"""Serving engine of the port: sampling, the block-paged KV pool, the
decode state and the continuous-batching engine."""
