"""Distributed-training pieces of the port; so far the int8 gradient
compression with error feedback."""
