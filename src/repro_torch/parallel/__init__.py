"""Parallel pieces of the port: the sharding rules and explicit tensor
parallelism over a device mesh (`sharding`, `collectives`) and the int8
gradient compression with error feedback (`compression`)."""
