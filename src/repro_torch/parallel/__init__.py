"""Parallel pieces of the port: the sharding rules and explicit tensor
parallelism over a device mesh (`sharding`, `collectives`, the
collectives carrying gradients under autograd), the GPipe pipeline over
a mesh axis (`pipeline`) and the int8 gradient compression with error
feedback (`compression`)."""
