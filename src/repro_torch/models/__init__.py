"""Model code of the port: config, shared blocks, the dense transformer,
RWKV6, the RG-LRU hybrid and the family facade."""
