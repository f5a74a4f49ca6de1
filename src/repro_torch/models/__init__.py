"""Model code of the port: config, shared blocks, the dense transformer
and the family facade."""
