"""The port's checkpoint manager, on the JAX package's on-disk layout."""
