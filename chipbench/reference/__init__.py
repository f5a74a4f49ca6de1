"""Plain float32 references, one module per model family, found by the
configuration's `reference` key."""
