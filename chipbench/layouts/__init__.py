"""Weight layouts of the program's model families, found by the
configuration's `layout` key: `leaves(cfg)` gives every leaf's path, shape
and standard deviation."""
