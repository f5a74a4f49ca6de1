"""Launchers of the port: execution policies, device meshes and the serve
and train entry points."""
