"""Launchers of the port: execution policies, device meshes, the serve
and train entry points, and the dry run (`specs`, `analyze`, `dryrun`,
`report`)."""
