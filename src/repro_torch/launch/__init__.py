"""Launchers of the port: execution policies and the serve entry point."""
