"""Launchers: the serving entry point (``launch.serve``; its advisor half)."""
