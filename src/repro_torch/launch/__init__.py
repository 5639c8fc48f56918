"""Launchers: the trainer (the mesh and dry-run layer is ROADMAP
A16)."""
