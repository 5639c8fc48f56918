"""Launchers: device meshes and the sharding rules (``mesh``,
``sharding``) and the trainer (``train``); the dry-run layer is ROADMAP
A16b."""
