"""Launchers: device meshes and the sharding rules (``mesh``,
``sharding``), the trainer (``train``), and the dry-run that traces every
(arch x shape x mesh) cell on a fake process group (``specs``,
``trace_cost``, ``dryrun``)."""
