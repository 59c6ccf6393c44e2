"""Launch layer: the trainer (``python -m
repro_torch.launch.train``).  The reference's mesh, sharding rules and
dry-run cells wait for the next slice (ROADMAP.md §1)."""
