"""Launch layer: meshes of torch devices, logical-axis sharding rules,
dry-run cells (arch x shape), the dry-run driver and the trainer.

``python -m repro_torch.launch.dryrun`` plans every cell on the
reference's production meshes, grids of PyTorch's ``meta`` placeholder
devices, and with ``--host`` runs the cells that fit on the devices
present; ``python -m repro_torch.launch.train`` trains.  Nothing in this
package touches a device at import time.
"""
