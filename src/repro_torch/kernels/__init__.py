"""Hand-written CUDA kernels of the port, for Hopper (``sm_90a``).

  postings    — bit-packed AND + popcount doc frequencies (method "pallas")
  level_step  — one fused BFS level: counts + masks + exact top-k
                (method "fused")

Use them through :mod:`repro_torch.kernels.ops` (device dispatch and launch
counts); :mod:`repro_torch.kernels.ref` holds their plain PyTorch versions.
Nothing is compiled at import.
"""
from repro_torch.kernels import ops, ref  # noqa: F401
