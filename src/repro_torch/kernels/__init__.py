"""Hand-written CUDA kernels of the port, for Hopper (``sm_90a``).

  postings    — bit-packed AND + popcount doc frequencies (method "pallas")
  level_step  — one fused BFS level: counts + masks + exact top-k
                (method "fused")
  cooccur     — int8 tensor-core co-occurrence counts x_l^T @ x_r
                (materialize(method="pallas"))
  dot_interaction — DLRM's strict lower triangle of x x^T per sample
                (models.recsys.dlrm_logits)
  flash_decode — GQA decode attention, S split across CTAs
                (ops.flash_decode)

Use them through :mod:`repro_torch.kernels.ops` (device dispatch and launch
counts); :mod:`repro_torch.kernels.ref` holds their plain PyTorch versions.
Nothing is compiled at import.
"""
from repro_torch.kernels import ops, ref  # noqa: F401
