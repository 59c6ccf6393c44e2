"""Real-time co-occurrence network construction from an inverted index —
the PyTorch/CUDA port of ``repro``, for one NVIDIA H100.

Entry points: :mod:`repro_torch.api` (the string-level
:class:`~repro_torch.api.CoocIndex` facade), :mod:`repro_torch.core`
(packed index, BFS construction, QuerySpec / QueryResult, QueryContext),
:mod:`repro_torch.serve` (CoocEngine).  They run on ``cuda`` unless the
caller passes ``device="cpu"``.  The package imports torch and numpy,
never jax and nothing of ``repro``.
"""

__version__ = "0.1.0"
