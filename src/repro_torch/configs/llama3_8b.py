"""llama3-8b [dense] — GQA, 128k vocab [arXiv:2407.21783].

A copy of ``repro.configs.llama3_8b``.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="llama3-8b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    fsdp=True,
    microbatches=1,
    moment_dtype="float32",
)
