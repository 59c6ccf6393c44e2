"""qwen1.5-32b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B family].

n_heads=40 is not divisible by the 16-way model axis; the sharding rules
replicate attention projections over "model" and rely on FSDP over "data"
for their memory (see DESIGN.md §4) — FFN (27392/16) and vocab (152064/16)
remain tensor-parallel.

A copy of ``repro.configs.qwen1_5_32b``.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="qwen1.5-32b",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    fsdp=True,
    microbatches=2,
    moment_dtype="bfloat16",
)
