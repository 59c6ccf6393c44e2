"""granite-3-8b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base family].

vocab 49155 is padded physically to 49280 (lcm-aligned); logical size kept.

A copy of ``repro.configs.granite_3_8b``.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="granite-3-8b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=10000.0,
    tie_embeddings=True,
    fsdp=True,
    moment_dtype="float32",
)
