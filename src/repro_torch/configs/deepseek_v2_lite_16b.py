"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed top-6
[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite].

First layer is dense (d_ff 10944) per the HF config
(first_k_dense_replace=1); remaining 26 layers are MoE with
moe_intermediate_size=1408.

A copy of ``repro.configs.deepseek_v2_lite_16b``.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,              # dense (first) layer FFN
    vocab_size=102400,
    rope_theta=10000.0,
    moe=True,
    n_experts=64,
    top_k=6,
    d_ff_expert=1408,
    n_shared_experts=2,
    first_dense_layers=1,
    mla=True,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    fsdp=False,
    moment_dtype="float32",
)
