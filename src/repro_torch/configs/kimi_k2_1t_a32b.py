"""kimi-k2-1t-a32b [moe] — trillion-param MoE [arXiv:2501.kimi2 per assignment].

Assigned spec: 61L d_model=7168 64H (GQA kv=8) d_ff=2048(/expert)
vocab=163840, MoE 384 experts top-8.  Following the K2/DeepSeek family
convention we add 1 shared expert and make the first layer dense
(d_ff 18432).  ~1.03T total / ~32B active params.

At this scale the config enables the full memory stack: Adafactor
(factored 2nd moment, bf16 1st moment), FSDP param+state sharding,
4-way gradient-accumulation microbatching, remat.

A copy of ``repro.configs.kimi_k2_1t_a32b``.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=18432,              # dense (first) layer FFN
    vocab_size=163840,
    rope_theta=50000.0,
    moe=True,
    n_experts=384,
    top_k=8,
    d_ff_expert=2048,
    n_shared_experts=1,
    first_dense_layers=1,
    capacity_factor=1.25,
    fsdp=True,
    microbatches=4,
    optimizer="adafactor",
    moment_dtype="bfloat16",
)
