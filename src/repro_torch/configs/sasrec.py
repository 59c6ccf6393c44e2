"""sasrec [recsys] — causal sequential, embed 50, 2 blocks, 1 head, seq 50
[arXiv:1808.09781].  A copy of ``repro.configs.sasrec``."""
from repro_torch.configs.base import RecSysConfig

CONFIG = RecSysConfig(
    name="sasrec",
    interaction="self-attn-seq",
    embed_dim=50,
    n_blocks=2,
    n_heads=1,
    seq_len=50,
    n_items=1000000,
    optimizer="adamw",
    learning_rate=1e-3,
    weight_decay=0.0,
)
