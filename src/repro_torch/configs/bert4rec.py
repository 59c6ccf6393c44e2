"""bert4rec [recsys] — bidirectional sequential, embed 64, 2 blocks, 2 heads,
seq 200 [arXiv:1904.06690].  A copy of ``repro.configs.bert4rec``."""
from repro_torch.configs.base import RecSysConfig

CONFIG = RecSysConfig(
    name="bert4rec",
    interaction="bidir-seq",
    embed_dim=64,
    n_blocks=2,
    n_heads=2,
    seq_len=200,
    n_items=1000000,
    optimizer="adamw",
    learning_rate=1e-3,
    weight_decay=0.0,
)
