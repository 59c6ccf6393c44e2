"""dlrm-rm2 [recsys] — 13 dense + 26 sparse, embed 64, bottom 13-512-256-64,
top 512-512-256-1, dot interaction [arXiv:1906.00091].  A copy of
``repro.configs.dlrm_rm2``."""
from repro_torch.configs.base import RecSysConfig

CONFIG = RecSysConfig(
    name="dlrm-rm2",
    interaction="dot",
    n_dense=13,
    n_sparse=26,
    vocab_per_field=1000000,
    embed_dim=64,
    bot_mlp=(512, 256, 64),
    top_mlp=(512, 512, 256, 1),
    optimizer="adamw",
    learning_rate=1e-3,
    weight_decay=0.0,
)
