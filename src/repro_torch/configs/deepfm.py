"""deepfm [recsys] — 39 sparse fields, embed 10, FM + 400-400-400 MLP
[arXiv:1703.04247].  A copy of ``repro.configs.deepfm``."""
from repro_torch.configs.base import RecSysConfig

CONFIG = RecSysConfig(
    name="deepfm",
    interaction="fm",
    n_dense=0,
    n_sparse=39,
    vocab_per_field=1000000,
    embed_dim=10,
    mlp=(400, 400, 400),
    optimizer="adamw",
    learning_rate=1e-3,
    weight_decay=0.0,
)
