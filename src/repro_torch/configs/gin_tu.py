"""gin-tu [gnn] — GIN, 5 layers, d_hidden=64, sum aggregator, learnable eps
[arXiv:1810.00826].  A copy of ``repro.configs.gin_tu``."""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="gin-tu",
    n_layers=5,
    d_hidden=64,
    aggregator="sum",
    learnable_eps=True,
    optimizer="adamw",
    learning_rate=1e-3,
    weight_decay=0.0,
)
