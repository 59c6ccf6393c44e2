"""cooccur-csl — the paper's own workload: co-occurrence network
construction over a CSL-scale corpus (396,209 docs) with a 65,536-term
lexicon, BFS depth 3, top-k 16, beam 32.  A copy of
``repro.configs.cooccur_csl``; its shapes are ``COOC_SHAPES``."""
from repro_torch.configs.base import CoocConfig

CONFIG = CoocConfig(
    name="cooccur-csl",
    vocab_size=65536,
    n_docs=396209,
    default_depth=3,
    default_topk=16,
    default_beam=32,
)
