"""cooccur-csl — the paper's own workload: co-occurrence network
construction over a CSL-scale corpus (396,209 docs) with a 65,536-term
lexicon, BFS depth 3, top-k 16, beam 32.  A copy of
``repro.configs.cooccur_csl``."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CoocConfig:
    name: str
    vocab_size: int
    n_docs: int
    default_depth: int
    default_topk: int
    default_beam: int

    @property
    def n_words(self) -> int:
        """Packed 32-bit words along the doc axis."""
        return (self.n_docs + 31) // 32


CONFIG = CoocConfig(
    name="cooccur-csl",
    vocab_size=65536,
    n_docs=396209,
    default_depth=3,
    default_topk=16,
    default_beam=32,
)
