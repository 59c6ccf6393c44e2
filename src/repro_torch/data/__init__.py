"""Host-side data: tokeniser, the synthetic CSL corpus and its statistics,
the seeded LM and recsys batches, the synthetic GNN graph and the
neighbour sampler."""
from repro_torch.data.corpus import (  # noqa: F401
    CorpusStats,
    corpus_stats,
    synthetic_csl,
)
from repro_torch.data.tokenizer import (  # noqa: F401
    DEFAULT_STOPWORDS,
    build_lexicon,
    tokenize,
)
from repro_torch.data.pipeline import (  # noqa: F401
    gnn_synthetic_graph,
    lm_batch,
    recsys_batch,
)
from repro_torch.data.sampler import (  # noqa: F401
    build_csr,
    sample_subgraph,
    subgraph_sizes,
)
