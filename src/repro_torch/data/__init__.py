"""Host-side data: tokeniser, the synthetic CSL corpus and its statistics,
and the seeded LM and recsys batches."""
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
from repro_torch.data.pipeline import lm_batch, recsys_batch  # noqa: F401
