"""Host-side data: tokeniser and the synthetic CSL corpus."""
from repro_torch.data.corpus import synthetic_csl  # noqa: F401
from repro_torch.data.tokenizer import (  # noqa: F401
    DEFAULT_STOPWORDS,
    build_lexicon,
    tokenize,
)
