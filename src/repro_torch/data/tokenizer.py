"""Tokenisation, copied from ``repro.data.tokenizer``: regex word split,
lowercasing, stopword filtering and lexicon construction.  The index
consumes only term-id lists."""
from __future__ import annotations

import re
from typing import Iterable, List, Set, Tuple

from repro_torch.core.inverted_index import Lexicon

_WORD = re.compile(r"[a-zA-Z][a-zA-Z0-9_\-]+")

DEFAULT_STOPWORDS: Set[str] = {
    "the", "a", "an", "and", "or", "of", "in", "on", "for", "to", "with",
    "is", "are", "was", "were", "be", "been", "by", "as", "at", "that",
    "this", "these", "those", "it", "its", "from", "we", "our", "their",
}


def tokenize(text: str, stopwords: Set[str] = DEFAULT_STOPWORDS) -> List[str]:
    return [w for w in (m.group(0).lower() for m in _WORD.finditer(text))
            if w not in stopwords]


def build_lexicon(texts: Iterable[str],
                  stopwords: Set[str] = DEFAULT_STOPWORDS
                  ) -> Tuple[Lexicon, List[List[int]]]:
    """Tokenise a corpus and assign term ids -> (lexicon, doc term-id lists)."""
    lex = Lexicon()
    docs: List[List[int]] = []
    for t in texts:
        docs.append([lex.add(w) for w in tokenize(t, stopwords)])
    return lex, docs
