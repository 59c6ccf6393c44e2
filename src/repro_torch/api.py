"""repro_torch.api — the string-level facade, mirroring ``repro.api``.

Text in, term-string co-occurrence network out: :class:`CoocIndex` joins
the tokenizer, the lexicon, the query context (packed index + per-epoch
artifacts) and the plan-aware engine behind one object::

    from repro_torch.api import CoocIndex

    idx = CoocIndex.from_texts(["an inverted index maps terms to documents",
                                "the index answers queries in real time"])
    idx.network(["index"], depth=2)        # {(term_a, term_b): weight}
    idx.add_documents(["fresh documents are visible immediately"])

It runs on ``cuda`` unless constructed with ``device="cpu"``.  Both
capacities grow on demand: the doc axis by repack on overflow
(``on_overflow="grow"``), the term axis as the lexicon mints ids.
Queries can be scoped to a source tag (``add_documents(source=...)``) or
a trailing time bucket (``scope="7d"``).

Not ported yet (``ROADMAP.md``): the sliding window, the cold tier, device
meshes, whole-corpus materialization and snapshots; those arguments and
methods raise ``NotImplementedError``.
"""
from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.inverted_index import Lexicon
from repro_torch.core.query import QueryResult
from repro_torch.core.query_context import (
    CapacityError,
    QueryContext,
    not_ported,
)
from repro_torch.data.tokenizer import DEFAULT_STOPWORDS, tokenize
from repro_torch.device import resolve_device
from repro_torch.serve.cooc_engine import CoocEngine, CoocFuture

_DURATION_RE = re.compile(r"^(\d+)(s|m|h|d|w)$")
_DURATION_SECONDS = {"s": 1, "m": 60, "h": 3600, "d": 86400, "w": 604800}

#: most duration-derived time buckets kept alive at once (LRU beyond this)
MAX_TIME_BUCKETS = 32


def parse_duration(spec: str) -> Optional[float]:
    """``"7d"`` -> 604800.0 seconds; None when ``spec`` is not a duration."""
    m = _DURATION_RE.match(spec)
    if m is None:
        return None
    return float(m.group(1)) * _DURATION_SECONDS[m.group(2)]


class CoocIndex:
    """Text-level co-occurrence index: tokenizer + lexicon + live packed
    index + plan-aware query engine, on one device.  The
    depth/topk/beam/dedup/method arguments are the default query plan;
    every query method takes per-call overrides."""

    def __init__(self, *, device="cuda", capacity: Optional[int] = None,
                 vocab_capacity: int = 256,
                 depth: int = 2, topk: int = 16, beam: int = 32,
                 dedup: bool = True, method: str = "gemm", q_batch: int = 8,
                 stopwords: Set[str] = DEFAULT_STOPWORDS,
                 on_overflow: str = "grow", window: Optional[int] = None,
                 mesh=None, devices=None, cold_store=None):
        if window is not None:
            raise not_ported("the sliding window (window=)")
        if mesh is not None or devices is not None:
            raise not_ported("sharded serving (mesh=/devices=)")
        if cold_store is not None:
            raise not_ported("the cold tier (cold_store=)")
        dev = resolve_device(device)
        self.lexicon = Lexicon()
        self.stopwords = stopwords
        cap = max(int(capacity or 1024), 32)
        self.ctx = QueryContext.from_docs([], max(int(vocab_capacity), 1),
                                          capacity=cap, device=dev)
        self.engine = CoocEngine(self.ctx, device=dev, depth=depth,
                                 topk=topk, beam=beam, dedup=dedup,
                                 method=method, q_batch=q_batch,
                                 on_overflow=on_overflow)
        self._doc_time = np.zeros((self.ctx.index.capacity,), np.float64)
        self._lt_epoch = -1
        self._lt_slots = np.zeros((0,), np.int64)
        self._lt_times = np.zeros((0,), np.float64)
        self._bucket_state: Dict[str, Tuple[int, float]] = {}

    @classmethod
    def from_texts(cls, texts: Sequence[str], **kwargs) -> "CoocIndex":
        """Build an index over ``texts`` (constructor kwargs pass through)."""
        idx = cls(**kwargs)
        idx.add_documents(texts)
        return idx

    # -- ingest path --------------------------------------------------------

    def add_documents(self, texts: Sequence[str], *,
                      timestamp: Optional[float] = None,
                      source: Optional[str] = None) -> int:
        """Tokenise + ingest; new terms extend the lexicon (growing the
        term axis when needed).  The docs are visible to the very next
        query.  ``timestamp`` (default now) drives the time-bucket scopes;
        ``source`` tags the batch as a named scope.  A rejected batch
        leaves no trace in the lexicon or the index.  Returns #docs."""
        if source is not None and parse_duration(source) is not None:
            raise ValueError(
                f"source tag {source!r} collides with the duration-scope "
                "syntax ('7d', '24h', ...); pick a non-duration name")
        if source == "all-time":
            raise ValueError(
                "source tag 'all-time' is reserved for the cold-tier scope "
                "(live + evicted docs); pick another name")
        token_docs = [tokenize(t, self.stopwords) for t in texts]
        if (self.engine.on_overflow != "grow"
                and self.ctx.n_docs + len(token_docs)
                > self.ctx.index.capacity):
            raise CapacityError(
                f"ingest of {len(token_docs)} docs would exceed capacity "
                f"{self.ctx.index.capacity} (n_docs={self.ctx.n_docs}); "
                f"pass on_overflow='grow' to repack")
        if not token_docs:
            if source is not None:
                self.ctx.tag_scope(source, [])
            return 0
        lex_size = len(self.lexicon)
        vocab_size = self.ctx.vocab_size
        docs = [[self.lexicon.add(w) for w in ws] for ws in token_docs]
        try:
            if len(self.lexicon) > self.ctx.vocab_size:
                self.ctx.grow_vocab(len(self.lexicon))
            max_len = max(max((len(d) for d in docs), default=1), 1)
            slots = self.ctx.ingest_docs(docs, max_len=max_len,
                                         on_overflow=self.engine.on_overflow,
                                         scope=source)
        except Exception:
            # un-intern this batch's new terms and un-grow the term axis:
            # the lexicon and the index never disagree on which terms exist
            for term in self.lexicon.id_to_term[lex_size:]:
                del self.lexicon.term_to_id[term]
            del self.lexicon.id_to_term[lex_size:]
            self.ctx.shrink_vocab(vocab_size)
            raise
        cap = self.ctx.index.capacity
        if cap > len(self._doc_time):
            self._doc_time = np.pad(self._doc_time,
                                    (0, cap - len(self._doc_time)))
        self._doc_time[slots] = time.time() if timestamp is None \
            else float(timestamp)
        return len(docs)

    # -- query path ---------------------------------------------------------

    def term_id(self, term: str) -> int:
        """Lexicon lookup (tokeniser-normalised); KeyError on unseen terms."""
        tid = self.lexicon.term_to_id.get(str(term).lower())
        if tid is None:
            raise KeyError(f"term {term!r} not in lexicon "
                           f"({len(self.lexicon)} terms indexed)")
        return tid

    def __contains__(self, term: str) -> bool:
        return str(term).lower() in self.lexicon.term_to_id

    def _live_by_time(self):
        """Live slots sorted by ingest timestamp, rebuilt once per epoch."""
        if self._lt_epoch != self.ctx.epoch:
            live = self.ctx.live_slots()
            t = self._doc_time[live]
            order = np.argsort(t, kind="stable")
            self._lt_slots, self._lt_times = live[order], t[order]
            self._lt_epoch = self.ctx.epoch
        return self._lt_slots, self._lt_times

    def _resolve_scope(self, scope: Optional[str],
                       now: Optional[float]) -> Optional[str]:
        """A duration ("7d", "24h") refreshes the matching time-bucket
        scope from the live docs' timestamps; any other string must name
        an existing scope."""
        if scope is None:
            return None
        seconds = parse_duration(scope)
        if seconds is not None:
            cutoff = (time.time() if now is None else float(now)) - seconds
            slots, times = self._live_by_time()
            state = self._bucket_state.get(scope)
            if (state is not None and state[0] == self.ctx.epoch
                    and scope in self.ctx.scope_names()):
                # membership changed iff a live timestamp lies between the
                # old and the new cutoff
                lo, hi = sorted((state[1], cutoff))
                if (np.searchsorted(times, hi, side="left")
                        == np.searchsorted(times, lo, side="left")):
                    del self._bucket_state[scope]
                    self._bucket_state[scope] = (self.ctx.epoch, cutoff)
                    return scope
            sel = slots[np.searchsorted(times, cutoff, side="left"):]
            self.ctx.define_scope(scope, sel)
            self._bucket_state.pop(scope, None)
            self._bucket_state[scope] = (self.ctx.epoch, cutoff)
            while len(self._bucket_state) > MAX_TIME_BUCKETS:
                old = next(iter(self._bucket_state))
                del self._bucket_state[old]
                # serve queued requests of the evicted bucket before its
                # bitmap goes, so they never fail at step time
                while any(r.spec.scope == old for r in self.engine.queue):
                    self.engine.step()
                self.ctx.drop_scope(old)
            return scope
        if scope not in self.ctx.scope_names():
            raise KeyError(
                f"unknown scope {scope!r}: not a duration (like '7d') and "
                f"no such tag; defined scopes: {list(self.ctx.scope_names())}")
        return scope

    def submit(self, seed_terms: Sequence[str], *,
               scope: Optional[str] = None, now: Optional[float] = None,
               **params) -> CoocFuture:
        """Queue a query rooted at ``seed_terms`` (strings); ``params``
        override the default plan, ``scope`` restricts it to a time bucket
        or a tag."""
        seeds = tuple(self.term_id(t) for t in seed_terms)
        name = self._resolve_scope(scope, now)
        if name is not None:
            params["scope"] = name
        return self.engine.submit(seeds, **params)

    def query(self, seed_terms: Sequence[str], **params) -> QueryResult:
        """Synchronous typed query: submit + drive to completion."""
        return self.submit(seed_terms, **params).result()

    def network(self, seed_terms: Sequence[str],
                **params) -> Dict[Tuple[str, str], int]:
        """{(term_a, term_b): co-occurrence count} of the BFS network
        rooted at ``seed_terms``."""
        res = self.query(seed_terms, **params)
        id2t = self.lexicon.id_to_term
        return {(id2t[a], id2t[b]): w for (a, b), w in res.edges().items()}

    def top(self, seed_terms: Sequence[str], limit: int = 10,
            **params) -> List[Tuple[str, str, int]]:
        """The ``limit`` heaviest string edges, heaviest first."""
        res = self.query(seed_terms, **params)
        id2t = self.lexicon.id_to_term
        return [(id2t[a], id2t[b], w) for a, b, w in res.top(limit)]

    # -- not ported yet -----------------------------------------------------

    def full_network(self, *args, **kwargs):
        raise not_ported("whole-corpus materialization (full_network)")

    def network_stats(self, *args, **kwargs):
        raise not_ported("whole-corpus materialization (network_stats)")

    def save(self, *args, **kwargs):
        raise not_ported("snapshots (save)")

    @classmethod
    def load(cls, *args, **kwargs):
        raise not_ported("snapshots (load)")

    # -- introspection ------------------------------------------------------

    @property
    def n_docs(self) -> int:
        return self.ctx.n_docs

    @property
    def live_docs(self) -> int:
        return self.ctx.live_docs

    @property
    def window(self) -> Optional[int]:
        return None

    @property
    def n_terms(self) -> int:
        return len(self.lexicon)

    @property
    def mesh(self):
        return None

    def stats(self):
        return self.engine.stats()
