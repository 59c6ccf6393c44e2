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
a trailing time bucket (``scope="7d"``).  ``window=`` enters sliding-window
mode (at most ``window`` live docs, oldest batch evicted first, memory
pinned), and ``cold_store=`` keeps every evicted batch in a cold tier that
``scope="all-time"`` answers over together with the live docs.

:meth:`CoocIndex.full_network` and :meth:`CoocIndex.network_stats` give the
whole-corpus network (every term's top-``k`` neighbors) and its global
statistics through :func:`repro_torch.core.materialize`, exactly or, with
``mode="approx"``, sketch-pruned.  :meth:`CoocIndex.save` and
:meth:`CoocIndex.load` snapshot and restore the whole index in the
reference's format (:mod:`repro_torch.core.snapshot`), so either package
restores what the other saved.

**Sharded serving.**  ``CoocIndex(devices=4)`` (the first four cards) or
``devices=["cuda:0"] * 4`` builds a term-sharded query mesh
(:func:`repro_torch.core.distributed.make_cooc_mesh`); ``mesh=`` takes a
prebuilt one (``shard="docs"`` for doc sharding).  Every query and
materialization then runs sharded, with the single device's answers, and
``load(mesh=, devices=)`` restores a snapshot onto a mesh.
"""
from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core import snapshot
from repro_torch.core.inverted_index import Lexicon
from repro_torch.core.materialize import materialize
from repro_torch.core.network import (
    CoocNetwork,
    NetworkStats,
    global_statistics,
    to_edge_dict,
)
from repro_torch.core.query import QueryResult
from repro_torch.core.query_context import CapacityError, QueryContext
from repro_torch.core.storage import make_storage
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


def _resolve_mesh(mesh, devices):
    """mesh= (prebuilt) XOR devices= (an int takes the first N cards, a
    sequence is used as given; terms are the split axis —
    ``make_cooc_mesh(shard="docs")`` callers pass mesh=)."""
    if mesh is not None and devices is not None:
        raise ValueError("pass mesh= (a prebuilt query mesh) OR "
                         "devices= (a device count/list to build a "
                         "term-sharded one over), not both")
    if devices is not None:
        from repro_torch.core.distributed import make_cooc_mesh
        if isinstance(devices, int):
            return make_cooc_mesh(devices)
        return make_cooc_mesh(devices=devices)
    return mesh


class CoocIndex:
    """Text-level co-occurrence index: tokenizer + lexicon + live packed
    index + plan-aware query engine, on one device or a mesh.  The
    depth/topk/beam/dedup/method arguments are the default query plan;
    every query method takes per-call overrides.  ``window`` enters
    sliding-window (streaming) mode: at most ``window`` live docs,
    oldest-ingest-first eviction, fixed memory; ``cold_store`` (a mapping
    or a :func:`~repro_torch.core.storage.make_storage` config) keeps the
    evicted batches for ``scope="all-time"``.  ``mesh`` / ``devices``
    serve sharded (see the module docstring); ``device`` must then name
    the mesh's first device."""

    def __init__(self, *, device="cuda", capacity: Optional[int] = None,
                 vocab_capacity: int = 256,
                 depth: int = 2, topk: int = 16, beam: int = 32,
                 dedup: bool = True, method: str = "gemm", q_batch: int = 8,
                 stopwords: Set[str] = DEFAULT_STOPWORDS,
                 on_overflow: str = "grow", window: Optional[int] = None,
                 mesh=None, devices=None, cold_store=None):
        if capacity is not None and window is not None:
            raise ValueError(
                f"capacity={capacity} and window={window} are contradictory:"
                " window mode pins the doc buffer at ceil(window/32)*32"
                " slots and reuses them forever — pass only one")
        mesh = _resolve_mesh(mesh, devices)
        dev = resolve_device(device)
        self.lexicon = Lexicon()
        self.stopwords = stopwords
        # window mode: set_window sizes the ring
        cap = max(int(capacity or 1024), 32) if window is None else 32
        if cold_store is not None:
            cold_store = make_storage(cold_store)
        self.ctx = QueryContext.from_docs([], max(int(vocab_capacity), 1),
                                          capacity=cap, device=dev,
                                          window=window, mesh=mesh,
                                          cold_store=cold_store)
        self.engine = CoocEngine(self.ctx, device=self.ctx.device,
                                 depth=depth,
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
        ``source`` tags the batch as a named scope.  In window mode the
        oldest batches are evicted first when the window fills.  A
        rejected batch leaves no trace in the lexicon or the index.
        Returns #docs."""
        if source is not None and parse_duration(source) is not None:
            raise ValueError(
                f"source tag {source!r} collides with the duration-scope "
                "syntax ('7d', '24h', ...); pick a non-duration name")
        if source == "all-time":
            raise ValueError(
                "source tag 'all-time' is reserved for the cold-tier scope "
                "(live + evicted docs); pick another name")
        if self.ctx.window is not None and len(texts) > self.ctx.window:
            # refused before interning: no phantom lexicon terms
            raise ValueError(
                f"batch of {len(texts)} docs exceeds window="
                f"{self.ctx.window}; it could never be live in full — "
                "split the batch or raise the window")
        token_docs = [tokenize(t, self.stopwords) for t in texts]
        if (self.ctx.window is None and self.engine.on_overflow != "grow"
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
        # a reused ring slot takes its new doc's time
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

    # -- whole-corpus network -----------------------------------------------

    def _materialize(self, k: int, scope: Optional[str],
                     now: Optional[float], method: Optional[str],
                     mode: str, **kwargs) -> CoocNetwork:
        # "all-time" is the cold-tier scope, not a tag or a time bucket:
        # core.materialize stacks the live and cold tiers
        name = scope if scope == "all-time" else self._resolve_scope(scope,
                                                                      now)
        return materialize(self.ctx, k=int(k),
                           method=method or self.engine.method, scope=name,
                           mode=mode, **kwargs)

    def full_network(self, k: int = 8, *, scope: Optional[str] = None,
                     now: Optional[float] = None,
                     method: Optional[str] = None, mode: str = "exact",
                     **kwargs) -> Dict[Tuple[str, str], int]:
        """The CORPUS-level network: every indexed term's top-``k``
        heaviest co-occurrence neighbors, as string edges
        ``{(term_a, term_b): count}`` — the paper's whole-corpus artifact,
        versus :meth:`network`'s seed-rooted neighborhood.  ``scope``
        restricts it to a time bucket ("7d") or source tag exactly as in
        :meth:`query`, and ``scope="all-time"`` answers over the live docs
        and every batch the window evicted to the cold store; ``method``
        defaults to the engine's.  A warm context (no ingest since the last
        call) serves the cached result."""
        net = self._materialize(k, scope, now, method, mode, **kwargs)
        id2t = self.lexicon.id_to_term
        return {(id2t[a], id2t[b]): w
                for (a, b), w in to_edge_dict(net).items()}

    def network_stats(self, k: int = 8, *, scope: Optional[str] = None,
                      now: Optional[float] = None,
                      method: Optional[str] = None, mode: str = "exact",
                      **kwargs) -> NetworkStats:
        """Global statistics of the materialized corpus network (node and
        edge counts, density, degree / weighted-degree distributions).
        Same k/scope/method semantics as :meth:`full_network`."""
        net = self._materialize(k, scope, now, method, mode, **kwargs)
        return global_statistics(net, self.ctx.vocab_size)

    # -- persistence --------------------------------------------------------

    def save(self, path: str, *, keep: int = 2) -> str:
        """Snapshot the whole index state under ``path``: packed postings,
        lexicon, streaming ring and scopes, doc timestamps, time-bucket
        state, engine plan defaults, cold-tier blocks and sketch state,
        through the crash-safe commit protocol of
        :mod:`repro_torch.core.snapshot` (the reference's format).  ``keep``
        retains that many snapshot generations.  Returns the committed
        snapshot directory."""
        extra_arrays = {"doc_time": np.asarray(self._doc_time, np.float64)}
        extra_meta = {
            "kind": "cooc",
            "cooc": {
                "lexicon": list(self.lexicon.id_to_term),
                "stopwords": sorted(self.stopwords),
                "engine": {"depth": self.engine.depth,
                           "topk": self.engine.topk,
                           "beam": self.engine.beam,
                           "dedup": self.engine.dedup,
                           "method": self.engine.method,
                           "q_batch": self.engine.q_batch,
                           "on_overflow": self.engine.on_overflow,
                           "window": self.engine.window},
                "bucket_state": {k: [int(e), float(c)]
                                 for k, (e, c) in self._bucket_state.items()},
            },
        }
        return snapshot.save_context(self.ctx, path,
                                     extra_arrays=extra_arrays,
                                     extra_meta=extra_meta, keep=keep)

    @classmethod
    def load(cls, path: str, *, device="cuda", cold_store=None,
             verify: bool = True, mesh=None, devices=None) -> "CoocIndex":
        """Restore a :meth:`save` snapshot (of either package) onto
        ``device``: it answers every query exactly like the saved index;
        warm caches rebuild lazily.  ``cold_store`` receives the
        snapshot's spilled blocks (the constructor's ``make_storage``
        configs; a fresh dict when omitted and the snapshot has any).
        ``mesh`` / ``devices`` restore onto a query mesh, as the
        constructor takes them: one snapshot, any mesh.  A bare-context
        snapshot raises :class:`SnapshotError`."""
        mesh = _resolve_mesh(mesh, devices)
        dev = resolve_device(device)
        if cold_store is not None:
            cold_store = make_storage(cold_store)
        arrays, meta = snapshot.read_snapshot(path, verify=verify)
        if meta.get("kind") != "cooc":
            raise snapshot.SnapshotError(
                f"snapshot under {path!r} is a bare context (kind="
                f"{meta.get('kind')!r}); restore it with "
                "repro_torch.core.snapshot.load_context instead")
        ctx = snapshot.context_from_state(arrays, meta, device=dev,
                                          mesh=mesh, cold_store=cold_store)
        cm = meta["cooc"]
        eng = cm["engine"]
        idx = cls.__new__(cls)
        idx.lexicon = Lexicon()
        for term in cm["lexicon"]:
            idx.lexicon.add(term)
        idx.stopwords = set(cm["stopwords"])
        idx.ctx = ctx
        idx.engine = CoocEngine(ctx, device=ctx.device,
                                depth=int(eng["depth"]),
                                topk=int(eng["topk"]), beam=int(eng["beam"]),
                                dedup=bool(eng["dedup"]),
                                method=eng["method"],
                                q_batch=int(eng["q_batch"]),
                                on_overflow=eng["on_overflow"],
                                window=int(eng.get("window", 2048)))
        doc_time = np.array(arrays["doc_time"], np.float64)
        cap = ctx.index.capacity
        if cap > len(doc_time):
            doc_time = np.pad(doc_time, (0, cap - len(doc_time)))
        idx._doc_time = doc_time
        idx._lt_epoch = -1
        idx._lt_slots = np.zeros((0,), np.int64)
        idx._lt_times = np.zeros((0,), np.float64)
        idx._bucket_state = {k: (int(v[0]), float(v[1]))
                             for k, v in cm["bucket_state"].items()}
        return idx

    # -- introspection ------------------------------------------------------

    @property
    def n_docs(self) -> int:
        return self.ctx.n_docs

    @property
    def live_docs(self) -> int:
        return self.ctx.live_docs

    @property
    def window(self) -> Optional[int]:
        return self.ctx.window

    @property
    def n_terms(self) -> int:
        return len(self.lexicon)

    @property
    def mesh(self):
        """The query mesh this index serves on (None = single device)."""
        return self.ctx.mesh

    def stats(self):
        return self.engine.stats()
