"""Typed query surface: QuerySpec / PlanKey / QueryResult + the count-method
registry.  Mirrors ``repro.core.query``; the method names and the
QuerySpec fields are the reference's, so one spec runs in both packages.

The built-in count methods:

* ``"gemm"``     — ``unpack(masks) @ x_dense`` (one int8 torch GEMM with
  int32 accumulation);
* ``"popcount"`` — AND + popcount over the packed bitmap (plain torch:
  ``kernels.ref.postings_counts_ref``, on every device);
* ``"pallas"``   — the same counts through the hand-written CUDA postings
  kernel (``kernels.ops.postings_counts``; its plain version on the CPU);
* ``"fused"``    — the whole level step (counts + masks + top-k) through
  the hand-written CUDA level-step kernel (``kernels.ops.level_step``).

A method's ``fn(index, masks, operands)`` returns the (R, V) counts; an
optional ``level_fn`` replaces the counts -> masks -> top-k chain with one
call that must be bit-identical to it.  ``"fused"`` always runs through
its ``level_fn``; its counts-only ``fn`` is the plain popcount.
"""
from __future__ import annotations

import dataclasses
from typing import (
    Callable,
    Dict,
    List,
    Mapping,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np
import torch

from repro_torch.core.inverted_index import (
    PackedIndex,
    doc_freq_under_batch,
    doc_freq_under_batch_gemm,
)
from repro_torch.core.network import (
    CoocNetwork,
    nodes_of,
    to_edge_dict,
    to_edge_index,
)
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# Count-method registry
# ---------------------------------------------------------------------------

#: context artifacts a count method may request via ``needs``
KNOWN_OPERANDS = ("x_dense", "packed_t", "packed_t_pad")

CountFn = Callable[[PackedIndex, torch.Tensor, Mapping[str, torch.Tensor]],
                   torch.Tensor]
#: level_fn(index, masks, terms, valid, visited, operands, *, k, dedup)
#: -> (weights (R, k), ids (R, k)); visited is (Q, V) for a batch-major
#: frontier of Q queries
LevelFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


class CountMethod(NamedTuple):
    name: str
    needs: Tuple[str, ...]
    fn: CountFn
    level_fn: Optional[LevelFn] = None


_REGISTRY: Dict[str, CountMethod] = {}
_BUILTIN = ("gemm", "popcount", "pallas", "fused")


def register_count_method(name: str, needs: Sequence[str], fn: CountFn, *,
                          level_fn: Optional[LevelFn] = None,
                          overwrite: bool = False) -> CountMethod:
    """Register a frontier-count method under ``name``; ``needs`` lists
    the QueryContext artifacts it consumes (subset of KNOWN_OPERANDS)."""
    needs = tuple(needs)
    unknown = [n for n in needs if n not in KNOWN_OPERANDS]
    if unknown:
        raise ValueError(f"unknown operand(s) {unknown} in needs; "
                         f"known context artifacts: {KNOWN_OPERANDS}")
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"count method {name!r} already registered; "
                         "pass overwrite=True to replace it")
    m = CountMethod(name, needs, fn, level_fn)
    _REGISTRY[name] = m
    return m


def unregister_count_method(name: str) -> None:
    if name in _BUILTIN:
        raise ValueError(f"refusing to unregister built-in method {name!r}")
    _REGISTRY.pop(name, None)


def get_count_method(name: str) -> CountMethod:
    m = _REGISTRY.get(name)
    if m is None:
        raise ValueError(f"unknown method {name!r}; "
                         f"choose from {sorted(_REGISTRY)}")
    return m


def count_method_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _gemm_counts(index, masks, operands):
    x_dense = operands.get("x_dense")
    if x_dense is None:
        raise ValueError("gemm method needs the dense incidence operand")
    return doc_freq_under_batch_gemm(masks, x_dense)[:, :index.vocab_size]


def _popcount_counts(index, masks, operands):
    return doc_freq_under_batch(index, masks)


def _pallas_counts(index, masks, operands):
    return ops.postings_counts(masks, index.packed)


def _fused_level(index, masks, terms, valid, visited, operands, *, k, dedup):
    """One ``kernels.ops.level_step`` call over the pre-padded transposed
    postings: counts, masking and top-k never leave the kernel."""
    return ops.level_step(masks, operands["packed_t_pad"], terms, valid,
                          visited, v=index.vocab_size, k=k, dedup=dedup)


register_count_method("gemm", ("x_dense",), _gemm_counts)
register_count_method("popcount", (), _popcount_counts)
register_count_method("pallas", (), _pallas_counts)
register_count_method("fused", ("packed_t_pad",), _popcount_counts,
                      level_fn=_fused_level)


# ---------------------------------------------------------------------------
# QuerySpec / PlanKey
# ---------------------------------------------------------------------------


class PlanKey(NamedTuple):
    """Everything that shapes one executed batch.  ``scope`` names an
    operand, not a shape: it keeps batches scope-homogeneous, and
    :func:`canonical_exec_key` erases it."""
    depth: int
    topk: int
    beam: int
    dedup: bool
    method: str
    scope: Optional[str] = None


def canonical_exec_key(key: PlanKey) -> PlanKey:
    """Collapse a plan key to its executor identity: scoped and unscoped
    plans of equal shape share one executor (the engine always passes a
    scope bitmap, the all-ones one for unscoped plans)."""
    return key._replace(scope=None)


#: field names a wire-format query request may carry (== QuerySpec fields)
SPEC_FIELDS: Tuple[str, ...] = ("seeds", "depth", "topk", "beam", "dedup",
                                "method", "scope")


def canonicalize_request(
        request: Union["QuerySpec", Mapping, Sequence[int]], *,
        defaults: Optional[Mapping] = None) -> "QuerySpec":
    """Normalise a wire-format request (a QuerySpec, a mapping of spec
    fields, or a bare seed sequence) into a validated QuerySpec; unknown
    mapping keys raise, ``defaults`` keys outside SPEC_FIELDS are
    ignored."""
    if isinstance(request, QuerySpec):
        return request
    base = {k: v for k, v in dict(defaults or {}).items() if k in SPEC_FIELDS}
    if isinstance(request, Mapping):
        unknown = sorted(set(request) - set(SPEC_FIELDS))
        if unknown:
            raise ValueError(
                f"unknown QuerySpec field(s) {unknown} in request; "
                f"valid fields: {sorted(SPEC_FIELDS)}")
        base.update(request)
        if "seeds" not in base:
            raise ValueError("request names no seeds")
    else:
        base["seeds"] = request
    base["seeds"] = tuple(int(s) for s in base["seeds"])
    return QuerySpec(**base)


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """A validated, hashable description of one co-occurrence query
    (same fields and validation as ``repro.core.query.QuerySpec``)."""
    seeds: Tuple[int, ...]
    depth: int = 3
    topk: int = 16
    beam: int = 32
    dedup: bool = True
    method: str = "gemm"
    scope: Optional[str] = None

    def __post_init__(self):
        seeds = tuple(int(s) for s in self.seeds)
        object.__setattr__(self, "seeds", seeds)
        if not seeds:
            raise ValueError("empty seed set")
        if any(s < 0 for s in seeds):
            raise ValueError(f"negative seed term id in {seeds} "
                             "(-1 is the internal padding sentinel)")
        if len(seeds) > self.beam:
            raise ValueError(
                f"{len(seeds)} seed terms exceed beam={self.beam}; raise the "
                f"spec's beam or split the query")
        for field in ("depth", "topk", "beam"):
            if int(getattr(self, field)) < 1:
                raise ValueError(f"{field} must be >= 1")
        if self.scope is not None and (not isinstance(self.scope, str)
                                       or not self.scope):
            raise ValueError(f"scope must be None or a non-empty scope name, "
                             f"got {self.scope!r}")
        get_count_method(self.method)

    @property
    def plan_key(self) -> PlanKey:
        return PlanKey(self.depth, self.topk, self.beam, self.dedup,
                       self.method, self.scope)

    @property
    def max_edges(self) -> int:
        return self.depth * self.beam * self.topk

    def seed_row(self) -> np.ndarray:
        """(beam,) int32 seeds padded with -1 — the executor's row format."""
        row = np.full((self.beam,), -1, np.int32)
        row[:len(self.seeds)] = self.seeds
        return row


# ---------------------------------------------------------------------------
# QueryResult
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QueryResult:
    """Typed response: the network + serving metadata + host-side views."""
    network: CoocNetwork
    spec: QuerySpec
    epoch: int = 0
    latency_ms: float = 0.0
    batch_occupancy: int = 1
    _edges: Optional[Dict[Tuple[int, int], int]] = dataclasses.field(
        default=None, repr=False, compare=False)

    def edges(self) -> Dict[Tuple[int, int], int]:
        """Undirected {(min, max): weight} dict (dedup keeps max weight)."""
        if self._edges is None:
            self._edges = to_edge_dict(self.network)
        return self._edges

    def edge_index(self) -> Tuple[np.ndarray, np.ndarray]:
        return to_edge_index(self.network)

    def top(self, limit: int) -> List[Tuple[int, int, int]]:
        """The ``limit`` heaviest undirected edges as (a, b, weight),
        heaviest first (ties by term ids)."""
        ranked = sorted(((a, b, w) for (a, b), w in self.edges().items()),
                        key=lambda t: (-t[2], t[0], t[1]))
        return ranked[:limit]

    def nodes(self) -> List[int]:
        return nodes_of(self.network)

    @property
    def num_edges(self) -> int:
        return len(self.edges())
