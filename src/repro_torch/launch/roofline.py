"""Roofline terms of a dry-run cell, on the H100 constants of
:mod:`repro_torch.launch.mesh`.

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs            / (chips * PEAK_FLOPS_BF16)
                 + each kernel's operations / (chips * its unit's rate)
    memory     = bytes accessed   / (chips * HBM_BW)
    collective = collective bytes / (chips * ICI_BW)

The HLO collective parser (``parse_collectives``) and ``Roofline`` are
copies of ``repro.launch.roofline``'s: host text parsing, which reads the
reference's HLO records too.  The reference reads FLOPs and bytes from
``compiled.cost_analysis()``; eager PyTorch has no compiled artifact, so
:class:`Counter` counts the program as it runs, on the card or on
``meta`` placeholders:

* FLOPs: the formulas ``torch.utils.flop_counter.FlopCounterMode``
  counts with, read from its registry by the counter's own dispatch mode
  (the matmul class, 2·m·n·k a product; ``torch._int_mm`` is registered
  here with the same formula);
* kernel operations, apart from the FLOPs: those the hand-written kernels
  report for themselves, each on its own unit (:data:`KERNEL_RATES`:
  AND+popcount words for kernels 1 and 2, int8 tensor-core operations for
  3, fp32 for 4, bf16 for 5), so the compute term holds each at its
  unit's rate and not at the bf16 tensor cores';
* bytes accessed: each ATen op's operand plus result bytes (XLA's
  definition, applied to each eager op, which is what eager runs), plus
  the kernels' own bytes.  Views, ``detach`` and allocation without a
  write move nothing; an argument an op only writes (``copy_``'s
  destination, ``out=``) is counted once, as its result;
* the peak of live tensor bytes (the planned memory of a ``meta`` run).

The kernels are called through ``ctypes``, so dispatch never sees them:
each wrapper in :mod:`repro_torch.kernels.ops` charges its launch to the
active counters.  ``coll_bytes_per_dev`` is 0 on one device; on several
it is ``None`` ("no partitioner"): the port's cells run one program on
one device, and nothing here guesses what a partitioner would move.
"""
from __future__ import annotations

import dataclasses
import re
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16, \
    PEAK_FLOPS_FP32, PEAK_OPS_INT8, PEAK_POPC

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

#: operations a second of each hand-written kernel's unit (its
#: ``kernels.ops.kernel_cost`` operations)
KERNEL_RATES = {"postings_counts": PEAK_POPC, "level_step": PEAK_POPC,
                "cooccur_counts": PEAK_OPS_INT8,
                "dot_interaction": PEAK_FLOPS_FP32,
                "flash_decode": PEAK_FLOPS_BF16}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLLECTIVE_RE = re.compile(
    r"=\s*(?:\([^)]*\)|[\w\[\],{}: ]+?)?\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_GROUPS_V2_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(shape_str: str) -> int:
    m = _SHAPE_RE.match(shape_str.strip())
    if not m:
        return 0
    dt, dims = m.groups()
    b = _DTYPE_BYTES.get(dt)
    if b is None:
        return 0
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * b


def _result_bytes(line: str) -> int:
    """Bytes of the instruction's result (handles tuple results)."""
    rhs = line.split("=", 1)[1]
    head = rhs.strip()
    if head.startswith("("):
        depth, end = 0, 0
        for i, ch in enumerate(head):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    end = i
                    break
        inner = head[1:end]
        return sum(_shape_bytes(s) for s in inner.split(",") if "[" in s)
    return _shape_bytes(head)


def _group_size(line: str) -> int:
    m = _GROUPS_V2_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_RE.search(line)
    if m:
        return len([x for x in m.group(1).split(",") if x.strip() != ""])
    return 2  # conservative default


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, float]   # ICI bytes per device
    total_bytes: float

    def summary(self) -> str:
        parts = [f"{k}x{v} ({self.bytes_by_kind[k]/1e6:.1f} MB)"
                 for k, v in sorted(self.counts.items())]
        return ", ".join(parts) if parts else "none"


def parse_collectives(hlo_text: str) -> CollectiveStats:
    counts: Dict[str, int] = {}
    by_kind: Dict[str, float] = {}
    for line in hlo_text.splitlines():
        m = _COLLECTIVE_RE.search(line)
        if not m:
            continue
        kind = m.group(1)
        n = _group_size(line)
        if n <= 1:
            continue
        rb = _result_bytes(line)
        if kind == "all-reduce":
            link = 2.0 * rb * (n - 1) / n
        elif kind == "all-gather":
            link = rb * (n - 1) / n
        elif kind == "reduce-scatter":
            link = rb * (n - 1)
        elif kind == "all-to-all":
            link = rb * (n - 1) / n
        else:  # collective-permute
            link = rb
        counts[kind] = counts.get(kind, 0) + 1
        by_kind[kind] = by_kind.get(kind, 0.0) + link
    return CollectiveStats(counts, by_kind, sum(by_kind.values()))


@dataclasses.dataclass
class Roofline:
    """The reference's, with ``coll_bytes_per_dev`` None where no
    partitioner measured it (then ``t_collective`` is None and the other
    two terms decide ``bottleneck`` and ``roofline_fraction``), and the
    hand-written kernels' operations beside the FLOPs: their seconds at
    their units' rates join the compute term, and their count the FLOPs
    in ``useful_ratio`` (the co-occurrence cells' MODEL_FLOPS count
    popcount words)."""

    flops_per_dev: float         # FLOPs, one device's share
    hbm_bytes_per_dev: float     # bytes accessed, one device's share
    coll_bytes_per_dev: Optional[float]  # ICI bytes one device moves
    n_chips: int
    model_flops: float           # global useful FLOPs (6ND style)
    model_bytes: float = 0.0     # global mandatory bytes (memory-bound work)
    collectives: Optional[CollectiveStats] = None
    kernel_ops_per_dev: float = 0.0  # the kernels' operations, one share
    kernel_s_per_dev: float = 0.0    # ... at their units' rates, seconds

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / PEAK_FLOPS_BF16 + self.kernel_s_per_dev

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_dev / HBM_BW

    @property
    def t_collective(self) -> Optional[float]:
        if self.coll_bytes_per_dev is None:
            return None
        return self.coll_bytes_per_dev / ICI_BW

    def _terms(self) -> Dict[str, float]:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return {k: v for k, v in ts.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        ts = self._terms()
        return max(ts, key=ts.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / global FLOPs (catches remat/redundancy waste)."""
        tot = (self.flops_per_dev + self.kernel_ops_per_dev) * self.n_chips
        return self.model_flops / tot if tot else 0.0

    @property
    def t_model(self) -> float:
        """The ideal step time: useful work at the relevant peak."""
        return max(self.model_flops / (self.n_chips * PEAK_FLOPS_BF16),
                   self.model_bytes / (self.n_chips * HBM_BW))

    @property
    def roofline_fraction(self) -> float:
        """t_model over the dominant counted term: the headline score."""
        t_dom = max(self._terms().values())
        return self.t_model / t_dom if t_dom > 0 else 0.0

    def to_dict(self) -> Dict:
        out = {
            "flops_per_dev": self.flops_per_dev,
            "hbm_bytes_per_dev": self.hbm_bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "n_chips": self.n_chips,
            "kernel_ops_per_dev": self.kernel_ops_per_dev,
            "t_kernel_ops_s": self.kernel_s_per_dev,
            "model_flops": self.model_flops,
            "model_bytes": self.model_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collective_counts": self.collectives.counts if self.collectives else {},
            "collective_bytes_by_kind":
                self.collectives.bytes_by_kind if self.collectives else {},
        }
        if self.coll_bytes_per_dev is None:
            out["collective_note"] = "no partitioner"
        return out


# ---------------------------------------------------------------------------
# The counter (in place of ``from_compiled``)
# ---------------------------------------------------------------------------


_INT_MM_REGISTERED = False


def _register_int_mm() -> None:
    """``torch._int_mm`` under FlopCounterMode: 2·m·n·k, as ``mm``."""
    global _INT_MM_REGISTERED
    if _INT_MM_REGISTERED:
        return
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.aten._int_mm)
    def _int_mm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs):
        m, k = a_shape
        return 2 * m * k * b_shape[1]

    _INT_MM_REGISTERED = True


# allocation without a write, and aliasing that moves nothing
_NO_TRAFFIC = {"aten::empty", "aten::empty_strided", "aten::empty_like",
               "aten::new_empty", "aten::new_empty_strided", "aten::detach",
               "aten::_unsafe_view", "aten::lift_fresh", "aten::alias",
               "aten::set_", "aten::resize_"}
# in-place ops that write ``self`` without reading it
_WRITE_ONLY_SELF = {"aten::copy_", "aten::fill_", "aten::zero_",
                    "aten::normal_", "aten::uniform_", "aten::random_",
                    "aten::bernoulli_", "aten::exponential_"}


def _tensor_bytes(t: torch.Tensor) -> int:
    """The bytes a strided tensor spans: its elements, or fewer where a
    stride is 0 (an expanded operand reads its source once)."""
    if t.numel() == 0:
        return 0
    if t.layout != torch.strided:
        return t.numel() * t.element_size()
    span = 1 + sum((n - 1) * abs(s) for n, s in zip(t.shape, t.stride()))
    return min(t.numel(), span) * t.element_size()


def _tensors(x) -> list:
    """The tensors of an op's arguments or results (nested lists and
    tuples of them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


class _OpInfo:
    """What the counter needs of one ATen overload, worked out once."""

    def __init__(self, func):
        from torch.utils.flop_counter import flop_registry
        name = func._schema.name
        self.moves = name not in _NO_TRAFFIC and not func.is_view
        self.write_only_self = name in _WRITE_ONLY_SELF
        self.out_args = {a.name for a in func._schema.arguments if a.is_out}
        self.flop_fn = flop_registry.get(func._overloadpacket)


class _CountMode(TorchDispatchMode):
    def __init__(self, counter: "Counter"):
        super().__init__()
        self.counter = counter
        self.info: Dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        c = self.counter
        c.last_op = func
        out = func(*args, **kwargs)
        info = self.info.get(func)
        if info is None:
            info = self.info[func] = _OpInfo(func)
        outs = _tensors(out)
        if info.flop_fn is not None:
            c.matmul_flops += info.flop_fn(*args, **kwargs, out_val=out)
        if info.moves and outs:
            operands = args[1:] if info.write_only_self else args
            ins = _tensors(operands) + _tensors(
                [v for k, v in kwargs.items() if k not in info.out_args])
            c.bytes += sum(_tensor_bytes(t) for t in ins + outs)
        c.track(outs)
        return out


class Counter:
    """Counts the work of the enclosed region (see the module docstring):
    ``flops``, ``bytes``, ``kernels`` (each hand-written kernel's launches,
    operations and bytes; ``kernel_ops`` and ``kernel_seconds`` sum them)
    and ``peak_bytes``, the most live tensor bytes
    at once, counting from the tensors given to :meth:`track` and every
    tensor the region makes.

        with Counter() as c:
            c.track(args)
            fn(*args)
        c.flops, c.bytes, c.peak_bytes
    """

    def __init__(self):
        self.bytes = 0
        self.matmul_flops = 0
        self.kernel_ops = 0
        self.last_op = None
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.live = 0
        self.peak_bytes = 0
        self._seen = weakref.WeakSet()
        self._mode = None

    def __enter__(self) -> "Counter":
        from repro_torch.kernels import ops
        _register_int_mm()
        self._mode = _CountMode(self)
        self._mode.__enter__()
        ops.add_cost_sink(self)
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.kernels import ops
        ops.remove_cost_sink(self)
        self._mode.__exit__(*exc)

    @property
    def flops(self) -> int:
        """The FLOPs dispatch sees (the kernels' operations are apart)."""
        return int(self.matmul_flops)

    @property
    def kernel_seconds(self) -> float:
        """The kernels' operations, each at its unit's rate."""
        return sum(k["ops"] / KERNEL_RATES[n]
                   for n, k in self.kernels.items())

    def charge(self, name: str, n_ops: int, n_bytes: int) -> None:
        """One launch of kernel ``name``: its operations and bytes."""
        k = self.kernels.setdefault(name, {"launches": 0, "ops": 0,
                                           "bytes": 0})
        k["launches"] += 1
        k["ops"] += n_ops
        k["bytes"] += n_bytes
        self.kernel_ops += n_ops
        self.bytes += n_bytes

    def _free(self, n: int) -> None:
        self.live -= n

    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors (a tensor, a module's
        parameters, nested dicts, lists and tuples of them) as live until
        they die."""
        if isinstance(tree, torch.nn.Module):
            tree = list(tree.parameters()) + list(tree.buffers())
        if isinstance(tree, dict):
            tree = list(tree.values())
        if isinstance(tree, (list, tuple)):
            for v in tree:
                self.track(v)
            return
        if isinstance(tree, torch.Tensor):
            st = tree.untyped_storage()
            if st in self._seen:
                return
            self._seen.add(st)
            n = st.nbytes()
            self.live += n
            self.peak_bytes = max(self.peak_bytes, self.live)
            weakref.finalize(st, self._free, n)

    def to_dict(self) -> Dict:
        return {"flops": self.flops, "kernel_ops": self.kernel_ops,
                "bytes": self.bytes, "peak_bytes": self.peak_bytes,
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


def from_counts(counter: Counter, n_chips: int, model_flops: float,
                model_bytes: float = 0.0) -> Roofline:
    """A :class:`Roofline` from a counted run of the whole program: each
    device's share is the global count over ``n_chips`` (no partitioner
    splits the program), and the collective term is 0 on one device and
    None (not measured) on several."""
    return Roofline(counter.flops / n_chips, counter.bytes / n_chips,
                    0.0 if n_chips == 1 else None, n_chips, model_flops,
                    model_bytes,
                    kernel_ops_per_dev=counter.kernel_ops / n_chips,
                    kernel_s_per_dev=counter.kernel_seconds / n_chips)
