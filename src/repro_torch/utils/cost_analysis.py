"""Op-level cost of one call of a function — the port's counterpart of the
JAX package's ``repro.utils.hlo_analysis``.

The JAX package parses a compiled module's HLO text and scales each
while-loop body by its trip count, because XLA's own cost analysis counts
a loop body once. Eager PyTorch has no module to parse and no loop body
to scale: it dispatches every operation of every layer, microbatch and
scan step, so the stream of operations *is* the trip-scaled program.
``analyze`` runs the function under a ``TorchDispatchMode`` and counts,
for every operation it dispatches:

  * **flops**: the FLOPs of each operation in
    ``torch.utils.flop_counter``'s registry — the matmuls (``mm``,
    ``addmm``, ``bmm``, ``baddbmm``; an ``einsum`` or ``matmul`` reaches
    them), convolutions and fused attention — 2 x (output elements) x
    (contracted length), the reference's ``2 * prod(result) *
    prod(contracting)``; elementwise work is not counted, as there;
  * **bytes**: the operand bytes read plus the result bytes written by
    every operation that is not a view or metadata operation. Each eager
    operation is a kernel, so this is the HBM traffic with no fusion at
    all: an upper bound, as the reference's count at the CPU backend's
    fusion boundaries is;
  * **coll**: the collective bytes by kind, from the port's
    ``CollectiveLedger`` (``core.engine.stats``) given as ``ledger`` and
    threaded through ``sharding.specs.make_constrain(..., ledger=)``:
    the records the call adds, under the reference's kind names
    ("all-gather", "all-reduce", "reduce-scatter", "all-to-all"; the
    ledger's "broadcast", which the JAX package never emits, keeps its
    own). The bytes are the ledger's: the operand for a reduction, an
    all-to-all and a reduce-scatter, the gathered output for an
    all-gather (the reference counts an all-gather's operand, one shard).

It also follows the storages the call allocates and frees (``peak``: the
most bytes they held at once), which the dry run reads as its memory
analysis. An operator that holds a workspace only while it runs (the
scan kernels' backward) registers its size in ``WORKSPACE_BYTES``; the
peak counts it on top of what is live once the operator's outputs are.

It runs on any device, ``meta`` included, where nothing is computed or
allocated: that is how ``launch.dryrun`` costs a production step on a
machine with no card. The JAX module's ``shape_bytes`` / ``shape_dims``
parse HLO type strings and have no PyTorch counterpart.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# The ledger's op names -> the reference's collective kinds.
LEDGER_KINDS = {"psum": "all-reduce", "pmax": "all-reduce",
                "all_gather": "all-gather",
                "reduce_scatter": "reduce-scatter",
                "all_to_all": "all-to-all", "broadcast": "broadcast"}

_aten = torch.ops.aten

# Overload packet -> fn(*args) -> the bytes of the workspace the operator
# allocates and frees inside its one call.
WORKSPACE_BYTES: Dict[object, Callable[..., int]] = {}

# Operations that allocate without writing, alias their input without
# saying so (``_unsafe_view``: a reshape's view of the copy it made), or
# only read metadata.
_NO_TRAFFIC = {
    _aten._unsafe_view.default, _aten.empty.memory_format,
    _aten.empty_like.default, _aten.empty_strided.default,
    _aten.new_empty.default, _aten.new_empty_strided.default,
    _aten.lift_fresh.default,
    _aten._local_scalar_dense.default, _aten.sym_size.int,
    _aten.sym_numel.default, _aten.sym_stride.int,
    _aten.sym_storage_offset.default, _aten.is_same_size.default,
}


def _bincount_meta(x, weights=None, minlength=0):
    """``bincount``'s result has a data-dependent length, max(x) + 1 or
    ``minlength``, so meta tensors cannot give it. Wherever every value
    lies below ``minlength`` — the MoE router's expert ids against the
    expert count, the one use on the LM path — it is (minlength,)."""
    dtype = torch.int64 if weights is None else weights.dtype
    return torch.empty((minlength,), dtype=dtype, device=x.device)


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = field(default_factory=dict)

    def add(self, other: "Cost", scale: float = 1.0):
        """``other`` x ``scale`` added in place (the reference's API)."""
        self.flops += other.flops * scale
        self.bytes += other.bytes * scale
        for k, v in other.coll.items():
            self.coll[k] = self.coll.get(k, 0.0) + v * scale

    @property
    def collective_bytes(self) -> float:
        return sum(self.coll.values())


def _tensors(tree) -> list:
    """The tensors of nested lists, tuples and dicts (an operation's
    arguments and results). Iterative: a recursive closure would hold
    the tensors in a reference cycle until the collector runs, and the
    storages they keep would count as live."""
    out: list = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree, seen: Optional[set] = None) -> int:
    """The bytes of the distinct storages under ``tree`` (tensors in
    nested dicts, lists and tuples): what holding ``tree`` costs a
    device. ``seen`` (storage keys) skips storages counted elsewhere and
    is updated."""
    seen = set() if seen is None else seen
    total = 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


class OpBudgetExceeded(RuntimeError):
    """The call dispatched more operations than its budget."""


class _Counter(TorchDispatchMode):
    def __init__(self, flop_registry, max_ops: Optional[int] = None):
        super().__init__()
        self.flop_registry = flop_registry
        self.max_ops = max_ops
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.live = 0
        self.peak = 0
        # storage key -> (bytes, a weak reference that frees it here)
        self._alive: Dict[int, tuple] = {}

    def _track(self, out, inputs: set) -> None:
        """Count the storages ``out`` holds that the operation's inputs
        do not (an in-place or aliasing result allocates nothing)."""
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in inputs or key in self._alive:
                continue
            n = st.nbytes()
            self._alive[key] = (n, weakref.ref(st, self._freed(key)))
            self.live += n
        self.peak = max(self.peak, self.live)

    def _freed(self, key: int):
        def cb(_ref):
            entry = self._alive.pop(key, None)
            if entry is not None:
                self.live -= entry[0]
        return cb

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _aten.bincount.default and any(
                t.device.type == "meta" for t in _tensors(args)):
            out = _bincount_meta(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        self.ops += 1
        if self.max_ops is not None and self.ops > self.max_ops:
            raise OpBudgetExceeded(f"more than {self.max_ops} operations")
        packet = func._overloadpacket
        if packet in self.flop_registry:
            self.flops += float(self.flop_registry[packet](
                *args, **kwargs, out_val=out))
        if func.is_view:
            return out
        ins = _tensors((args, kwargs))
        if func not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in ins)
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        self._track(out, {t.untyped_storage()._cdata for t in ins})
        if packet in WORKSPACE_BYTES:
            self.peak = max(self.peak, self.live + WORKSPACE_BYTES[packet](
                *args, **kwargs))
        return out


@dataclass
class Analysis:
    """What ``analyze`` saw beside the ``Cost``: the operations it
    counted, and the most bytes the storages the call allocated held at
    once (``peak``)."""
    ops: int
    peak: int


def analyze(fn, *args, ledger=None, **kw) -> Tuple[object, Cost]:
    """``fn(*args, **kw)`` under the counter: (its result, its ``Cost``).
    ``ledger``: the ``CollectiveLedger`` that ``fn``'s collectives record
    into (it must be recording: a phase set); ``Cost.coll`` holds the
    records the call added."""
    out, cost, _ = analyze_with_memory(fn, *args, ledger=ledger, **kw)
    return out, cost


def analyze_with_memory(fn, *args, ledger=None, max_ops=None, **kw):
    """``analyze``, with the call's ``Analysis``: (result, ``Cost``,
    ``Analysis``). ``max_ops``: raise ``OpBudgetExceeded`` past that many
    operations."""
    from torch.utils.flop_counter import flop_registry
    n0 = len(ledger.records) if ledger is not None else 0
    counter = _Counter(flop_registry, max_ops)
    with counter:
        out = fn(*args, **kw)
    coll: Dict[str, float] = {}
    if ledger is not None:
        for r in ledger.records[n0:]:
            kind = LEDGER_KINDS.get(r.op, r.op)
            coll[kind] = coll.get(kind, 0.0) + r.nbytes
    cost = Cost(flops=counter.flops, bytes=counter.bytes, coll=coll)
    return out, cost, Analysis(ops=counter.ops, peak=counter.peak)
