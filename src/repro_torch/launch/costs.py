"""Per-device cost counter: the counterpart of the JAX package's
``analyze_hlo``, as a ``TorchDispatchMode`` over the ops one device runs.

Run a step under :class:`CostCounter` and it counts, per device per step:

- FLOPs: 2·M·N·K for every ``mm``, ``addmm``, ``bmm`` and ``baddbmm``,
  2 × output elements × (input channels / groups × kernel elements) for a
  convolution, and torch's own ``flop_counter`` formula for any other op it
  knows (attention kernels).
- bytes: each op's tensor inputs plus its outputs.  This is the traffic at
  eager op boundaries: a fused program moves at most this much, so it bounds
  a fused program's HBM traffic from above (views, metadata ops, empty
  allocations and collectives move nothing here).
- collective bytes by kind (JAX's five names), at result shapes, with counts.
- the peak of live local-storage bytes: every storage an op creates is live
  until Python frees its last tensor (``weakref`` on the storage), plus the
  arguments registered with :meth:`CostCounter.track`.  On CUDA each storage
  is rounded up to 512 bytes, as the caching allocator rounds every block.
  Two things the card's ``max_memory_allocated`` holds are not a step's and
  are not counted: the cuBLAS and cuBLASLt workspaces, which the first
  matmul of a process on a stream allocates and keeps (a measurement makes
  them first), and the allocator's slack, a reused block split only when
  more than 1 MiB would remain (on the H100, +1.4 % at PGT-DCRNN batch 32,
  +0.5 % at dcrnn-pems batch 8, 0.0 % at a qwen1.5-4b decode, while the
  bytes the ops requested equal the count; ``PERF.md``).

DTensor ops are not counted at their global shapes: the mode declines them
(``NotImplemented``), DTensor runs its local ops and collectives, and those
are what the mode counts — the per-device program, as XLA's SPMD output is
for the JAX package.  DTensor's sharding propagation runs the op once on
global-shaped fake tensors to learn the output's metadata; ops called from
there are not counted.

Eager execution unrolls every loop, so trip counts come free.  Loops whose
iterations are alike may instead say so with ``repro_torch.loops.trips``:
under a counter made with ``roll=True`` such a loop runs two trips and the
second's costs count for every later trip, as ``analyze_hlo`` rolls a while body up by its trip
count.  The dry-run rolls the microbatch loop and the blockwise-attention
kv loop; an unrolled run of the same step counts the same FLOPs.  A rolled
loop computes two trips, so a rolling counter takes meta arguments only
(:meth:`CostCounter.track` refuses real ones, and a loop rolls only once the
arguments are tracked); the host tensors DTensor makes for its own index
arithmetic are not the step's values and pass.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import loops

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# torch op-name fragments -> the JAX package's collective kinds
_KIND_OF = (("all_gather", "all-gather"), ("allgather", "all-gather"),
            ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
            ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
            ("alltoall", "all-to-all"), ("broadcast", "collective-permute"),
            ("permute", "collective-permute"), ("send", "collective-permute"),
            ("recv", "collective-permute"))

_FREE = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
         "device", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
         "is_same_size", "lift_fresh", "wait_tensor", "_local_scalar_dense",
         "set_", "resize_", "record_stream", "_unsafe_view"}

#: storage bytes of one CUDA caching-allocator block step
CUDA_BLOCK = 512

def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective_kind(name: str) -> str | None:
    if not name.startswith(("_c10d_functional", "c10d", "_dtensor")):
        return None
    return next((kind for frag, kind in _KIND_OF if frag in name), None)


def _in_sharding_prop() -> bool:
    """Whether the current op was called by DTensor's sharding propagation
    (a metadata run on global shapes, not part of the device's program)."""
    f = sys._getframe(2)
    for _ in range(48):
        if f is None:
            return False
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _flops(func, name: str, args, kwargs, out) -> float:
    if name == "mm":
        a, b = args[0], args[1]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name == "addmm":
        a, b = args[1], args[2]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name == "bmm":
        a, b = args[0], args[1]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name == "baddbmm":
        a, b = args[1], args[2]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name in ("convolution", "_convolution"):
        return _conv_flops(args, out)
    from torch.utils.flop_counter import flop_registry

    formula = flop_registry.get(func._overloadpacket)
    return float(formula(*args, **kwargs, out_val=out)) if formula else 0.0


def _conv_flops(args, out) -> float:
    x, w = args[0], args[1]
    transposed = bool(args[6]) if len(args) > 6 else False
    groups = int(args[8]) if len(args) > 8 else 1
    kernel = math.prod(w.shape[2:])
    if transposed:  # weight [C_in, C_out / groups, *k]: every input feeds
        return 2.0 * x.numel() * w.shape[1] * kernel
    return 2.0 * out.numel() * (x.shape[1] // groups) * kernel


@dataclasses.dataclass
class Costs:
    """Per-device costs of one step."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_op: dict = dataclasses.field(default_factory=dict)
    coll_counts: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    argument_bytes: int = 0


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes, collectives and live memory of the ops that
    run while it is active (see the module docstring).

    ``block``: allocation granularity in bytes (``CUDA_BLOCK`` on CUDA,
    1 for a plain sum of storage sizes).  ``roll``: loops marked with
    ``loops.trips`` run two trips and count every trip (meta tensors only).
    """

    def __init__(self, *, block: int = 1, roll: bool = False):
        super().__init__()
        self.block = block
        self.roll = roll
        self.costs = Costs(coll_by_op={k: 0.0 for k in _COLLECTIVES},
                           coll_counts={k: 0 for k in _COLLECTIVES})
        self._live: dict[int, tuple[int, weakref.ref]] = {}
        self._args: set[int] = set()
        self.current = 0

    def __enter__(self):
        if self.roll:
            loops._ROLLING.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        if self.roll:
            loops._ROLLING.remove(self)
        return super().__exit__(*exc)

    # -------------------------------------------------------------- rolls
    def open_trip(self) -> Costs:
        """The costs so far, before one trip of a rolled loop."""
        if not self._args:
            raise RuntimeError("a rolled loop needs the step's arguments registered "
                               "with CostCounter.track, which checks that they are meta")
        c = self.costs
        return dataclasses.replace(c, coll_by_op=dict(c.coll_by_op),
                                   coll_counts=dict(c.coll_counts))

    def close_trip(self, before: Costs, n: int) -> None:
        """Count the trip since ``before`` ``n`` times (live memory is not
        scaled: the trip holds its predecessor's carry, as every later one
        does, so it peaks as they do)."""
        c = self.costs
        for f in ("flops", "bytes", "coll_bytes"):
            setattr(c, f, getattr(before, f) + n * (getattr(c, f) - getattr(before, f)))
        for k in c.coll_by_op:
            c.coll_by_op[k] = before.coll_by_op[k] + n * (c.coll_by_op[k]
                                                          - before.coll_by_op[k])
            c.coll_counts[k] = before.coll_counts[k] + n * (c.coll_counts[k]
                                                            - before.coll_counts[k])

    # ------------------------------------------------------------- memory
    def _storage_bytes(self, st) -> int:
        n = st.nbytes()
        return -(-n // self.block) * self.block if n else 0

    def _register(self, t: torch.Tensor) -> int | None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return None
        key = st._cdata
        if key in self._live:
            return key
        n = self._storage_bytes(st)

        def free(_ref, key=key, n=n, live=self._live, counter=weakref.ref(self)):
            if live.pop(key, None) is not None and counter() is not None:
                counter().current -= n

        self._live[key] = (n, weakref.ref(st, free))
        self.current += n
        self.costs.peak_bytes = max(self.costs.peak_bytes, self.current)
        return key

    def track(self, tree) -> None:
        """Register tensors that exist before the step (its arguments: the
        local shards of DTensors, or plain tensors)."""
        from torch.distributed.tensor import DTensor

        for t in _tensors(tree):
            if isinstance(t, DTensor):
                t = t._local_tensor
            if self.roll and not t.is_meta:
                raise ValueError("a rolling CostCounter counts meta shards only: a "
                                 "rolled loop computes two trips, so real arguments "
                                 "would give wrong results")
            key = self._register(t)
            if key is not None and key not in self._args:
                self._args.add(key)
                self.costs.argument_bytes += self._live[key][0]

    def live_keys(self, tree) -> dict[int, int]:
        """``{storage key: bytes}`` of the local storages under ``tree``."""
        from torch.distributed.tensor import DTensor

        out = {}
        for t in _tensors(tree):
            if isinstance(t, DTensor):
                t = t._local_tensor
            st = t.untyped_storage()
            out[st._cdata] = self._storage_bytes(st)
        return out

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_sharding_prop():
            return out
        c = self.costs
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        outs = _tensors(out)
        kind = _collective_kind(f"{ns}.{name}")
        if kind is not None:
            b = float(sum(_nbytes(t) for t in outs))
            c.coll_bytes += b
            c.coll_by_op[kind] += b
            c.coll_counts[kind] += 1
        elif name not in _FREE and not func.is_view:
            c.flops += _flops(func, name, args, kwargs, out)
            c.bytes += float(sum(_nbytes(t) for t in _tensors(args))
                             + sum(_nbytes(t) for t in outs))
        for t in outs:
            self._register(t)
        return out


def count(fn, *args, block: int = 1, roll: bool = False,
          **kwargs) -> tuple[object, Costs]:
    """Run ``fn(*args, **kwargs)`` under a fresh :class:`CostCounter` with
    ``args`` registered as arguments; returns ``(result, costs)``."""
    counter = CostCounter(block=block, roll=roll)
    counter.track(args)
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.costs
