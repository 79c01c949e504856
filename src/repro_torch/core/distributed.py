"""Dataset placements of distributed-index-batching (paper §4.2, §5.4).

Three placements, matching the paper's three distributed designs, each
trained as data parallel over ``torch.distributed`` (one process a rank;
gradients all-reduced before AdamW):

- ``REPLICATED``  — distributed-index-batching (§4.2): every rank holds the
  whole standardized series on its device.  Window gathers are local, global
  shuffling costs no communication; the step's only collective is the
  gradient all-reduce.
- ``PARTITIONED`` — generalized-distributed-index-batching (§5.4): the series
  is split along TIME (``local_time_range``) and each rank keeps only its
  shard, plus, with ``halo``, the next shard's first ``span - 1`` rows, so
  that a window starting near the shard's end is still local.  Samplers draw
  each rank's windows from its own shard (local batch shuffling), so train
  gathers never leave the resident rows.
- ``ONDEMAND``    — the paper's DDP baseline: time-sharded like
  PARTITIONED, but windows drawn *globally*, so the rows of every batch are
  exchanged between ranks each step (``pipeline/gathers.exchange_windows``).

:func:`resident_rows` is the one definition of which ``[lo, hi)`` time rows a
rank keeps on its device; :func:`local_time_range` the rows it OWNS (the
shards partition the series, so the exchange writes each row exactly once).

:class:`MeshSpec`, :class:`PartitionSpec` and :class:`NamedSharding` are the
port's mesh and sharding vocabulary: pure data that the launcher's rules
(``launch/mesh.py``, ``launch/sharding.py``) build and that a model reads
through :func:`constrain` (DTensor programs only; a plain tensor passes
through).  :func:`data_axes`, :func:`series_sharding` and
:func:`batch_sharding` give the JAX package's shardings on a mesh
(``.placements(device_mesh)`` turns one into DTensor placements); the
dry-run's cells read them.  The training path itself holds plain tensors: a
rank keeps its resident rows, and the process group (:func:`process_info`)
takes the mesh's place, so :func:`dp_size` reads the group's size instead
of a mesh's data axes.
"""
from __future__ import annotations

import dataclasses
import datetime
import enum
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.windows import WindowSpec


# ------------------------------------------------------ meshes and shardings
@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named mesh axes and their sizes, major to minor."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{self.axis_names} vs {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        """``{axis: size}`` in axis order, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def label(self) -> str:
        """``"16x16"``: the dry-run records' ``mesh`` field."""
        return "x".join(str(s) for s in self.sizes)


def as_spec(mesh) -> MeshSpec:
    """A :class:`MeshSpec` for a spec or a named ``DeviceMesh``."""
    if isinstance(mesh, MeshSpec):
        return mesh
    return MeshSpec(tuple(mesh.mesh_dim_names), tuple(int(s) for s in mesh.shape))


class PartitionSpec(tuple):
    """Per-dim mesh axes of a tensor: ``P(None, "model")``, ``P(("pod",
    "data"))``; trailing dims not named are replicated.  A group of one
    name is that name and an empty group is None, as JAX canonicalises
    them."""

    def __new__(cls, *entries):
        def canon(e):
            if isinstance(e, (tuple, list)):
                return (e[0] if len(e) == 1 else None) if len(e) < 2 else tuple(e)
            return e
        return super().__new__(cls, tuple(canon(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the JAX class of the same name)."""

    mesh: MeshSpec
    spec: PartitionSpec

    def placements(self, device_mesh) -> tuple:
        return to_placements(self.spec, device_mesh)


def to_placements(spec, mesh) -> tuple:
    """DTensor placements, one per mesh dim, for ``spec`` on ``mesh``.

    A tensor dim named by several axes (``("pod", "data")``) is ``Shard(d)``
    on each of those mesh dims; DTensor splits it major-to-minor in mesh-dim
    order, which is JAX's order when the names come in the mesh's own order
    (they always do here).  Any other order raises.
    """
    from torch.distributed.tensor import Replicate, Shard

    names = as_spec(mesh).axis_names
    sizes = as_spec(mesh).sizes
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} are not in mesh order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]!r} used twice")
            if sizes[i] > 1:  # one slot holds the whole dim: replicated
                out[i] = Shard(d)
    return tuple(out)


def constrain(x, hint: NamedSharding | None):
    """Redistribute a DTensor to ``hint``'s placements (the JAX package's
    ``with_sharding_constraint``); no hint or a plain tensor: ``x``."""
    from torch.distributed.tensor import DTensor

    if hint is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, hint.placements(x.device_mesh))


def minor_split(t):
    """A DTensor with its dim 0 split over the minor one of the mesh axes
    that split it (``("pod", "data")`` -> ``"data"``): DTensor's row
    gathers and reshapes take one mesh axis a dim.  Anything else: ``t``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(t, DTensor):
        return t
    split = [i for i, p in enumerate(t.placements) if p == Shard(0)]
    if len(split) < 2:
        return t
    return t.redistribute(t.device_mesh, [Replicate() if i in split[:-1] else p
                                          for i, p in enumerate(t.placements)])


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor.  Reads ``DTensor`` only once its module
    is loaded (no DTensor can exist before), so a plain path pays one dict
    lookup and never imports it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def shard_local(t: torch.Tensor, device_mesh, placements):
    """``t``, whole on every rank, as a DTensor with ``placements``: each
    rank keeps its own chunk and nothing is communicated (torch's
    ``distribute_tensor`` scatters from one rank; here every rank holds the
    same tensor, drawn from one seed or uploaded from the same host row).
    A chunk is copied, so a rank holds only its shard; an unsplit tensor
    is wrapped as it is."""
    from torch.distributed.tensor import DTensor, Shard

    local = t
    coord = device_mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = device_mesh.size(i)
            if local.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not split "
                                 f"into {n} shards")
            local = local.chunk(n, dim=p.dim)[coord[i]]
    if local is not t:
        local = local.clone()
    return DTensor.from_local(local, device_mesh, tuple(placements), run_check=False,
                              shape=t.shape, stride=t.stride())


def as_dtensor(t, device_mesh):
    """A DTensor as it is; a plain tensor (the same on every rank) as a
    replicated one, without a copy."""
    from torch.distributed.tensor import DTensor, Replicate

    if is_dtensor(t):
        return t
    return DTensor.from_local(t, device_mesh, [Replicate()] * device_mesh.ndim,
                              run_check=False)


def wrap_local(local: torch.Tensor, device_mesh, placements, shape):
    """This rank's ``local`` result as the DTensor of global ``shape`` laid
    out by ``placements`` (shards may be uneven, so the shape is given),
    contiguous, as the global stride it is given says."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local.contiguous(), device_mesh, tuple(placements),
                              run_check=False, shape=shape, stride=stride)


def local_offset(t, dim: int) -> int:
    """Global index of this rank's first element along ``dim`` of the
    DTensor ``t`` (0 where ``dim`` is not split)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    _, offset = compute_local_shape_and_global_offset(t.shape, t.device_mesh,
                                                      t.placements)
    return int(offset[dim % t.dim()])


def model_dims(device_mesh) -> list[int]:
    """Indices of the mesh dims named ``"model"`` that hold more than one
    slot (the tensor-parallel dims a local form may split heads over)."""
    names = device_mesh.mesh_dim_names or ()
    return [i for i, n in enumerate(names) if n == "model" and device_mesh.size(i) > 1]


class Placement(enum.Enum):
    REPLICATED = "replicated"
    PARTITIONED = "partitioned"
    ONDEMAND = "ondemand"


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that carry data parallelism (everything named pod/data)."""
    return tuple(a for a in as_spec(mesh).axis_names if a in ("pod", "data"))


def series_sharding(mesh, placement: Placement) -> NamedSharding:
    """Sharding of the resident series [T, N, F] (or token stream [T])."""
    if placement is Placement.REPLICATED:
        return NamedSharding(as_spec(mesh), P())
    # Time axis sharded across the data-parallel axes; nodes/features replicated.
    return NamedSharding(as_spec(mesh), P(data_axes(mesh)))


def batch_sharding(mesh, *, pure_dp: bool = False) -> NamedSharding:
    """Sharding of per-step batched tensors (leading batch dim).

    ``pure_dp=True`` reproduces the paper's scheme on the fixed production
    mesh: batch sharded over EVERY axis (each device is one DDP worker,
    params fully replicated).  Otherwise batch shards over the data axes only
    and the model axis is free for TP.
    """
    axes = as_spec(mesh).axis_names if pure_dp else data_axes(mesh)
    return NamedSharding(as_spec(mesh), P(tuple(axes)))


def process_info() -> tuple[int, int]:
    """``(rank, size)`` of this process in the default process group, or
    ``(0, 1)`` when no group is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def dp_size() -> int:
    """Data-parallel size: the process group's world size, or 1 without one."""
    return process_info()[1]


def local_time_range(entries: int, rank: int, world: int) -> tuple[int, int]:
    """[start, end) of the series shard owned by ``rank`` under PARTITIONED."""
    per = entries // world
    rem = entries % world
    start = rank * per + min(rank, rem)
    return start, start + per + (1 if rank < rem else 0)


def local_window_ids(
    entries: int, spec: WindowSpec, rank: int, world: int, *, halo: bool = True
) -> np.ndarray:
    """Window ids fully contained in rank's shard (PARTITIONED placement).

    ``halo=True`` lets a window start anywhere in the local range even if it
    spills ``span−1`` steps into the next shard — the rank then keeps those
    rows too (:func:`resident_rows`).  ``halo=False`` keeps windows strictly
    interior, with slightly fewer samples.
    """
    start, end = local_time_range(entries, rank, world)
    last_valid = entries - spec.span  # last legal window start globally
    hi = min(end - (0 if halo else spec.span - 1), last_valid + 1)
    lo = min(start, last_valid + 1)
    return np.arange(lo, max(hi, lo), dtype=np.int32)


def resident_rows(
    placement: Placement,
    entries: int,
    spec: WindowSpec,
    rank: int,
    world: int,
    *,
    halo: bool = True,
    feed_ids: np.ndarray | None = None,
) -> tuple[int, int]:
    """``[lo, hi)``: the time rows ``rank`` keeps on its device.

    - ``REPLICATED``: every row.
    - ``ONDEMAND``: its shard, ``local_time_range``; windows reach the other
      rows through the exchange.
    - ``PARTITIONED``: its shard, with ``halo`` also the next shard's first
      ``span - 1`` rows (the shard-aligned sampler's halo windows read
      them), widened to cover every window its feed can draw: ``feed_ids``,
      the START STEPS of the rank's whole feed domain (None takes
      ``local_window_ids(..., halo)``).  With the shard-aligned sampler the
      feed lies inside the shard and its halo; with the count-split
      fallback the partition sets the extent.
    """
    if placement is Placement.REPLICATED:
        return 0, entries
    lo, hi = local_time_range(entries, rank, world)
    if placement is Placement.ONDEMAND:
        return lo, hi
    ids = (local_window_ids(entries, spec, rank, world, halo=halo)
           if feed_ids is None else np.asarray(feed_ids))
    if halo:
        hi = min(hi + spec.span - 1, entries)
    if len(ids):
        lo = min(lo, int(ids.min()))
        hi = max(hi, int(ids.max()) + spec.span)
    return lo, hi


def choose_backend(device: torch.device, local_world: int) -> str:
    """The collective backend for ``local_world`` processes of one host on
    ``device``: ``nccl`` when each has a card of its own, ``gloo`` when they
    share a card (NCCL refuses two ranks on one device) or run on the CPU.
    The choice follows the topology alone and is never revised after a
    failure."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_from_env(device: str | torch.device, *,
                  timeout: datetime.timedelta | None = None) -> tuple[torch.device, str]:
    """Join the process group that ``torch.distributed.run`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).

    Returns ``(device, backend)``: on ``cuda``, local rank ``i`` takes card
    ``i`` (``nccl``), or, when the host's processes outnumber its cards,
    card ``i % cards`` (``gloo``).  A missing variable raises ``KeyError``.
    ``timeout``: how long a collective waits for its peers (None: torch's
    default, 30 minutes).
    """
    dev = torch.device(device)
    local_rank = int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    backend = choose_backend(dev, local_world)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            **({"timeout": timeout} if timeout is not None else {}),
                            **({"device_id": dev} if backend == "nccl" else {}))
    return dev, backend
