"""Production mesh definitions.

A mesh is a :class:`MeshSpec` (``core/distributed.py``, re-exported here):
the axis names and their sizes, nothing else.
The sharding rules (``launch/sharding.py``) and the cell builders
(``launch/specs.py``) read only that, so they are pure functions that run
with no process group, as the JAX package's run on a tiled mesh.
:func:`device_mesh` realises a spec as a ``torch.distributed`` ``DeviceMesh``
once a process group exists, fake (the dry-run) or real.

Single pod = 16×16 = 256 devices, axes (data, model); multi-pod adds a
leading "pod" axis (2×16×16 = 512).  On H100s that is 32 or 64 nodes of 8
GPUs: each 16-wide axis spans two NVLink nodes, so both production axes
cross the inter-node network.  Shardings keep "pod" pure data parallel: the
only collective that crosses it is the gradient all-reduce.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.distributed import MeshSpec, as_spec
from repro_torch.device import resolve_device


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_host_mesh(*, model: int | None = None, devices: int = 1) -> MeshSpec:
    """Small ``(data, model)`` mesh over ``devices`` slots (tests and
    single-host training).  The JAX package counts ``jax.devices()``; a
    torch process counts nothing, so the caller names the slots (the
    world size of its process group)."""
    model = model or 1
    if devices % model:
        raise ValueError(f"{devices} devices do not split into model={model}")
    return MeshSpec(("data", "model"), (devices // model, model))


def shrink_mesh(mesh: MeshSpec, new_dp: int) -> MeshSpec:
    """Largest sub-mesh with ``new_dp`` data-parallel slots, model axis whole.

    When the mesh already has at most ``new_dp`` data slots it is returned
    unchanged (the logical world still shrinks in the sampler and config).
    """
    mesh = as_spec(mesh)
    model = int(mesh.shape.get("model", 1))
    slots = mesh_chips(mesh) // model
    if new_dp >= slots:
        return mesh
    return MeshSpec(("data", "model"), (new_dp, model))


def mesh_chips(mesh) -> int:
    return int(math.prod(as_spec(mesh).sizes))


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in as_spec(mesh).axis_names if a in ("pod", "data"))


def dp_size(mesh) -> int:
    shape = as_spec(mesh).shape
    return int(math.prod(shape[a] for a in dp_axes(mesh)))


def tp_size(mesh) -> int:
    return int(as_spec(mesh).shape.get("model", 1))


def device_mesh(spec: MeshSpec, device_type: str = "cuda"):
    """Realise ``spec`` as a ``DeviceMesh`` over the default process group,
    whose world size must equal the spec's slot count.  ``device_type`` is
    ``"cuda"`` (checked to be usable) or ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device_type)
    if not torch.distributed.is_initialized():
        raise ValueError(f"mesh {spec.label} needs a process group of "
                         f"{mesh_chips(spec)} ranks; none is initialised")
    world = torch.distributed.get_world_size()
    if world != mesh_chips(spec):
        raise ValueError(f"mesh {spec.label} needs {mesh_chips(spec)} ranks, "
                         f"the process group has {world}")
    return init_device_mesh(dev.type, spec.sizes, mesh_dim_names=spec.axis_names)
