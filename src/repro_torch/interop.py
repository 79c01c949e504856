"""Bridge parameter trees from the JAX package into the port.

Torch cannot replay ``jax.random`` draws, so parity runs hand the reference's
own parameters over: ``params_from_jax(jax.device_get(tree))`` turns a pytree
of numpy arrays (nested dicts and lists) into the port's tree of tensors, with
the same keys, list order and shapes.  Nothing here imports JAX; the caller
does the ``device_get``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


def params_from_jax(tree: Any, *, device: str | torch.device = "cuda",
                    dtype: torch.dtype | None = torch.float32) -> Any:
    """Nested dicts and lists of array-likes -> the same tree of tensors on
    ``device``.

    ``dtype=None`` keeps each leaf's own dtype.
    """
    dev = resolve_device(device)

    def leaf(a):
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=dev, dtype=dtype or t.dtype)

    return tree_map(leaf, tree)

