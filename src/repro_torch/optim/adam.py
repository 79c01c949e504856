"""AdamW with f32 math, a configurable state dtype and global-norm clipping.

State is a tree congruent with params (``m``, ``v``) plus an integer step
(a Python int, or a 0-d integer tensor as the dry-run's cells hold it);
bias correction is computed in float32 from that step, as in the JAX
package.  ``state_dtype="bfloat16"`` halves the moment memory.  Updates are
functional: new tensors come back and the inputs are left as they were.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float | None = 1.0
    state_dtype: str = "float32"


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def init_opt_state(params: Any, cfg: AdamConfig) -> dict[str, Any]:
    dt = torch_dtype(cfg.state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "step": 0}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in tree_leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: dict, cfg: AdamConfig,
                  lr: torch.Tensor | float) -> tuple[Any, dict, torch.Tensor | None]:
    """One AdamW step.  Returns ``(params, state, grad_norm | None)``.

    Clipping scales each gradient leaf inside its own update, with
    :func:`clip_by_global_norm`'s arithmetic, so no clipped copy of the
    whole gradient tree is held beside the new parameters and moments.
    """
    grad_norm = scale = None
    if cfg.grad_clip is not None:
        grad_norm = global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / torch.clamp(grad_norm, min=1e-12), max=1.0)
    step = state["step"] + 1
    if isinstance(step, torch.Tensor):  # a 0-d int32 counter, as the JAX state
        b1c = 1.0 - cfg.b1 ** step.float()
        b2c = 1.0 - cfg.b2 ** step.float()
    else:
        b1c = float(np.float32(1.0) - np.float32(cfg.b1) ** np.float32(step))
        b2c = float(np.float32(1.0) - np.float32(cfg.b2) ** np.float32(step))
    dt = torch_dtype(cfg.state_dtype)

    def upd(p, g, m, v):
        if scale is not None:
            g = (g.float() * scale).to(g.dtype)
        g32 = g.float()
        m32 = m.float() * cfg.b1 + g32 * (1.0 - cfg.b1)
        v32 = v.float() * cfg.b2 + torch.square(g32) * (1.0 - cfg.b2)
        delta = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m32.to(dt), v32.to(dt)

    out = tree_map(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda t: t[i], out)
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, grad_norm
