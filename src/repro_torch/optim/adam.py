"""AdamW with f32 math, a configurable state dtype and global-norm clipping.

State is a tree congruent with params (``m``, ``v``) plus an integer step
(a Python int, or a 0-d integer tensor as the dry-run's cells hold it);
bias correction is computed in float32 from that step, as in the JAX
package.  ``state_dtype="bfloat16"`` halves the moment memory.  Updates are
functional (new tensors come back and the inputs are left as they were),
or with ``in_place`` write each moment leaf into its own storage, as the
train step asks: the parameters still come back new (a caller may hold
the old ones), the moments are the optimiser's alone, and the arithmetic
and its roundings are the same either way.
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


#: Elements a slice of the in-place update takes at once: a leaf's
#: temporaries are a slice's, never the whole leaf's.
SLICE = 1 << 24


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: dict, cfg: AdamConfig,
                  lr: torch.Tensor | float, *,
                  in_place: bool = False) -> tuple[Any, dict, torch.Tensor | None]:
    """One AdamW step.  Returns ``(params, state, grad_norm | None)``.

    Clipping scales each gradient leaf inside its own update, with
    :func:`clip_by_global_norm`'s arithmetic, so no clipped copy of the
    whole gradient tree is held beside the new parameters and moments.

    ``in_place``: ``state``'s moment leaves are updated where they lie and
    returned, each gradient leaf is dropped from ``grads`` once applied,
    and a leaf is updated ``SLICE`` elements at a time, so the step holds
    one set of moments, and gradients and new parameters together no more
    than one set.  The same elementwise operations in the same order: the
    results are the functional path's, bit for bit.
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

    if in_place:
        def update(p, g, m, v):
            new = torch.empty_like(p)
            if p.numel() <= SLICE or not all(t.is_contiguous() for t in (p, g, m, v)):
                _update_slice(p, g, m, v, new, cfg, scale, b1c, b2c, lr)
                return new
            views = [t.view(-1) for t in (p, g, m, v, new)]
            for lo in range(0, p.numel(), SLICE):
                _update_slice(*(t[lo:lo + SLICE] for t in views), cfg, scale, b1c, b2c, lr)
            return new

        new_params = _consume(params, grads, state["m"], state["v"], update)
        return new_params, {"m": state["m"], "v": state["v"], "step": step}, grad_norm

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


def _update_slice(p, g, m, v, new, cfg: AdamConfig, scale, b1c, b2c, lr) -> None:
    """AdamW on one slice: ``m`` and ``v`` written in place, the new
    parameters into ``new``; the functional path's operations, each
    rounding as there (``b1 m`` then ``+ (1 - b1) g``: two roundings)."""
    if scale is not None:
        g = (g.float() * scale).to(g.dtype)
    g32 = g.float()
    if m.dtype == torch.float32 and v.dtype == torch.float32:
        m32 = m.mul_(cfg.b1).add_(g32 * (1.0 - cfg.b1))
        v32 = v.mul_(cfg.b2).add_(torch.square(g32).mul_(1.0 - cfg.b2))
    else:
        m32 = m.float() * cfg.b1 + g32 * (1.0 - cfg.b1)
        v32 = v.float() * cfg.b2 + torch.square(g32) * (1.0 - cfg.b2)
    del g, g32
    delta = m32 / b1c
    denom = v32 / b2c
    delta.div_(denom.sqrt_().add_(cfg.eps))
    del denom
    if cfg.weight_decay:
        delta.add_(cfg.weight_decay * p.float())
    if new.dtype == torch.float32:
        torch.sub(p.float(), delta.mul_(lr), out=new)
    else:
        new.copy_(p.float() - delta.mul_(lr))
    if m32 is not m:
        m.copy_(m32)
        v.copy_(v32)


def _consume(params, grads, m, v, update):
    """``update(p, g, m, v)`` over the trees' leaves into a new tree shaped
    like ``params``, each gradient leaf dropped from ``grads`` (set to None)
    as soon as it is applied."""
    if isinstance(params, dict):
        keys = list(params)
    elif isinstance(params, list):
        keys = range(len(params))
    else:
        raise TypeError("apply_updates(in_place=True) takes a tree of dicts and lists")
    out = {} if isinstance(params, dict) else [None] * len(params)
    for k in keys:
        if isinstance(params[k], (dict, list)):
            out[k] = _consume(params[k], grads[k], m[k], v[k], update)
        else:
            out[k] = update(params[k], grads[k], m[k], v[k])
            grads[k] = None
    return out
