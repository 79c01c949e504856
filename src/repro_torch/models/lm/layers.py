"""Shared LM layers: norms, embeddings, RoPE, MLP variants.

Initializers take ``draw(shape) -> float32 standard normals`` (a closure over
one ``torch.Generator``) and a ``lead`` shape: the model stacks every layer's
parameters over its stage's ``repeats``, as the JAX package's ``vmap`` init
does.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

Draw = Callable[[tuple], torch.Tensor]


def rms_norm(x, gain, eps: float = 1e-6):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * gain


def init_linear(draw: Draw, d_in, d_out, *, bias=False, dtype=torch.float32,
                scale=None, lead: tuple = ()):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": draw(lead + (d_in, d_out)).mul_(scale).to(dtype)}
    if bias:
        p["b"] = torch.zeros(lead + (d_out,), dtype=dtype, device=p["w"].device)
    return p


def linear(p, x):
    """``x @ w`` with the weight cast to the activation dtype at every call,
    as the JAX package does (a no-op for a tree already in that dtype)."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ----------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D], positions: [B, S] (absolute token positions).

    The head splits into halves (not interleaved pairs), as in the JAX
    package.
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # [D/2]
    angles = positions[..., None].float() * freqs  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------------ MLP
def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def init_mlp(draw: Draw, d_model, d_ff, kind: str, dtype=torch.float32,
             lead: tuple = ()):
    if kind in ("swiglu", "geglu"):
        return {
            "wi": init_linear(draw, d_model, d_ff, dtype=dtype, lead=lead),
            "wg": init_linear(draw, d_model, d_ff, dtype=dtype, lead=lead),
            "wo": init_linear(draw, d_ff, d_model, dtype=dtype, lead=lead),
        }
    return {
        "wi": init_linear(draw, d_model, d_ff, dtype=dtype, lead=lead),
        "wo": init_linear(draw, d_ff, d_model, dtype=dtype, lead=lead),
    }


def mlp(p, x, kind: str):
    if kind == "swiglu":
        return linear(p["wo"], F.silu(linear(p["wg"], x)) * linear(p["wi"], x))
    if kind == "geglu":
        return linear(p["wo"], gelu(linear(p["wg"], x)) * linear(p["wi"], x))
    if kind == "gelu":
        return linear(p["wo"], gelu(linear(p["wi"], x)))
    if kind == "relu_sq":
        return linear(p["wo"], torch.square(F.relu(linear(p["wi"], x))))
    raise ValueError(kind)
