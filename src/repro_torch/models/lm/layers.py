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
def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """DeepSeek-V2's ``yarn_get_mscale``: ``0.1 mscale ln(factor) + 1``."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def _yarn_pair_index(rotations: float, head_dim: int, theta: float, max_pos: int) -> float:
    """The pair index whose wavelength turns ``rotations`` times over
    ``max_pos`` positions (``yarn_find_correction_dim``)."""
    return (head_dim * math.log(max_pos / (rotations * 2 * math.pi))) / (2 * math.log(theta))


def rope_freqs(head_dim: int, theta: float, device=None, scaling=None) -> torch.Tensor:
    """The ``head_dim / 2`` rope frequencies, float32.  ``scaling`` (a
    ``YaRNConfig``): DeepSeek-V2's YaRN blend, ``theta``-extrapolated below
    the ramp's low pair index and ``factor``-interpolated above its high
    one, with a linear ramp between."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    if scaling is None:
        return 1.0 / (theta ** exps)
    extra = 1.0 / (theta ** exps)
    inter = 1.0 / (scaling.factor * theta ** exps)
    orig = scaling.original_max_position_embeddings
    low = max(math.floor(_yarn_pair_index(scaling.beta_fast, head_dim, theta, orig)), 0)
    high = min(math.ceil(_yarn_pair_index(scaling.beta_slow, head_dim, theta, orig)),
               head_dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(head_dim // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    extrapolated = 1.0 - ramp
    return inter * (1 - extrapolated) + extra * extrapolated


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               scaling=None) -> torch.Tensor:
    """x: [B, S, H, D], positions: [B, S] (absolute token positions).

    The head splits into halves (not interleaved pairs), as in the JAX
    package.  ``scaling``: YaRN (:func:`rope_freqs`), whose cos and sin
    take ``mscale(mscale) / mscale(mscale_all_dim)`` (1 where the two are
    equal, as in DeepSeek-V2).
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device, scaling)  # [D/2]
    angles = positions[..., None].float() * freqs  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    if scaling is not None:
        gain = (yarn_mscale(scaling.factor, scaling.mscale)
                / yarn_mscale(scaling.factor, scaling.mscale_all_dim))
        if gain != 1.0:
            cos, sin = cos * gain, sin * gain
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
