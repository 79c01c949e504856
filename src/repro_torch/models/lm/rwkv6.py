"""RWKV-6 "Finch" block: time-mix with data-dependent decay + channel-mix.

Per head (size hs) the wkv recurrence over tokens t is

    out_t = r_t · (S_{t-1} + (u ⊙ k_t) v_tᵀ)
    S_t   = diag(w_t) S_{t-1} + k_t v_tᵀ

with w_t = exp(-exp(w0 + lora_w(x̄_t))) the data-dependent per-channel decay
and token-shift interpolation x̄ = lerp(x_t, x_{t-1}, μ + lora).  The state is
[H, hs, hs] a sequence, whatever the context length.  The JAX package's
``lax.scan`` over time is :class:`_WKV` here, an autograd function with a
float32 state: its forward loops over time and keeps each step's incoming
state in one residual stack (as XLA's scan keeps a stack for its
gradient), and its backward loops back over time carrying dS.  Both loops
run through ``loops.trips``, so a dry-run counts them from two steps.  The
cache stores the state in its own dtype, as the JAX package does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.distributed import as_dtensor, is_dtensor, model_dims, wrap_local
from repro_torch.loops import trips
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.layers import Draw, init_linear, linear, rms_norm

_LORA_R = 32


def _uniform(draw: Draw, shape) -> torch.Tensor:
    """Uniform [0, 1) draws made from the normal draws (the normal CDF)."""
    return torch.special.ndtr(draw(shape))


def _lora_init(draw: Draw, d, out, dtype, lead):
    return {"a": (draw(lead + (d, _LORA_R)) * 0.01).to(dtype),
            "b": (draw(lead + (_LORA_R, out)) * 0.01).to(dtype)}


def _lora(p, x):
    return torch.tanh(x @ p["a"].to(x.dtype)) @ p["b"].to(x.dtype)


def init_rwkv_block(draw: Draw, cfg: LMConfig, dtype=torch.float32, lead: tuple = ()):
    """The JAX package's parameters, in shape and in how they are drawn: the
    five time-mix μ share one draw, as do the two channel-mix μ; ``w0`` and
    ``u`` are float32 whatever the parameter dtype."""
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    n_h = d // hs
    mu = (_uniform(draw, lead + (d,)) * 0.5 + 0.25).to(dtype)
    cm_mu = (_uniform(draw, lead + (d,)) * 0.5 + 0.25).to(dtype)
    return {
        "mu": {n: mu.clone() for n in ("r", "k", "v", "g", "w")},
        "lora_mix": _lora_init(draw, d, d, dtype, lead),  # shared data-dep shift mix
        "wr": init_linear(draw, d, d, dtype=dtype, lead=lead),
        "wk": init_linear(draw, d, d, dtype=dtype, lead=lead),
        "wv": init_linear(draw, d, d, dtype=dtype, lead=lead),
        "wg": init_linear(draw, d, d, dtype=dtype, lead=lead),
        "w0": torch.full(lead + (d,), -0.6, dtype=torch.float32, device=mu.device),
        "lora_w": _lora_init(draw, d, d, dtype, lead),
        "u": draw(lead + (n_h, hs)) * 0.1,
        "ln_x": torch.ones(lead + (d,), dtype=dtype, device=mu.device),  # per-head norm gain
        "wo": init_linear(draw, d, d, dtype=dtype, lead=lead),
        # channel mix
        "cm_mu_k": cm_mu,
        "cm_mu_r": cm_mu.clone(),
        "cm_k": init_linear(draw, d, cfg.d_ff, dtype=dtype, lead=lead),
        "cm_v": init_linear(draw, cfg.d_ff, d, dtype=dtype, lead=lead),
        "cm_r": init_linear(draw, d, d, dtype=dtype, lead=lead),
    }


def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros, or the carried ``last``, at t=0).
    x: [B, S, d]."""
    prev = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([prev, x[:, :-1]], dim=1)


def _wkv_forward(r, k, v, w, u, s0, states=None):
    """The WKV recurrence step by step; each step's incoming state is
    written into ``states`` ([S, B, H, hs, hs]) when one is given."""
    out = torch.empty_like(r)
    s = s0
    for t in trips(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]  # [B, H, hs]
        if states is not None:
            states[t] = s
        bonus = torch.sum(rt * u * kt, dim=-1, keepdim=True)  # [B, H, 1]
        out[:, t] = torch.einsum("bhk,bhkv->bhv", rt, s) + bonus * vt
        s = wt[..., :, None] * s + kt[..., :, None] * vt[..., None, :]
    return out, s


class _WKV(torch.autograd.Function):
    """:func:`_wkv_forward` with its own backward: per step, for
    ``g = dL/dout_t`` and the carried ``dS = dL/dS_t``,

        dr_t = S_{t-1} g + (u ⊙ k_t)(v_t · g)
        dk_t = (u ⊙ r_t)(v_t · g) + dS v_t
        dv_t = (Σ r_t ⊙ u ⊙ k_t) g + dSᵀ k_t
        dw_t = Σ_v dS ⊙ S_{t-1}
        du  += Σ_b r_t ⊙ k_t (v_t · g)
        dS  <- r_t gᵀ + w_t ⊙ dS          (dS_0 at the end: ds0)
    """

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        states = torch.empty((r.shape[1],) + tuple(s0.shape), dtype=s0.dtype,
                             device=s0.device)
        out, s_last = _wkv_forward(r, k, v, w, u, s0, states)
        ctx.save_for_backward(r, k, v, w, u, states)
        return out, s_last

    @staticmethod
    def backward(ctx, g_out, g_s):
        r, k, v, w, u, states = ctx.saved_tensors
        n = r.shape[1]
        dr, dk, dv, dw = (torch.empty_like(t) for t in (r, k, v, w))
        du = torch.zeros_like(u)
        ds = g_s
        for i in trips(n):
            t = n - 1 - i
            rt, kt, vt, wt, gt = r[:, t], k[:, t], v[:, t], w[:, t], g_out[:, t]
            st = states[t]
            vg = torch.sum(vt * gt, dim=-1, keepdim=True)  # [B, H, 1]
            bonus = torch.sum(rt * u * kt, dim=-1, keepdim=True)
            dr[:, t] = torch.einsum("bhkv,bhv->bhk", st, gt) + u * kt * vg
            dk[:, t] = u * rt * vg + torch.einsum("bhkv,bhv->bhk", ds, vt)
            dv[:, t] = bonus * gt + torch.einsum("bhkv,bhk->bhv", ds, kt)
            dw[:, t] = torch.sum(ds * st, dim=-1)
            du = du + torch.sum(rt * kt * vg, dim=0)
            ds = rt[..., :, None] * gt[..., None, :] + wt[..., :, None] * ds
        return dr, dk, dv, dw, du, ds


def _wkv_scan(r, k, v, w, u, s0):
    """r/k/v: [B, S, H, hs], w: [B, S, H, hs] decay in (0,1), u: [H, hs],
    s0: [B, H, hs, hs].  Returns (out [B, S, H, hs], s_last).

    ``r·(S + (u ⊙ k) vᵀ)`` is taken as ``r·S + (Σ r ⊙ u ⊙ k) v``: the same
    sum in another order, which never forms the [B, H, hs, hs] bonus term.
    Where a gradient is wanted the scan is :class:`_WKV`, which keeps one
    state a step for its backward; otherwise the same forward keeps none.
    DTensor operands run on each rank's shards (:func:`_wkv_on_shards`).
    """
    args = (r, k, v, w, u, s0)
    if any(is_dtensor(t) for t in args):
        return _wkv_on_shards(*args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _WKV.apply(*args)
    return _wkv_forward(*args)


def _wkv_on_shards(r, k, v, w, u, s0):
    """:func:`_wkv_scan` for DTensor operands: batch rows and heads are
    independent, so every rank scans its own rows and, over ``model``, its
    own heads (when the head count divides the dim), and the results are
    wrapped back with those placements: the SPMD form of the step's
    einsum, which torch 2.11's DTensor cannot fold when a head dim is
    split."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = next(t for t in (r, k, v, w, u, s0) if is_dtensor(t)).device_mesh
    r, k, v, w, u, s0 = (as_dtensor(t, mesh) for t in (r, k, v, w, u, s0))
    tp = model_dims(mesh)
    pl = [p if p == Shard(0) else
          Shard(2) if i in tp and r.shape[2] % mesh.size(i) == 0 else Replicate()
          for i, p in enumerate(r.placements)]  # [B, S, H, hs]
    pu = [Shard(0) if p == Shard(2) else Replicate() for p in pl]  # [H, hs]
    ps = [Shard(1) if p == Shard(2) else p for p in pl]  # [B, H, hs, hs]

    def local(t, placements):
        return t.redistribute(mesh, placements).to_local()

    out, s = _wkv_scan(*(local(t, pl) for t in (r, k, v, w)), local(u, pu), local(s0, ps))
    return wrap_local(out, mesh, pl, r.shape), wrap_local(s, mesh, ps, s0.shape)


def time_mix(p, cfg: LMConfig, x, *, cache=None):
    """x: [B, S, d] -> (y, new_cache {shift [B, d], state [B, H, hs, hs]})."""
    b, s, d = x.shape
    hs = cfg.rwkv_head_size
    n_h = d // hs
    last = None if cache is None else cache["shift"]
    xs = _shift(x, last)
    mix = _lora(p["lora_mix"], x)

    def lerp(name):
        mu = p["mu"][name].to(x.dtype)
        return x + (xs - x) * torch.clamp(mu + mix, 0.0, 1.0)

    r = linear(p["wr"], lerp("r")).reshape(b, s, n_h, hs)
    k = linear(p["wk"], lerp("k")).reshape(b, s, n_h, hs)
    v = linear(p["wv"], lerp("v")).reshape(b, s, n_h, hs)
    g = F.silu(linear(p["wg"], lerp("g")))
    w_log = p["w0"].float() + _lora(p["lora_w"], lerp("w")).float()
    w = torch.exp(-torch.exp(w_log)).reshape(b, s, n_h, hs)  # data-dependent decay

    s0 = (torch.zeros((b, n_h, hs, hs), dtype=torch.float32, device=x.device)
          if cache is None else cache["state"].float())
    out, s_last = _wkv_scan(r.float(), k.float(), v.float(), w, p["u"].float(), s0)
    out = out.reshape(b, s, d).to(x.dtype)
    out = rms_norm(out.reshape(b, s, n_h, hs), 1.0, cfg.norm_eps).reshape(b, s, d)
    y = linear(p["wo"], out * p["ln_x"].to(x.dtype) * g)
    return y, {"shift": x[:, -1], "state": s_last.to(x.dtype)}


def channel_mix(p, cfg: LMConfig, x, *, cache=None):
    last = None if cache is None else cache["shift"]
    xs = _shift(x, last)
    mk = x + (xs - x) * p["cm_mu_k"].to(x.dtype)
    mr = x + (xs - x) * p["cm_mu_r"].to(x.dtype)
    k = torch.square(F.relu(linear(p["cm_k"], mk)))
    return (torch.sigmoid(linear(p["cm_r"], mr)) * linear(p["cm_v"], k),
            {"shift": x[:, -1]})


def init_rwkv_cache(cfg: LMConfig, batch: int, dtype, device) -> dict:
    hs = cfg.rwkv_head_size
    n_h = cfg.d_model // hs

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"tm": {"shift": zeros(batch, cfg.d_model), "state": zeros(batch, n_h, hs, hs)},
            "cm": {"shift": zeros(batch, cfg.d_model)}}
