"""DCRNN (Li et al., ICLR'18) — full encoder-decoder with DCGRU cells.

The paper's baseline model ("the original DCRNN"): an encoder stack of
DCGRU layers consumes the input sequence; a decoder stack (with output
projection) rolls out ``horizon`` predictions, teacher-forced during
training via scheduled sampling.

Diffusion convolution follows the dual random-walk form

    DConv(X; theta) = sum_{k=0..K} ( (D_O^{-1} A)^k X W_k^{fwd}
                                   + (D_I^{-1} A^T)^k X W_k^{rev} )

through :func:`repro_torch.kernels.diffusion_conv.diffusion_conv`.
``use_pallas`` (the JAX package's flag name; on by default) runs the hops on
the hand-written kernels on a CUDA card (``hop_gemm`` forward and backward in
training, ``hop_project`` without gradients) and on their plain versions on
the CPU; ``use_pallas=False`` runs the plain oracle.

Parameters are a nested dict of tensors shaped like the JAX package's
pytree: ``encoder`` and ``decoder`` lists of ``{"ru", "c"}`` cells (each
``{"w", "b"}``) and ``proj``, so ``repro_torch.interop.params_from_jax``
carries the reference's weights across unchanged.

Scheduled sampling: the JAX package draws its coin with
``jax.random.bernoulli``, which torch cannot replay, so :func:`apply` takes
the coin as an optional ``[horizon]`` bool tensor and otherwise draws it
from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.diffusion_conv import diffusion_conv


@dataclasses.dataclass(frozen=True)
class DCRNNConfig:
    num_nodes: int
    in_features: int = 2
    out_features: int = 1
    hidden: int = 64
    layers: int = 2
    max_diffusion_step: int = 2  # K
    input_len: int = 12
    horizon: int = 12
    use_pallas: bool = True  # route DConv's hops through the hand-written kernels
    remat: bool = False  # checkpoint each time step (needed at PeMS scale)

    @property
    def n_supports(self) -> int:
        return 2  # forward + reverse random walks

    @property
    def n_matrices(self) -> int:
        # identity hop + K hops per support
        return 1 + self.n_supports * self.max_diffusion_step


# --------------------------------------------------------------------- params
def init(generator: torch.Generator, cfg: DCRNNConfig,
         device: str | torch.device = "cuda") -> dict[str, Any]:
    """Random parameters drawn from ``generator`` (a CPU generator), placed
    on ``device``.  Layout and scales as the JAX package's ``init``."""
    dev = resolve_device(device)

    def normal(rows, cols, fan_in):
        w = torch.randn((rows, cols), generator=generator, dtype=torch.float32)
        return (w / fan_in ** 0.5).to(dev)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    def dconv(in_dim, out_dim):
        fan_in = in_dim * cfg.n_matrices
        return {"w": normal(fan_in, out_dim, fan_in), "b": zeros(out_dim)}

    def cell(in_dim):
        h = cfg.hidden
        return {"ru": dconv(in_dim + h, 2 * h),  # fused reset+update gates
                "c": dconv(in_dim + h, h)}

    enc = [cell(cfg.in_features if i == 0 else cfg.hidden) for i in range(cfg.layers)]
    dec = [cell(cfg.out_features if i == 0 else cfg.hidden) for i in range(cfg.layers)]
    proj = {"w": normal(cfg.hidden, cfg.out_features, cfg.hidden),
            "b": zeros(cfg.out_features)}
    return {"encoder": enc, "decoder": dec, "proj": proj}


# ---------------------------------------------------------------------- cells
def _dconv(p, cfg: DCRNNConfig, supports, x):
    """x: [B, N, C_in] -> [B, N, C_out] via the shared diffusion-conv op."""
    return diffusion_conv(x, supports, p["w"], p["b"],
                          k_hops=cfg.max_diffusion_step, use_pallas=cfg.use_pallas)


def dcgru_cell(p, cfg: DCRNNConfig, supports, x, h):
    """One DCGRU step.  x: [B, N, C], h: [B, N, H] -> new h."""
    xh = torch.cat([x, h], dim=-1)
    ru = torch.sigmoid(_dconv(p["ru"], cfg, supports, xh))
    r, u = torch.split(ru, cfg.hidden, dim=-1)
    xc = torch.cat([x, r * h], dim=-1)
    c = torch.tanh(_dconv(p["c"], cfg, supports, xc))
    return u * h + (1.0 - u) * c


def _stack_step(cells, cfg, supports, x, hs):
    """Run the layer stack for one time step.  hs: one [B, N, H] per layer."""
    new_hs = []
    inp = x
    for p, h in zip(cells, hs):
        inp = dcgru_cell(p, cfg, supports, inp, h)
        new_hs.append(inp)
    return inp, new_hs


# -------------------------------------------------------------------- forward
def apply(
    params,
    cfg: DCRNNConfig,
    supports,
    x_seq: torch.Tensor,
    *,
    y_teacher: torch.Tensor | None = None,
    teacher_prob: float = 0.0,
    coin: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """x_seq: [B, T_in, N, F] -> predictions [B, horizon, N, out_features].

    Scheduled sampling: with ``y_teacher`` given, the decoder input at step
    t is the ground truth ``y_teacher[:, t]`` where ``coin[t]`` is true, and
    its own previous output elsewhere.  ``coin`` ([horizon] bool) pins the
    draw; without it, teacher forcing needs ``teacher_prob > 0`` and draws
    the coin from ``generator`` with probability ``teacher_prob``.
    """
    bsz, _, n, _ = x_seq.shape
    remat = cfg.remat and torch.is_grad_enabled()
    hs = [torch.zeros((bsz, n, cfg.hidden), dtype=x_seq.dtype, device=x_seq.device)
          for _ in range(cfg.layers)]

    # ---- encoder: over the input time steps
    def enc_step(xt, *hs):
        return tuple(_stack_step(params["encoder"], cfg, supports, xt, hs)[1])

    for t in range(x_seq.shape[1]):
        # remat stores only each step's carries and recomputes the DConv
        # intermediates in the backward pass
        hs = (checkpoint(enc_step, x_seq[:, t], *hs, use_reentrant=False) if remat
              else enc_step(x_seq[:, t], *hs))

    # ---- decoder: roll out horizon steps
    if y_teacher is not None and coin is None and teacher_prob > 0.0:
        if generator is None:
            raise ValueError("scheduled sampling draws its coin from an explicit "
                             "torch.Generator; pass generator= or coin=")
        coin = torch.rand((cfg.horizon,), generator=generator) < teacher_prob
    teach = ([bool(c) for c in coin.tolist()] if y_teacher is not None and coin is not None
             else [False] * cfg.horizon)

    def dec_step(inp, *hs):
        top, hs2 = _stack_step(params["decoder"], cfg, supports, inp, hs)
        return (top @ params["proj"]["w"] + params["proj"]["b"], *hs2)

    prev = torch.zeros((bsz, n, cfg.out_features), dtype=x_seq.dtype,
                       device=x_seq.device)
    outs = []
    for t in range(cfg.horizon):
        inp = y_teacher[:, t] if teach[t] else prev
        prev, *hs = (checkpoint(dec_step, inp, *hs, use_reentrant=False) if remat
                     else dec_step(inp, *hs))
        outs.append(prev)
    return torch.stack(outs, dim=1)  # [B, horizon, N, F_out]


# ----------------------------------------------------------------------- loss
def mae_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def loss_fn(params, cfg: DCRNNConfig, supports, x, y):
    """Mean absolute error of the rollout against ``y``'s first
    ``out_features`` channels."""
    pred = apply(params, cfg, supports, x)
    return mae_loss(pred, y[..., : cfg.out_features])
