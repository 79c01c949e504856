"""Plain PyTorch reference of everything the models do not: windows and
their split, the train-split scaler, the dual random-walk supports, the
window gather, global-norm clipping and AdamW, and a TF32 product for the
lower-precision control.

It is a frozen copy of the paper's equations, written from the raw inputs
the benchmark makes. It imports nothing of the program, so a later change
to the program cannot move what it is judged against.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: Train / val / test shares of the windows (paper: 70/10/20).
SPLIT = (0.7, 0.1)


def window_split(entries: int, span: int) -> dict[str, np.ndarray]:
    """Window ids of each split: every placement of ``span`` rows, split
    contiguously in time. A window's id is its first row."""
    n = max(entries - span + 1, 0)
    n_train = round(n * SPLIT[0])
    n_val = round(n * SPLIT[1])
    ids = np.arange(n, dtype=np.int64)
    return {"train": ids[:n_train], "val": ids[n_train:n_train + n_val],
            "test": ids[n_train + n_val:]}


@dataclasses.dataclass(frozen=True)
class Scaler:
    mean: float
    std: float


def fit_scaler(raw: np.ndarray, rows: int, device, *, feature: int = 0,
               chunk: int = 4096) -> Scaler:
    """Mean and (population) standard deviation of ``raw[:rows, :, feature]``
    in float64, accumulated over row chunks on ``device``."""
    total = torch.zeros((), dtype=torch.float64, device=device)
    squares = torch.zeros((), dtype=torch.float64, device=device)
    for lo in range(0, rows, chunk):
        part = torch.from_numpy(raw[lo:min(lo + chunk, rows)]).to(device)
        v = part[..., feature].double()
        total += v.sum()
        squares += (v * v).sum()
    count = rows * raw.shape[1]
    mean = total.item() / count
    var = max(squares.item() / count - mean * mean, 0.0)
    std = var ** 0.5
    return Scaler(mean, std if std > 0.0 else 1.0)


def windows(raw: np.ndarray, ids: np.ndarray, span: int, scaler: Scaler,
            device, *, feature: int = 0) -> torch.Tensor:
    """``[B, span, N, F]`` float32: the raw rows of each window, with
    ``feature`` standardised."""
    host = np.stack([raw[int(s):int(s) + span] for s in ids])
    w = torch.from_numpy(host).to(device).double()
    w[..., feature] = (w[..., feature] - scaler.mean) / scaler.std
    return w.float()


def transition_matrices(adj: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(D_O^-1 A, D_I^-1 A^T): the forward and reverse random walks, with
    the degrees summed in float64."""
    a = adj.double()
    out_deg = a.sum(dim=1, keepdim=True).clamp_min(1e-8)
    in_deg = a.sum(dim=0, keepdim=True).clamp_min(1e-8)
    return (a / out_deg).float().contiguous(), (a.T / in_deg.T).float().contiguous()


# ------------------------------------------------------------- products
def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits (to nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """``a @ b`` as TF32 tensor cores compute it: both inputs rounded to
    TF32, products accumulated in float32; the backward products too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(_tf32(a), _tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.mm(_tf32(g), _tf32(b).T)
        if ctx.needs_input_grad[1]:
            gb = torch.mm(_tf32(a).T, _tf32(g))
        return ga, gb


def product(precision: str):
    """The 2-D product of a precision: ``"float32"`` (TF32 off) or
    ``"tf32"``, the control's."""
    if precision == "float32":
        return torch.mm
    if precision == "tf32":
        return _TF32Product.apply
    raise ValueError(f"unknown precision {precision!r}")


# ------------------------------------------------------------ optimiser
@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float | None = 1.0


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """The gradients' global norm, summed in float64."""
    return torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))


def clip(grads: list[torch.Tensor], max_norm: float | None) -> list[torch.Tensor]:
    """Gradients scaled so that their global norm is at most ``max_norm``."""
    if max_norm is None:
        return grads
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return [(g.double() * scale).float() for g in grads]


def adamw_step(params, grads, m, v, step: int, opt: AdamW):
    """One AdamW step (``step`` counts from 1) on lists of leaves; the
    gradients are already clipped. Returns ``(params, m, v)``. The bias
    corrections ``1 - b ** step`` are float32, the configurations' precision
    (in float64, ``1 - 0.999`` differs from float32's by 1.3e-5, which moves
    every update by 6e-6 of itself)."""
    b1c = float(np.float32(1.0) - np.float32(opt.b1) ** np.float32(step))
    b2c = float(np.float32(1.0) - np.float32(opt.b2) ** np.float32(step))
    out_p, out_m, out_v = [], [], []
    for p, g, mi, vi in zip(params, grads, m, v):
        mi = opt.b1 * mi + (1.0 - opt.b1) * g
        vi = opt.b2 * vi + (1.0 - opt.b2) * g * g
        delta = (mi / b1c) / (torch.sqrt(vi / b2c) + opt.eps)
        if opt.weight_decay:
            delta = delta + opt.weight_decay * p
        out_p.append(p - opt.lr * delta)
        out_m.append(mi)
        out_v.append(vi)
    return out_p, out_m, out_v
