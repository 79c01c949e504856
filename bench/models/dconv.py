"""Diffusion convolution, the dual random-walk form of DCRNN (Li et al.,
ICLR 2018, eq. 2), as plain products:

    DConv(X) = sum_k ( S_fwd^k X W_k^fwd + S_rev^k X W_k^rev ),  k = 0..K

with the identity hop once. The weight's rows are
``[identity | support 0 hops 1..K | support 1 hops 1..K]``, each a block of
``C`` rows. Every hop is one ``[N, N] @ [N, B*C]`` product and the
projection one ``[B*N, (1+2K)*C] @ [(1+2K)*C, H]`` product, so the
benchmark's count of FLOPs (``bench/counts``) is that of these products.
"""
from __future__ import annotations

import torch

from bench.reference import transition_matrices


def graph(adjacency: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The operator a diffusion-convolutional model takes from the raw
    adjacency: the forward and reverse random walks."""
    return transition_matrices(adjacency)


def dconv(x, supports, w, b, k_hops: int, mm):
    """x: [B, N, C] -> [B, N, H]; ``mm`` is the 2-D product."""
    bsz, n, c = x.shape
    z0 = x.permute(1, 0, 2).reshape(n, bsz * c)
    feats = [z0]
    for s in supports:
        z = z0
        for _ in range(k_hops):
            z = mm(s, z)
            feats.append(z)
    m = len(feats)
    h = torch.stack(feats).reshape(m, n, bsz, c).permute(2, 1, 0, 3)
    out = mm(h.reshape(bsz * n, m * c), w) + b
    return out.reshape(bsz, n, w.shape[1])


def gru_cell(p, supports, x, h, k_hops: int, hidden: int, mm):
    """One diffusion-convolutional GRU step (DCRNN eq. 3)."""
    ru = torch.sigmoid(dconv(torch.cat([x, h], -1), supports, p["ru"]["w"],
                             p["ru"]["b"], k_hops, mm))
    r, u = ru[..., :hidden], ru[..., hidden:]
    c = torch.tanh(dconv(torch.cat([x, r * h], -1), supports, p["c"]["w"],
                         p["c"]["b"], k_hops, mm))
    return u * h + (1.0 - u) * c


def project(p, h, mm):
    """[B, N, H] -> [B, N, out]: the output projection."""
    bsz, n, hidden = h.shape
    return (mm(h.reshape(bsz * n, hidden), p["w"]) + p["b"]).reshape(bsz, n, -1)


def cell_specs(prefix: tuple, in_dim: int, hidden: int, n_matrices: int) -> list:
    """``(path, shape, fan_in)`` of one GRU cell's leaves; ``fan_in`` None
    for a bias, which starts at zero."""
    rows = (in_dim + hidden) * n_matrices
    return [(prefix + ("ru", "w"), (rows, 2 * hidden), rows),
            (prefix + ("ru", "b"), (2 * hidden,), None),
            (prefix + ("c", "w"), (rows, hidden), rows),
            (prefix + ("c", "b"), (hidden,), None)]
