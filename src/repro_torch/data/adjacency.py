"""Sensor-graph construction (paper §2.1).

DCRNN-style weighted adjacency from sensor coordinates: Gaussian kernel of
pairwise road distance, thresholded for sparsity, plus the dual random-walk
transition matrices used by diffusion convolution (forward D_O^{-1} A and
reverse D_I^{-1} A^T).
"""
from __future__ import annotations

import numpy as np


def random_sensor_coords(nodes: int, *, seed: int = 0) -> np.ndarray:
    """Plausible sensor layout: clusters along a few 'highways'."""
    rng = np.random.default_rng(seed)
    n_roads = max(1, nodes // 64)
    coords = []
    for r in range(n_roads):
        start = rng.uniform(0, 100, size=2)
        direction = rng.standard_normal(2)
        direction /= np.linalg.norm(direction)
        n = nodes // n_roads + (1 if r < nodes % n_roads else 0)
        ts = np.sort(rng.uniform(0, 60, size=n))
        pts = start[None, :] + ts[:, None] * direction[None, :]
        pts += rng.standard_normal((n, 2)) * 0.5
        coords.append(pts)
    return np.concatenate(coords, axis=0)[:nodes]


def gaussian_adjacency(
    coords: np.ndarray, *, threshold: float = 0.1, sigma: float | None = None
) -> np.ndarray:
    """W_ij = exp(-d_ij^2 / sigma^2), zeroed below ``threshold`` (DCRNN eq. 10)."""
    d = np.linalg.norm(coords[:, None, :] - coords[None, :, :], axis=-1)
    if sigma is None:
        sigma = float(d.std()) or 1.0
    w = np.exp(-((d / sigma) ** 2))
    w[w < threshold] = 0.0
    np.fill_diagonal(w, 1.0)
    return w.astype(np.float32)


def transition_matrices(adj: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(D_O^{-1} A, D_I^{-1} A^T) — forward/reverse random-walk operators."""
    out_deg = adj.sum(axis=1, keepdims=True)
    in_deg = adj.sum(axis=0, keepdims=True)
    fwd = adj / np.maximum(out_deg, 1e-8)
    rev = adj.T / np.maximum(in_deg.T, 1e-8)
    return fwd.astype(np.float32), rev.astype(np.float32)


def sym_norm_adjacency(adj: np.ndarray) -> np.ndarray:
    """D^{-1/2} (A + I) D^{-1/2} — GCN operator used by A3T-GCN / T-GCN."""
    a = adj + np.eye(adj.shape[0], dtype=adj.dtype)
    d = a.sum(axis=1)
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(d, 1e-8))
    return (a * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]).astype(np.float32)
