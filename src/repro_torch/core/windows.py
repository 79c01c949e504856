"""Sliding-window math and the paper's memory model (eqs. 1 and 2).

The paper (§2.3, §3.3) shows that standard spatiotemporal preprocessing
materialises every sliding-window snapshot, growing an ``entries × nodes ×
features`` series by ``≈ 2·horizon×``.  Index-batching (§4.1) keeps one copy of
the series plus an integer start index per window.  This module is the single
source of truth for window counting and the analytic memory model; the
benchmarks validate it against the paper's Table 1.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

Counting = Literal["exact", "paper", "table"]


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """Sliding-window geometry.

    ``input_len`` (T') steps of input predict ``horizon`` (T) future steps.
    The paper uses T' == T == horizon (12 for the traffic datasets); we keep
    them independent so other seq2seq workloads (e.g. LM next-token windows)
    reuse the same machinery.
    """

    horizon: int
    input_len: int | None = None
    stride: int = 1

    def __post_init__(self) -> None:
        if self.horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {self.horizon}")
        if self.input_len is not None and self.input_len < 1:
            raise ValueError(f"input_len must be >= 1, got {self.input_len}")
        if self.stride < 1:
            raise ValueError(f"stride must be >= 1, got {self.stride}")

    @property
    def in_len(self) -> int:
        return self.horizon if self.input_len is None else self.input_len

    @property
    def span(self) -> int:
        """Total time steps one (x, y) pair covers."""
        return self.in_len + self.horizon


def num_windows(entries: int, spec: WindowSpec, counting: Counting = "exact") -> int:
    """Number of sliding windows over a series of ``entries`` steps.

    counting="exact"  — every valid placement: entries − (T' + T) + 1.
    counting="paper"  — the paper's eq. (1) term: entries − (2·horizon − 1)
                        (equals "exact" when T' == T == horizon).
    counting="table"  — entries − 2·horizon; this is what the paper's Table 1
                        numbers actually match (see DESIGN.md §7).
    """
    if counting == "exact":
        n = entries - spec.span + 1
    elif counting == "paper":
        n = entries - (2 * spec.horizon - 1)
    elif counting == "table":
        n = entries - 2 * spec.horizon
    else:  # pragma: no cover - guarded by Literal
        raise ValueError(f"unknown counting {counting!r}")
    n = max(n, 0)
    return (n + spec.stride - 1) // spec.stride if spec.stride > 1 else n


def window_starts(entries: int, spec: WindowSpec, counting: Counting = "exact") -> np.ndarray:
    """Start index of every window (int32)."""
    return np.arange(num_windows(entries, spec, counting), dtype=np.int32) * spec.stride


def materialized_bytes(
    entries: int,
    nodes: int,
    features: int,
    spec: WindowSpec,
    dtype_bytes: int = 8,
    counting: Counting = "paper",
) -> int:
    """Paper eq. (1): bytes after standard (snapshot-materialising) preprocessing.

    size = 2 · windows · horizon · nodes · features   (values) · dtype_bytes
    The x and y snapshot stacks each hold ``windows × horizon`` time-slices.
    """
    w = num_windows(entries, spec, counting)
    values = w * (spec.in_len + spec.horizon) * nodes * features
    return values * dtype_bytes


def index_batching_bytes(
    entries: int,
    nodes: int,
    features: int,
    spec: WindowSpec,
    dtype_bytes: int = 8,
    index_bytes: int = 8,
    counting: Counting = "paper",
) -> int:
    """Paper eq. (2): one copy of the series + one start index per window."""
    series = entries * nodes * features * dtype_bytes
    idx = num_windows(entries, spec, counting) * index_bytes
    return series + idx


def memory_reduction(
    entries: int, nodes: int, features: int, spec: WindowSpec, dtype_bytes: int = 8
) -> float:
    """Fractional reduction of index-batching vs materialised snapshots."""
    mat = materialized_bytes(entries, nodes, features, spec, dtype_bytes)
    idx = index_batching_bytes(entries, nodes, features, spec, dtype_bytes)
    return 1.0 - idx / mat if mat else 0.0


def split_windows(
    n_windows: int, train: float = 0.7, val: float = 0.1
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Contiguous train/val/test split over window indices (paper: 70/10/20)."""
    if not 0.0 < train < 1.0 or val < 0.0 or train + val > 1.0:
        raise ValueError(f"bad split train={train} val={val}")
    n_train = round(n_windows * train)
    n_val = round(n_windows * val)
    idx = np.arange(n_windows, dtype=np.int32)
    return idx[:n_train], idx[n_train : n_train + n_val], idx[n_train + n_val :]
