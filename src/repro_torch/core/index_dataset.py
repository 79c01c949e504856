"""IndexDataset — the paper's compact representation (series + window indices).

Holds exactly what eq. (2) budgets for: one standardized copy of the series and
the int32 start-index array.  ``to_device`` realises GPU-index-batching: the
series is placed on the card once, before training, and every batch is
gathered there from int32 window starts.  ``to_device(rows=(lo, hi))`` places
only those time rows (a rank's share under the distributed placements) and
records their origin ``lo``; ``entries`` stays the whole series' length.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import windows as W
from repro_torch.data.normalize import Scaler, apply_scaler, fit_scaler
from repro_torch.device import resolve_device


@dataclasses.dataclass
class IndexDataset:
    series: Any  # [T, N, F] (np.ndarray on host, torch.Tensor once placed)
    starts: np.ndarray  # [W] int32 — window start per sample
    spec: W.WindowSpec
    scaler: Scaler
    train_windows: np.ndarray
    val_windows: np.ndarray
    test_windows: np.ndarray
    origin: int = 0  # first time row ``series`` holds
    total_entries: int | None = None  # whole series' rows; None: series is whole

    # ------------------------------------------------------------------ build
    @classmethod
    def from_raw(
        cls,
        raw: np.ndarray,
        spec: W.WindowSpec,
        *,
        train: float = 0.7,
        val: float = 0.1,
        scale_feature: int | None = 0,
        counting: W.Counting = "exact",
    ) -> "IndexDataset":
        starts = W.window_starts(raw.shape[0], spec, counting)
        tr, va, te = W.split_windows(len(starts), train, val)
        # Scaler over the series range the training windows cover (Alg. 1 l.16-18).
        train_end_step = int(starts[tr[-1]]) + spec.in_len if len(tr) else raw.shape[0]
        scaler = fit_scaler(raw, train_end_step, feature=scale_feature)
        series = apply_scaler(raw, scaler, feature=scale_feature)
        return cls(series, starts, spec, scaler, tr, va, te)

    # -------------------------------------------------------------- placement
    def to_device(self, device: str | torch.device = "cuda", *,
                  rows: tuple[int, int] | None = None) -> "IndexDataset":
        """GPU-index-batching: one host→device transfer of the compact series,
        or of its time rows ``[lo, hi)`` only.  Only the slice is copied to
        the device; the returned dataset holds no reference to the host
        series, which the caller may then drop.  The scaler is the one fitted
        on the whole train split before the slice."""
        dev = resolve_device(device)
        entries = self.entries
        lo, hi = (0, entries) if rows is None else rows
        if not 0 <= lo < hi <= entries:
            raise ValueError(f"rows [{lo}, {hi}) outside the series' {entries} rows")
        if self.total_entries is not None:
            raise ValueError("to_device places rows of a whole series only")
        series = self.series[lo:hi]
        return dataclasses.replace(
            self, series=torch.as_tensor(series).to(dev), origin=lo,
            total_entries=None if (lo, hi) == (0, entries) else entries)

    # ------------------------------------------------------------- accounting
    @property
    def entries(self) -> int:
        """Rows of the whole series (also when only a slice is placed)."""
        if self.total_entries is not None:
            return self.total_entries
        return self.series.shape[0]

    @property
    def resident_rows(self) -> tuple[int, int]:
        """``[lo, hi)``: the time rows ``series`` holds."""
        return self.origin, self.origin + self.series.shape[0]

    @property
    def n_windows(self) -> int:
        return len(self.starts)

    def nbytes_index(self) -> int:
        """Bytes this representation holds: the resident series rows plus the
        index array."""
        return int(self.series.nbytes) + self.starts.nbytes

    def nbytes_materialized(self) -> int:
        """Bytes the Alg.-1 baseline would need for the same windows."""
        per_window = self.spec.span * int(np.prod(self.series.shape[1:]))
        return self.n_windows * per_window * self.series.dtype.itemsize
