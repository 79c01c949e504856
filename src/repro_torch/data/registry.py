"""Dataset specs from the paper's Table 1.

Sizes before/after preprocessing are reproduced analytically by
``benchmarks/table1_memory.py`` from these specs + the window math in
``repro.core.windows``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    kind: str  # epidemiological | energy | traffic
    features: int
    nodes: int
    entries: int
    horizon: int  # windows used by the paper's pipelines
    raw_bytes: int  # "Size Before Preprocessing" (Table 1)
    table1_post_bytes: float | None = None  # paper-reported post size, bytes


_KB, _MB, _GB = 1e3, 1e6, 2**30  # Table 1 mixes decimal KB/MB with GiB; see DESIGN.md §7

TABLE1 = {
    "chickenpox-hungary": DatasetSpec(
        "chickenpox-hungary", "epidemiological", 1, 20, 522, 4,
        raw_bytes=int(83.36 * _KB), table1_post_bytes=657.92 * _KB,
    ),
    "windmill-large": DatasetSpec(
        "windmill-large", "energy", 1, 319, 17_472, 8,
        raw_bytes=int(44.59 * _MB), table1_post_bytes=712.80 * _MB,
    ),
    "metr-la": DatasetSpec(
        "metr-la", "traffic", 2, 207, 34_272, 12,
        raw_bytes=int(54.39 * _MB), table1_post_bytes=2.54 * _GB,
    ),
    "pems-bay": DatasetSpec(
        "pems-bay", "traffic", 2, 325, 52_105, 12,
        raw_bytes=int(129.62 * _MB), table1_post_bytes=6.05 * _GB,
    ),
    "pems-all-la": DatasetSpec(
        "pems-all-la", "traffic", 2, 2_716, 105_120, 12,
        raw_bytes=int(2.12 * _GB), table1_post_bytes=102.08 * _GB,
    ),
    "pems": DatasetSpec(
        "pems", "traffic", 2, 11_160, 105_120, 12,
        raw_bytes=int(8.71 * _GB), table1_post_bytes=419.46 * _GB,
    ),
}


def get_dataset_spec(name: str) -> DatasetSpec:
    try:
        return TABLE1[name]
    except KeyError:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(TABLE1)}") from None
