"""ST-GNN architecture specs — the paper's own models as first-class configs.

They run through the same launcher as the LM archs; their shape cells are
the paper's datasets (nodes × window) at the paper's batch sizes, plus a
production-scale training cell on the full PeMS graph.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchSpec, ShapeCell
from repro_torch.models.dcrnn import DCRNNConfig
from repro_torch.models.pgt_dcrnn import PGTDCRNNConfig


@dataclasses.dataclass(frozen=True)
class STGNNSpec(ArchSpec):
    model: object | None = None  # DCRNNConfig / PGTDCRNNConfig
    dataset: str = "pems"


DCRNN_PEMS = STGNNSpec(
    id="dcrnn-pems",
    family="stgnn",
    lm=None,
    model=DCRNNConfig(num_nodes=11_160, in_features=2, out_features=1,
                      hidden=64, layers=2, max_diffusion_step=2,
                      input_len=12, horizon=12),
    dataset="pems",
    shapes=(ShapeCell("train_pems", "train", 12, 1024),),
    source="Li et al. ICLR'18 + paper §3",
    notes="full PeMS graph, no partitioning — the paper's headline workload",
)

PGT_DCRNN_PEMS_ALL_LA = STGNNSpec(
    id="pgt-dcrnn-pems-all-la",
    family="stgnn",
    lm=None,
    model=PGTDCRNNConfig(num_nodes=2_716, in_features=2, out_features=1,
                         hidden=64, max_diffusion_step=2,
                         input_len=12, horizon=12),
    dataset="pems-all-la",
    shapes=(ShapeCell("train_all_la", "train", 12, 1024),),
    source="paper §3 case study",
)
