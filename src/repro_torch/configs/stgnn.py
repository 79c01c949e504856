"""ST-GNN architecture specs — the paper's own models as first-class configs.

They run through the same launcher as the LM archs; their shape cells are
the paper's datasets (nodes × window) at the paper's batch sizes, plus a
production-scale training cell on the full PeMS graph.

``stllm-ds2lite-pems-all-la`` is the port's own (the JAX registry has no
such arch, and the dry-run no cell of it): ST-LLM on PeMS-All-LA with
DeepSeek-V2-Lite's block as its backbone at the published widths, routing
and YaRN, 5 of its 27 layers.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchSpec, ShapeCell
from repro_torch.configs.deepseek_v2_lite_16b import ARCH as DEEPSEEK_V2_LITE
from repro_torch.models.dcrnn import DCRNNConfig
from repro_torch.models.lm.config import YaRNConfig
from repro_torch.models.pgt_dcrnn import PGTDCRNNConfig
from repro_torch.models.stllm import STLLMConfig


@dataclasses.dataclass(frozen=True)
class STGNNSpec(ArchSpec):
    model: object | None = None  # DCRNNConfig / PGTDCRNNConfig / STLLMConfig
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


_DS2 = DEEPSEEK_V2_LITE.lm

#: DeepSeek-V2-Lite's block as published (config.json): YaRN rope (factor 40
#: over 4,096 positions, mscale = mscale_all_dim = 0.707), softmax routing
#: over 64 experts, greedy top-6 without renormalisation, a per-sequence
#: balance loss (aux_loss_alpha 0.001), every assignment computed; 5 layers
#: (the dense one and 4 MoE), float32.  No vocabulary: node tokens enter
#: through ST-LLM's patch embedding, so ``embed`` and ``lm_head`` keep one row.
DS2LITE_BACKBONE = dataclasses.replace(
    _DS2, name="stllm-ds2lite-backbone", layers=5, vocab=1, dtype="float32",
    param_dtype="float32",
    rope_scaling=YaRNConfig(factor=40.0, original_max_position_embeddings=4096,
                            beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                            mscale_all_dim=0.707),
    moe=dataclasses.replace(_DS2.moe, norm_topk_prob=False, routed_scaling_factor=1.0,
                            seq_aux=True, dropless=True, aux_loss_coef=0.001))

STLLM_DS2LITE_PEMS_ALL_LA = STGNNSpec(
    id="stllm-ds2lite-pems-all-la",
    family="stgnn",
    lm=None,
    model=STLLMConfig(num_nodes=2_716, in_features=2, out_features=1,
                      input_len=12, horizon=12, backbone=DS2LITE_BACKBONE),
    dataset="pems-all-la",
    shapes=(),
    source="Liu et al. arXiv:2401.04463 + arXiv:2405.04434",
    notes="ST-LLM (paper §5.5) with DeepSeek-V2-Lite's MLA and 64-expert MoE block "
          "as its backbone, 5 of 27 layers; the port's own arch",
)
