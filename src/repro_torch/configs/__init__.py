"""Architecture registry of the port: ``get_arch(<id>)``, every arch of the
JAX package's registry with the same configs, and the port's own
(``PORT_ONLY``)."""
from __future__ import annotations

from repro_torch.configs.base import LM_SHAPES, ArchSpec, ShapeCell
from repro_torch.configs.deepseek_v2_lite_16b import ARCH as DEEPSEEK_V2_LITE
from repro_torch.configs.granite_34b import ARCH as GRANITE_34B
from repro_torch.configs.grok1_314b import ARCH as GROK1_314B
from repro_torch.configs.h2o_danube3_4b import ARCH as H2O_DANUBE3_4B
from repro_torch.configs.internvl2_26b import ARCH as INTERNVL2_26B
from repro_torch.configs.minitron_8b import ARCH as MINITRON_8B
from repro_torch.configs.musicgen_large import ARCH as MUSICGEN_LARGE
from repro_torch.configs.qwen15_4b import ARCH as QWEN15_4B
from repro_torch.configs.recurrentgemma_2b import ARCH as RECURRENTGEMMA_2B
from repro_torch.configs.rwkv6_1b6 import ARCH as RWKV6_1B6
from repro_torch.configs.stgnn import (DCRNN_PEMS, PGT_DCRNN_PEMS_ALL_LA,
                                      STLLM_DS2LITE_PEMS_ALL_LA)

LM_ARCHS: dict[str, ArchSpec] = {
    a.id: a
    for a in (
        QWEN15_4B, MINITRON_8B, GRANITE_34B, H2O_DANUBE3_4B, INTERNVL2_26B,
        GROK1_314B, DEEPSEEK_V2_LITE, MUSICGEN_LARGE, RECURRENTGEMMA_2B,
        RWKV6_1B6,
    )
}

STGNN_ARCHS = {a.id: a for a in (DCRNN_PEMS, PGT_DCRNN_PEMS_ALL_LA,
                                  STLLM_DS2LITE_PEMS_ALL_LA)}
#: archs the JAX package's registry does not have
PORT_ONLY = (STLLM_DS2LITE_PEMS_ALL_LA.id,)

ARCHS: dict[str, ArchSpec] = {**LM_ARCHS, **STGNN_ARCHS}


def get_arch(arch_id: str) -> ArchSpec:
    try:
        return ARCHS[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}") from None


__all__ = ["ARCHS", "LM_ARCHS", "STGNN_ARCHS", "PORT_ONLY", "get_arch", "ArchSpec",
           "ShapeCell", "LM_SHAPES"]
