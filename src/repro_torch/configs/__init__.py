"""Architecture registry of the port: ``get_arch(<id>)``.

Only the archs whose every module is ported are registered.  Asking for an
arch of the JAX package that is not ported yet raises and names the
``ROADMAP.md`` item that ports it.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchSpec, ShapeCell
from repro_torch.configs.recurrentgemma_2b import ARCH as RECURRENTGEMMA_2B
from repro_torch.configs.stgnn import DCRNN_PEMS, PGT_DCRNN_PEMS_ALL_LA

ARCHS: dict[str, ArchSpec] = {
    a.id: a for a in (RECURRENTGEMMA_2B, DCRNN_PEMS, PGT_DCRNN_PEMS_ALL_LA)}

#: archs of the JAX package that the port does not have yet, and where
#: ``ROADMAP.md`` queues them
NOT_PORTED = {
    **dict.fromkeys(
        ("qwen1.5-4b", "minitron-8b", "granite-34b", "h2o-danube-3-4b",
         "internvl2-26b", "musicgen-large"),
        "queue 1, item 6 (the rest of the LM family)"),
    **dict.fromkeys(("grok-1-314b", "deepseek-v2-lite-16b"),
                    "queue 1, item 6 (the rest of the LM family: MoE and MLA)"),
    "rwkv6-1.6b": "queue 1, item 6 (the rest of the LM family: RWKV-6)",
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in ARCHS:
        return ARCHS[arch_id]
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet: ROADMAP.md "
            f"{NOT_PORTED[arch_id]}")
    raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")


__all__ = ["ARCHS", "NOT_PORTED", "get_arch", "ArchSpec", "ShapeCell"]
