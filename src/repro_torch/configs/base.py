"""Config system: architecture specs and input-shape cells, as in the JAX
package.

Every architecture is one ``ArchSpec`` selectable by ``--arch <id>`` in the
launcher.  ``shapes`` lists its (arch × shape) cells; ``skips`` documents
the cells the assignment spec skips (long_500k for pure full-attention
archs); ``smoke_config`` is the reduced same-family config the CPU tests
run.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

from repro_torch.models.lm.config import LMConfig

ShapeKind = Literal["train", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: ShapeKind
    seq_len: int
    global_batch: int


LM_SHAPES = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)

_FULL_ATTN_SKIP = ("long_500k is long-context decode over a 524,288-token KV "
                   "cache; this arch is pure full attention (no sub-quadratic "
                   "path), skipped per assignment spec")


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    id: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm | stgnn
    lm: LMConfig | None  # None for the ST-GNN family
    shapes: tuple[ShapeCell, ...] = LM_SHAPES
    skips: dict[str, str] = dataclasses.field(default_factory=dict)
    source: str = ""
    notes: str = ""
    # reduced same-family config for CPU smoke tests
    smoke_overrides: dict = dataclasses.field(default_factory=dict)

    def cells(self, include_skipped: bool = False):
        for s in self.shapes:
            if s.name in self.skips and not include_skipped:
                continue
            yield s

    def smoke_config(self) -> LMConfig:
        if self.lm is None:
            raise ValueError(f"{self.id} is not an LM arch")
        base = dict(
            layers=2, d_model=64, n_heads=4, n_kv_heads=min(4, self.lm.n_kv_heads),
            d_ff=128, vocab=128, head_dim=16, max_seq_len=128, dtype="float32",
        )
        base.update(self.smoke_overrides)
        return dataclasses.replace(self.lm, **base)


def full_attn_skips() -> dict[str, str]:
    return {"long_500k": _FULL_ATTN_SKIP}
