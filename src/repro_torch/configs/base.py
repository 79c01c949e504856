"""Config system: architecture specs and input-shape cells, as in the JAX
package.

Every architecture is one ``ArchSpec`` selectable by ``--arch <id>`` in the
launcher.  ``shapes`` lists its (arch × shape) cells; ``smoke_config`` is
the reduced same-family config the CPU tests run.  The JAX package's
``LM_SHAPES`` and long-context skips arrive with the LM launchers.
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


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    id: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm | stgnn
    lm: LMConfig | None  # None for the ST-GNN family
    shapes: tuple[ShapeCell, ...] = ()
    source: str = ""
    notes: str = ""
    # reduced same-family config for CPU smoke tests
    smoke_overrides: dict = dataclasses.field(default_factory=dict)

    def smoke_config(self) -> LMConfig:
        if self.lm is None:
            raise ValueError(f"{self.id} is not an LM arch")
        base = dict(
            layers=2, d_model=64, n_heads=4, n_kv_heads=min(4, self.lm.n_kv_heads),
            d_ff=128, vocab=128, head_dim=16, max_seq_len=128, dtype="float32",
        )
        base.update(self.smoke_overrides)
        return dataclasses.replace(self.lm, **base)
