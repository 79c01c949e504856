"""Config system: architecture specs, as in the JAX package.

Every architecture is one ``ArchSpec``; ``smoke_config`` is the reduced
same-family config the CPU tests run.  The JAX package's input-shape cells
(``ShapeCell``, ``LM_SHAPES``) wait for the launchers that read them.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.lm.config import LMConfig


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    id: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm | stgnn
    lm: LMConfig
    source: str = ""
    # reduced same-family config for CPU smoke tests
    smoke_overrides: dict = dataclasses.field(default_factory=dict)

    def smoke_config(self) -> LMConfig:
        base = dict(
            layers=2, d_model=64, n_heads=4, n_kv_heads=min(4, self.lm.n_kv_heads),
            d_ff=128, vocab=128, head_dim=16, max_seq_len=128, dtype="float32",
        )
        base.update(self.smoke_overrides)
        return dataclasses.replace(self.lm, **base)
