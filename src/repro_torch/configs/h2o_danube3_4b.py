"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention.
Runs long_500k: SWA window bounds the KV cache and prefill FLOPs.
[arXiv:2401.16818; unverified]"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm.config import LMConfig

ARCH = ArchSpec(
    id="h2o-danube-3-4b",
    family="dense",
    lm=LMConfig(
        name="h2o-danube-3-4b",
        layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
        d_ff=10_240, vocab=32_000, head_dim=120,
        attn="swa", window=4096, pos="rope", mlp="swiglu",
    ),
    source="arXiv:2401.16818",
    smoke_overrides={"window": 16},
)
