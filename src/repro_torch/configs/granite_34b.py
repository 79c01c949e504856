"""granite-34b — 88-layer llama-arch code model, MQA (kv=1).
[arXiv:2405.04324; hf-verified]"""
from repro_torch.configs.base import ArchSpec, full_attn_skips
from repro_torch.models.lm.config import LMConfig

ARCH = ArchSpec(
    id="granite-34b",
    family="dense",
    lm=LMConfig(
        name="granite-34b",
        layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24_576, vocab=49_152, head_dim=128,
        attn="full", pos="rope", mlp="gelu",  # granite-code uses GELU MLP
    ),
    skips=full_attn_skips(),
    source="arXiv:2405.04324",
    smoke_overrides={"n_kv_heads": 1},
)
