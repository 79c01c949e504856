"""rwkv6-1.6b "Finch" — attention-free RNN with data-dependent decay.
Runs long_500k: per-layer state is [H, 64, 64] regardless of context.
[arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm.config import LMConfig

ARCH = ArchSpec(
    id="rwkv6-1.6b",
    family="ssm",
    lm=LMConfig(
        name="rwkv6-1.6b",
        layers=24, d_model=2048, n_heads=32, n_kv_heads=32,  # heads = d/64
        d_ff=7168, vocab=65_536,
        rwkv=True, rwkv_head_size=64, attn="none", pos="none",
        mlp="relu_sq",
    ),
    source="arXiv:2404.05892",
    smoke_overrides={"rwkv_head_size": 16},
)
