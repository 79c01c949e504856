"""grok-1-314b — MoE decoder: 8 experts, top-2, GQA kv=8.
[hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import ArchSpec, full_attn_skips
from repro_torch.models.lm.config import LMConfig, MoEConfig

ARCH = ArchSpec(
    id="grok-1-314b",
    family="moe",
    lm=LMConfig(
        name="grok-1-314b",
        layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=32_768, vocab=131_072, head_dim=128,
        attn="full", pos="rope", mlp="geglu",
        moe=MoEConfig(n_experts=8, top_k=2),
    ),
    skips=full_attn_skips(),
    source="hf:xai-org/grok-1",
    # capacity_factor = E/k makes the smoke config worst-case dropless so
    # prefill/decode parity tests are exact (production keeps 1.25).
    smoke_overrides={"moe": MoEConfig(n_experts=4, top_k=2, capacity_factor=2.0)},
)
