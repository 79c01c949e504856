"""deepseek-v2-lite-16b — MLA (kv_lora=512) + MoE 64 routed top-6 + 2 shared.
First layer is dense (d_ff 10944); routed experts are 1408-wide.
[arXiv:2405.04434; hf-verified]"""
from repro_torch.configs.base import ArchSpec, full_attn_skips
from repro_torch.models.lm.config import LMConfig, MLAConfig, MoEConfig

ARCH = ArchSpec(
    id="deepseek-v2-lite-16b",
    family="moe",
    lm=LMConfig(
        name="deepseek-v2-lite-16b",
        layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab=102_400, head_dim=128,
        attn="mla", pos="rope", mlp="swiglu",
        mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128),
        moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408,
                      first_k_dense=1, dense_d_ff=10_944),
    ),
    skips=full_attn_skips(),
    source="arXiv:2405.04434",
    smoke_overrides={
        "moe": MoEConfig(n_experts=8, top_k=2, n_shared=1, d_expert=32,
                         first_k_dense=1, dense_d_ff=64, capacity_factor=4.0),
        "mla": MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                         qk_rope_head_dim=8, v_head_dim=16),
    },
)
