"""qwen1.5-4b — dense decoder, MHA (kv == heads), QKV bias.
[hf:Qwen/Qwen1.5-0.5B family scaled per assignment; hf-verified]"""
from repro_torch.configs.base import ArchSpec, full_attn_skips
from repro_torch.models.lm.config import LMConfig

ARCH = ArchSpec(
    id="qwen1.5-4b",
    family="dense",
    lm=LMConfig(
        name="qwen1.5-4b",
        layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
        d_ff=6912, vocab=151_936, head_dim=128,
        qkv_bias=True, attn="full", pos="rope", mlp="swiglu",
    ),
    skips=full_attn_skips(),
    source="hf:Qwen/Qwen1.5-0.5B",
)
