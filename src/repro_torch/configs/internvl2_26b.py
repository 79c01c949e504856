"""internvl2-26b — VLM: InternViT frontend (STUB) + InternLM2-20B backbone.
Per assignment the modality frontend is a stub: ``input_specs`` provides
precomputed patch embeddings [B, n_prefix, d_model] prepended to the text.
[arXiv:2404.16821; hf-verified]"""
from repro_torch.configs.base import ArchSpec, full_attn_skips
from repro_torch.models.lm.config import LMConfig

ARCH = ArchSpec(
    id="internvl2-26b",
    family="vlm",
    lm=LMConfig(
        name="internvl2-26b",
        layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16_384, vocab=92_553, head_dim=128,
        attn="full", pos="rope", mlp="swiglu",
        frontend="patches", n_prefix=1024,  # 448px / 14 patch + thumbnails ~ 1024 tokens
        pad_vocab_to_multiple=16,  # 92553 -> 92560 so vocab shards over TP=16
    ),
    skips=full_attn_skips(),
    source="arXiv:2404.16821",
    smoke_overrides={"n_prefix": 8},
)
