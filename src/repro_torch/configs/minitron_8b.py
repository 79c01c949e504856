"""minitron-8b — width/depth-pruned nemotron dense decoder, GQA kv=8.
[arXiv:2407.14679; hf-verified]"""
from repro_torch.configs.base import ArchSpec, full_attn_skips
from repro_torch.models.lm.config import LMConfig

ARCH = ArchSpec(
    id="minitron-8b",
    family="dense",
    lm=LMConfig(
        name="minitron-8b",
        layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=16_384, vocab=256_000, head_dim=128,
        attn="full", pos="rope", mlp="relu_sq",  # nemotron uses squared ReLU
    ),
    skips=full_attn_skips(),
    source="arXiv:2407.14679",
)
