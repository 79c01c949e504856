"""recurrentgemma-2b — Griffin hybrid: RG-LRU recurrent blocks + local
attention (window 2048), pattern rec,rec,attn (1 attn : 2 recurrent), MQA.
Runs long_500k: recurrent state + window cache are constant-size.
[arXiv:2402.19427; hf-verified]"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm.config import LMConfig

ARCH = ArchSpec(
    id="recurrentgemma-2b",
    family="hybrid",
    lm=LMConfig(
        name="recurrentgemma-2b",
        layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
        d_ff=7680, vocab=256_000, head_dim=256,
        block_pattern=("rec", "rec", "swa"), window=2048,
        lru_width=2560, conv1d_width=4,
        pos="rope", mlp="geglu",
    ),
    source="arXiv:2402.19427",
    smoke_overrides={"layers": 4, "lru_width": 64, "window": 16,
                     "n_kv_heads": 1, "head_dim": 16},
)
