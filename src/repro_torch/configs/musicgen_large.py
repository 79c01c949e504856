"""musicgen-large — decoder-only over EnCodec tokens (frontend STUB: the
EnCodec tokenizer is upstream; ``input_specs`` provides token streams).
MHA (kv == heads), learned absolute positions.
[arXiv:2306.05284; hf-verified]"""
from repro_torch.configs.base import ArchSpec, full_attn_skips
from repro_torch.models.lm.config import LMConfig

ARCH = ArchSpec(
    id="musicgen-large",
    family="audio",
    lm=LMConfig(
        name="musicgen-large",
        layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=2048, head_dim=64,
        attn="full", pos="learned", mlp="gelu",
        frontend="frames", max_seq_len=32_768,
    ),
    skips=full_attn_skips(),
    source="arXiv:2306.05284",
)
