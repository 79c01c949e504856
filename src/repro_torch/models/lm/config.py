"""Model-level configuration for the LM backbone (10 assigned architectures).

One ``LMConfig`` describes any of: dense GQA/MQA decoders (qwen/minitron/
granite/danube/internvl backbone), MoE decoders (grok, deepseek-v2-lite w/
MLA), audio-token decoders (musicgen), hybrid recurrent (recurrentgemma
RG-LRU 1:2) and attention-free SSM (rwkv6).
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_expert: int | None = None  # expert FFN width (defaults to d_ff)
    first_k_dense: int = 0  # leading dense layers (deepseek)
    dense_d_ff: int | None = None  # width of those dense layers
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    aux_loss_coef: float = 0.01
    # DeepSeek-V2's routing; the defaults are the JAX package's
    norm_topk_prob: bool = True  # renormalise the top-k weights to sum to 1
    routed_scaling_factor: float = 1.0  # times the top-k weights
    seq_aux: bool = False  # balance loss per sequence (else Switch-style, all tokens)
    dropless: bool = False  # every assignment computed (else capacity_factor drops)


@dataclasses.dataclass(frozen=True)
class YaRNConfig:
    """YaRN rope scaling as DeepSeek-V2 publishes it (``rope_scaling``,
    ``type: yarn``): frequencies blended between extrapolated and
    ``factor``-interpolated by a linear ramp over the pair indices that
    ``beta_fast`` and ``beta_slow`` rotations bound at
    ``original_max_position_embeddings``; the softmax scale gains
    ``mscale(factor, mscale_all_dim) ** 2``, and cos/sin the ratio
    ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``."""

    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    qkv_bias: bool = False  # qwen1.5
    attn: Literal["full", "swa", "mla", "none"] = "full"
    window: int | None = None  # swa / recurrentgemma local-attn window
    pos: Literal["rope", "learned", "none"] = "rope"
    rope_theta: float = 10_000.0
    rope_scaling: YaRNConfig | None = None  # None: plain rope
    max_seq_len: int = 8192  # learned-pos table size / cache default
    mlp: Literal["swiglu", "geglu", "gelu", "relu_sq"] = "swiglu"
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    # hybrid/ssm families
    block_pattern: tuple[str, ...] | None = None  # e.g. ("rec","rec","attn")
    lru_width: int | None = None  # RG-LRU state width
    conv1d_width: int = 4  # Griffin temporal conv
    rwkv: bool = False
    rwkv_head_size: int = 64
    # frontend stubs
    frontend: Literal["tokens", "patches", "frames"] = "tokens"
    n_prefix: int = 0  # precomputed patch/frame embeddings prepended
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # numerics
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    # kernels
    use_pallas_scan: bool = False  # route RG-LRU through kernels/linear_scan
    # sharding: pad the embedding/logit tables so vocab divides the TP axis
    # (standard practice; padded ids are masked to -inf in logits_fn)
    pad_vocab_to_multiple: int = 0
    # blockwise-attention tile shape (perf knob; see EXPERIMENTS.md §Perf)
    q_chunk: int = 512
    kv_chunk: int = 512

    def __post_init__(self):
        if self.attn != "none" and self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: n_heads {self.n_heads} not divisible by kv {self.n_kv_heads}")

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_to_multiple
        return self.vocab if not m else -(-self.vocab // m) * m

    def block_types(self) -> tuple[str, ...]:
        """Per-layer block kind: attn | swa | mla | rec | rwkv."""
        if self.rwkv:
            return ("rwkv",) * self.layers
        if self.block_pattern is not None:
            pat = self.block_pattern
            return tuple(pat[i % len(pat)] for i in range(self.layers))
        return (self.attn,) * self.layers

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline and memory budgets)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total = emb
        for kind in self.block_types():
            total += 2 * d  # two RMSNorm gains
            if kind in ("attn", "full", "swa"):
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                total += q + kv + o
                if self.qkv_bias:
                    total += (self.n_heads + 2 * self.n_kv_heads) * hd
            elif kind == "mla":
                m = self.mla
                qd = self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                total += d * qd  # W_q
                total += d * (m.kv_lora_rank + m.qk_rope_head_dim)  # W_dkv
                total += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                total += self.n_heads * m.v_head_dim * d  # W_o
            elif kind == "rec":
                w = self.lru_width or d
                total += 2 * d * w + w * d  # in-proj x2 + out-proj
                total += self.conv1d_width * w + w  # conv1d
                total += 2 * w + 2 * w * max(w // 16, 8)  # RG-LRU gates (lora-ish)
            elif kind == "rwkv":
                total += 6 * d * d // 1  # r,k,v,g,o,w projections (approx)
                total += 2 * d * self.d_ff  # channel mix
                continue  # rwkv has its own ffn accounted above
            # FFN
            if self.moe is not None and kind not in ("rec",):
                continue  # counted below per-layer via moe block
            mult = 3 if self.mlp in ("swiglu", "geglu") else 2
            total += mult * d * self.d_ff
        if self.moe is not None:
            de = self.moe.d_expert or self.d_ff
            mult = 3 if self.mlp in ("swiglu", "geglu") else 2
            n_moe = self.layers - self.moe.first_k_dense
            total += n_moe * (self.moe.n_experts + self.moe.n_shared) * mult * d * de
            total += n_moe * d * self.moe.n_experts  # router
            dff = self.moe.dense_d_ff or self.d_ff
            total += self.moe.first_k_dense * mult * d * dff
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k) for 6·N_active·D."""
        if self.moe is None:
            return self.param_count()
        de = self.moe.d_expert or self.d_ff
        mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        n_moe = self.layers - self.moe.first_k_dense
        inactive = n_moe * (self.moe.n_experts - self.moe.top_k) * mult * self.d_model * de
        return self.param_count() - inactive
