"""Port parity for flash attention: the port's ``flash_attention`` (its plain
version on the CPU) against the JAX package's ``full_attention``, its Pallas
kernel in interpret mode and its oracle ``flash_attention_ref``.  The CUDA
kernel itself is held against the plain version on a card by
tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention import flash_attention_ref as jax_flash_ref
from repro.models.lm.attention import full_attention as jax_full_attention
from repro_torch.kernels import flash_attention, flash_attention_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.models.lm.attention import full_attention

# tests/test_flash_attention.py's tolerances.
ATOL_F32, ATOL_BF16 = 5e-5, 3e-2


def _qkv(seed, b, s, h, kv, d, s_kv=None):
    rng = np.random.default_rng(seed)
    s_kv = s if s_kv is None else s_kv
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s_kv, kv, d), (b, s_kv, kv, d)))


def _t(*arrays, dtype=torch.float32):
    return tuple(torch.as_tensor(a).to(dtype) for a in arrays)


@pytest.mark.parametrize("b,s,h,kv,d,bq,bk", [  # tests/test_flash_attention.py's five
    (2, 256, 8, 4, 32, 64, 64),
    (1, 512, 4, 1, 64, 128, 128),   # MQA
    (2, 300, 6, 6, 16, 128, 64),    # ragged S
    (1, 128, 20, 20, 128, 128, 128),
    (2, 192, 8, 2, 32, 64, 96),
])
def test_flash_matches_jax_full_attention_and_pallas(b, s, h, kv, d, bq, bk):
    q, k, v = _qkv(0, b, s, h, kv, d)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    full = np.asarray(jax_full_attention(jq, jk, jv, causal=True))
    pallas = np.asarray(jax_flash_attention(jq, jk, jv, causal=True, use_pallas=True,
                                            block_q=bq, block_k=bk))
    before = fa_kernel.flash_attention.launches
    got = flash_attention(*_t(q, k, v), causal=True, use_pallas=True,
                          block_q=bq, block_k=bk).numpy()
    assert fa_kernel.flash_attention.launches == before  # a CPU tensor: plain version
    np.testing.assert_allclose(got, full, atol=ATOL_F32)
    np.testing.assert_allclose(got, pallas, atol=ATOL_F32)


def test_flash_bf16_matches_jax():
    q, k, v = _qkv(2, 1, 128, 4, 4, 32)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_full_attention(jq, jk, jv, causal=True), np.float32)
    pallas = np.asarray(jax_flash_attention(jq, jk, jv, causal=True, use_pallas=True,
                                            block_q=64, block_k=64), np.float32)
    got = flash_attention(*_t(q, k, v, dtype=torch.bfloat16), causal=True,
                          use_pallas=True, block_q=64, block_k=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=ATOL_BF16)
    np.testing.assert_allclose(got.float().numpy(), pallas, atol=ATOL_BF16)


@given(s=st.integers(16, 200), h=st.sampled_from([2, 4]),
       kv=st.sampled_from([1, 2]), d=st.sampled_from([8, 16, 24]))
@settings(max_examples=15, deadline=None)
def test_flash_property(s, h, kv, d):
    q, k, v = _qkv(s * 3 + h, 1, s, h, kv, d)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    got = flash_attention(*_t(q, k, v), causal=True, use_pallas=True).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_full_attention(jq, jk, jv, causal=True)),
                               atol=ATOL_F32)
    ref = jax_flash_ref(*(jnp.swapaxes(a, 1, 2) for a in (jq, jk, jv)), causal=True)
    np.testing.assert_allclose(got, np.asarray(jnp.swapaxes(ref, 1, 2)), atol=ATOL_F32)


@pytest.mark.parametrize("s", [100, 300])
def test_flash_non_causal_ragged_matches_jax_oracle(s):
    """Held against JAX's flash_attention_ref, never its Pallas kernel: with
    causal=False the Pallas kernel leaves its zero padding keys unmasked
    (S=100, block 64: max abs error 0.157; ROADMAP.md queue 3, non-causal
    ragged attention)."""
    q, k, v = _qkv(3, 2, s, 4, 2, 16)
    want = jax_flash_ref(*(jnp.swapaxes(jnp.asarray(a), 1, 2) for a in (q, k, v)),
                         causal=False)
    got = flash_attention(*_t(q, k, v), causal=False, use_pallas=True,
                          block_q=64, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.swapaxes(want, 1, 2)),
                               atol=ATOL_F32)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_unequal_lengths_match_jax_ref(causal):
    """Sq != Skv: both oracles align the causal mask at position 0."""
    q, k, v = _qkv(4, 2, 40, 4, 1, 16, s_kv=70)
    qt, kt, vt = (np.swapaxes(a, 1, 2) for a in (q, k, v))
    want = jax_flash_ref(*(jnp.asarray(a) for a in (qt, kt, vt)), causal=causal)
    got = flash_attention_ref(*_t(qt, kt, vt), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32)


def test_flash_matches_port_full_attention_and_impl_names():
    q, k, v = _t(*_qkv(5, 2, 64, 10, 1, 32))
    want = full_attention(q, k, v, causal=True)
    for impl in ("ref", "pallas"):
        torch.testing.assert_close(flash_attention(q, k, v, impl=impl), want,
                                   atol=ATOL_F32, rtol=0)
    with pytest.raises(ValueError, match="impl"):
        flash_attention(q, k, v, impl="triton")
    with pytest.raises(ValueError, match="equal query and key lengths"):
        flash_attention(q, k[:, :32], v[:, :32], use_pallas=True)


def test_flash_kernel_tile_limits():
    """The launcher's shared-memory arithmetic and tiles, per dtype.
    float32: 64 x 64 tiles fit head dim 256, 128 x 128 tiles do not, and
    tiles are square.  bfloat16: 64 x 64 only, 8 warps in two key groups.
    Two such blocks share an SM's 228 KB (1 KB reserved per block) up to
    head dim 128; at 256 one block fills it (one key group of 4 warps, two
    blocks an SM, measured slower: PERF.md)."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert fa_kernel.smem_bytes(64, 64, 256) == 148_992
    assert fa_kernel.fits(64, 64, 256) and fa_kernel.fits(128, 128, 128)
    assert not fa_kernel.fits(128, 64, 256) and not fa_kernel.fits(32, 64, 16)
    assert not fa_kernel.fits(128, 128, 256) and not fa_kernel.fits(96, 64, 64)
    assert fa_kernel.smem_bytes(32, 32, 8) == fa_kernel.smem_bytes(32, 32, 16)

    assert fa_kernel.smem_bytes(64, 64, 256, bf16) == 2 * (64 + 2 * 2 * 64) * 256 == 163_840
    assert fa_kernel.smem_bytes(64, 64, 120, bf16) == fa_kernel.smem_bytes(64, 64, 128, bf16)
    for d in (16, 33, 64, 120, 128, 256):
        assert fa_kernel.fits(64, 64, d, bf16)
        for tiles in ((32, 32), (128, 64), (64, 32), (128, 128), (64, 128)):
            assert not fa_kernel.fits(*tiles, d, bf16)
    sm_bytes, reserved = 233_472, 1_024
    assert 2 * (fa_kernel.smem_bytes(64, 64, 128, bf16) + reserved) <= sm_bytes
    assert 2 * (fa_kernel.smem_bytes(64, 64, 256, bf16) + reserved) > sm_bytes
    assert fa_kernel.fits(32, 32, 64, f32) and not fa_kernel.fits(32, 32, 64, bf16)
