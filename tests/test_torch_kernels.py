"""Port parity for the two kernel modules of the ST-GNN path.

On the CPU the port's wrappers run each kernel's plain PyTorch version; the
JAX side runs its oracles and its Pallas kernels in interpret mode.  The
CUDA kernels themselves are held against those plain versions on a card by
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.batching import gather_batch as jax_gather_batch
from repro.kernels.diffusion_conv import diffusion_conv as jax_diffusion_conv
from repro.kernels.diffusion_conv import diffusion_conv_ref as jax_diffusion_conv_ref
from repro.kernels.diffusion_conv.kernel import hop_project as jax_hop_project
from repro.kernels.window_gather import window_gather as jax_window_gather
from repro.kernels.window_gather import window_gather_ref as jax_window_gather_ref
from repro_torch.kernels.common import kernel_defaults
from repro_torch.kernels.diffusion_conv import diffusion_conv, diffusion_conv_ref
from repro_torch.kernels.diffusion_conv.kernel import hop_project, hop_project_plain
from repro_torch.kernels.window_gather import window_gather
from repro_torch.kernels.window_gather import kernel as wg_kernel
from repro_torch.pipeline.gathers import GATHERS, resolve_gather

# The float tolerance of tests/test_kernels.py's diffusion-conv sweep.
ATOL, RTOL = 2e-4, 1e-4

GATHER_SHAPES = [  # tests/test_kernels.py's window_gather cases
    (64, (24, 2), 6, 8, np.float32),
    (100, (13,), 5, 4, np.float32),
    (50, (), 7, 3, np.float32),
    (256, (128,), 24, 16, np.float32),
    (64, (7, 3), 4, 2, np.int32),
    (40, (130,), 3, 5, np.float32),  # trailing dim not lane-aligned
]


def _series(rng, t, trail, dtype):
    if np.issubdtype(dtype, np.integer):
        return rng.integers(0, 100, size=(t,) + trail).astype(dtype)
    return rng.standard_normal((t,) + trail).astype(dtype)


def _supports(rng, n):
    adj = rng.uniform(0, 1, (n, n)).astype(np.float32)
    adj[adj < 0.5] = 0
    np.fill_diagonal(adj, 1.0)
    return (adj / adj.sum(1, keepdims=True),
            adj.T / adj.T.sum(1, keepdims=True))


# ------------------------------------------------------------- window_gather
@pytest.mark.parametrize("t,trail,span,b,dtype", GATHER_SHAPES)
def test_window_gather_matches_jax_ref_and_pallas(t, trail, span, b, dtype):
    rng = np.random.default_rng(0)
    series = _series(rng, t, trail, dtype)
    starts = rng.integers(0, t - span + 1, size=b).astype(np.int32)
    ref = np.asarray(jax_window_gather_ref(jnp.asarray(series), jnp.asarray(starts),
                                           span=span))
    pal = np.asarray(jax_window_gather(jnp.asarray(series), jnp.asarray(starts),
                                       span=span, use_pallas=True))
    for use_pallas in (False, True):
        got = window_gather(torch.as_tensor(series), torch.as_tensor(starts),
                            span=span, use_pallas=use_pallas).numpy()
        assert got.dtype == ref.dtype
        assert np.array_equal(got, ref) and np.array_equal(got, pal)


def test_window_gather_out_of_range_starts_follow_jax_ref():
    """Held to the JAX oracle only: the JAX Pallas gather does not clamp.
    ``dynamic_slice`` wraps a negative start once (s + T), then clamps it to
    [0, T - span]."""
    series = np.arange(60, dtype=np.float32).reshape(20, 3)
    starts = np.array([17, 25, -3, 0, 15, 16, 2**31 - 1, -2**31], np.int32)
    ref = np.asarray(jax_window_gather_ref(jnp.asarray(series), jnp.asarray(starts),
                                           span=5))
    for use_pallas in (False, True):
        got = window_gather(torch.as_tensor(series), torch.as_tensor(starts),
                            span=5, use_pallas=use_pallas).numpy()
        assert np.array_equal(got, ref)
    assert list(got[:, 0, 0]) == [45.0, 45.0, 45.0, 0.0, 45.0, 45.0, 45.0, 0.0]


def test_window_gather_cpu_counts_no_launch():
    before = wg_kernel.window_gather.launches
    series = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    window_gather(series, torch.tensor([0, 3], dtype=torch.int32), span=4,
                  use_pallas=True)
    assert wg_kernel.window_gather.launches == before


@pytest.mark.parametrize("name", sorted(GATHERS))
def test_every_gather_matches_jax_gather_batch(name):
    rng = np.random.default_rng(4)
    series = rng.standard_normal((90, 7, 2)).astype(np.float32)
    starts = rng.integers(0, 90 - 10 + 1, size=6).astype(np.int32)
    jx, jy = jax_gather_batch(jnp.asarray(series), jnp.asarray(starts),
                              input_len=4, horizon=6)
    tx, ty = resolve_gather(name)(torch.as_tensor(series), torch.as_tensor(starts),
                                  input_len=4, horizon=6)
    assert np.array_equal(tx.numpy(), np.asarray(jx))
    assert np.array_equal(ty.numpy(), np.asarray(jy))


def test_gathers_not_ported_yet_raise():
    for name in ("auto", "lm"):
        with pytest.raises(NotImplementedError):
            resolve_gather(name)
    with pytest.raises(ValueError):
        resolve_gather("nope")


def test_kernel_defaults_rows():
    assert kernel_defaults("cuda").kernel and not kernel_defaults("cpu").kernel
    assert kernel_defaults(torch.device("cuda", 0)) is kernel_defaults("cuda")
    with pytest.raises(ValueError):
        kernel_defaults("meta")


# ------------------------------------------------------------ diffusion_conv
@pytest.mark.parametrize("n,b,c,h,block", [(24, 2, 10, 8, 8), (16, 3, 66, 12, 16),
                                            (128, 4, 16, 32, 128)])
def test_hop_project_matches_jax_pallas_interpret(n, b, c, h, block):
    rng = np.random.default_rng(7)
    s = _supports(rng, n)[0]
    z = rng.standard_normal((n, b, c)).astype(np.float32)
    w = (rng.standard_normal((c, h)) * 0.1).astype(np.float32)
    y = rng.standard_normal((n, b, h)).astype(np.float32)
    jz, jy = jax_hop_project(jnp.asarray(s), jnp.asarray(z), jnp.asarray(w),
                             jnp.asarray(y), block_n=block, interpret=True)
    tz, ty = hop_project(*(torch.as_tensor(a) for a in (s, z, w, y)))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,n,c,h,k,block", [
    (2, 24, 10, 8, 2, 8),
    (1, 16, 4, 4, 1, 16),
    (4, 50, 6, 12, 3, 16),  # N not a multiple of the JAX block: its padding path
    (3, 128, 16, 32, 2, 128),
])
def test_diffusion_conv_matches_jax(b, n, c, h, k, block):
    rng = np.random.default_rng(5)
    sup = _supports(rng, n)
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    w = (rng.standard_normal(((1 + 2 * k) * c, h)) * 0.1).astype(np.float32)
    bias = rng.standard_normal((h,)).astype(np.float32)
    jref = np.asarray(jax_diffusion_conv_ref(jnp.asarray(x), tuple(map(jnp.asarray, sup)),
                                             jnp.asarray(w), jnp.asarray(bias), k_hops=k))
    jpal = np.asarray(jax_diffusion_conv(jnp.asarray(x), tuple(map(jnp.asarray, sup)),
                                         jnp.asarray(w), jnp.asarray(bias), k_hops=k,
                                         use_pallas=True, block_n=block))
    tsup = tuple(torch.as_tensor(s) for s in sup)
    args = (torch.as_tensor(x), tsup, torch.as_tensor(w), torch.as_tensor(bias))
    for use_pallas in (False, True):
        got = diffusion_conv(*args, k_hops=k, use_pallas=use_pallas).numpy()
        np.testing.assert_allclose(got, jref, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got, jpal, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(diffusion_conv_ref(*args, k_hops=k).numpy(), jref,
                               atol=ATOL, rtol=RTOL)


def test_diffusion_conv_kernel_path_refuses_gradients():
    rng = np.random.default_rng(3)
    sup = tuple(torch.as_tensor(s) for s in _supports(rng, 8))
    x = torch.randn(2, 8, 3)
    w = torch.randn(15, 4, requires_grad=True)
    b = torch.zeros(4)
    with pytest.raises(NotImplementedError, match="no backward"):
        diffusion_conv(x, sup, w, b, k_hops=2, use_pallas=True)
    with torch.no_grad():
        out = diffusion_conv(x, sup, w, b, k_hops=2, use_pallas=True)
    assert out.shape == (2, 8, 4)
    diffusion_conv(x, sup, w, b, k_hops=2).sum().backward()  # plain path trains
    assert w.grad is not None and torch.isfinite(w.grad).all()
