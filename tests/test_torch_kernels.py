"""Port parity for the kernel modules: the ST-GNN path's two and the RG-LRU's
linear scan.

On the CPU the port's wrappers run each kernel's plain PyTorch version; the
JAX side runs its oracles and its Pallas kernels in interpret mode.  The
CUDA kernels themselves are held against those plain versions on a card by
tests/test_torch_cuda.py.
"""
import functools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.batching import gather_batch as jax_gather_batch
from repro.kernels.diffusion_conv import diffusion_conv as jax_diffusion_conv
from repro.kernels.diffusion_conv import diffusion_conv_ref as jax_diffusion_conv_ref
from repro.kernels.diffusion_conv.kernel import hop_project as jax_hop_project
from repro.kernels.linear_scan import linear_scan as jax_linear_scan
from repro.kernels.linear_scan import linear_scan_ref as jax_linear_scan_ref
from repro.kernels.window_gather import window_gather as jax_window_gather
from repro.kernels.window_gather import window_gather_ref as jax_window_gather_ref
from repro_torch.kernels.common import kernel_defaults
from repro_torch.kernels.diffusion_conv import diffusion_conv, diffusion_conv_ref
from repro_torch.kernels.diffusion_conv import kernel as dc_kernel
from repro_torch.kernels.diffusion_conv.kernel import hop_project, hop_project_plain
from repro_torch.kernels.linear_scan import kernel as ls_kernel
from repro_torch.kernels.linear_scan import linear_scan
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


# "lm" has another contract (y = shift(x), token streams), as the JAX
# package's tests/test_pipeline.py excludes it; tests/test_torch_lm_train.py
# holds it to lm_window_batch
@pytest.mark.parametrize("name", sorted(n for n in GATHERS if n != "lm"))
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
    """Every gather of the JAX package resolves, ``lm`` included; an
    unknown name raises."""
    assert resolve_gather("lm") is GATHERS["lm"]
    with pytest.raises(ValueError):
        resolve_gather("nope")


def test_kernel_defaults_rows():
    assert kernel_defaults("cuda").kernel and not kernel_defaults("cpu").kernel
    assert kernel_defaults(torch.device("cuda", 0)) is kernel_defaults("cuda")
    with pytest.raises(ValueError):
        kernel_defaults("meta")


def test_flash_tiles_and_hop_rows_are_per_dtype_and_compiled():
    """The card's default flash tile is compiled for both dtypes, the tuner
    offers each dtype only its kernel's tiles, and the hop kernel's row
    tile is fixed in its source (one launch shape)."""
    from repro_torch.kernels.autotune import _OPS, _fa_grid
    from repro_torch.kernels.flash_attention.kernel import BF16_BLOCK, BLOCKS

    kd = kernel_defaults("cuda")
    assert kd.block_q == kd.block_k and kd.block_q in BLOCKS
    assert kd.block_q == BF16_BLOCK
    dims = {"b": 2, "s": 512, "h": 16, "hkv": 1, "d": 256}
    assert _fa_grid(dims, kd, torch.bfloat16) == ({"block_q": 64, "block_k": 64},)
    assert {p["block_q"] for p in _fa_grid(dims, kd, torch.float32)} == {32, 64}
    (hop,) = [v for v in _OPS["diffusion_conv"].variants() if v.kernel]
    # one launch shape at every C: above MAX_C the columns run as tiles
    assert hop.grid({"c": 128}, kd, torch.float32) == ({},)
    assert hop.grid({"c": 256}, kd, torch.float32) == ({},)


def test_library_digest_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edit to a csrc/*.cuh header renames every library, so each source
    that includes it is rebuilt."""
    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build._CSRC, csrc)
    monkeypatch.setattr(build, "_CSRC", csrc)
    before = {name: build.library_path(name) for name in build.SOURCES}
    (csrc / "window_gather.cu").write_text((csrc / "window_gather.cu").read_text() + "\n")
    assert build.library_path("window_gather") != before["window_gather"]
    assert build.library_path("hop_project") == before["hop_project"]
    header = csrc / "mma.cuh"
    header.write_text(header.read_text() + "// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    assert all(after[name] != before[name] for name in build.SOURCES)
    assert all(path.parent == before[name].parent for name, path in after.items())


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


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 (10 mantissa bits), to nearest with ties away from
    zero, as cvt.rna.tf32.f32 and the hop kernel's integer rounding give."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_matmul(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b as the tensor cores compute it from TF32 operands, float32
    accumulation: one product of the rounded operands, or the 3xTF32 sum
    a_lo·b_hi + a_hi·b_lo + a_hi·b_hi.  A product of two TF32 values is exact
    in float32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if terms == 1:
        return a_hi @ b_hi
    return (_tf32(a - a_hi) @ b_hi + a_hi @ _tf32(b - b_hi)) + a_hi @ b_hi


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 1 + 3 * 2**-11, 3.0])
    assert _tf32(x).tolist() == [1 + 2**-10, -(1 + 2**-10), 1.0, 1 + 2**-9, 3.0]


def test_3xtf32_hop_keeps_fp32_tolerance_and_one_tf32_product_does_not():
    """The hop kernel's precision design, emulated: at N 512, B 4, C 66,
    H 128 on a random-walk support, the 3xTF32 hop and projection stay
    within atol = rtol = 1e-4 of float64; one TF32 product per fp32 product
    does not."""
    rng = np.random.default_rng(11)
    n, b, c, h = 512, 4, 66, 128
    s = torch.as_tensor(_supports(rng, n)[0])
    z = torch.as_tensor(rng.standard_normal((n, b, c)).astype(np.float32))
    w = torch.as_tensor((rng.standard_normal((c, h)) / np.sqrt(c)).astype(np.float32))
    y = torch.as_tensor(rng.standard_normal((n, b, h)).astype(np.float32))
    z64 = (s.double() @ z.double().reshape(n, b * c)).reshape(n, b, c)
    y64 = y.double() + z64 @ w.double()

    def run(terms):
        zt = _tf32_matmul(s, z.reshape(n, b * c), terms).reshape(n, b, c)
        yt = y + _tf32_matmul(zt.reshape(n * b, c), w, terms).reshape(n, b, h)
        return [(got.double() - want).abs() for got, want in ((zt, z64), (yt, y64))], \
            [1e-4 + 1e-4 * want.abs() for want in (z64, y64)]

    errs3, tols = run(3)
    errs1, _ = run(1)
    assert all(bool((e <= tol).all()) for e, tol in zip(errs3, tols))
    assert not all(bool((e <= tol).all()) for e, tol in zip(errs1, tols))
    for e3, e1 in zip(errs3, errs1):
        assert float(e3.max()) * 100 < float(e1.max())


def _spy_hop_gemm(monkeypatch):
    """Record the direction of every ``hop_gemm`` call the kernel path makes
    (a CPU tensor takes the plain version and counts no launch)."""
    calls = []
    real = dc_kernel.hop_gemm

    def spy(s, z, *, transpose=False):
        calls.append("bwd" if transpose else "fwd")
        return real(s, z, transpose=transpose)

    monkeypatch.setattr(dc_kernel, "hop_gemm", spy)
    return calls


def test_diffusion_conv_kernel_path_refuses_gradients(monkeypatch):
    """Gradients through ``use_pallas=True`` no longer raise: they run each
    hop through the differentiable ``hop`` (forward and backward) and match
    the plain oracle, and the no-grad path still runs ``hop_project`` alone."""
    rng = np.random.default_rng(3)
    sup = tuple(torch.as_tensor(s) for s in _supports(rng, 8))
    x = torch.randn(2, 8, 3)
    w = torch.randn(15, 4, requires_grad=True)
    b = torch.zeros(4)
    calls = _spy_hop_gemm(monkeypatch)
    out = diffusion_conv(x, sup, w, b, k_hops=2, use_pallas=True)
    out.sum().backward()
    # x takes no gradient, so no hop runs backward
    assert calls == ["fwd"] * 4
    dw = w.grad.clone()
    w.grad = None
    diffusion_conv_ref(x, sup, w, b, k_hops=2).sum().backward()
    torch.testing.assert_close(dw, w.grad, atol=1e-5, rtol=1e-5)
    calls.clear()
    with torch.no_grad():
        out = diffusion_conv(x, sup, w, b, k_hops=2, use_pallas=True)
    assert out.shape == (2, 8, 4) and calls == []


@pytest.mark.parametrize("n_sup", [1, 2])
@pytest.mark.parametrize("c", [65, 66, 128])
@pytest.mark.parametrize("x_grad", [True, False])
def test_diffusion_conv_kernel_path_trains_as_the_oracle(monkeypatch, c, n_sup, x_grad):
    """``diffusion_conv(use_pallas=True)`` with gradients against
    ``diffusion_conv_ref``'s autograd: output, dx, dw and db; a hop runs
    backward only where its input takes a gradient."""
    rng = np.random.default_rng(c + n_sup)
    n, bsz, h, k = 24, 3, 16, 2
    sup = tuple(torch.as_tensor(s) for s in _supports(rng, n)[:n_sup])
    x = torch.as_tensor(rng.standard_normal((bsz, n, c)).astype(np.float32))
    w = torch.as_tensor((rng.standard_normal(((1 + n_sup * k) * c, h))
                         / np.sqrt(c)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal(h).astype(np.float32))
    g = torch.as_tensor(rng.standard_normal((bsz, n, h)).astype(np.float32))
    calls = _spy_hop_gemm(monkeypatch)
    got, want = [], []
    for fn, into in ((functools.partial(diffusion_conv, use_pallas=True), got),
                     (diffusion_conv_ref, want)):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        if not x_grad:
            leaves[0].requires_grad_(False)
        out = fn(leaves[0], sup, *leaves[1:], k_hops=k)
        into.append(out)
        into.extend(torch.autograd.grad(out, [t for t in leaves if t.requires_grad], g))
    hops = n_sup * k
    assert calls == ["fwd"] * hops + (["bwd"] * hops if x_grad else [])
    assert len(got) == len(want) == (4 if x_grad else 3)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("transpose", [False, True])
def test_hop_plain_version_and_its_backward(transpose):
    """``hop_gemm_plain`` is ``S @ Z`` (``Sᵀ @ Z``) over [N, B, C] in any
    strides, and ``hop``'s backward is ``Sᵀ @ G`` in float64."""
    rng = np.random.default_rng(4)
    n, bsz, c = 19, 3, 5
    s = torch.as_tensor(_supports(rng, n)[0]).double()
    x = torch.as_tensor(rng.standard_normal((bsz, n, c))).double()
    z = x.transpose(0, 1)  # the strided view the first hop reads
    a = s.T if transpose else s
    want = torch.einsum("mn,nbc->mbc", a, z)
    torch.testing.assert_close(dc_kernel.hop_gemm_plain(s, z, transpose=transpose), want)
    if transpose:
        return
    zg = z.detach().clone().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda t: dc_kernel.hop(s, t), (zg,))
    with pytest.raises(NotImplementedError, match="supports take no gradient"):
        dc_kernel.hop(s.clone().requires_grad_(True), zg)


@pytest.mark.parametrize("arch", ["dcrnn", "pgt_dcrnn"])
def test_train_step_runs_its_hops_through_hop_gemm(monkeypatch, arch):
    """A train step at the models' default ``use_pallas`` runs every hop
    through ``hop_gemm`` forward: time steps x layers x 2 dconvs x 2
    supports x K.  All but the first cell's gate hops run backward: that
    cell's input (the data beside a zero state) takes no gradient.  These
    are the counts chip_smoke.py's ``train_hops`` holds the card to."""
    from repro_torch.models import dcrnn, pgt_dcrnn
    from repro_torch.tree import tree_leaves

    rng = np.random.default_rng(7)
    n, bsz, k = 6, 2, 2
    if arch == "dcrnn":
        mod, cfg = dcrnn, dcrnn.DCRNNConfig(num_nodes=n, hidden=4, layers=2,
                                            max_diffusion_step=k, input_len=3, horizon=2)
        steps, layers, y_len = cfg.input_len + cfg.horizon, cfg.layers, cfg.horizon
    else:
        mod, cfg = pgt_dcrnn, pgt_dcrnn.PGTDCRNNConfig(num_nodes=n, hidden=4,
                                                       max_diffusion_step=k, input_len=3,
                                                       horizon=3)
        steps, layers, y_len = cfg.input_len, 1, cfg.input_len
    assert cfg.use_pallas
    params = mod.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    sup = tuple(torch.as_tensor(s) for s in _supports(rng, n))
    x = torch.as_tensor(rng.standard_normal((bsz, cfg.input_len, n, 2)).astype(np.float32))
    y = torch.as_tensor(rng.standard_normal((bsz, y_len, n, 2)).astype(np.float32))
    calls = _spy_hop_gemm(monkeypatch)
    mod.loss_fn(params, cfg, sup, x, y).backward()
    per_step = steps * layers * 2 * 2 * k
    assert (calls.count("fwd"), calls.count("bwd")) == (per_step, per_step - 2 * k)


# --------------------------------------------------------------- linear_scan
# tests/test_kernels.py's linear_scan cases and tolerance: a float32 carry
# through S steps in both packages.
SCAN_ATOL = 1e-5


def _scan_inputs(rng, b, s, d, decay=None):
    a = (np.full((b, s, d), decay, np.float32) if decay is not None
         else rng.uniform(0.7, 1.0, (b, s, d)).astype(np.float32))
    bb = rng.standard_normal((b, s, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    return a, bb, h0


@pytest.mark.parametrize("b,s,d,chunk", [
    (8, 64, 128, 32), (2, 37, 33, 16), (1, 5, 256, 8), (16, 512, 128, 256),
    (4, 128, 64, 128),
])
def test_linear_scan_matches_jax_ref_and_pallas(b, s, d, chunk):
    a, bb, h0 = _scan_inputs(np.random.default_rng(1), b, s, d)
    ja, jb, jh = jnp.asarray(a), jnp.asarray(bb), jnp.asarray(h0)
    r_seq, r_last = jax_linear_scan_ref(ja, jb, jh)
    p_seq, p_last = jax_linear_scan(ja, jb, jh, use_pallas=True, chunk=chunk)
    for use_pallas in (False, True):
        t_seq, t_last = linear_scan(torch.as_tensor(a), torch.as_tensor(bb),
                                    torch.as_tensor(h0), use_pallas=use_pallas)
        for want in (r_seq, p_seq):
            np.testing.assert_allclose(t_seq.numpy(), np.asarray(want), atol=SCAN_ATOL)
        for want in (r_last, p_last):
            np.testing.assert_allclose(t_last.numpy(), np.asarray(want), atol=SCAN_ATOL)


@pytest.mark.parametrize("decay", [0.0, 1.0, 0.5])
@pytest.mark.parametrize("b,s,d", [(3, 1, 33), (2, 100, 8), (5, 17, 128)])
def test_linear_scan_decays_match_jax_pallas(b, s, d, decay):
    """Decay 0 (h_t = b_t), 1 (a running sum) and between, at S = 1 and
    ragged S and D, from ``h0=None`` (zeros)."""
    a, bb, _ = _scan_inputs(np.random.default_rng(b * 7 + s), b, s, d, decay)
    ja, jb = jnp.asarray(a), jnp.asarray(bb)
    r_seq, r_last = jax_linear_scan_ref(ja, jb, jnp.zeros((b, d)))
    p_seq, p_last = jax_linear_scan(ja, jb, None, use_pallas=True, chunk=32)
    t_seq, t_last = linear_scan(torch.as_tensor(a), torch.as_tensor(bb),
                                use_pallas=True)
    for want in (r_seq, p_seq):
        np.testing.assert_allclose(t_seq.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_allclose(t_last.numpy(), np.asarray(p_last), atol=1e-4,
                               rtol=1e-4)
    if decay == 0.0:
        assert np.array_equal(t_seq.numpy(), bb)


def test_linear_scan_identity_decay_is_cumsum():
    b, s, d = 2, 20, 8
    bb = np.random.default_rng(0).standard_normal((b, s, d)).astype(np.float32)
    jseq, _ = jax_linear_scan(jnp.ones((b, s, d)), jnp.asarray(bb), None,
                              use_pallas=True, chunk=5)
    seq, last = linear_scan(torch.ones(b, s, d), torch.as_tensor(bb),
                            use_pallas=True)
    np.testing.assert_allclose(seq.numpy(), np.cumsum(bb, axis=1), atol=SCAN_ATOL)
    np.testing.assert_allclose(seq.numpy(), np.asarray(jseq), atol=SCAN_ATOL)
    assert torch.equal(last, seq[:, -1])


def test_linear_scan_dtypes_and_cpu_counts_no_launch():
    """h_seq in a's dtype, h_last in h0's (a's without h0), and the float32
    carry under bfloat16 inputs; a CPU tensor launches nothing."""
    rng = np.random.default_rng(2)
    a, bb, h0 = (torch.as_tensor(x) for x in _scan_inputs(rng, 2, 9, 5))
    before = ls_kernel.linear_scan.launches
    seq, last = linear_scan(a.bfloat16(), bb.bfloat16(), h0, use_pallas=True)
    assert seq.dtype == torch.bfloat16 and last.dtype == torch.float32
    assert linear_scan(a, bb, use_pallas=True)[1].dtype == torch.float32
    assert ls_kernel.linear_scan.launches == before
    h = h0.clone()
    for t in range(9):  # the float32 carry, rounded to bf16 only on output
        h = a[:, t].bfloat16().float() * h + bb[:, t].bfloat16().float()
        assert torch.equal(seq[:, t], h.bfloat16())
    assert torch.equal(last, h)


# ------------------------------------------------- forward-only kernel paths
def _flash_inputs(requires_grad):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(1, 8, 2, 16, generator=g).requires_grad_(requires_grad)
            for _ in range(3)]


def test_linear_scan_kernel_path_refuses_gradients_as_jax_does():
    """``use_pallas=True`` is forward-only in both packages: ``jax.grad``
    through the Pallas scan fails its assert, the port raises
    ``NotImplementedError`` on the CPU as on the card, before the kernel
    wrapper; under ``no_grad`` (serving) it runs, and the plain path trains."""
    import jax

    rng = np.random.default_rng(4)
    a, bb, h0 = _scan_inputs(rng, 2, 6, 8)
    with pytest.raises(AssertionError):
        jax.grad(lambda x: jax_linear_scan(jnp.asarray(a), x, jnp.asarray(h0),
                                           use_pallas=True)[0].sum())(jnp.asarray(bb))
    ta, th0 = torch.as_tensor(a), torch.as_tensor(h0)
    tb = torch.as_tensor(bb).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        linear_scan(ta, tb, th0, use_pallas=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        linear_scan(ta, tb, th0, impl="pallas")
    with torch.no_grad():
        seq, _ = linear_scan(ta, tb, th0, use_pallas=True)
    linear_scan(ta, tb, th0)[0].sum().backward()
    assert torch.equal(seq, linear_scan(ta, tb.detach(), th0, use_pallas=True)[0])
    assert tb.grad is not None and float(tb.grad.abs().sum()) > 0


def test_flash_attention_kernel_path_refuses_gradients():
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = _flash_inputs(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_attention(q, k, v, use_pallas=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_attention(q, k.detach(), v.detach(), impl="pallas")
    with torch.no_grad():
        out = flash_attention(q, k, v, use_pallas=True)
    assert out.shape == q.shape
    flash_attention(q, k, v).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


@pytest.mark.parametrize("use_pallas_scan", [True, False])
def test_recurrentgemma_loss_through_the_kernel_scan_raises(use_pallas_scan):
    """An LM step with ``use_pallas_scan=True`` cannot quietly give the
    RG-LRU's weights upstream of the scan a zero gradient: the loss raises.
    The plain scan trains them."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.lm import model as tm
    from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

    cfg = dataclasses.replace(get_arch("recurrentgemma-2b").smoke_config(),
                              use_pallas_scan=use_pallas_scan)
    params = tm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1))
    if use_pallas_scan:
        with pytest.raises(NotImplementedError, match="no backward"):
            tm.loss_fn(tree_unflatten(params, leaves), cfg, toks, toks)
        with torch.no_grad():
            loss, _ = tm.loss_fn(params, cfg, toks, toks)
        assert torch.isfinite(loss)
        return
    loss, _ = tm.loss_fn(tree_unflatten(params, leaves), cfg, toks, toks)
    grads = dict(zip(tree_paths(params), torch.autograd.grad(loss, leaves)))
    assert float(grads["stages/0/sub0/rec/wx/w"].abs().sum()) > 0
    assert float(grads["stages/0/sub0/rec/in_x/w"].abs().sum()) > 0
