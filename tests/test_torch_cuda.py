"""The hand-written CUDA kernels against their plain PyTorch versions, on a
card.  Every test here is marked ``cuda`` and skips without a card (a CUDA
kernel has no CPU mode).  The file imports neither JAX nor the JAX package,
so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.diffusion_conv import diffusion_conv
from repro_torch.kernels.diffusion_conv.kernel import (column_tiles, hop_project,
                                                       hop_project_plain)
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.linear_scan import kernel as ls_kernel
from repro_torch.kernels.linear_scan import linear_scan, linear_scan_ref
from repro_torch.kernels.window_gather import window_gather
from repro_torch.kernels.window_gather import kernel as wg_kernel
from repro_torch.pipeline.gathers import resolve_gather
from repro_torch.tree import tree_leaves, tree_map, tree_paths, tree_unflatten

GATHER_SHAPES = [  # tests/test_kernels.py's window_gather cases, and two more
    (64, (24, 2), 6, 8, np.float32),
    (100, (13,), 5, 4, np.float32),
    (50, (), 7, 3, np.float32),
    (256, (128,), 24, 16, np.float32),
    (64, (7, 3), 4, 2, np.int32),
    (40, (130,), 3, 5, np.float32),
    (500, (13,), 7, 9, np.uint8),
    (300, (2716, 2), 24, 32, np.float32),  # main-path row width
    # the bulk route (16-byte rows; 4 KB pieces, a ring of 8 a block)
    (300, (48,), 24, 32, np.float32),      # 192-byte rows, 9 blocks of 2 windows and more
    (64, (10_000,), 3, 2, np.float32),     # 40,000-byte rows: pieces cut rows
    (50, (16,), 5, 2, np.float32),         # 640 bytes: one block, one piece a window
    (400, (2716, 2), 24, 64, np.float32),  # 33 MB over 132 blocks: the ring wraps
    (64, (8,), 6, 40, np.int32),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _series(rng, t, trail, dtype):
    if np.issubdtype(dtype, np.integer):
        return rng.integers(0, 100, size=(t,) + trail).astype(dtype)
    return rng.standard_normal((t,) + trail).astype(dtype)


def _support(rng, n):
    adj = rng.uniform(0, 1, (n, n)).astype(np.float32)
    adj[adj < 0.5] = 0
    np.fill_diagonal(adj, 1.0)
    return adj / adj.sum(1, keepdims=True)


@pytest.mark.cuda
@pytest.mark.parametrize("t,trail,span,b,dtype", GATHER_SHAPES)
def test_cuda_window_gather_matches_plain(cuda, t, trail, span, b, dtype):
    rng = np.random.default_rng(1)
    series = torch.as_tensor(_series(rng, t, trail, dtype)).to(cuda)
    starts = torch.as_tensor(rng.integers(-3, t + 3, size=b).astype(np.int32)).to(cuda)
    before = wg_kernel.window_gather.launches
    got = window_gather(series, starts, span=span, use_pallas=True)
    torch.cuda.synchronize()
    assert wg_kernel.window_gather.launches == before + 1
    want = window_gather(series, starts, span=span)
    assert torch.equal(got, want)


HOP_SHAPES = [  # (N, B, C, H)
    (24, 2, 10, 8), (50, 3, 66, 128), (129, 4, 128, 64), (300, 5, 1, 3), (2716, 2, 66, 64),
    # C not a multiple of 8, B not a multiple of the batch elements per block
    (2716, 32, 66, 128), (2716, 7, 66, 64), (129, 3, 128, 64),
    # C past MAX_C: column tiles of 65 and 96, each tile's Y feeding the next
    (2716, 8, 130, 64), (2716, 8, 192, 128), (129, 3, 130, 5),
    # the full PeMS graph (dcrnn-pems): N 11,160, B 8
    (11160, 8, 128, 128), (11160, 8, 65, 64),
    # the wgmma tiling's edges: N neither a multiple of 128 nor of 4 (S by
    # cp.async), B = 1 (the narrow tile), 17 column tiles with the last half
    # full, NB·C = 134 of 136 columns, H past 128 and not a multiple of 64
    (2715, 5, 66, 128), (2716, 1, 66, 128), (203, 1, 65, 64), (300, 33, 66, 64),
    (130, 3, 67, 128), (40, 9, 17, 200),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,b,c,h", HOP_SHAPES)
def test_cuda_hop_project_matches_plain(cuda, n, b, c, h):
    rng = np.random.default_rng(2)
    s = torch.as_tensor(_support(rng, n)).to(cuda)
    z, w, y = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(cuda)
               for shape in ((n, b, c), (c, h), (n, b, h)))
    w = w / c ** 0.5  # the model's init scale
    before = hop_project.launches
    got = hop_project(s, z, w, y)
    torch.cuda.synchronize()
    assert hop_project.launches == before + len(column_tiles(c))  # one a tile
    want = hop_project_plain(s, z, w, y)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_hop_project_keeps_fp32_accuracy_against_float64(cuda):
    """At the forecast cell's shape [2716, 32, 66 -> 128], Z_next and Y_next
    against the float64 plain version, held to hop_gemm's rule
    (_assert_hop_gemm_close, chip_smoke.py's hop_gemm_limit): at most 4 times
    the fp32 plain version's largest error plus 2**-20 of the largest
    magnitude.  The one-pass TF32 hop reads far past it."""
    n, b, c, h = 2716, 32, 66, 128
    rng = np.random.default_rng(31)
    s = torch.as_tensor(_support(rng, n)).to(cuda)
    z, w, y = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(cuda)
               for shape in ((n, b, c), (c, h), (n, b, h)))
    w = w / c ** 0.5
    got = hop_project(s, z, w, y)
    torch.cuda.synchronize()
    want = hop_project_plain(s.double(), z.double(), w.double(), y.double())
    fp32 = hop_project_plain(s, z, w, y)
    for g, e, f in zip(got, want, fp32):
        limit = 4 * float((f.double() - e).abs().max()) + 2.0 ** -20 * float(e.abs().max())
        err = float((g.double() - e).abs().max())
        assert err <= limit, f"max_abs_err {err:.3e} above {limit:.3e}"
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = torch.einsum("mn,nbc->mbc", s, z)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    f_err = float((fp32[0].double() - want[0]).abs().max())
    limit = 4 * f_err + 2.0 ** -20 * float(want[0].abs().max())
    assert float((tf32.double() - want[0]).abs().max()) > limit


@pytest.mark.cuda
def test_cuda_hop_project_rejects_what_it_cannot_take(cuda):
    s = torch.eye(4, device=cuda)
    z = torch.zeros(4, 2, 129, device=cuda)
    with pytest.raises(ValueError, match="feature dim"):
        hop_project(s, z[..., :0], torch.zeros(0, 3, device=cuda),
                    torch.zeros(4, 2, 3, device=cuda))
    with pytest.raises(ValueError, match="shape"):  # checked in every tile
        hop_project(s, z, torch.zeros(129, 3, device=cuda), torch.zeros(4, 2, 4, device=cuda))
    with pytest.raises(ValueError):
        hop_project(s.double(), z[..., :3].double(), torch.zeros(3, 3, device=cuda),
                    torch.zeros(4, 2, 3, device=cuda))


HOP_GEMM_SHAPES = [  # (N, B, C): the train path's B·C 520, 528, 1,024 and 2,112
    (2716, 8, 65), (2716, 8, 66), (2716, 32, 66), (11160, 8, 128),
    # ragged N (not a multiple of 4: 4-byte copies of S), odd B·C, one row
    (203, 8, 65), (203, 32, 66), (203, 3, 5), (1, 1, 1), (1, 4, 66),
]


def _assert_hop_gemm_close(got, s, z, transpose):
    """hop_gemm's output against the float64 product, held to fp32's own
    error on the same inputs: at most 4 times the fp32 plain product's
    largest error, plus 2**-20 of the product's largest magnitude (where
    fp32 is exact).  A sound 3xTF32 kernel reads under 1 times fp32's error;
    a kernel whose tensor-core accumulator truncates over K, or one TF32
    product, reads 30 times it and more (chip_smoke.py's hop_gemm_limit)."""
    from repro_torch.kernels.diffusion_conv.kernel import hop_gemm_plain

    want = hop_gemm_plain(s.double(), z.double(), transpose=transpose)
    fp32 = float((hop_gemm_plain(s, z, transpose=transpose).double() - want).abs().max())
    limit = 4 * fp32 + 2.0 ** -20 * float(want.abs().max())
    err = float((got.double() - want).abs().max())
    assert err <= limit, f"max_abs_err {err:.3e} above {limit:.3e} (fp32's {fp32:.3e})"


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("n,b,c", HOP_GEMM_SHAPES)
def test_cuda_hop_gemm_matches_plain(cuda, n, b, c, transpose):
    """S @ Z and Sᵀ @ Z against the plain product in float64: 3xTF32 keeps
    fp32's accuracy (_assert_hop_gemm_close, at sums of up to 11,160 terms)."""
    from repro_torch.kernels.diffusion_conv.kernel import hop_gemm

    rng = np.random.default_rng(n + c)
    s = torch.as_tensor(_support(rng, n)).to(cuda)
    z = torch.as_tensor(rng.standard_normal((n, b, c)).astype(np.float32)).to(cuda)
    before = (hop_gemm.launches_fwd, hop_gemm.launches_bwd)
    got = hop_gemm(s, z, transpose=transpose)
    torch.cuda.synchronize()
    assert (hop_gemm.launches_fwd, hop_gemm.launches_bwd) == (
        before[0] + (not transpose), before[1] + transpose)
    _assert_hop_gemm_close(got, s, z, transpose)


@pytest.mark.cuda
def test_cuda_hop_gemm_reads_strided_inputs_and_rejects_what_it_cannot_take(cuda):
    from repro_torch.kernels.diffusion_conv.kernel import hop_gemm

    rng = np.random.default_rng(5)
    s = torch.as_tensor(_support(rng, 300)).to(cuda)
    x = torch.as_tensor(rng.standard_normal((4, 300, 66 * 5)).astype(np.float32)).to(cuda)
    for z in (x.transpose(0, 1), x[..., 66:132].transpose(0, 1)):  # a view, a slice
        _assert_hop_gemm_close(hop_gemm(s, z, transpose=True), s, z, True)
    with pytest.raises(ValueError, match="contiguous"):
        hop_gemm(s.T, x.transpose(0, 1))
    with pytest.raises(ValueError, match="float32"):
        hop_gemm(s.double(), x.transpose(0, 1).double())


@pytest.mark.cuda
@pytest.mark.parametrize("x_grad", [True, False])
def test_cuda_diffusion_conv_trains_through_hop_gemm(cuda, x_grad):
    """diffusion_conv(use_pallas=True) with gradients at the PGT-DCRNN
    width: output, dx, dw and db against the plain oracle; each hop
    launches forward, and backward only where its input takes a gradient;
    without gradients hop_project runs and hop_gemm does not."""
    from repro_torch.kernels.diffusion_conv import diffusion_conv_ref
    from repro_torch.kernels.diffusion_conv.kernel import hop_gemm

    rng = np.random.default_rng(6)
    n, b, c, h = 2716, 32, 66, 128
    sup = tuple(torch.as_tensor(_support(rng, n)).to(cuda) for _ in range(2))
    x = torch.as_tensor(rng.standard_normal((b, n, c)).astype(np.float32)).to(cuda)
    w = torch.as_tensor((rng.standard_normal((5 * c, h)) / np.sqrt(5 * c))
                        .astype(np.float32)).to(cuda)
    bias = torch.as_tensor(rng.standard_normal(h).astype(np.float32)).to(cuda)
    g = torch.as_tensor(rng.standard_normal((b, n, h)).astype(np.float32)).to(cuda)
    results, launches = [], None
    for use_pallas in (True, False):
        leaves = [x.clone().requires_grad_(x_grad), w.clone().requires_grad_(True),
                  bias.clone().requires_grad_(True)]
        before = (hop_gemm.launches_fwd, hop_gemm.launches_bwd)
        out = diffusion_conv(leaves[0], sup, *leaves[1:], k_hops=2, use_pallas=use_pallas)
        grads = torch.autograd.grad(out, [t for t in leaves if t.requires_grad], g)
        torch.cuda.synchronize()
        if use_pallas:
            launches = (hop_gemm.launches_fwd - before[0], hop_gemm.launches_bwd - before[1])
        results.append([out, *grads])
    assert launches == (4, 4 if x_grad else 0)
    for a, e in zip(*results):
        torch.testing.assert_close(a, e, atol=1e-4, rtol=1e-4)
    before = (hop_gemm.launches_fwd, hop_gemm.launches_bwd, hop_project.launches)
    with torch.no_grad():
        want = diffusion_conv_ref(x, sup, w, bias, k_hops=2)
        got = diffusion_conv(x, sup, w, bias, k_hops=2, use_pallas=True)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert (hop_gemm.launches_fwd, hop_gemm.launches_bwd) == before[:2]
    assert hop_project.launches == before[2] + 4


SCAN_CASES = [  # (B, S, D, a/b dtype, h0 dtype or None, decay)
    (8, 1, 2560, torch.float32, torch.float32, None),    # RG-LRU decode shape
    (8, 1, 2560, torch.float32, torch.bfloat16, None),   # decode, bf16 carry in
    (8, 512, 2560, torch.float32, torch.float32, None),  # RG-LRU prefill shape
    (2, 128, 2560, torch.float32, torch.float32, None),
    (4, 100, 2560, torch.bfloat16, torch.bfloat16, None),
    (3, 37, 33, torch.float32, None, None),              # ragged S and D
    (2, 1, 33, torch.bfloat16, None, None),
    (5, 64, 7, torch.float32, torch.float32, 0.0),       # decay 0: h_t = b_t
    (5, 64, 129, torch.float32, torch.float32, 1.0),     # decay 1: cumsum
    # the staged kernel: blocks of 32 channels and 64 steps a stage, or 64
    # and 32; a ring of 4 stages
    (1, 256, 2560, torch.float32, torch.float32, None),  # the serving path's
    (1, 512, 2560, torch.float32, torch.float32, None),  # prefill groups
    (2, 512, 2560, torch.float32, torch.float32, None),
    (4, 128, 2560, torch.float32, torch.float32, None),
    (4, 256, 2560, torch.float32, torch.float32, None),
    (1, 50, 20, torch.float32, torch.float32, None),     # B·D below one block
    (1, 70, 4225, torch.float32, torch.float32, None),   # 133 one-warp blocks
    (133, 40, 64, torch.float32, None, None),            # 133 two-warp blocks
    (2, 200, 2560, torch.float32, torch.float32, None),  # S = 3 x 64 + 8
    (4, 300, 2560, torch.float32, torch.float32, None),  # S = 9 x 32 + 12: the ring wraps
    (2, 1000, 96, torch.float32, torch.bfloat16, None),  # 16 stages
    (2, 20, 2560, torch.float32, torch.float32, None),   # S shorter than a stage
    (4, 17, 2560, torch.bfloat16, torch.float32, None),
    (3, 70, 6, torch.bfloat16, torch.bfloat16, None),    # 12-byte rows: 4-byte copies
    (3, 70, 33, torch.bfloat16, torch.float32, None),    # odd bf16 rows: element loads
    (2, 90, 2562, torch.bfloat16, None, None),           # 5,124-byte rows
    (2, 0, 64, torch.float32, torch.float32, None),      # no steps: h_last = h0
    # S = 1 takes the step kernel: 4 channels a thread where B·D allows it
    (1, 1, 32, torch.float32, None, None),               # the launch floor's shape
    (4, 1, 64, torch.bfloat16, torch.bfloat16, None),
    (3, 1, 7, torch.float32, torch.float32, None),       # B·D = 21: one a thread
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,dtype,h_dtype,decay", SCAN_CASES)
def test_cuda_linear_scan_bit_exact_to_plain(cuda, b, s, d, dtype, h_dtype, decay):
    rng = np.random.default_rng(3)
    a = (np.full((b, s, d), decay, np.float32) if decay is not None
         else rng.uniform(0.7, 1.0, (b, s, d)).astype(np.float32))
    a = torch.as_tensor(a).to(cuda, dtype)
    bb = torch.as_tensor(rng.standard_normal((b, s, d)).astype(np.float32)).to(cuda, dtype)
    h0 = (None if h_dtype is None else
          torch.as_tensor(rng.standard_normal((b, d)).astype(np.float32)).to(cuda, h_dtype))
    before = ls_kernel.linear_scan.launches
    seq, last = linear_scan(a, bb, h0, use_pallas=True)
    torch.cuda.synchronize()
    assert ls_kernel.linear_scan.launches == before + 1
    want_seq, want_last = linear_scan_ref(a, bb, h0)
    assert seq.dtype == dtype and last.dtype == (h_dtype or dtype)
    assert torch.equal(seq, want_seq) and torch.equal(last, want_last)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_cuda_window_gather_unaligned_base_takes_the_vector_route(cuda, offset):
    """A 16-byte row whose series does not start on a 16-byte boundary."""
    rng = np.random.default_rng(4)
    flat = torch.as_tensor(rng.standard_normal(offset + 200 * 48).astype(np.float32)).to(cuda)
    series = flat[offset:].view(200, 48)
    assert wg_kernel.launch_shape(5, 12, 192, aligned=series.data_ptr() % 16 == 0,
                                  sms=132)[0] == "vector"
    starts = torch.as_tensor(rng.integers(-3, 203, size=5).astype(np.int32)).to(cuda)
    got = window_gather(series, starts, span=12, use_pallas=True)
    assert torch.equal(got, window_gather(series, starts, span=12))


@pytest.mark.cuda
def test_cuda_linear_scan_rejects_what_it_cannot_take(cuda):
    a = torch.ones(2, 3, 4, device=cuda)
    with pytest.raises(ValueError, match="a must be"):
        linear_scan(a.double(), a.double(), use_pallas=True)
    with pytest.raises(ValueError, match="b must be"):
        linear_scan(a, a.bfloat16(), use_pallas=True)
    with pytest.raises(ValueError, match="h0 must be"):
        linear_scan(a, a, torch.zeros(2, 5, device=cuda), use_pallas=True)


# ----------------------------------------------------------- flash_attention
FLASH_CASES = [  # (B, S, H, Hkv, D, dtype, causal, (block_q, block_k) or None)
    (2, 512, 10, 1, 256, torch.bfloat16, True, None),   # recurrentgemma-2b prompts
    (1, 512, 8, 2, 64, torch.float32, True, None),      # the JAX kernels bench shape
    (2, 256, 8, 4, 32, torch.float32, True, (64, 64)),
    (1, 512, 4, 1, 64, torch.float32, True, (128, 128)),  # MQA
    (2, 300, 6, 6, 16, torch.float32, True, (128, 128)),   # ragged S, H = Hkv
    (1, 128, 20, 20, 128, torch.float32, True, (128, 128)),
    (2, 192, 8, 2, 32, torch.float32, True, (32, 32)),
    (2, 100, 4, 2, 16, torch.float32, False, (64, 64)),   # non-causal, ragged S
    (1, 300, 2, 1, 256, torch.float32, False, (32, 32)),
    (1, 300, 4, 2, 256, torch.bfloat16, False, (64, 64)),
    (2, 77, 4, 4, 120, torch.float32, True, (64, 64)),    # h2o-danube3's head dim
    (3, 33, 2, 1, 8, torch.float32, True, (32, 32)),
    (1, 1, 4, 2, 64, torch.float32, True, None),          # one token
    (1, 640, 10, 1, 256, torch.bfloat16, True, (64, 64)),
    # the bf16 tensor-core kernel
    (1, 512, 8, 2, 64, torch.bfloat16, True, None),        # GQA 8:2
    (1, 512, 8, 2, 64, torch.bfloat16, False, (64, 64)),
    (2, 77, 4, 4, 120, torch.bfloat16, True, None),        # D 120, H = Hkv
    (2, 100, 4, 2, 128, torch.bfloat16, False, None),      # non-causal, ragged S
    (2, 100, 4, 2, 128, torch.bfloat16, True, None),
    (3, 33, 2, 1, 64, torch.bfloat16, True, None),         # ragged S, MQA
    (3, 33, 2, 1, 256, torch.bfloat16, False, None),
    (1, 300, 4, 1, 256, torch.bfloat16, True, None),       # MQA
    (2, 300, 6, 6, 128, torch.bfloat16, True, None),       # H = Hkv
    (1, 1, 4, 2, 64, torch.bfloat16, True, None),          # one token
    (1, 1, 4, 2, 256, torch.bfloat16, False, None),
    (1, 2048, 10, 1, 256, torch.bfloat16, True, None),     # recurrentgemma-2b's window
    (2, 200, 4, 2, 16, torch.bfloat16, True, None),        # D 16 and 32: narrow swizzles
    (2, 200, 4, 2, 32, torch.bfloat16, False, None),
    (2, 150, 4, 2, 33, torch.bfloat16, True, None),        # D % 8 != 0: element loads
]
# tests/test_flash_attention.py's tolerances: f32 sums in another order;
# bf16 outputs, and the kernel rounds p to bf16 before P·V as the JAX kernel does.
FLASH_ATOL = {torch.float32: 5e-5, torch.bfloat16: 3e-2}


def _qkv(rng, b, s, h, kv, d, dtype, device, s_kv=None):
    s_kv = s if s_kv is None else s_kv
    return tuple(torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
                 .to(device, dtype)
                 for shape in ((b, s, h, d), (b, s_kv, kv, d), (b, s_kv, kv, d)))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,d,dtype,causal,blocks", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(cuda, b, s, h, kv, d, dtype, causal, blocks):
    q, k, v = _qkv(np.random.default_rng(5), b, s, h, kv, d, dtype, cuda)
    bq, bk = blocks or (None, None)
    before = fa_kernel.flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, use_pallas=True, block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention.launches == before + 1
    want = flash_attention(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == (b, s, h, d) and got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), atol=FLASH_ATOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_kernel_aligns_unequal_lengths_at_zero(cuda, causal, dtype):
    """Sq != Skv at the kernel level follows the plain version's top-left
    alignment; the op itself takes equal lengths only."""
    q, k, v = _qkv(np.random.default_rng(6), 2, 70, 4, 2, 64, dtype, cuda, s_kv=150)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    got = fa_kernel.flash_attention(qt, kt, vt, causal=causal)
    torch.testing.assert_close(got.float(),
                               flash_attention_ref(qt, kt, vt, causal=causal).float(),
                               atol=FLASH_ATOL[dtype], rtol=0)
    with pytest.raises(ValueError, match="equal query and key lengths"):
        flash_attention(q, k, v, use_pallas=True)


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_what_it_cannot_take(cuda):
    q, k, v = _qkv(np.random.default_rng(7), 1, 64, 4, 2, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="must be"):
        flash_attention(q.double(), k.double(), v.double(), use_pallas=True)
    with pytest.raises(ValueError, match="tiles"):
        flash_attention(q, k, v, use_pallas=True, block_q=96, block_k=96)
    with pytest.raises(ValueError, match="square"):
        flash_attention(q, k, v, use_pallas=True, block_q=128, block_k=64)
    big = torch.zeros(1, 8, 2, 512, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(big, big, big, use_pallas=True)
    wide = _qkv(np.random.default_rng(7), 1, 64, 4, 2, 256, torch.float32, cuda)
    with pytest.raises(ValueError, match="tiles"):  # 330,752 bytes of shared memory
        flash_attention(*wide, use_pallas=True, block_q=128, block_k=128)
    with pytest.raises(ValueError, match=r"must be \(64, 64\)"):  # not the bf16 tile
        flash_attention(*(t.bfloat16() for t in (q, k, v)), use_pallas=True,
                        block_q=32, block_k=32)


# ------------------------------------------------------- measured dispatch
def _auto_cases(cuda):
    rng = np.random.default_rng(8)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(cuda)

    sup = tuple(torch.as_tensor(_support(rng, 40)).to(cuda) for _ in range(2))
    x, w, bias = t(4, 40, 66), t(5 * 66, 64) / 8, t(64)
    series = t(300, 24, 2)
    starts = torch.as_tensor(rng.integers(0, 276, 6).astype(np.int32)).to(cuda)
    q, k, v = _qkv(rng, 2, 96, 10, 1, 256, torch.bfloat16, cuda)
    a = torch.as_tensor(rng.uniform(0.7, 1.0, (3, 40, 70)).astype(np.float32)).to(cuda)
    bb = t(3, 40, 70)
    gathers = {"auto": resolve_gather("auto"), "ref": resolve_gather("slice")}
    return {  # op -> (call(impl), atol against the plain version)
        "window_gather": (lambda impl: window_gather(series, starts, span=24, impl=impl), 0),
        "gather": (lambda impl: gathers[impl](series, starts, input_len=12, horizon=12), 0),
        "linear_scan": (lambda impl: linear_scan(a, bb, impl=impl), 1e-3),
        "flash_attention": (lambda impl: flash_attention(q, k, v, impl=impl), 3e-2),
        "diffusion_conv": (lambda impl: diffusion_conv(x, sup, w, bias, k_hops=2,
                                                       impl=impl), 1e-4),
    }


@pytest.mark.cuda
def test_cuda_auto_tunes_every_kernel_and_matches_plain(cuda, tmp_path):
    """impl="auto" on CUDA tensors: only the kernel's launch shapes compete,
    each is measured and admitted, the verdict is the kernel, and the
    dispatched result equals the plain version."""
    with autotune.autotuning(mode="tune", cache_dir=str(tmp_path), warmup=0, iters=2):
        for op, (call, atol) in _auto_cases(cuda).items():
            got, want = call("auto"), call("ref")
            for g, w in zip(autotune._leaves(got), autotune._leaves(want)):
                torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=atol)
    entries = autotune.load_cache(autotune.cache_path("cuda", str(tmp_path)), "cuda")
    assert sorted(key.split("|")[0] for key in entries) == sorted(_auto_cases(cuda))
    for key, entry in entries.items():
        assert entry["variant"] == "pallas", entry
        assert entry["candidates"] and all(c.startswith("pallas")
                                           for c in entry["candidates"]), entry
        assert all("rejected" not in c for c in entry["candidates"].values()), entry


@pytest.mark.cuda
def test_cuda_wrong_kernel_raises_when_no_launch_shape_passes(cuda, tmp_path, monkeypatch):
    """On the card a rejected kernel leaves no candidate: tuning raises
    rather than dispatching the plain version."""
    base = autotune._OPS["window_gather"]

    def off_by_one(static, params):
        return lambda series, starts: window_gather(series, starts + 1, span=static["span"],
                                                    use_pallas=True)

    monkeypatch.setitem(autotune._OPS, "window_gather", autotune.OpSpec(
        name="window_gather", describe=base.describe, synth=base.synth, default=base.default,
        variants=lambda: (base.variants()[0], autotune.Variant("pallas", off_by_one,
                                                               kernel=True))))
    series = torch.zeros(64, 8, device=cuda).normal_()
    starts = torch.tensor([0, 3, 9], dtype=torch.int32, device=cuda)
    with autotune.autotuning(mode="tune", cache_dir=str(tmp_path), warmup=0, iters=1):
        with pytest.raises(RuntimeError, match="no launch shape"):
            window_gather(series, starts, span=6, impl="auto")


@pytest.mark.cuda
def test_cuda_cached_plain_verdict_is_stale(cuda, tmp_path, caplog):
    """A cache entry naming the plain version is not a candidate on the
    card: it is logged as stale and the kernel runs."""
    q, k, v = _qkv(np.random.default_rng(10), 1, 64, 4, 2, 32, torch.float32, cuda)
    key = autotune.bucket_key("flash_attention", "cuda",
                              {"b": 1, "s": 64, "h": 4, "hkv": 2, "d": 32}, q.dtype)
    autotune.save_cache(autotune.cache_path("cuda", str(tmp_path)), "cuda",
                        {key: {"variant": "ref", "params": {}}})
    before = fa_kernel.flash_attention.launches
    with autotune.autotuning(mode="load", cache_dir=str(tmp_path)):
        got = flash_attention(q, k, v, impl="auto")
    assert fa_kernel.flash_attention.launches == before + 1
    assert "stale cache entry" in caplog.text
    torch.testing.assert_close(got, flash_attention(q, k, v), atol=5e-5, rtol=0)


@pytest.mark.cuda
def test_cuda_failing_kernel_variant_raises_instead_of_being_rejected(cuda, tmp_path,
                                                                     monkeypatch):
    def broken():
        raise RuntimeError("kernel library did not build")

    monkeypatch.setattr(fa_kernel, "_entry", broken)
    q, k, v = _qkv(np.random.default_rng(9), 1, 64, 4, 2, 32, torch.float32, cuda)
    with autotune.autotuning(mode="tune", cache_dir=str(tmp_path), warmup=0, iters=1):
        with pytest.raises(RuntimeError, match="did not build"):
            flash_attention(q, k, v, impl="auto")
    with autotune.autotuning(mode="off"):  # the card's default is the kernel
        with pytest.raises(RuntimeError, match="did not build"):
            flash_attention(q, k, v, impl="auto")


@pytest.mark.cuda
def test_cuda_dcrnn_forward_through_hop_project_matches_plain_hops(cuda):
    """DCRNN with use_pallas=True (every hop through the kernel: C 66, 65
    and 2 x hidden, H 2 x hidden and hidden) against the plain hops."""
    from repro_torch.models import dcrnn

    rng = np.random.default_rng(11)
    n, hidden = 300, 80  # layer 2 feeds C = 160: two column tiles
    sup = tuple(torch.as_tensor(_support(rng, n)).to(cuda) for _ in range(2))
    x = torch.as_tensor(rng.standard_normal((4, 12, n, 2)).astype(np.float32)).to(cuda)
    cfg = dcrnn.DCRNNConfig(num_nodes=n, hidden=hidden)
    params = dcrnn.init(torch.Generator().manual_seed(0), cfg, device=cuda)
    before = hop_project.launches
    with torch.no_grad():
        got = dcrnn.apply(params, dataclasses.replace(cfg, use_pallas=True), sup, x)
        torch.cuda.synchronize()
        launches = hop_project.launches - before
        want = dcrnn.apply(params, dataclasses.replace(cfg, use_pallas=False), sup, x)
    # 24 cell steps x 2 dconvs x 2 supports x K 2, layer 2's hops in 2 tiles
    assert launches == 24 * 2 * 2 * 2 * (1 + 2)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["dcrnn", "pgt_dcrnn"])
def test_cuda_model_gradients_through_hop_gemm_match_plain_hops(cuda, model):
    """A training loss's gradients at the models' default (every hop on
    hop_gemm, forward and backward) against use_pallas=False; the first
    cell's hops, whose input takes no gradient, launch nothing backward."""
    import importlib

    from repro_torch.kernels.diffusion_conv.kernel import hop_gemm

    mod = importlib.import_module(f"repro_torch.models.{model}")
    rng = np.random.default_rng(12)
    n = 300
    sup = tuple(torch.as_tensor(_support(rng, n)).to(cuda) for _ in range(2))
    x = torch.as_tensor(rng.standard_normal((4, 12, n, 2)).astype(np.float32)).to(cuda)
    y = torch.as_tensor(rng.standard_normal((4, 12, n, 2)).astype(np.float32)).to(cuda)
    cls = mod.DCRNNConfig if model == "dcrnn" else mod.PGTDCRNNConfig
    cfg = cls(num_nodes=n)
    assert cfg.use_pallas
    params = mod.init(torch.Generator().manual_seed(0), cfg, device=cuda)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    grads = {}
    for use in (True, False):
        before = (hop_gemm.launches_fwd, hop_gemm.launches_bwd)
        loss = mod.loss_fn(params, dataclasses.replace(cfg, use_pallas=use), sup, x, y)
        grads[use] = (loss, torch.autograd.grad(loss, leaves))
        torch.cuda.synchronize()
        if use:
            fwd, bwd = hop_gemm.launches_fwd - before[0], hop_gemm.launches_bwd - before[1]
    cells = cfg.layers * (cfg.input_len + cfg.horizon) if model == "dcrnn" else cfg.input_len
    hops = 2 * 2 * cfg.max_diffusion_step  # two dconvs, two supports
    # the first cell's gate dconv sees x and a zero state: no backward
    assert (fwd, bwd) == (cells * hops, cells * hops - hops // 2)
    torch.testing.assert_close(grads[True][0], grads[False][0], atol=1e-5, rtol=1e-5)
    for a, e in zip(grads[True][1], grads[False][1]):
        torch.testing.assert_close(a, e, atol=1e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("staleness", [1, 2])
def test_cuda_prefetcher_side_stream_gives_the_synchronous_batches(cuda, staleness):
    """Staleness >= 1 copies each row from a pinned buffer on the transfer
    thread's own stream; the consumer's stream waits on the copy's event.
    The step here reads each batch on the default stream after a long
    device sleep, so a missing wait would read memory not yet written."""
    from repro_torch.pipeline import FeedPrefetcher, PrefetchPlan

    rng = np.random.default_rng(12)
    grid = rng.integers(0, 10**6, size=(40, 64)).astype(np.int32)

    def blocks():
        for lo in range(0, len(grid), 8):
            yield grid[lo:lo + 8]

    sync = [torch.as_tensor(row).to(cuda) for row in grid]
    pf = FeedPrefetcher(blocks(), lambda row: row, PrefetchPlan(staleness=staleness),
                        device=cuda)
    got = []
    for batch in pf:
        assert batch.device.type == "cuda" and batch.dtype == torch.int32
        torch.cuda._sleep(100_000)  # the step's stream is busy while copies land
        got.append(batch * 1)  # consumed on the default stream
    assert len(got) == len(sync)
    assert all(torch.equal(a, b) for a, b in zip(got, sync))
    assert not pf._dev_thread.is_alive()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(0, 280), (140, 300), (137, 181)])
def test_cuda_window_gather_at_rebased_starts_matches_plain_over_the_whole_series(cuda, rows):
    """A rank's resident rows ``[lo, hi)`` of a series at PeMS-All-LA's row
    width (2,716 nodes x 2 features, 21,728-byte rows): the kernel at the
    starts rebased to ``lo`` gives the windows the plain gather gives over
    the whole series at the global starts."""
    rng = np.random.default_rng(13)
    whole = torch.as_tensor(_series(rng, 300, (2716, 2), np.float32)).to(cuda)
    lo, hi = rows
    span = 24
    resident = whole[lo:hi].contiguous()
    starts = torch.as_tensor(rng.integers(lo, hi - span + 1, size=32).astype(np.int32))
    before = wg_kernel.window_gather.launches
    got = window_gather(resident, (starts - lo).to(cuda), span=span, use_pallas=True)
    torch.cuda.synchronize()
    assert wg_kernel.window_gather.launches == before + 1
    assert torch.equal(got, window_gather(whole, starts.to(cuda), span=span))


@pytest.mark.cuda
def test_cuda_exchange_over_a_one_process_group_assembles_exact_windows(cuda):
    """``exchange_windows`` on CUDA tensors in a one-process group (the
    topology's backend: NCCL with the card to itself): rows this process
    owns come back as the plain gather gives them, through one
    ``window_gather`` launch, the others as zeros."""
    import socket

    import torch.distributed as dist

    from repro_torch.core.distributed import choose_backend
    from repro_torch.pipeline.gathers import exchange_windows

    rng = np.random.default_rng(14)
    series = torch.as_tensor(_series(rng, 200, (2716, 2), np.float32)).to(cuda)
    starts = torch.as_tensor(rng.integers(0, 200 - 24 + 1, size=32).astype(np.int32)).to(cuda)
    backend = choose_backend(cuda, 1)
    assert backend == "nccl"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        want = window_gather(series, starts, span=24)
        before = wg_kernel.window_gather.launches
        got = exchange_windows(series, starts, span=24, owned=(0, 200), impl="pallas")
        torch.cuda.synchronize()
        assert wg_kernel.window_gather.launches == before + 1
        assert torch.equal(got, want)
        part = exchange_windows(series, starts, span=24, owned=(50, 120), impl="pallas")
        rows = starts.long()[:, None] + torch.arange(24, device=cuda)
        mine = ((rows >= 50) & (rows < 120))[..., None, None]
        assert torch.equal(part, torch.where(mine, want, torch.zeros_like(want)))
    finally:
        dist.destroy_process_group()


class _DeadThenBack:
    """``step_feed`` fake: ranks 1 and 2 of 4 go silent at step 3 while the
    clock jumps past the timeout, and beat from outside the shrunk world
    from step 6."""

    def __init__(self, clock):
        self.clock, self.killed = clock, False

    def __call__(self, step, world):
        self.clock[0] += 1.0
        beats = {r: (step, None) for r in range(world)}
        if not self.killed and world == 4 and step >= 3:
            del beats[1], beats[2]
            self.clock[0] += 100.0
            self.killed = True
        if world < 4 and step >= 6:
            beats.update({world: (step, None), world + 1: (step, None)})
        return beats


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [{}, {"prefetch_depth": 2, "staleness": 1}])
def test_cuda_elastic_shrink_grow_is_bit_equal_to_the_uninterrupted_run(cuda, tmp_path,
                                                                      prefetch):
    """In one process on the card: world 4 shrinks to 2 and grows back to 4
    (per-rank batch 2 → 4 → 2, the global batch 8 throughout), every step
    gathering through the CUDA ``window_gather``, synchronously or through
    the prefetcher's side stream (drained before each re-mesh frees the old
    series); losses, val_mae and the final state equal the uninterrupted
    synchronous world-4 run's bit for bit."""
    from repro_torch.core import WindowSpec
    from repro_torch.data import (gaussian_adjacency, make_traffic_series,
                                  random_sensor_coords, transition_matrices)
    from repro_torch.models import pgt_dcrnn
    from repro_torch.optim import AdamConfig
    from repro_torch.pipeline import ElasticConfig, PipelineConfig, build_pipeline
    from repro_torch.train import TrainLoopConfig

    nodes = 16
    cfg = pgt_dcrnn.PGTDCRNNConfig(num_nodes=nodes, in_features=2, out_features=1,
                                   hidden=8, max_diffusion_step=2, input_len=4, horizon=4)
    adj = gaussian_adjacency(random_sensor_coords(nodes, seed=3))
    supports = tuple(torch.as_tensor(np.ascontiguousarray(s)).to(cuda)
                     for s in transition_matrices(adj))
    series = make_traffic_series(160, nodes, 2, seed=3, adjacency=adj)

    def loss_fn(p, x, y):
        return pgt_dcrnn.loss_fn(p, cfg, supports, x, y), {}

    runs = []
    for label, loop_kw in (("smooth", {}), ("elastic", prefetch)):
        clock = [0.0]
        elastic = (ElasticConfig(heartbeat_timeout=50.0, clock=lambda: clock[0],
                                 step_feed=_DeadThenBack(clock))
                   if label == "elastic" else None)
        pipe = build_pipeline(
            series, WindowSpec(horizon=4, input_len=4), loss_fn,
            pgt_dcrnn.init(torch.Generator().manual_seed(3), cfg, device="cuda"),
            PipelineConfig(batch_per_rank=2, world=4, gather="pallas", seed=3,
                           device="cuda", adam=AdamConfig(lr=1e-3),
                           loop=TrainLoopConfig(epochs=2, log_every=1,
                                                ckpt_dir=str(tmp_path / label),
                                                **loop_kw)),
            elastic=elastic)
        before = wg_kernel.window_gather.launches
        state, history = pipe.fit()
        torch.cuda.synchronize()
        runs.append((pipe, state, history, wg_kernel.window_gather.launches - before))
    (_, smooth, smooth_hist, _), (pipe, state, hist, launches) = runs
    assert [(r["kind"], r["world"], r["batch_per_rank"]) for r in pipe.restarts] == \
        [("shrink", 2, 4), ("grow", 4, 2)]
    assert launches >= len([h for h in hist if "epoch_time_s" not in h])
    assert [h["loss"] for h in hist if "epoch_time_s" not in h] == \
        [h["loss"] for h in smooth_hist if "epoch_time_s" not in h]
    assert [h["val_mae"] for h in hist if "epoch_time_s" in h] == \
        [h["val_mae"] for h in smooth_hist if "epoch_time_s" in h]
    for a, b in zip(tree_leaves(smooth), tree_leaves(state), strict=True):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


# ------------------------------------------ the §5.5 models: A3T-GCN, ST-LLM
BAY_NODES = 325  # PeMS-Bay: 325 x 2 features x 4 bytes = 2,600-byte rows


@pytest.mark.cuda
def test_cuda_window_gather_vector_route_at_pems_bay_rows_is_bit_exact(cuda):
    """PeMS-Bay's uncut series, [52105, 650] float32: its 2,600-byte rows
    are not whole 16-byte chunks, so the gather takes the vector route."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    series = torch.randn((52_105, 2 * BAY_NODES), device=cuda, generator=gen)
    starts = torch.randint(0, 52_105 - 24 + 1, (32,), device=cuda, generator=gen,
                           dtype=torch.int32)
    assert wg_kernel.launch_shape(32, 24, series.shape[1] * 4, aligned=True,
                                  sms=132) == ("vector", 32 * 24)
    before = wg_kernel.window_gather.launches
    got = window_gather(series, starts, span=24, use_pallas=True)
    torch.cuda.synchronize()
    assert wg_kernel.window_gather.launches == before + 1
    assert torch.equal(got, window_gather(series, starts, span=24))


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["a3tgcn", "stllm"])
def test_cuda_section55_step_through_the_kernel_gather_is_bit_equal_to_slice(cuda, model):
    """One index-batched train step of A3T-GCN or ST-LLM over a PeMS-Bay-wide
    graph: ``gather="pallas"`` (the CUDA kernel) and ``gather="slice"`` give
    the same loss and parameters bit for bit."""
    from repro_torch.core import IndexDataset, WindowSpec
    from repro_torch.data import (gaussian_adjacency, make_traffic_series,
                                  random_sensor_coords, sym_norm_adjacency)
    from repro_torch.models import a3tgcn, stllm
    from repro_torch.pipeline import PipelineConfig, build_pipeline
    from repro_torch.train.loop import init_train_state

    spec = WindowSpec(horizon=12, input_len=12)
    ds = IndexDataset.from_raw(make_traffic_series(400, BAY_NODES), spec)
    if model == "a3tgcn":
        cfg = a3tgcn.A3TGCNConfig(num_nodes=BAY_NODES)
        a_hat = torch.as_tensor(sym_norm_adjacency(gaussian_adjacency(
            random_sensor_coords(BAY_NODES))), dtype=torch.float32, device=cuda)

        def loss_fn(p, x, y):
            return a3tgcn.loss_fn(p, cfg, a_hat, x, y), {}
        init = lambda: a3tgcn.init(torch.Generator().manual_seed(0), cfg, device=cuda)
    else:
        cfg = stllm.STLLMConfig(num_nodes=BAY_NODES, d_model=64, layers=2, n_heads=4,
                                d_ff=128)

        def loss_fn(p, x, y):
            return stllm.loss_fn(p, cfg, x, y), {}
        init = lambda: stllm.init(torch.Generator().manual_seed(0), cfg, device=cuda)
    runs = {}
    for gather in ("pallas", "slice"):
        config = PipelineConfig(batch_per_rank=8, gather=gather, device="cuda")
        params = init()
        pipe = build_pipeline(None, spec, loss_fn, params, config, dataset=ds)
        batch = pipe.batch_of_starts(pipe.dataplane.epoch_global(0)[0])
        before = wg_kernel.window_gather.launches
        state, metrics = pipe.train_step(init_train_state(params, config.adam), batch)
        torch.cuda.synchronize()
        assert wg_kernel.window_gather.launches - before == (gather == "pallas")
        runs[gather] = (metrics["loss"], tree_leaves(state["params"]))
    (loss_k, params_k), (loss_s, params_s) = runs["pallas"], runs["slice"]
    assert torch.equal(loss_k, loss_s) and torch.isfinite(loss_k)
    assert all(torch.equal(a, b) for a, b in zip(params_k, params_s))


# ---------------------------------------- forward-only kernels and the LM family
@pytest.mark.cuda
def test_cuda_kernel_paths_refuse_gradients(cuda):
    """The CPU tests' refusal, on the card: the ops and the kernel wrappers
    raise on inputs that require grad, and launch under ``no_grad``."""
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.rand(2, 16, 32, device=cuda, generator=g)
    b = torch.randn(2, 16, 32, device=cuda, generator=g).requires_grad_(True)
    q, k, v = (torch.randn(1, 64, 2, 32, device=cuda, generator=g).requires_grad_(True)
               for _ in range(3))
    for call in (lambda: linear_scan(a, b, use_pallas=True),
                 lambda: ls_kernel.linear_scan(a, b),
                 lambda: flash_attention(q, k, v, use_pallas=True),
                 lambda: fa_kernel.flash_attention(*(t.transpose(1, 2) for t in (q, k, v)))):
        with pytest.raises(NotImplementedError, match="no backward"):
            call()
    before = (ls_kernel.linear_scan.launches, fa_kernel.flash_attention.launches)
    with torch.no_grad():
        seq, _ = linear_scan(a, b, use_pallas=True)
        out = flash_attention(q, k, v, use_pallas=True)
    torch.cuda.synchronize()
    assert (ls_kernel.linear_scan.launches, fa_kernel.flash_attention.launches) \
        == (before[0] + 1, before[1] + 1)
    assert torch.equal(seq, linear_scan_ref(a, b.detach(), None)[0])
    ref = flash_attention_ref(*(t.detach().transpose(1, 2) for t in (q, k, v))).transpose(1, 2)
    assert float((out - ref).abs().max()) <= 5e-5


@pytest.mark.cuda
def test_cuda_recurrentgemma_loss_through_the_kernel_scan_raises(cuda):
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import model as lm

    cfg = dataclasses.replace(get_arch("recurrentgemma-2b").smoke_config(),
                              use_pallas_scan=True)
    params = lm.init(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (2, 8), device=cuda)
    with pytest.raises(NotImplementedError, match="no backward"):
        lm.loss_fn(params, cfg, toks, toks)


LM_NEW = ("qwen1.5-4b", "minitron-8b", "granite-34b", "h2o-danube-3-4b",
          "internvl2-26b", "musicgen-large", "grok-1-314b", "deepseek-v2-lite-16b",
          "rwkv6-1.6b")


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", LM_NEW)
def test_cuda_lm_arch_matches_the_cpu(cuda, arch_id):
    """Each new arch's smoke config in float32 (TF32 off): the loss and
    every gradient on the card against the same parameters on the CPU,
    within atol 1e-4 plus rtol 1e-3 (cuBLAS sums in another order); and
    prefill plus 4 decode steps against a teacher-forced forward, within
    1e-4 (tests/test_models_smoke.py's identity, on the card)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import model as lm

    cfg = get_arch(arch_id).smoke_config()
    cpu_params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    params = tree_map(lambda t: t.to(cuda), cpu_params)
    toks = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(1))
    grads = []
    for dev, p in ((torch.device("cpu"), cpu_params), (cuda, params)):
        leaves = [t.detach().clone().requires_grad_(True) for t in tree_leaves(p)]
        loss, _ = lm.loss_fn(tree_unflatten(p, leaves), cfg, toks.to(dev), toks.to(dev))
        grads.append((loss, torch.autograd.grad(loss, leaves, allow_unused=True,
                                                materialize_grads=True)))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = grads
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, atol=1e-4, rtol=1e-3)
    for path, a, b in zip(tree_paths(cpu_params), g_gpu, g_cpu):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-3, msg=path)
    seq = toks.to(cuda)
    with torch.no_grad():
        full, _ = lm.forward(params, cfg, seq)
        cache = lm.init_cache(cfg, 2, 16, device=cuda)
        logits, cache, lengths = lm.prefill(params, cfg, seq[:, :8], cache)
        torch.testing.assert_close(logits, full[:, 7], atol=1e-4, rtol=1e-4)
        for t in range(8, 12):
            logits, cache = lm.decode_step(params, cfg, seq[:, t:t + 1], cache, lengths)
            lengths = lengths + 1
            torch.testing.assert_close(logits, full[:, t], atol=1e-4, rtol=1e-4)


# ------------------------------------------------------ the LM family's scans
@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 129, 4096])
def test_cuda_associative_scan_equals_the_cpu_bit_for_bit(cuda, s):
    """RG-LRU's associative scan (``h0`` folded in) on the card: eager
    ``mul`` and ``add`` round each op as the CPU's do, so ``h`` and the
    decay products equal the CPU's bit for bit."""
    from repro_torch.loops import associative_scan
    from repro_torch.models.lm.rglru import _assoc_scan, _combine

    g = torch.Generator().manual_seed(s)
    a = 0.5 + 0.5 * torch.rand(2, s, 2560, generator=g)
    b = torch.randn(2, s, 2560, generator=g)
    h0 = torch.randn(2, 2560, generator=g)
    want = associative_scan(_combine, (a, b), dim=1)
    got = associative_scan(_combine, (a.to(cuda), b.to(cuda)), dim=1)
    assert all(torch.equal(x.cpu(), y) for x, y in zip(got, want))
    h, h_last = _assoc_scan(a.to(cuda), b.to(cuda), h0.to(cuda))
    wh, wlast = _assoc_scan(a, b, h0)
    assert torch.equal(h.cpu(), wh) and torch.equal(h_last.cpu(), wlast)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1, 3, 8), (2, 33, 4, 64)])
def test_cuda_wkv_function_matches_the_cpu(cuda, shape):
    """The WKV scan's autograd function on the card (TF32 off): its outputs
    and every input's gradient against the CPU's, within the rwkv6 block
    tolerance (atol 1e-5 plus rtol 1e-4; cuBLAS sums the state products in
    another order)."""
    from repro_torch.models.lm.rwkv6 import _wkv_scan

    b, n, h, hs = shape
    g = torch.Generator().manual_seed(n)
    r, k, v = (torch.randn(shape, generator=g) for _ in range(3))
    w = 0.2 + 0.79 * torch.rand(shape, generator=g)
    u = 0.1 * torch.randn(h, hs, generator=g)
    s0 = torch.randn(b, h, hs, hs, generator=g)
    g_out, g_s = torch.randn(shape, generator=g), torch.randn(b, h, hs, hs, generator=g)
    results = []
    for dev in (torch.device("cpu"), cuda):
        xs = [t.to(dev).requires_grad_(True) for t in (r, k, v, w, u, s0)]
        out, s_last = _wkv_scan(*xs)
        grads = torch.autograd.grad((out * g_out.to(dev)).sum()
                                    + (s_last * g_s.to(dev)).sum(), xs)
        results.append([t.detach().cpu() for t in (out, s_last, *grads)])
    for name, want, got in zip("out s_last dr dk dv dw du ds0".split(), *results):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4, msg=name)


@pytest.mark.cuda
def test_cuda_recurrentgemma_trains_through_the_associative_scan(cuda):
    """recurrentgemma-2b's smoke config in float32 with the plain scans
    (training takes the associative scan): the loss and every gradient on
    the card against the CPU's, within test_cuda_lm_arch_matches_the_cpu's
    atol 1e-4 plus rtol 1e-3."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import model as lm

    cfg = dataclasses.replace(get_arch("recurrentgemma-2b").smoke_config(),
                              use_pallas_scan=False)
    cpu_params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(1))
    grads = []
    for dev in (torch.device("cpu"), cuda):
        p = tree_map(lambda t: t.to(dev), cpu_params)
        leaves = [t.detach().clone().requires_grad_(True) for t in tree_leaves(p)]
        loss, _ = lm.loss_fn(tree_unflatten(p, leaves), cfg, toks.to(dev), toks.to(dev))
        grads.append((loss, torch.autograd.grad(loss, leaves, allow_unused=True,
                                                materialize_grads=True)))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = grads
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, atol=1e-4, rtol=1e-3)
    for path, a, b in zip(tree_paths(cpu_params), g_gpu, g_cpu):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-3, msg=path)


# ------------------------------------- paged caches, keyed sampling, the fleet
@pytest.mark.cuda
def test_cuda_request_keys_and_bits_equal_the_cpu(cuda):
    """The threefry keys, bits and uniforms computed on the card's int64
    tensors equal the CPU's bit for bit (seeds next to 2**32 included)."""
    from repro_torch.serve import sampling, threefry

    rng = np.random.default_rng(0)
    seeds = np.concatenate([rng.integers(0, 2**32, 62), [2**32 - 1, 2**32 - 2]])
    rids = rng.integers(0, 2**31, 64)
    pos = rng.integers(0, 4096, 64)
    keys = {dev: sampling.request_key(*(torch.as_tensor(a, device=dev)
                                        for a in (seeds, rids, pos)))
            for dev in ("cpu", cuda)}
    for a, b in zip(keys["cpu"], keys[cuda]):
        assert torch.equal(a, b.cpu())
    assert torch.equal(threefry.random_bits(keys[cuda], 4099).cpu(),
                       threefry.random_bits(keys["cpu"], 4099))
    assert torch.equal(threefry.uniform(keys[cuda], 4099).cpu(),
                       threefry.uniform(keys["cpu"], 4099))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_keyed_sample_tokens_equal_the_cpu(cuda, dtype):
    """[8, 151,936] rows (qwen1.5-4b's vocabulary), greedy, sampled and
    filtered lanes: the card's tokens equal the CPU's on the same logits."""
    from repro_torch.serve import keyed_sample

    rng = np.random.default_rng(1)
    logits = torch.as_tensor(rng.standard_normal((8, 151_936)).astype(np.float32) * 3
                             ).to(dtype)
    rows = (rng.integers(0, 1000, 8).astype(np.int32),
            rng.integers(0, 2**32, 8, dtype=np.uint32),
            rng.integers(1, 1024, 8).astype(np.int32),
            np.array([0, 0.7, 0.7, 1.3, 0.7, 0.2, 1.0, 0.7], np.float32),
            np.array([0, 0, 50, 0, 50, 10, 0, 1], np.int32),
            np.array([1, 1, 0.9, 0.9, 1, 0.5, 0.95, 1], np.float32))
    assert torch.equal(keyed_sample(logits.to(cuda), *rows).cpu(),
                       keyed_sample(logits, *rows))


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id,block_size", [("qwen1.5-4b", 4), ("qwen1.5-4b", 5),
                                                ("deepseek-v2-lite-16b", 5),
                                                ("recurrentgemma-2b", 4)])
def test_cuda_paged_engine_equals_contiguous_sampled(cuda, arch_id, block_size):
    """A paged engine (a pool sized to the live tokens) generates the
    contiguous engine's tokens on the card, greedy and sampled lanes mixed,
    with every block back in the pool at the end."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import model as lm
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_arch(arch_id).smoke_config()
    params = lm.init(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in rng.integers(3, 12, 9)]
    outs = []
    for extra in ({}, dict(block_size=block_size, pool_blocks=4 * (-(-20 // block_size)))):
        eng = ServeEngine(params, cfg, ServeConfig(slots=4, max_len=24, max_new_tokens=8,
                                                   **extra), planes=2, device=cuda)
        rids = [eng.submit(p, temperature=0.8 * (i % 2), seed=i, top_k=20 * (i % 3 == 1))
                for i, p in enumerate(prompts)]
        got = eng.run()
        outs.append([got[r] for r in rids])
        assert all(r.status == "ok" for r in eng.router.done.values())
    assert outs[0] == outs[1]
    assert all(p.pool.available == p.pool.num_blocks for p in eng.planes)


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_cuda_fleet_kill_restores_equal_tokens(cuda, temperature):
    """The in-process kill drill on the card (float32 smoke config): worker
    1 dies mid-decode, its requests re-prefill on worker 0, and every
    request's tokens equal one engine's."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import model as lm
    from repro_torch.serve import (FleetEngine, LocalMailbox, ServeConfig, ServeEngine,
                                   ServeWorker)

    cfg = get_arch("qwen1.5-4b").smoke_config()
    params = lm.init(torch.Generator(device=cuda).manual_seed(1), cfg, device=cuda)
    sc = ServeConfig(slots=2, max_len=48, max_new_tokens=8, block_size=4)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 120, int(rng.integers(2, 10))) for _ in range(6)]
    kw = lambda i: dict(temperature=temperature, seed=40 + i)
    ref_eng = ServeEngine(params, cfg, sc, device=cuda)
    ref_rids = [ref_eng.submit(p, **kw(i)) for i, p in enumerate(prompts)]
    ref = ref_eng.run()
    now = [0.0]
    fleet = FleetEngine(sc, world=2, hb_timeout=1.5, clock=lambda: now[0])
    workers = {}
    for wid in range(2):
        inbox, outbox = LocalMailbox(), LocalMailbox()
        workers[wid] = ServeWorker(params, cfg, sc, worker_id=wid, inbox=inbox,
                                   outbox=outbox, device=cuda)
        fleet.attach(wid, send=inbox, recv=outbox)
    rids = [fleet.submit(p, **kw(i)) for i, p in enumerate(prompts)]
    n, killed = 0, False
    while fleet.pending() or n == 0:
        fleet.tracker.observe({0: n} if killed else {0: n, 1: n})
        fleet.tick()
        for wid, w in workers.items():
            if not (killed and wid == 1):
                w.tick()
        if not killed and n == 3:
            assert fleet.workers[1].inflight
            killed = True
            now[0] += 2.0
        now[0] += 0.01
        n += 1
        assert n < 800
    res = fleet.results()
    assert [res[r] for r in rids] == [ref[r] for r in ref_rids]
    assert fleet.workers[0].served == len(prompts)


# ----------------------------------------------------------- launch tooling
@pytest.mark.cuda
@pytest.mark.parametrize("arch_id,shape,placement", [
    ("pgt-dcrnn-pems-all-la", "train_all_la", "replicated"),
    ("qwen1.5-4b", "decode_32k", None)])
def test_cuda_dryrun_on_a_fake_cuda_mesh(cuda, arch_id, shape, placement):
    """One cell on a fake CUDA mesh of 256 ranks: a record in the JAX
    schema, the ST-GNN gradients reduced by one all-reduce of the float32
    parameter bytes, the decode cache written in place."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun, roofline

    kw = {"placement": placement} if placement else {}
    rec = dryrun.run_cell(arch_id, shape, device="cuda", verbose=False, **kw)
    assert rec["status"] == "ok", rec.get("error")
    assert not dist.is_initialized()
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"] < 80 * 2**30
    assert mem["peak_bytes"] % 512 == 0  # CUDA blocks
    assert rec["cost"]["flops"] > 0 and rec["chips"] == 256
    if placement:
        assert rec["collectives"]["all-reduce"] == 254_468  # 63,617 f32 parameters
        assert rec["collectives"]["total"] == rec["collectives"]["all-reduce"]
    else:
        assert mem["alias_bytes"] > 0
    assert roofline.summarize([rec])[0]["step_lower_bound_s"] > 0


@pytest.mark.cuda
def test_cuda_dry_run_at_one_rank_predicts_the_card(cuda):
    """At a 1x1 mesh over a one-rank NCCL group: the dry-run's FLOPs equal
    the counter's over the real step, and its peak is within 10 % of
    ``max_memory_allocated`` above the args' start."""
    import socket

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch import mesh as M
    from repro_torch.launch.costs import CUDA_BLOCK, CostCounter

    arch = get_arch("pgt-dcrnn-pems-all-la")
    arch = dataclasses.replace(arch, model=dataclasses.replace(arch.model, num_nodes=512))
    cell = dataclasses.replace(arch.shapes[0], global_batch=8)
    one = M.MeshSpec(("data", "model"), (1, 1))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        dm = M.device_mesh(one, "cuda")
        prog = specs.build_stgnn_train(arch, cell, one, series_len=400)
        pred = dryrun.count_cell(arch, cell, one, dm, block=CUDA_BLOCK, series_len=400)
        a = torch.ones(64, 64, device="cuda")  # the persistent cuBLAS(Lt) workspaces
        (a @ a, torch.addmm(a[0], a, a), torch.bmm(a[None], a[None]))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        args = specs.place_args(prog, dm, specs.random_local("cuda", 0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, loss = prog.fn(*args)
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated() - base
        assert torch.isfinite(loss.full_tensor())
        del state, loss
        counter = CostCounter(block=CUDA_BLOCK)
        with counter:
            prog.fn(*args)
        assert counter.costs.flops == pred.flops
        assert abs(measured - pred.peak) <= 0.10 * measured, (pred.peak, measured)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------- serving on a mesh
@pytest.fixture
def nccl_mesh(cuda):
    """A 1x1 (data, model) DeviceMesh over a one-rank NCCL group of this
    process, torn down after the test."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch import mesh as M

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield M.device_mesh(M.MeshSpec(("data", "model"), (1, 1)), "cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_linear_scan_on_dtensors_launches_the_kernel_on_local_shards(nccl_mesh, dtype):
    """DTensor operands (rows and channels split, on a one-rank mesh) run the
    kernel once on the local shard, bit-exact to the plain scan of the whole
    tensors; a split sequence raises."""
    from torch.distributed.tensor import DTensor, Shard

    g = torch.Generator(device="cuda").manual_seed(3)
    a = torch.sigmoid(torch.randn(4, 33, 96, generator=g, device="cuda")).to(dtype)
    b = torch.randn(4, 33, 96, generator=g, device="cuda").to(dtype)
    h0 = torch.randn(4, 96, generator=g, device="cuda")
    put = lambda t, *pl: DTensor.from_local(t, nccl_mesh, pl, run_check=False)
    before = ls_kernel.linear_scan.launches
    h, h_last = linear_scan(put(a, Shard(0), Shard(2)), put(b, Shard(0), Shard(2)),
                            put(h0, Shard(0), Shard(1)), use_pallas=True)
    torch.cuda.synchronize()
    assert ls_kernel.linear_scan.launches == before + 1
    want_h, want_last = linear_scan_ref(a, b, h0)
    assert tuple(h.placements) == (Shard(0), Shard(2))
    assert torch.equal(h.to_local(), want_h) and torch.equal(h_last.to_local(), want_last)
    with pytest.raises(ValueError, match="sequence dim is split"):
        linear_scan(put(a, Shard(0), Shard(1)), put(b, Shard(0), Shard(1)), use_pallas=True)


@pytest.mark.cuda
@pytest.mark.parametrize("block_size", [None, 5])
def test_cuda_sharded_qwen_smoke_plane_equals_the_unsharded_one(nccl_mesh, block_size):
    """qwen1.5-4b's smoke config served by ``ServeEngine(mesh=...)`` over a
    one-rank NCCL mesh and by the unsharded engine, greedy and sampled
    lanes: the same tokens, the cache placed as DTensors."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import model as lm
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_arch("qwen1.5-4b").smoke_config()
    params = lm.init(torch.Generator(device="cuda").manual_seed(2), cfg, device="cuda")
    sc = ServeConfig(slots=4, max_len=48, max_new_tokens=6, block_size=block_size)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 120, int(rng.integers(3, 12))) for _ in range(6)]
    outs = []
    for mesh in (None, nccl_mesh):
        eng = ServeEngine(params, cfg, sc, mesh=mesh, device="cuda")
        rids = [eng.submit(p, **({"temperature": 0.7, "top_k": 20, "top_p": 0.9, "seed": i}
                                 if i % 2 else {})) for i, p in enumerate(prompts)]
        out = eng.run()
        outs.append([out[r] for r in rids])
    assert outs[0] == outs[1]
    assert all(hasattr(t, "placements") for t in tree_leaves(eng.planes[0].cache))
    assert eng.planes[0].mesh.shape == {"data": 1, "model": 1}
