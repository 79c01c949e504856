"""The hand-written CUDA kernels against their plain PyTorch versions, on a
card.  Every test here is marked ``cuda`` and skips without a card (a CUDA
kernel has no CPU mode).  The file imports neither JAX nor the JAX package,
so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.diffusion_conv.kernel import hop_project, hop_project_plain
from repro_torch.kernels.linear_scan import kernel as ls_kernel
from repro_torch.kernels.linear_scan import linear_scan, linear_scan_ref
from repro_torch.kernels.window_gather import window_gather
from repro_torch.kernels.window_gather import kernel as wg_kernel

GATHER_SHAPES = [  # tests/test_kernels.py's window_gather cases, and two more
    (64, (24, 2), 6, 8, np.float32),
    (100, (13,), 5, 4, np.float32),
    (50, (), 7, 3, np.float32),
    (256, (128,), 24, 16, np.float32),
    (64, (7, 3), 4, 2, np.int32),
    (40, (130,), 3, 5, np.float32),
    (500, (13,), 7, 9, np.uint8),
    (300, (2716, 2), 24, 32, np.float32),  # main-path row width
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


@pytest.mark.cuda
@pytest.mark.parametrize("n,b,c,h", [(24, 2, 10, 8), (50, 3, 66, 128), (129, 4, 128, 64),
                                     (300, 5, 1, 3), (2716, 2, 66, 64)])
def test_cuda_hop_project_matches_plain(cuda, n, b, c, h):
    rng = np.random.default_rng(2)
    s = torch.as_tensor(_support(rng, n)).to(cuda)
    z, w, y = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(cuda)
               for shape in ((n, b, c), (c, h), (n, b, h)))
    w = w / c ** 0.5  # the model's init scale
    got = hop_project(s, z, w, y)
    torch.cuda.synchronize()
    want = hop_project_plain(s, z, w, y)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_hop_project_rejects_what_it_cannot_take(cuda):
    s = torch.eye(4, device=cuda)
    z = torch.zeros(4, 2, 129, device=cuda)
    with pytest.raises(ValueError, match="feature dim"):
        hop_project(s, z, torch.zeros(129, 3, device=cuda), torch.zeros(4, 2, 3, device=cuda))
    with pytest.raises(ValueError):
        hop_project(s.double(), z[..., :3].double(), torch.zeros(3, 3, device=cuda),
                    torch.zeros(4, 2, 3, device=cuda))


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
def test_cuda_linear_scan_rejects_what_it_cannot_take(cuda):
    a = torch.ones(2, 3, 4, device=cuda)
    with pytest.raises(ValueError, match="a must be"):
        linear_scan(a.double(), a.double(), use_pallas=True)
    with pytest.raises(ValueError, match="b must be"):
        linear_scan(a, a.bfloat16(), use_pallas=True)
    with pytest.raises(ValueError, match="h0 must be"):
        linear_scan(a, a, torch.zeros(2, 5, device=cuda), use_pallas=True)
