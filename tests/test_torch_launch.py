"""The launch-shape rules of the hand-written scan and gather, on the CPU.

Both kernels take their launch shape from the call's shape alone (and the
card's SM count), through pure functions of their launchers; the kernels
themselves run on the card only (tests/test_torch_cuda.py).
"""
import math

import pytest

from repro_torch.kernels.linear_scan.kernel import scan_threads
from repro_torch.kernels.window_gather.kernel import PIECE_BYTES, launch_shape

H100_SMS = 132
RG_LRU_WIDTH = 2560
# (B, D) of recurrentgemma-2b's scans on the serving path: decode over 8
# lanes and the prompt groups, plus narrow and ragged widths.
SCAN_SHAPES = [(8, RG_LRU_WIDTH), (4, RG_LRU_WIDTH), (2, RG_LRU_WIDTH),
               (1, RG_LRU_WIDTH), (3, 33), (5, 7), (5, 129), (1, 1), (500, 7),
               (2, 4224), (1, 4225), (133, 64)]


@pytest.mark.parametrize("batch,dim", SCAN_SHAPES)
def test_scan_blocks_cover_every_sm_where_the_channels_allow(batch, dim):
    threads = scan_threads(batch, dim, H100_SMS)
    assert threads in (32, 64)
    blocks = batch * math.ceil(dim / threads)
    if batch * dim >= H100_SMS * 32:
        assert blocks >= H100_SMS
    if threads == 64:
        assert dim > 32  # the channel tile fits D: no second warp of idle lanes


def test_scan_threads_at_the_serving_shapes():
    """Two warps where B·ceil(D/64) still fills the card, one below."""
    assert scan_threads(8, RG_LRU_WIDTH, H100_SMS) == 64   # 320 blocks
    assert scan_threads(4, RG_LRU_WIDTH, H100_SMS) == 64   # 160 blocks
    assert scan_threads(2, RG_LRU_WIDTH, H100_SMS) == 32   # 160 blocks, not 80
    assert scan_threads(1, RG_LRU_WIDTH, H100_SMS) == 32   # 80 blocks: B·D < 132 x 32
    assert scan_threads(1000, 32, H100_SMS) == 32          # D fits one warp
    assert scan_threads(2, RG_LRU_WIDTH, 64) == 64         # a smaller card


MAIN_ROW = 2716 * 2 * 4  # pgt-dcrnn-pems-all-la: 2,716 nodes x 2 features, f32


@pytest.mark.parametrize("row_bytes", [MAIN_ROW, 16, 48 * 4, 36_000, 10_000 * 4])
def test_gather_takes_the_bulk_route_for_16_byte_rows(row_bytes):
    route, blocks = launch_shape(32, 24, row_bytes, aligned=True, sms=H100_SMS)
    pieces = math.ceil(32 * 24 * row_bytes / PIECE_BYTES)
    assert route == "bulk" and blocks == min(pieces, H100_SMS)
    assert PIECE_BYTES % 16 == 0


@pytest.mark.parametrize("row_bytes", [130 * 4, 13, 7 * 4, 7 * 3 * 4, 8, MAIN_ROW + 4])
def test_gather_takes_the_vector_route_for_ragged_rows(row_bytes):
    assert launch_shape(32, 24, row_bytes, aligned=True, sms=H100_SMS) == ("vector", 32 * 24)


def test_gather_route_needs_aligned_bases_and_caps_blocks_at_the_sms():
    assert launch_shape(32, 24, MAIN_ROW, aligned=False, sms=H100_SMS) == ("vector", 768)
    # the main path: 16.7 MB of output, 4,075 pieces' worth over 132 blocks
    assert launch_shape(32, 24, MAIN_ROW, aligned=True, sms=H100_SMS) == ("bulk", 132)
    # less output than SMs x one piece: a block a piece's worth of bytes
    assert launch_shape(2, 5, 192, aligned=True, sms=H100_SMS) == ("bulk", 1)
    assert launch_shape(3, 2, 40_000, aligned=True, sms=H100_SMS) == ("bulk", 59)
