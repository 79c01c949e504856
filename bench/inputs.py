"""Every input of a run, made from ``--seed``: the sensor graph, the raw
series, the initial weights and the window ids of every batch. The program
and the reference are handed the same ones.

The series has the shape of a PeMS speed feed at full scale: per-sensor
free-flow speed with two rush-hour dips a day, AR(1) noise smoothed over the
sensor graph, and the time of day as the second feature. It is made on the
device in blocks of rows and copied into one host array, the raw input the
program's ``IndexDataset.from_raw`` takes.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

STEPS_PER_DAY = 288  # 5-minute bins, as PeMS
AR = 0.4675  # AR(1) coefficient of the noise (0.85 damped by 0.55 a step)
TAPS = 32  # AR's impulse response is cut where it falls below 3e-11
BLOCK_ROWS = 2048

# Tags of the independent streams drawn from one seed.
COORDS, SERIES, WEIGHTS, TRAFFIC = range(4)


def stream_seed(seed: int, tag: int) -> int:
    """A 63-bit seed of stream ``tag`` of run ``seed`` (any whole number)."""
    entropy = [abs(seed) % 2 ** 64, int(seed < 0), tag]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)


@dataclasses.dataclass
class Inputs:
    adjacency: np.ndarray  # [N, N] float32, the Gaussian kernel of road distance
    raw: np.ndarray  # [T, N, F] float32, host
    params: dict  # the initial weights in the port's tree layout, on the host
    splits: dict  # split name -> window ids


def sensor_coords(nodes: int, seed: int) -> np.ndarray:
    """Sensors in clusters along straight roads of about 64 sensors."""
    rng = np.random.default_rng(stream_seed(seed, COORDS))
    roads = max(1, nodes // 64)
    counts = [nodes // roads + (r < nodes % roads) for r in range(roads)]
    start = rng.uniform(0, 100, size=(roads, 2))
    direction = rng.standard_normal((roads, 2))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    road = np.repeat(np.arange(roads), counts)
    along = rng.uniform(0, 60, size=nodes)
    pts = start[road] + along[:, None] * direction[road]
    return pts + rng.standard_normal((nodes, 2)) * 0.5


def gaussian_adjacency(coords: np.ndarray, device, threshold: float = 0.1) -> torch.Tensor:
    """W_ij = exp(-d_ij^2 / sigma^2), zeroed below ``threshold``, ones on the
    diagonal (DCRNN eq. 10); sigma the standard deviation of the distances."""
    c = torch.as_tensor(coords, dtype=torch.float32, device=device)
    d = torch.cdist(c, c, compute_mode="donot_use_mm_for_euclid_dist")
    w = torch.exp(-(d / d.std()) ** 2)
    del d
    w[w < threshold] = 0.0
    w.fill_diagonal_(1.0)
    return w


def make_series(entries: int, features: int, adjacency: torch.Tensor,
                seed: int) -> np.ndarray:
    """``[entries, N, features]`` float32 on the host."""
    device = adjacency.device
    n = adjacency.shape[0]
    gen = torch.Generator(device).manual_seed(stream_seed(seed, SERIES))
    u = torch.rand((3, n), generator=gen, device=device)
    free_flow, dip, phase = 55.0 + 15.0 * u[0], 10.0 + 20.0 * u[1], 0.1 * u[2] - 0.05
    smooth = adjacency / (adjacency.sum(dim=1, keepdim=True) + 1e-6)
    taps = 1.1 * AR ** torch.arange(TAPS, device=device, dtype=torch.float32)
    carry = torch.randn((TAPS - 1, n), generator=gen, device=device)
    host = np.empty((entries, n, features), dtype=np.float32)
    out = torch.from_numpy(host)
    for lo in range(0, entries, BLOCK_ROWS):
        rows = min(BLOCK_ROWS, entries - lo)
        shocks = torch.cat([carry, torch.randn((rows, n), generator=gen, device=device)])
        noise = sum(taps[k] * shocks[TAPS - 1 - k:TAPS - 1 - k + rows] for k in range(TAPS))
        carry = shocks[rows:]
        noise = noise + 0.5 * noise @ smooth.T
        tod = ((lo + torch.arange(rows, device=device)) % STEPS_PER_DAY).float() / STEPS_PER_DAY

        def rush(center):
            return torch.exp(-0.5 * ((tod[:, None] - center - phase) / 0.06) ** 2)

        block = torch.empty((rows, n, features), device=device)
        block[..., 0] = (free_flow - dip * (rush(0.33) + 0.8 * rush(0.71)) + noise).clamp(3.0, 85.0)
        if features > 1:
            block[..., 1] = tod[:, None]
        if features > 2:
            block[..., 2:] = torch.randn((rows, n, features - 2), generator=gen, device=device)
        out[lo:lo + rows].copy_(block)
    return host


#: A leaf spec's ``fan_in`` for a leaf that starts at one (a norm's gain).
ONES = "ones"


def make_params(specs, seed: int, device) -> dict:
    """The weights of ``specs`` (``(path, shape, fan_in)``) in one draw on
    the device: normal over sqrt(fan_in); biases (``fan_in`` None) zero;
    gains (``fan_in`` :data:`ONES`) one. Zeros and ones take no draw."""
    gen = torch.Generator(device).manual_seed(stream_seed(seed, WEIGHTS))
    drawn = [spec for spec in specs if spec[2] not in (None, ONES)]
    flat = torch.randn((sum(math.prod(shape) for _, shape, _ in drawn),),
                       generator=gen, device=device)
    tree: dict = {}
    offset = 0
    for path, shape, fan_in in specs:
        if fan_in is None:
            leaf = torch.zeros(shape, device=device)
        elif fan_in == ONES:
            leaf = torch.ones(shape, device=device)
        else:
            size = math.prod(shape)
            leaf = flat[offset:offset + size].view(shape) / fan_in ** 0.5
            offset += size
        put(tree, path, leaf)
    return tree


def put(tree, path: tuple, leaf) -> None:
    """Set ``tree[path]``, making the dicts (str keys) and lists (int keys)
    on the way."""
    for key, nxt in zip(path, path[1:]):
        empty = [] if isinstance(nxt, int) else {}
        if isinstance(tree, list):
            while len(tree) <= key:
                tree.append(type(empty)())
            tree = tree[key]
        else:
            tree = tree.setdefault(key, empty)
    if isinstance(tree, list):
        while len(tree) <= path[-1]:
            tree.append(None)
    tree[path[-1]] = leaf


def to_device(tree, device):
    """A copy of a tree of dicts and lists of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.detach().to(device, copy=True)


def leaves(tree, prefix: tuple = ()) -> dict:
    """``{path: leaf}`` of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(leaves(sub, prefix + (key,)))
    return out


def batches(ids: np.ndarray, batch: int, seed: int):
    """Endless window-id batches over ``ids``: a fresh permutation a pass,
    so no window repeats within one."""
    rng = np.random.default_rng(stream_seed(seed, TRAFFIC))
    while True:
        perm = rng.permutation(ids)
        for lo in range(0, len(perm) - batch + 1, batch):
            yield perm[lo:lo + batch]
