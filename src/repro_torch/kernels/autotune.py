"""Measured kernel autotuning: a variant registry + shape-bucketed dispatcher.

The port of the JAX package's measured dispatch.  Every op declares its
candidate lowerings (**variants**): the plain PyTorch reference, the other
plain alternatives (the ``take`` / ``fused`` gathers), and the hand-written
kernel over the launch shapes it really takes (the flash tiles of the
call's dtype; the other kernels launch at the fixed shapes of the
``"cuda"`` row, so their grid has one entry).  The **tuner** synthesizes
inputs at the call's **shape bucket** (the power-of-two envelope of every
dimension), admits only candidates whose VALUES match the reference, times
the admitted ones and keeps the fastest.
Verdicts are keyed ``op|backend|bucket|dtype`` and persisted to
``TUNING_<backend>.json``, written atomically and loaded defensively (a
missing, torn or foreign-backend file reads as empty).

The backend is the device type of the call's first tensor (``"cuda"`` or
``"cpu"``), read per call; verdicts and memos are keyed by it.  On a CUDA
tensor the candidates are the kernel's launch shapes only: the plain
version there is the admission oracle, never dispatched.  On a CPU tensor
every variant competes, the kernel variant running its plain version.

Modes (:func:`set_autotune`):

- ``"off"``  — the static default only: the plain version on the CPU (the
  ``slice`` gather), the kernel at the ``"cuda"`` row's launch shapes on the
  card; no file IO.
- ``"load"`` — a persisted verdict when one covers the bucket, else the
  static default; never measures.  The default mode.
- ``"tune"`` — like ``load``, but a cache miss measures the candidates and
  persists the verdict.

Where the port differs from the JAX package:

- Timing: CUDA events on the card (warmup, ``synchronize``, the median of
  ``iters``), ``perf_counter`` on the CPU.  Nothing is traced, so the
  tuning runs on the caller's thread.
- Cache location: ``build/tuning/`` under the checkout (git-ignored), never
  ``results/``, where the JAX tuner keeps its own ``TUNING_cpu.json`` under
  the same backend key.  The payload records ``torch.__version__`` and the
  device's name.
- No fallback that hides a kernel: a candidate or a dispatched variant that
  raises (a kernel that does not build, launch, or take the shape) raises,
  and so does tuning on the card when every launch shape of the kernel is
  rejected.  Two things fall back, and both are logged: a candidate whose
  values diverge from the reference is rejected ("may be slow, never
  wrong"), and a stale cache entry (a variant name that is not a candidate
  on this backend, or params outside the current grid) dispatches the
  static default.
- Admission of a non-exact variant compares in float32, element by element:
  ``|out - ref| <= atol + rtol·|ref| + eps·|ref| + slack`` with the JAX
  tolerances, ``eps`` the spacing of the output dtype at 1 (2^-7 for
  bfloat16, 1.2e-7 for float32) and ``slack`` the variant's own bound on
  rounding it does by design (zero unless it says otherwise).  ``eps·|ref|``
  covers the one rounding of each output to its dtype, in the variant and
  in the reference.  The flash kernel's slack is the rounding of its
  probabilities to bfloat16 before P·V, as the JAX kernel does: at most
  ``2^-8·Σ_j w_j·|v_j|`` per output, the attention of ``|v|``.  The JAX
  tolerances alone reject that rounding; every admitted candidate's entry
  records its error against both rules.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
import platform
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable

import torch

from repro_torch.kernels.common import (KernelDefaults, block_candidates,
                                        kernel_defaults, resolve_backend)

_LOG = logging.getLogger(__name__)

#: ``build/tuning`` under the checkout: git-ignored, and apart from the JAX
#: package's ``results/TUNING_<backend>.json``.
DEFAULT_CACHE_DIR = str(Path(__file__).resolve().parents[3] / "build" / "tuning")

# --------------------------------------------------------------------- policy


@dataclasses.dataclass(frozen=True)
class AutotunePolicy:
    """Process-wide dispatch policy (see the module docstring for the modes)."""

    mode: str = "load"                   # off | load | tune
    cache_dir: str = DEFAULT_CACHE_DIR   # TUNING_<backend>.json lives here
    warmup: int = 1                      # untimed calls per candidate
    iters: int = 5                       # timed calls per candidate; median wins


MODES = ("off", "load", "tune")

_LOCK = threading.RLock()
_policy = AutotunePolicy()
#: (bucket key, mode, cache_dir) -> Verdict — resolved dispatch decisions.
_MEMO: dict[tuple, "Verdict"] = {}
#: cache path -> entries dict loaded from disk (refreshed on policy change).
_FILE_MEMO: dict[str, dict] = {}


def autotune_policy() -> AutotunePolicy:
    return _policy


def set_autotune(mode: str | None = None, cache_dir: str | None = None,
                 warmup: int | None = None,
                 iters: int | None = None) -> AutotunePolicy:
    """Update the process-wide policy; clears the resolved-verdict memos."""
    global _policy
    if mode is not None and mode not in MODES:
        raise ValueError(f"autotune mode {mode!r}; expected one of {MODES}")
    kw = {k: v for k, v in dict(mode=mode, cache_dir=cache_dir, warmup=warmup,
                                iters=iters).items() if v is not None}
    with _LOCK:
        _policy = dataclasses.replace(_policy, **kw)
        _MEMO.clear()
        _FILE_MEMO.clear()
    return _policy


def reset_autotune() -> None:
    """Restore the default policy and drop every memo (tests)."""
    global _policy
    with _LOCK:
        _policy = AutotunePolicy()
        _MEMO.clear()
        _FILE_MEMO.clear()


@contextlib.contextmanager
def autotuning(**kw):
    """Scoped policy override: ``with autotuning(mode="tune", cache_dir=d):``"""
    global _policy
    with _LOCK:
        prev = _policy
    try:
        yield set_autotune(**kw)
    finally:
        with _LOCK:
            _policy = prev
            _MEMO.clear()
            _FILE_MEMO.clear()


# ------------------------------------------------------------ shape bucketing


def pow2_bucket(n: int) -> int:
    """The power-of-two envelope of ``n`` (1 for n <= 1)."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def bucket_key(op: str, backend: str, dims: dict, dtype) -> str:
    """Cache key: every dim rounded up to its power-of-two envelope, so one
    measured verdict covers the whole envelope instead of one exact shape.
    The same string as the JAX package's for the same dims and dtype."""
    parts = ",".join(f"{k}={pow2_bucket(v)}" for k, v in dims.items())
    return f"{op}|{backend}|{parts}|{str(dtype).removeprefix('torch.')}"


# ------------------------------------------------------------- tuning cache


def cache_path(backend: str, cache_dir: str | None = None) -> str:
    d = cache_dir if cache_dir is not None else _policy.cache_dir
    return os.path.join(d, f"TUNING_{backend}.json")


def load_cache(path: str, backend: str) -> dict:
    """The persisted entries, or ``{}`` — never an exception.

    A missing file, torn or corrupt JSON, a non-object payload, or a cache
    tuned for a different backend all read as empty: the dispatcher then
    retunes (``tune``) or uses the static default.
    """
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(data, dict) or data.get("backend") != backend:
        return {}
    entries = data.get("entries")
    return dict(entries) if isinstance(entries, dict) else {}


def _device_name(backend: str) -> str:
    if backend == "cuda" and torch.cuda.is_available():
        return torch.cuda.get_device_name()
    return platform.processor() or platform.machine() or backend


def save_cache(path: str, backend: str, entries: dict) -> None:
    """Merge ``entries`` into the persisted cache, atomically.

    Read-merge-replace: concurrent tuners interleave per key, last writer
    wins, and ``os.replace`` of a same-directory temporary file means no
    reader, nor a crash mid-write, ever sees a torn file.
    """
    merged = load_cache(path, backend)
    merged.update(entries)
    payload = {"schema": 1, "backend": backend, "torch": torch.__version__,
               "device": _device_name(backend), "entries": merged}
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".tuning-", dir=d)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


# ----------------------------------------------------------------- registry


@dataclasses.dataclass(frozen=True)
class Variant:
    """One candidate lowering of an op.

    ``build(static, params) -> fn(*tensors)``.  ``grid(bucket_dims, kd,
    dtype) -> (params, ...)`` is the launch-shape search space, derived from
    :class:`KernelDefaults` and limited to what the kernel takes at the
    bucket in ``dtype``; on the CPU a kernel variant runs its plain version,
    has no knobs, and its grid is ``({},)``.  ``kernel`` marks the hand-written
    kernel, the only candidate on a CUDA tensor.  ``exact`` selects the
    admission check against the reference: bit-equality for pure data
    movement, the float32 tolerance of the module docstring for float
    kernels, with ``slack(args, static)`` the variant's own rounding bound.
    """

    name: str
    build: Callable[[dict, dict], Callable]
    grid: Callable[[dict, KernelDefaults, Any], tuple] = lambda dims, kd, dtype: ({},)
    kernel: bool = False
    exact: bool = True
    atol: float = 1e-3
    rtol: float = 1e-3
    slack: Callable[[tuple, dict], Any] | None = None


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One tunable op: how to key it, synthesize it, and lower it.

    ``describe(args, static) -> (dims, dtype)`` extracts the bucketable
    dimensions.  ``variants()`` returns the candidates, reference FIRST (the
    admission oracle); lowerings are imported inside it.
    ``synth(bucket_dims, static, dtype, device)`` builds inputs at the
    bucket envelope from a seeded ``torch.Generator``.
    ``default(backend, dims) -> (variant, params)`` is the unmeasured
    choice: the plain version on the CPU, the kernel on the card.
    """

    name: str
    describe: Callable[[tuple, dict], tuple[dict, Any]]
    variants: Callable[[], tuple[Variant, ...]]
    synth: Callable[[dict, dict, Any, torch.device], tuple]
    default: Callable[[str, dict], tuple[str, dict]]


@dataclasses.dataclass(frozen=True)
class Verdict:
    """A resolved dispatch decision and where it came from."""

    variant: str
    params: dict
    us: float | None = None
    source: str = "default"  # default | cache | tuned


_OPS: dict[str, OpSpec] = {}


def register_op(spec: OpSpec) -> OpSpec:
    _OPS[spec.name] = spec
    return spec


def registered_ops() -> tuple[str, ...]:
    return tuple(_OPS)


# ------------------------------------------------------------------- tuning


def _timed(fn: Callable[[], Any], device: torch.device, *, warmup: int,
           iters: int) -> float:
    """Median seconds of ``iters`` calls after ``warmup`` untimed ones: CUDA
    events around each call on the card, the host clock on the CPU."""
    for _ in range(max(warmup, 0)):
        fn()
    times = []
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            for _ in range(max(iters, 1)):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(max(iters, 1)):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _leaves(x) -> list:
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _admission(ref, out, variant: Variant, slack=0.0) -> tuple[str | None, dict]:
    """Why ``out`` fails admission against ``ref`` (None if it passes), and
    for a non-exact variant its max abs error and its largest error as a
    share of the allowance (``of_allowance``) and of the JAX tolerances
    alone (``of_jax_tol``)."""
    rl, ol = _leaves(ref), _leaves(out)
    if len(rl) != len(ol):
        return f"{len(ol)} outputs, the reference has {len(rl)}", {}
    stats: dict = {}
    for r, o in zip(rl, ol):
        if r.shape != o.shape or r.dtype != o.dtype:
            return (f"{o.dtype} {tuple(o.shape)} where the reference gives "
                    f"{r.dtype} {tuple(r.shape)}"), {}
        if variant.exact:
            if not torch.equal(r, o):
                return "values diverge from ref (bit-exact required)", {}
            continue
        if not r.numel():
            continue
        r32, o32 = r.float(), o.float()
        err = (o32 - r32).abs()
        jax_tol = variant.atol + variant.rtol * r32.abs()
        allowance = jax_tol + torch.finfo(r.dtype).eps * r32.abs() + slack
        leaf = {"max_abs_err": float(err.max()),
                "of_allowance": round(float((err / allowance).max()), 4),
                "of_jax_tol": round(float((err / jax_tol).max()), 4)}
        stats = {k: max(x, stats.get(k, x)) for k, x in leaf.items()}
        if not bool((err <= allowance).all()):
            return (f"values diverge from ref (max abs err {stats['max_abs_err']:.3e}, "
                    f"{stats['of_allowance']} of the allowance; atol {variant.atol}, "
                    f"rtol {variant.rtol})"), stats
    return None, stats


def _candidates(spec: OpSpec, backend: str) -> tuple[Variant, ...]:
    """The variants that compete on ``backend``: the kernel alone on the
    card (the plain version is the oracle there), every variant on the CPU."""
    variants = spec.variants()
    return tuple(v for v in variants if v.kernel) if backend == "cuda" else variants


def _label(name: str, params: dict) -> str:
    if not params:
        return name
    inner = ",".join(f"{k}={v}" for k, v in sorted(params.items()))
    return f"{name}[{inner}]"


def _tune(spec: OpSpec, device: torch.device, dims: dict, static: dict, dtype,
          policy: AutotunePolicy) -> dict:
    """Measure every candidate at the bucket envelope; returns a cache entry.

    Inputs are synthesized at the bucket, not taken from the call, so the
    verdict stands for the whole envelope.  A candidate that raises raises,
    and so does a card bucket where no launch shape of the kernel passes.
    """
    kd = kernel_defaults(device)
    bdims = {k: pow2_bucket(v) for k, v in dims.items()}
    candidates: dict[str, dict] = {}
    best: tuple[str, dict, float] | None = None
    with torch.no_grad():
        sargs = spec.synth(bdims, static, dtype, device)
        ref_out = spec.variants()[0].build(static, {})(*sargs)
        for v in _candidates(spec, device.type):
            slack = 0.0 if v.slack is None else v.slack(sargs, static)
            for params in v.grid(bdims, kd, dtype):
                label = _label(v.name, params)
                fn = v.build(static, params)
                why, stats = _admission(ref_out, fn(*sargs), v, slack)
                if why is not None:
                    _LOG.warning("autotune %s %s: rejected %s: %s", spec.name,
                                 bdims, label, why)
                    candidates[label] = {"us": None, "rejected": why, **stats}
                    continue
                us = 1e6 * _timed(lambda: fn(*sargs), device,
                                  warmup=policy.warmup, iters=policy.iters)
                candidates[label] = {"us": round(us, 2), **stats}
                if best is None or us < best[2]:
                    best = (v.name, dict(params), us)
    if best is None:  # on the CPU the reference always matches itself
        raise RuntimeError(f"autotune {spec.name}: no launch shape of the kernel "
                           f"takes the bucket {bdims} and matches the plain "
                           f"version: {candidates or 'none in the grid'}")
    return {"variant": best[0], "params": best[1], "us": round(best[2], 2),
            "dims": dict(dims), "bucket": bdims, "candidates": candidates,
            "tuned_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}


# ----------------------------------------------------------------- dispatch


def _resolve(spec: OpSpec, device: torch.device, key: str, dims: dict,
             static: dict, dtype) -> Verdict:
    policy = _policy
    backend = device.type
    if policy.mode == "off":
        name, params = spec.default(backend, dims)
        return Verdict(name, params, source="default")
    memo_key = (key, policy.mode, policy.cache_dir)
    with _LOCK:
        hit = _MEMO.get(memo_key)
    if hit is not None:
        return hit
    path = cache_path(backend, policy.cache_dir)
    with _LOCK:
        entries = _FILE_MEMO.get(path)
        if entries is None:
            entries = load_cache(path, backend)
            _FILE_MEMO[path] = entries
    entry = entries.get(key)
    if isinstance(entry, dict) and isinstance(entry.get("variant"), str):
        v = Verdict(entry["variant"], dict(entry.get("params") or {}),
                    entry.get("us"), "cache")
    elif policy.mode == "tune":
        entry = _tune(spec, device, dims, static, dtype, policy)
        with _LOCK:
            entries[key] = entry
            save_cache(path, backend, {key: entry})
        v = Verdict(entry["variant"], dict(entry["params"]), entry["us"],
                    "tuned")
    else:
        name, params = spec.default(backend, dims)
        v = Verdict(name, params, source="default")
    with _LOCK:
        _MEMO[memo_key] = v
    return v


def verdict_for(op: str, *args, **static) -> Verdict:
    """The dispatch decision for this call, without executing it."""
    spec = _OPS[op]
    dims, dtype = spec.describe(args, static)
    backend = resolve_backend(args[0])
    return _resolve(spec, args[0].device, bucket_key(op, backend, dims, dtype),
                    dims, static, dtype)


def dispatch(op: str, *args, **static):
    """Run ``op`` through its measured (or default) lowering.

    Resolution happens per call: the backend read from the first tensor
    now, the bucket computed from the call's shapes, the verdict looked up
    (memoized per bucket key, which names the backend).  A stale cache entry
    (a variant that is not a candidate on this backend, or params outside
    the current grid) is logged and dispatches the static default; a
    variant that raises raises.
    """
    spec = _OPS[op]
    device = args[0].device
    dims, dtype = spec.describe(args, static)
    key = bucket_key(op, resolve_backend(args[0]), dims, dtype)
    verdict = _resolve(spec, device, key, dims, static, dtype)
    by_name = {v.name: v for v in _candidates(spec, device.type)}
    var = by_name.get(verdict.variant)
    if var is None or (verdict.source == "cache" and verdict.params not in var.grid(
            {k: pow2_bucket(n) for k, n in dims.items()}, kernel_defaults(device),
            dtype)):
        name, params = spec.default(device.type, dims)
        _LOG.warning("autotune %s: stale cache entry %s for %s; dispatching "
                     "the default %s", op, _label(verdict.variant, verdict.params),
                     key, _label(name, params))
        var, verdict = by_name[name], Verdict(name, params, source="default")
    return var.build(static, verdict.params)(*args)


# ------------------------------------------------------------- op specs
# Lowerings are imported inside variants()/build: the ops modules import this
# module for impl="auto", and the laziness breaks the cycle.


def _gen(device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def _randn(shape, dtype, gen, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _synth_series(t: int, c: int, dtype, gen, device) -> torch.Tensor:
    if dtype.is_floating_point:
        return _randn((t, c), dtype, gen, device)
    return torch.randint(0, 100, (t, c), generator=gen, device=device, dtype=dtype)


def _kernel_or_ref(params_for_kernel: Callable[[KernelDefaults], dict]):
    """Static default: the plain version on the CPU, the kernel at the
    ``"cuda"`` row's launch shapes on the card."""

    def default(backend: str, dims: dict) -> tuple[str, dict]:
        kd = kernel_defaults(backend)
        return ("pallas", params_for_kernel(kd)) if kd.kernel else ("ref", {})

    return default


def _span_starts(bdims, span, dtype, device):
    gen = _gen(device)
    t = max(bdims["t"], span)
    series = _synth_series(t, bdims["c"], dtype, gen, device)
    starts = torch.randint(0, max(t - span + 1, 1), (bdims["b"],), generator=gen,
                           device=device, dtype=torch.int32)
    return series, starts


# window_gather: series [T, ...], starts [B] -> [B, span, ...]


def _wg_describe(args, static):
    series, starts = args
    return ({"t": series.shape[0], "c": math.prod(series.shape[1:]),
             "b": starts.shape[0], "span": static["span"]}, series.dtype)


def _wg_synth(bdims, static, dtype, device):
    return _span_starts(bdims, static["span"], dtype, device)


def _wg_variants() -> tuple[Variant, ...]:
    def ref(static, params):
        from repro_torch.kernels.window_gather.ref import window_gather_ref
        span = static["span"]
        return lambda s, st: window_gather_ref(s, st, span=span)

    def take(static, params):
        span = static["span"]

        def fn(series, starts):
            offs = torch.arange(span, dtype=torch.long, device=series.device)
            idx = (starts.to(torch.long)[:, None] + offs[None, :]).reshape(-1)
            return series.index_select(0, idx).reshape(
                (starts.shape[0], span) + tuple(series.shape[1:]))

        return fn

    def pallas(static, params):
        from repro_torch.kernels.window_gather.ops import window_gather
        span = static["span"]
        return lambda s, st: window_gather(s, st, span=span, use_pallas=True)

    return (Variant("ref", ref),
            Variant("take", take),
            Variant("pallas", pallas, kernel=True))


register_op(OpSpec(
    name="window_gather",
    describe=_wg_describe,
    variants=_wg_variants,
    synth=_wg_synth,
    default=_kernel_or_ref(lambda kd: {}),
))


# gather: the pipeline-level (x, y) window gather —
# gather(series, starts, input_len=, horizon=) -> (x, y)


def _xy_describe(args, static):
    series, starts = args
    return ({"t": series.shape[0], "c": math.prod(series.shape[1:]),
             "b": starts.shape[0],
             "span": static["input_len"] + static["horizon"]}, series.dtype)


def _xy_synth(bdims, static, dtype, device):
    return _span_starts(bdims, static["input_len"] + static["horizon"], dtype,
                        device)


def _xy_variants() -> tuple[Variant, ...]:
    def _wrap(gather_fn, static):
        il, hz = static["input_len"], static["horizon"]
        return lambda s, st: gather_fn(s, st, input_len=il, horizon=hz)

    def slice_(static, params):
        from repro_torch.core.batching import gather_batch
        return _wrap(gather_batch, static)

    def take(static, params):
        from repro_torch.core.batching import gather_batch_take
        return _wrap(gather_batch_take, static)

    def fused(static, params):
        from repro_torch.core.batching import gather_batch_fused
        return _wrap(gather_batch_fused, static)

    def pallas(static, params):
        from repro_torch.kernels.window_gather.ops import window_gather
        il, hz = static["input_len"], static["horizon"]

        def fn(series, starts):
            w = window_gather(series, starts, span=il + hz, use_pallas=True)
            return w[:, :il], w[:, il:]

        return fn

    return (Variant("slice", slice_),
            Variant("take", take),
            Variant("fused", fused),
            Variant("pallas", pallas, kernel=True))


def _xy_default(backend: str, dims: dict) -> tuple[str, dict]:
    return ("pallas", {}) if kernel_defaults(backend).kernel else ("slice", {})


register_op(OpSpec(
    name="gather",
    describe=_xy_describe,
    variants=_xy_variants,
    synth=_xy_synth,
    default=_xy_default,
))


# linear_scan: h_t = a_t * h_{t-1} + b_t over [B, S, D]


def _ls_describe(args, static):
    a = args[0]
    return ({"b": a.shape[0], "s": a.shape[1], "d": a.shape[2]}, a.dtype)


def _ls_synth(bdims, static, dtype, device):
    gen = _gen(device)
    shape = (bdims["b"], bdims["s"], bdims["d"])
    a = (0.7 + 0.3 * torch.rand(shape, generator=gen, device=device)).to(dtype)
    b = _randn(shape, dtype, gen, device)
    h0 = torch.zeros((bdims["b"], bdims["d"]), dtype=dtype, device=device)
    return a, b, h0


def _ls_variants() -> tuple[Variant, ...]:
    def ref(static, params):
        from repro_torch.kernels.linear_scan.ref import linear_scan_ref
        return linear_scan_ref

    def pallas(static, params):
        from repro_torch.kernels.linear_scan.ops import linear_scan
        return lambda a, b, h0: linear_scan(a, b, h0, use_pallas=True)

    return (Variant("ref", ref),
            Variant("pallas", pallas, kernel=True, exact=False))


register_op(OpSpec(
    name="linear_scan",
    describe=_ls_describe,
    variants=_ls_variants,
    synth=_ls_synth,
    default=_kernel_or_ref(lambda kd: {}),
))


# flash_attention: q [B, S, H, D], k/v [B, S, Hkv, D] (model layout)


def _fa_describe(args, static):
    q, k, _ = args
    return ({"b": q.shape[0], "s": q.shape[1], "h": q.shape[2],
             "hkv": k.shape[2], "d": q.shape[3]}, q.dtype)


def _fa_synth(bdims, static, dtype, device):
    gen = _gen(device)
    b, s, h, hkv, d = (bdims["b"], bdims["s"], bdims["h"], bdims["hkv"],
                       bdims["d"])
    h = max(h, hkv) // hkv * hkv  # grouped-query: H must divide by Hkv
    return (_randn((b, s, h, d), dtype, gen, device),
            _randn((b, s, hkv, d), dtype, gen, device),
            _randn((b, s, hkv, d), dtype, gen, device))


def _fa_grid(dims: dict, kd: KernelDefaults, dtype) -> tuple:
    """Square tiles of the dtype's kernel (float32: around the default;
    bfloat16: its one tile) that fit shared memory at the bucket's head dim;
    a tile of twice the sequence or more is skipped (the half tile already
    covers the sequence)."""
    from repro_torch.kernels.flash_attention.kernel import BF16_BLOCK, MAX_D, fits
    if not kd.kernel:
        return ({},)
    if dims["d"] > MAX_D:
        return ()
    blocks = ((BF16_BLOCK,) if dtype == torch.bfloat16
              else block_candidates(kd.block_q, hi=128))
    return tuple({"block_q": b, "block_k": b} for b in blocks
                 if (b == blocks[0] or b // 2 < dims["s"])
                 and fits(b, b, dims["d"], dtype))


def _fa_slack(args, static):
    """The kernel's bfloat16 probabilities: each p carries a relative
    rounding error of at most 2^-8, so an output moves by at most 2^-8 times
    the attention of |v| (zero in float32, where p is not rounded)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    q, k, v = args
    if q.dtype != torch.bfloat16:
        return 0.0
    return 2.0 ** -8 * flash_attention(q.float(), k.float(), v.float().abs(),
                                       causal=static["causal"])


def _fa_variants() -> tuple[Variant, ...]:
    def ref(static, params):
        from repro_torch.kernels.flash_attention.ops import flash_attention
        causal = static["causal"]
        return lambda q, k, v: flash_attention(q, k, v, causal=causal)

    def pallas(static, params):
        from repro_torch.kernels.flash_attention.ops import flash_attention
        causal = static["causal"]
        bq, bk = params.get("block_q"), params.get("block_k")
        return lambda q, k, v: flash_attention(q, k, v, causal=causal,
                                               use_pallas=True, block_q=bq,
                                               block_k=bk)

    return (Variant("ref", ref),
            Variant("pallas", pallas, grid=_fa_grid, kernel=True, exact=False,
                    atol=2e-3, rtol=2e-3, slack=_fa_slack))


register_op(OpSpec(
    name="flash_attention",
    describe=_fa_describe,
    variants=_fa_variants,
    synth=_fa_synth,
    default=_kernel_or_ref(lambda kd: {"block_q": kd.block_q,
                                       "block_k": kd.block_k}),
))


# diffusion_conv: x [B, N, C], supports (tuple of [N, N]), w, bias


def _dc_describe(args, static):
    x, _, w, _ = args
    return ({"b": x.shape[0], "n": x.shape[1], "c": x.shape[2],
             "h": w.shape[1]}, x.dtype)


def _dc_synth(bdims, static, dtype, device):
    gen = _gen(device)
    b, n, c, h = bdims["b"], bdims["n"], bdims["c"], bdims["h"]
    k, ns = static["k_hops"], static["n_supports"]
    supports = []
    for _ in range(ns):
        adj = torch.rand((n, n), generator=gen, device=device)
        adj = torch.where(adj < 0.5, 0.0, adj)
        adj.fill_diagonal_(1.0)
        supports.append((adj / adj.sum(1, keepdim=True)).to(dtype))
    x = _randn((b, n, c), dtype, gen, device)
    w = (torch.randn(((1 + ns * k) * c, h), generator=gen, device=device)
         * 0.1).to(dtype)
    return x, tuple(supports), w, torch.zeros((h,), dtype=dtype, device=device)


def _dc_variants() -> tuple[Variant, ...]:
    def ref(static, params):
        from repro_torch.kernels.diffusion_conv.ref import diffusion_conv_ref
        k = static["k_hops"]
        return lambda x, sup, w, b: diffusion_conv_ref(x, sup, w, b, k_hops=k)

    def pallas(static, params):
        from repro_torch.kernels.diffusion_conv.ops import diffusion_conv
        k = static["k_hops"]
        return lambda x, sup, w, b: diffusion_conv(x, sup, w, b, k_hops=k,
                                                   use_pallas=True)

    return (Variant("ref", ref),
            # One launch shape at every C: the hop tile is fixed in its
            # source, and C above its MAX_C runs as column tiles.
            Variant("pallas", pallas, kernel=True, exact=False))


register_op(OpSpec(
    name="diffusion_conv",
    describe=_dc_describe,
    variants=_dc_variants,
    synth=_dc_synth,
    default=_kernel_or_ref(lambda kd: {}),
))
