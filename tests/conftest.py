"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests run on the single real
CPU device; only repro.launch.dryrun forces 512 placeholder devices.

Also installs a seeded-example fallback for ``hypothesis`` so the property
suites (`test_windows.py`, `test_sampler.py`, `test_kernels.py`,
`test_flash_attention.py`, `test_index_batching.py`) run on a bare pytest
install: when the real library is absent, ``@given`` draws a fixed number of
deterministic examples (seeded from the test name) from mini-strategies that
cover the subset of the API these tests use.  With hypothesis installed the
real library is used untouched.
"""
import sys
import types
import zlib

import jax
import numpy as np
import pytest

jax.config.update("jax_enable_x64", False)

# Cap for the fallback: property tests declare up to 200 examples, which the
# real hypothesis shrinks/reuses efficiently; the seeded fallback just replays
# N deterministic draws, so keep N small enough for a fast CI suite.
_FALLBACK_MAX_EXAMPLES = 25


def _install_hypothesis_fallback() -> None:
    class _Strategy:
        def __init__(self, draw_fn):
            self._draw_fn = draw_fn

        def example(self, rng):
            return self._draw_fn(rng)

    def integers(lo, hi):
        return _Strategy(lambda rng: int(rng.integers(lo, hi + 1)))

    def floats(lo, hi, **_):
        return _Strategy(lambda rng: float(rng.uniform(lo, hi)))

    def sampled_from(seq):
        items = list(seq)
        return _Strategy(lambda rng: items[int(rng.integers(0, len(items)))])

    def lists(elem, *, min_size=0, max_size=None):
        hi = min_size + 8 if max_size is None else max_size

        def draw(rng):
            n = int(rng.integers(min_size, hi + 1))
            return [elem.example(rng) for _ in range(n)]

        return _Strategy(draw)

    def composite(fn):
        def build(*args, **kwargs):
            return _Strategy(
                lambda rng: fn(lambda s: s.example(rng), *args, **kwargs))

        return build

    def settings(*, max_examples=20, deadline=None, **_):
        def deco(fn):
            fn._fallback_max_examples = max_examples
            return fn

        return deco

    def given(*arg_strategies, **kw_strategies):
        def deco(fn):
            declared = getattr(fn, "_fallback_max_examples", 20)
            n_examples = min(declared, _FALLBACK_MAX_EXAMPLES)
            seed = zlib.crc32(fn.__qualname__.encode())

            def wrapper(*args, **kwargs):
                rng = np.random.default_rng(seed)
                for _ in range(n_examples):
                    drawn = tuple(s.example(rng) for s in arg_strategies)
                    drawn_kw = {k: s.example(rng)
                                for k, s in kw_strategies.items()}
                    fn(*args, *drawn, **kwargs, **drawn_kw)

            # NOT functools.wraps: copying __wrapped__ would make pytest
            # resolve the original signature and demand fixtures for the
            # drawn parameters.
            for attr in ("__name__", "__qualname__", "__doc__", "__module__",
                         "pytestmark"):
                if hasattr(fn, attr):
                    setattr(wrapper, attr, getattr(fn, attr))
            return wrapper

        return deco

    mod = types.ModuleType("hypothesis")
    mod.given = given
    mod.settings = settings
    strategies = types.ModuleType("hypothesis.strategies")
    strategies.integers = integers
    strategies.floats = floats
    strategies.sampled_from = sampled_from
    strategies.lists = lists
    strategies.composite = composite
    mod.strategies = strategies
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = strategies


try:
    import hypothesis  # noqa: F401
except ImportError:
    _install_hypothesis_fallback()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


# --------------------------------------------------- multi-host harness kit
# Fixtures for tests that drive REAL subprocesses (tests/multihost.py): the
# pytest process itself has already initialised a single-CPU jax backend, so
# every jax.distributed participant must be a fresh subprocess with its own
# XLA_FLAGS/coordinator env — these fixtures own that plumbing.

@pytest.fixture
def free_port():
    """Callable returning an OS-assigned free TCP port (coordinator/transport
    addresses for subprocess fleets)."""
    import socket

    def get() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    return get


@pytest.fixture(scope="session")
def repo_root():
    import os
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="session")
def results_dir(repo_root):
    """``results/`` at the repo root — where harnesses drop the JSON evidence
    files CI uploads as artifacts."""
    import os
    d = os.path.join(repo_root, "results")
    os.makedirs(d, exist_ok=True)
    return d


@pytest.fixture
def mh_spawn(repo_root):
    """Launch ``tests/multihost.py`` subprocess roles (worker / announce).

    Returns ``spawn(argv, *, devices, log) -> subprocess.Popen``: PYTHONPATH
    points at ``src``, XLA_FLAGS forces ``devices`` CPU devices, and stdout/
    stderr append to the ``log`` file (pipes would deadlock on XLA's crash
    dumps, and the files double as CI artifacts).  Every spawned process is
    terminated at fixture teardown so a failing driver can't leak a fleet.
    """
    import os
    import subprocess
    import sys

    procs: list[subprocess.Popen] = []
    logs: list = []
    script = os.path.join(repo_root, "tests", "multihost.py")

    def spawn(argv, *, devices: int = 1, log: str | None = None):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.join(repo_root, "src") + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        env["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={devices}")
        env.setdefault("JAX_PLATFORMS", "cpu")
        if log is not None:
            sink = open(log, "a")
            logs.append(sink)
        else:
            sink = subprocess.DEVNULL
        p = subprocess.Popen([sys.executable, script, *[str(a) for a in argv]],
                             env=env, stdout=sink, stderr=subprocess.STDOUT)
        procs.append(p)
        return p

    yield spawn
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in logs:
        f.close()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (hand-written CUDA kernels); "
                   "skipped without one")
