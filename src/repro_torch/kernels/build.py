"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``build/kernels/<name>-<hash>.so`` under the checkout),
for ``sm_90a``.  The libraries are built at first use; :func:`build` starts
one ``nvcc`` per source, all at once, and waits for them together.  The file
name carries a hash of the source, of every shared header ``csrc/*.cuh`` and
of the flags, so an edit to any of them rebuilds and an unchanged source is
reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCES = ("window_gather", "hop_project", "hop_gemm", "linear_scan", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parents[3] / "build" / "kernels"
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the CUDA "
                           "kernels are built from source at first use")
    return path


def library_path(name: str) -> Path:
    if name not in SOURCES:
        raise ValueError(f"unknown kernel source {name!r}; known: {SOURCES}")
    digest = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD / f"{name}-{digest.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, in parallel.

    Returns ``{name: compiler output}`` (ptxas's register and shared-memory
    report) for the sources compiled by this call.  Raises with the compiler
    output if any ``nvcc`` fails; every started compiler is waited for or
    killed before this returns.
    """
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, out)
        reports = {}
        for name, (proc, tmp, out) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            os.replace(tmp, out)
            reports[name] = log
        return reports
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
