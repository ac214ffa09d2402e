"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/torch_kernels/lib<name>-<hash>.so`` at the repository root.
The hash covers the source, every shared header ``csrc/*.cuh`` and the
flags, so an edited source or header never reuses a stale library. Nothing builds at import: the first call that needs a
kernel builds it (a few seconds per source), and :func:`build` starts one
``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
# No --use_fast_math: the kernels rely on IEEE division and rounding.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}   # name -> nvcc/ptxas output of the last build
build_seconds: dict[str, float] = {}   # name -> wall time of its last build


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the port's CUDA kernels are "
        "built from source at first use and need the CUDA toolkit")


def library_path(name: str, csrc: Path = CSRC) -> Path:
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict[str, Path]:
    """Compile every named source that has no library yet, all nvcc
    processes at once; raise with the compiler's output on any failure."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        log = tmp.with_suffix(".log")
        with open(log, "w") as out:
            procs[n] = (tmp, log, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=out, stderr=subprocess.STDOUT))
    running = dict(procs)
    while running:   # poll, so each source's wall time is its own
        for n, (_, _, proc) in list(running.items()):
            if proc.poll() is not None:
                build_seconds[n] = time.perf_counter() - t0
                del running[n]
        time.sleep(0.1)
    failed = []
    for n, (tmp, log, proc) in procs.items():
        build_logs[n] = log.read_text()
        log.unlink(missing_ok=True)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu:\n{build_logs[n]}")
            continue
        os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed. Raises when no
    CUDA device is visible: the kernels never run anywhere else."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            f"CUDA kernel {name!r} needs a CUDA device and none is visible")
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return _loaded[name]
