"""Build the hand-written CUDA kernels under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``_build/`` beside this
file (git-ignored).  The library's file name carries a hash of its source
and flags, so an edited source is rebuilt and an unchanged one is loaded as
it is.  ``build`` starts one ``nvcc`` per source, all at once, and waits for
them.  A failed build raises: nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("stencil", "pack")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class Built:
    """One compiled library: where it is, how long ``nvcc`` took (0 when the
    library was already built) and the ``ptxas -v`` lines of its build."""

    path: Path
    seconds: float
    ptxas: tuple[str, ...]


def nvcc_path() -> str:
    """``nvcc`` on ``PATH``, else ``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc is neither on PATH nor under $CUDA_HOME/bin: the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _ptxas_lines(log: str) -> tuple[str, ...]:
    return tuple(line.strip() for line in log.splitlines() if line.startswith("ptxas"))


def build(names: tuple[str, ...] = SOURCES) -> dict[str, Built]:
    """Compile every library of ``names`` that is not built yet, in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done: dict[str, Built] = {}
    running = {}
    for name in names:
        so = _library_path(name)
        log = so.with_suffix(".log")
        if so.is_file():
            done[name] = Built(so, 0.0, _ptxas_lines(log.read_text()) if log.is_file() else ())
            continue
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, so, tmp, log, time.perf_counter())
    for name, (proc, so, tmp, log, t0) in running.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{out}")
        log.write_text(out)
        os.replace(tmp, so)  # atomic: a concurrent loader sees the whole library or none
        done[name] = Built(so, seconds, _ptxas_lines(out))
    return done


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build((name,))[name].path))


def check_launch(kernel: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA kernel launch failed with cudaError {err}")
