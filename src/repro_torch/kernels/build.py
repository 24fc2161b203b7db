"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``<repo>/build/kernels/lib<name>-<hash>.so``; the hash covers the
source and the compiler flags, so an edited kernel rebuilds and an
unchanged one is reused.  Nothing here runs at import: a kernel is built
at its first use (``load``), or all at once, one nvcc per source started
together (``build_all``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("moe_gmm", "decode_attn", "deposit", "backlog_scan",
           "admission_window", "admission_ctrl")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels build only where the CUDA toolkit is")
    return found


def _sources(name: str) -> list[Path]:
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)           # atomic: a reader never sees half a file
    return log


def build_all(names=KERNELS) -> dict[str, str]:
    """Compile every kernel not built yet, one nvcc each, all in parallel.

    Returns each kernel's compiler log (ptxas register/spill report), or
    "" for a library that was already built.
    """
    jobs = {n: _start(n) for n in names}
    return {n: _finish(n, job) for n, job in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    if name not in _LIBS:
        _finish(name, _start(name))
        _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaGetLastError() returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``; the wrappers
    size their grids by it."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count
