"""Build the port's CUDA C++ sources and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers, ints and the
stream as arguments, ``cudaGetLastError()`` as the return value), so it
compiles in seconds with ``nvcc`` alone, without PyTorch's headers.  The
shared library lands in ``build/kernels/`` at the repository root, named by
a digest of its source, the shared headers (``csrc/*.cuh``) and the flags:
a changed source never loads a stale library.  Building and loading hold
an exclusive ``flock`` on ``build/kernels/lock``, so processes started
together on a fresh tree (the ranks of a mesh) build each library once:
the first builds, the others wait and then find it.  The kernel drops the
lock with its holder, so a process killed mid-build leaves no stale lock
(the file stays and is harmless); each ``nvcc`` still writes a private
temporary file and renames it into place.

Nothing here runs at import time; the first launch of a kernel builds it.
:func:`build` compiles several sources at once, one ``nvcc`` process each.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("paged_attention", "expert_mlp", "lowrank", "flash_attention", "flash_attention_bwd",
           "quant", "group_gate")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


@contextlib.contextmanager
def _build_lock():
    """Hold the exclusive lock of ``BUILD_DIR`` (blocking)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source whose library is missing, all ``nvcc``
    processes at once, under the build lock; raise with the compiler output
    if one fails.  Each build's output (ptxas' register and spill report)
    is kept beside its library as ``<library>.log``."""
    with _build_lock():
        return _build(names)


def _build(names: Iterable[str]) -> Dict[str, Path]:
    out: Dict[str, Path] = {}
    procs = {}
    for name in names:
        target = library_path(name)
        out[name] = target
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        target.with_suffix(".log").write_text(log)
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use (built
    and loaded under the build lock)."""
    lib = _LIBS.get(name)
    if lib is None:
        with _build_lock():
            lib = ctypes.CDLL(str(_build([name])[name]))
        _LIBS[name] = lib
    return lib


def refuse_grad(what: str, *tensors) -> None:
    """Raise where a tensor that wants a gradient (grad mode on) reaches a
    kernel that has no backward: its output would carry no ``grad_fn``,
    and the gradient would be dropped without a word."""
    if any(t is not None and t.requires_grad for t in tensors):
        import torch

        if torch.is_grad_enabled():
            raise NotImplementedError(
                f"{what}: the kernel has no backward, and an operand wants a gradient")


def check_launch(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code (a refused launch never
    runs, and a later synchronise would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
