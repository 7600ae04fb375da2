"""Builds the port's CUDA C++ kernels with ``nvcc`` and binds them with
``ctypes`` (no JAX counterpart: Pallas kernels compile inside XLA).

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``build/torch_kernels/lib<name>-<digest>.so`` under the checkout, at
first use. The digest covers the source and the flags, so an edited
source rebuilds and an unchanged one is reused. ``nvcc`` runs with
``-Xptxas -v``; its register and spill report is kept beside the library
(``.log``) and returned by :func:`build`.

Sources never include PyTorch's headers: a file with a plain C interface
compiles in seconds, one that includes them in minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


@dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    log: str          # nvcc's output, ptxas register/spill lines included
    seconds: float    # 0.0 when an up-to-date library was reused


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> List[BuildResult]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` per source, all started together. Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    results: Dict[str, BuildResult] = {}
    for name in names:
        target = _target(name)
        log_path = target.with_suffix(".log")
        if target.exists() and log_path.exists():
            results[name] = BuildResult(name, target, log_path.read_text(),
                                        0.0)
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, target, tmp, log_path, proc, time.monotonic()))
    failed = []
    for name, target, tmp, log_path, proc, t0 in jobs:
        out, _ = proc.communicate()
        secs = time.monotonic() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        log_path.write_text(out)
        os.replace(tmp, target)
        results[name] = BuildResult(name, target, out, secs)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return [results[n] for n in names]


def load(name: str, functions: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed. Each
    entry of ``functions`` gets its ``argtypes`` (``c_void_p`` for every
    pointer and for the stream) and an ``int`` return: the CUDA error
    code of the launch, 0 on success."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            (res,) = build([name])
            lib = ctypes.CDLL(str(res.path))
            for fn, argtypes in functions.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
