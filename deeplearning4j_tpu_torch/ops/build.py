"""Builds the port's CUDA C++ kernels with ``nvcc`` and binds them with
``ctypes`` (no JAX counterpart: Pallas kernels compile inside XLA).

Each library ``<name>`` is built from ``csrc/<name>.cu`` (or the sources
:data:`LIBRARIES` lists for it), which have a plain C interface, into
``build/torch_kernels/lib<name>-<digest>.so`` under the checkout, at
first use. The digest covers the sources, every header beside them
(``csrc/*.cuh``, which a source may include) and the flags, so an edited
source or header rebuilds and an unchanged one is reused. ``nvcc`` runs
with ``-Xptxas -v``; its register and spill report is kept beside the
library (``.log``) and returned by :func:`build`. :func:`sass` disassembles
a built library with ``cuobjdump`` (the check that a kernel issues
tensor-core instructions); :func:`sass_functions` splits that text by
kernel.

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

# libraries built from more than one source: K4's entry point
# (flash_attention.cu) calls K5's (flash_attention_ext.cu), so the flash
# kernels of csrc/flash_fwd.cuh are compiled once, into one library
LIBRARIES = {"flash_attention": ("flash_attention.cu",
                                 "flash_attention_ext.cu")}

_lock = threading.Lock()
_libs: Dict[tuple, ctypes.CDLL] = {}


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


def sources(name: str) -> List[Path]:
    """The sources of library ``name``."""
    return [CSRC / s for s in LIBRARIES.get(name, (f"{name}.cu",))]


def _target(name: str, flags: Sequence[str] = ()) -> Path:
    """The path of library ``name``: a digest of its sources, every
    ``csrc/*.cuh`` (by name and content) and every flag ``nvcc`` gets
    (the link flags and ``flags`` included)."""
    digest = hashlib.sha256()
    for path in sources(name) + sorted(CSRC.glob("*.cuh")):
        digest.update(b"\0" + path.name.encode() + b"\0")
        digest.update(path.read_bytes())
    digest.update(b"\0" + " ".join((*NVCC_FLAGS, *flags)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def cuobjdump_path():
    """``cuobjdump`` of the CUDA toolkit, or None where there is none."""
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    return None


def sass(name: str) -> str:
    """The SASS of library ``name`` (built if needed), from ``cuobjdump
    -sass``. Raises where there is no ``cuobjdump``."""
    tool = cuobjdump_path()
    if tool is None:
        raise RuntimeError("cuobjdump not found: it comes with the CUDA "
                           "toolkit")
    (res,) = build([name])
    return subprocess.run([tool, "-sass", str(res.path)], check=True,
                          capture_output=True, text=True).stdout


def sass_functions(text: str) -> Dict[str, str]:
    """``cuobjdump -sass`` output split by kernel: each function's
    (mangled) name to its SASS, the lines from its ``Function :`` header
    to the next."""
    out: Dict[str, List[str]] = {}
    lines = None
    for line in text.splitlines():
        if "Function : " in line:
            lines = out.setdefault(line.split("Function : ", 1)[1].strip(),
                                   [])
        elif lines is not None:
            lines.append(line)
    return {name: "\n".join(body) for name, body in out.items()}


def build(names: Sequence[str],
          flags: Sequence[str] = ()) -> List[BuildResult]:
    """Compile every named library that is not up to date, one ``nvcc``
    per library, all started together; ``flags`` are added to
    :data:`NVCC_FLAGS` (a variant build, e.g. a ``-D`` switch). Raises on
    any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    results: Dict[str, BuildResult] = {}
    for name in names:
        target = _target(name, flags)
        log_path = target.with_suffix(".log")
        if target.exists() and log_path.exists():
            results[name] = BuildResult(name, target, log_path.read_text(),
                                        0.0)
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-o", str(tmp),
               *map(str, sources(name))]
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


def load(name: str, functions: Dict[str, list],
         flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Library ``name`` (built with ``flags`` added), loaded and built if
    needed. Each entry of ``functions`` gets its ``argtypes``
    (``c_void_p`` for every pointer and for the stream) and an ``int``
    return: the CUDA error code of the launch, 0 on success."""
    key = (name, tuple(flags))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            (res,) = build([name], flags)
            lib = ctypes.CDLL(str(res.path))
            for fn, argtypes in functions.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[key] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
