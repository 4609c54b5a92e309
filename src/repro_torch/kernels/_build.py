"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, all ``nvcc`` processes started together,
at the first call that needs a kernel.  The libraries land in
``build/repro_torch_kernels/<digest>/`` at the root of the checkout, where
``<digest>`` hashes the sources and flags, so an edited source is rebuilt and
an unchanged one is reused.  They are loaded with ``ctypes``; pointers and the
stream go through ``c_void_p``.  A failed build raises: nothing falls back to
the plain versions.

Importing this module compiles nothing and needs no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the port's "
                           "kernels are built with nvcc at first use")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build_dir() -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no library yet, in parallel.

    Returns {source stem: library path}.  The compiler's output (with
    ``-Xptxas -v``: registers, shared memory and spills of each kernel) is
    kept beside each library as ``<stem>.log``.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out_dir / f"lib{src.stem}.so"
            for src in sorted(CSRC.glob("*.cu"))}
    jobs = []
    for stem, so in libs.items():
        if so.exists():
            continue
        tmp = so.with_name(f"tmp{os.getpid()}_{so.name}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        jobs.append((stem, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for stem, so, tmp, proc in jobs:
        log, _ = proc.communicate()
        (out_dir / f"{stem}.log").write_text(log)
        if proc.returncode:
            errors.append(f"nvcc {stem}.cu exited {proc.returncode}:\n{log}")
        else:
            os.replace(tmp, so)          # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(errors))
    return libs


def build_logs() -> dict[str, str]:
    """The compiler output of each built source (empty before a build)."""
    return {p.stem: p.read_text() for p in sorted(build_dir().glob("*.log"))}


def function(lib: str, name: str, argtypes):
    """The C function ``name`` of library ``lib`` (built on first use), with
    its argument types declared and an int (cudaError_t) result."""
    key = (lib, name)
    if key in _fns:
        return _fns[key]
    with _lock:
        if not _libs:
            for stem, path in build_all().items():
                _libs[stem] = ctypes.CDLL(str(path))
                _libs[stem].naszip_error_string.argtypes = [I]
                _libs[stem].naszip_error_string.restype = ctypes.c_char_p
        fn = getattr(_libs[lib], name)
        fn.argtypes = list(argtypes)
        fn.restype = I
        _fns[key] = fn
    return fn


def check(lib: str, name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code:
        msg = _libs[lib].naszip_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as a pointer-sized int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()
