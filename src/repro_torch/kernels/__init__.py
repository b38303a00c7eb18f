"""Hand-written CUDA kernels of the port: build, load and launch.

The kernels are CUDA C++ with a plain C interface, in ``csrc/``.  At first
use the package compiles them with ``nvcc`` for Hopper (``sm_90a``) into
``build/`` at the root of the checkout, under a file lock, and loads the
shared library with ``ctypes``.  The library's file name carries a hash of
its source, so an edited source is rebuilt and a stale library never loads.
A failed build raises.

Every wrapper (:mod:`.block_diff`, :mod:`.sparse_apply`, :mod:`.chain_apply`)
dispatches on the device of its tensors: CPU tensors take the plain PyTorch
version in :mod:`.ref`; CUDA tensors launch the kernel or raise.  There is no
fallback from one to the other, and no wrapper writes into its arguments.
Each wrapper counts its launches in a plain integer attribute,
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

from .ref import BLOCK_SHAPE

SOURCE = Path(__file__).resolve().parent / "csrc" / "delta_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
_GENCODE = "arch=compute_90a,code=sm_90a"

_load_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: building the CUDA kernels needs the CUDA toolkit "
        "(put nvcc on PATH or set CUDA_HOME)"
    )


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libdelta_kernels_{digest}.so"


def build() -> Path:
    """Compile the kernels unless this source is already built; returns the
    library's path.  ``nvcc``'s output (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside the library as ``.log``."""
    path = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if path.exists():
            return path
        tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
        cmd = [
            _nvcc(), "-gencode", _GENCODE, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(SOURCE),
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        path.with_suffix(".log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode} building "
                f"{SOURCE.name}:\n{proc.stderr}"
            )
        os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _load_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i, ll, vp = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
            signatures = {
                "delta_changed_block_mask": [i, vp, vp, vp, ll, vp],
                "delta_sparse_scatter": [i, vp, vp, vp, ll, ll, vp],
                "delta_chain_winner": [i, vp, vp, ll, ll, vp],
                "delta_chain_copy": [i, vp, vp, vp, vp, ll, ll, vp],
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.delta_error_string.argtypes = [i]
            lib.delta_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, device: torch.device, *args: int) -> None:
    """Call C entry ``name`` on ``device`` and PyTorch's current stream;
    raise if the launch reports a CUDA error."""
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, name)(device.index, *args, stream)
    if err:
        msg = lib.delta_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def is_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when all lie on one
    CUDA device; anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) == 1:
        (device,) = devices
        if device.type == "cpu":
            return True
        if device.type == "cuda":
            return False
    raise ValueError(
        "kernel arguments must all lie on the CPU or all on one CUDA device, "
        f"got {sorted(str(d) for d in devices)}"
    )


def check_blocks(name: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` is an int32 ``(..., 8, 128)`` block array."""
    if t.dtype != torch.int32 or tuple(t.shape[-2:]) != BLOCK_SHAPE:
        raise ValueError(
            f"{name} must be int32 (..., 8, 128) blocks, got "
            f"{t.dtype} {tuple(t.shape)}"
        )


def check_launchable(**tensors: torch.Tensor) -> None:
    """Raise unless each CUDA argument is contiguous and 16-byte aligned
    (the kernels move one int4 per thread)."""
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
