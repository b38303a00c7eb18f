"""Hand-written CUDA kernels of the port: build, load and launch.

The kernels are CUDA C++ with a plain C interface, one library per source
file in ``csrc/`` (``delta_kernels.cu``: the block-sparse delta path;
``block_kernels.cu``: the XOR delta and the block hash;
``segment_kernels.cu``: the solvers' segment min/argmin reductions and the
Prim and Modified-Prim step loops; ``attention_kernels.cu``: the dense LM's
prefill attention).  At first use the package compiles every
source with ``nvcc`` for Hopper (``sm_90a``) into ``build/`` at the root of
the checkout — one ``nvcc`` process per source, all started together —
under a file lock, and loads each shared library with ``ctypes``.  A
library's file name carries a hash of its compile flags, its source and
every header in ``csrc/``, so an edited source, header or flag is rebuilt
and a stale library never loads.  A failed build raises.

Every wrapper (:mod:`.block_diff`, :mod:`.xor_delta`, :mod:`.sparse_apply`,
:mod:`.chain_apply`, :mod:`.segment_ops`, :mod:`.flash_attention`)
dispatches on the device of its tensors: CPU tensors take the plain
PyTorch version in :mod:`.ref`; CUDA tensors launch the kernel or raise.
There is no fallback from one to the other.  No wrapper writes into its
arguments, except ``prim_loop`` and ``mp_loop``, whose contract is an
in-place update of the solver's own loop buffers.
Each wrapper counts its launches in a plain integer attribute,
``<wrapper>.launches`` (through :func:`count_launch`, safe across threads).
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
from typing import Dict, Union

import torch

from .ref import BLOCK_SHAPE

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
_GENCODE = "arch=compute_90a,code=sm_90a"
#: nvcc flags after the target.  ``-fmad=false`` keeps f32 arithmetic
#: unfused, term for term as the plain versions compute it: the segment
#: kernels' selection must be bit-exact.  The attention kernel promises no
#: bit-identity and its softmax is a chain of multiply-adds, so it fuses.
_FLAGS = ["-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
          "-Xptxas", "-v"]
_SOURCE_FLAGS = {"attention_kernels": [f for f in _FLAGS if f != "-fmad=false"]}

_i, _ll, _vp = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
#: library (source stem) -> (its error-string entry, {entry: argtypes}); every
#: entry takes the device first and the stream last and returns a CUDA error
_ENTRIES = {
    "delta_kernels": ("delta_error_string", {
        "delta_changed_block_mask": [_i, _vp, _vp, _vp, _ll, _vp],
        "delta_sparse_scatter": [_i, _vp, _vp, _vp, _ll, _ll, _vp],
        "delta_chain_winner": [_i, _vp, _vp, _ll, _ll, _vp],
        "delta_chain_copy": [_i, _vp, _vp, _vp, _vp, _ll, _ll, _vp],
    }),
    "segment_kernels": ("segment_error_string", {
        "segment_min_rows": [_i, _vp, _vp, _ll, _ll, _vp],
        "segment_argmin_rows": [_i, _vp, _vp, _ll, _ll, _vp],
        # x, out_val, out_idx, workspace; n, workspace bytes
        "segment_min_argmin_1d": [_i] + [_vp] * 4 + [_ll] * 2 + [_vp],
        # pd, pw, best, bp, in_tree; nvp, width, steps; chunk
        "segment_prim_loop": [_i] + [_vp] * 5 + [_ll] * 3 + [_i, _vp],
        # pd, pdelta, pphi, bound, l, d, p, in_tree, mark; nvp, width, steps;
        # chunk
        "segment_mp_loop": [_i] + [_vp] * 9 + [_ll] * 3 + [_i, _vp],
        "segment_loop_floor": [_i, _vp, _vp, _ll, _vp],
        "segment_launch_floor": [_i, _vp],
    }),
    "block_kernels": ("block_error_string", {
        "block_xor_delta": [_i, _vp, _vp, _vp, _ll, _vp],
        "block_hash": [_i, _vp, _vp, _vp, _ll, _vp],
    }),
    "attention_kernels": ("attention_error_string", {
        # q, k, v, o, the work-tile counter; B, Sq, Sk, H, KV, hd; 4 x 3
        # strides; scale, causal
        "attention_flash_fwd": (
            [_i] + [_vp] * 5 + [_ll] * 6 + [_ll] * 12 + [ctypes.c_float, _i, _vp]
        ),
    }),
}
_LIBRARY_OF = {
    entry: stem for stem, (_, entries) in _ENTRIES.items() for entry in entries
}

_load_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()


def count_launch(fn) -> None:
    """Add one to ``fn.launches``.  The increment is a read-modify-write and
    the service's reader threads launch concurrently, so it takes a lock."""
    with _count_lock:
        fn.launches += 1


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device a store or solver computes on; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs its kernels on a CUDA device and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device}")
    return device


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


def sources() -> Dict[str, Path]:
    """Every kernel source, ``csrc/*.cu``, by stem."""
    return {src.stem: src for src in sorted(CSRC.glob("*.cu"))}


def compile_flags(stem: str) -> list:
    """nvcc's arguments for ``csrc/<stem>.cu``, but the compiler, the output
    and the source."""
    return ["-gencode", _GENCODE] + _SOURCE_FLAGS.get(stem, _FLAGS)


def library_path(source: Path) -> Path:
    """Where the library of ``source`` is built: its name hashes the compile
    flags, the source and every ``*.cuh`` beside it."""
    h = hashlib.sha256(" ".join(compile_flags(source.stem)).encode())
    for path in [source] + sorted(source.parent.glob("*.cuh")):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:12]}.so"


def build() -> Dict[str, Path]:
    """Compile every source whose library is not built yet, one ``nvcc``
    per source, all at once; returns each library's path by source stem.
    ``nvcc``'s output (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = sources()
    paths = {stem: library_path(src) for stem, src in srcs.items()}
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        jobs = []
        for stem, path in paths.items():
            if path.exists():
                continue
            src = srcs[stem]
            tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
            cmd = [_nvcc(), *compile_flags(stem), "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            jobs.append((src, path, tmp, cmd, proc))
        failed = []
        for src, path, tmp, cmd, proc in jobs:
            out, err = proc.communicate()
            path.with_suffix(".log").write_text(" ".join(cmd) + "\n" + out + err)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(
                    f"nvcc failed with exit code {proc.returncode} building "
                    f"{src.name}:\n{err}"
                )
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("\n".join(failed))
    return paths


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu`` (every library is built on
    the first call)."""
    with _load_lock:
        if not _libs:
            built = build()
            for name, (err_fn, entries) in _ENTRIES.items():
                lib = ctypes.CDLL(str(built[name]))
                for entry, argtypes in entries.items():
                    fn = getattr(lib, entry)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                getattr(lib, err_fn).argtypes = [ctypes.c_int]
                getattr(lib, err_fn).restype = ctypes.c_char_p
                _libs[name] = lib
        return _libs[stem]


def launch(name: str, device: torch.device, *args: int) -> None:
    """Call C entry ``name`` on ``device`` and PyTorch's current stream;
    raise if the launch reports a CUDA error."""
    stem = _LIBRARY_OF[name]
    lib = library(stem)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, name)(device.index, *args, stream)
    if err:
        msg = getattr(lib, _ENTRIES[stem][0])(err).decode()
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
