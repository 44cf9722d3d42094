"""Build the port's CUDA kernels from the sources in the checkout, at first use.

Each ``csrc/<name>.cu`` has a plain C interface; ``nvcc`` compiles it for
``sm_90a`` into ``rayfed_tpu_torch/_build/lib<name>-<hash>.so`` and ctypes
loads it.  This keeps PyTorch's headers out of the compile (seconds instead
of minutes) and needs no ``ninja``.  The file name carries a hash of the
source, every shared header (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and a stale library is never loaded.  A failed
build raises with the compiler's output.
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
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",  # registers, shared memory and spills of each kernel, into the log
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            f"nvcc not found (looked on PATH and in {cuda_home}/bin); "
            f"the CUDA kernels need the CUDA toolkit"
        )
    return nvcc


def _source_digest(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, every ``csrc/*.cuh`` header and the flags."""
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}-{_source_digest(name)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True,
        text=True,
    )
    log_path(name).write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def log_path(name: str) -> Path:
    """The compiler output (``-Xptxas -v`` included) of the last build."""
    return BUILD_DIR / f"{name}.log"


@functools.lru_cache(maxsize=None)
def flash_fwd_lib() -> ctypes.CDLL:
    """The flash-attention forward kernels (and the Hopper probe), built and
    loaded once per process."""
    lib = ctypes.CDLL(str(build("flash_fwd")))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rf_flash_fwd.argtypes = (
        [ptr] * 5 + [i32] * 7 + [ctypes.c_float] + [i32] * 4 + [ptr]
    )
    lib.rf_flash_fwd.restype = i32
    lib.rf_hopper_probe.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
    lib.rf_hopper_probe.restype = i32
    lib.rf_cuda_error_string.argtypes = [i32]
    lib.rf_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def flash_bwd_lib() -> ctypes.CDLL:
    """The flash-attention backward kernels (dQ, dK/dV), built and loaded once."""
    lib = ctypes.CDLL(str(build("flash_bwd")))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    tail = [i32] * 7 + [ctypes.c_float] + [i32] * 4 + [ptr]
    lib.rf_flash_bwd_dq.argtypes = [ptr] * 7 + tail
    lib.rf_flash_bwd_dkv.argtypes = [ptr] * 8 + tail
    lib.rf_flash_bwd_dq.restype = i32
    lib.rf_flash_bwd_dkv.restype = i32
    lib.rf_cuda_error_string.argtypes = [i32]
    lib.rf_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def fold_lib() -> ctypes.CDLL:
    """The float fold's fused multiply-add kernel, built and loaded once."""
    lib = ctypes.CDLL(str(build("fold_fma")))
    ptr = ctypes.c_void_p
    lib.rf_fold_fma.argtypes = [ptr] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ptr]
    lib.rf_fold_fma.restype = ctypes.c_int
    lib.rf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rf_cuda_error_string.restype = ctypes.c_char_p
    return lib
