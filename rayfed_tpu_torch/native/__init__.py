"""ctypes bindings for the native (C++) wire data plane.

Builds ``libwirecodec.so`` from :file:`wirecodec.cc` on first use if
missing (g++, ~1s) into the package's ``_build/`` directory, never next to
the source, and exposes:

- :func:`crc32c` — CRC32-C checksum (slicing-by-8 in C++, GIL released)
- :func:`gather_copy` — assemble many buffers into one ``bytearray``,
  optionally computing the checksum in the same pass
- :func:`writev_full` — vectored socket write (writev + EAGAIN poll)
  with the GIL released: the send path drains multi-MB payloads to the
  kernel without copying into asyncio's transport buffer or blocking
  the event loop
- :func:`is_available` — False when no toolchain; every consumer keeps a
  pure-Python fallback (the transport works without native code, just
  slower on multi-MB payloads).

The reference's native layer is third-party (gRPC C-core, Ray core —
SURVEY §2.9); ours is first-party and scoped to the byte hot path.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "wirecodec.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB = os.path.join(_BUILD_DIR, "libwirecodec.so")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_build_lock = threading.Lock()


def _build() -> bool:
    # A private temporary name per process: the parties of one host may
    # build at the same time, and os.replace publishes each atomically.
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    os.makedirs(_BUILD_DIR, exist_ok=True)
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    # Prefer the host ISA (hardware CRC32-C on x86); fall back to generic.
    for extra in (["-march=native"], []):
        cmd = base[:2] + extra + base[2:]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, _LIB)
            return True
        except (OSError, subprocess.SubprocessError) as e:
            logger.debug("native build %s failed: %s", extra, e)
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    with _build_lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        try:
            stale = not os.path.exists(_LIB) or (
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
            )
            if stale and not _build():
                return None
            lib = ctypes.CDLL(_LIB)
        except OSError as e:
            logger.debug("native wirecodec unavailable: %s", e)
            return None
        lib.rf_crc32c.restype = ctypes.c_uint32
        lib.rf_crc32c.argtypes = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_uint64]
        lib.rf_gather_copy.restype = ctypes.c_uint64
        lib.rf_gather_copy.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64,
        ]
        lib.rf_gather_copy_crc.restype = ctypes.c_uint64
        lib.rf_gather_copy_crc.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.rf_writev_full.restype = ctypes.c_int64
        lib.rf_writev_full.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64,
            ctypes.c_int,
        ]
        _lib = lib
        return lib


def is_available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# Buffer address extraction (zero-copy where the buffer allows it)
# ---------------------------------------------------------------------------


def _byte_view(buf) -> memoryview:
    mv = memoryview(buf)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    if not mv.c_contiguous:  # pragma: no cover — callers pass contiguous bufs
        mv = memoryview(bytes(mv))
    return mv


def _addr_of(mv: memoryview, keepalive: List) -> int:
    """Address of a memoryview's first byte, zero-copy.

    Writable views go through ``ctypes.from_buffer``; readonly views
    (numpy views of payload buffers, ``bytes``) are wrapped by
    ``np.frombuffer`` — numpy accepts readonly buffers zero-copy and
    exposes the base address.  (An earlier version fell back to
    ``bytes(mv)`` here, which silently memcpy'd every readonly payload —
    at wire rates that one line halved push throughput.)
    """
    if not mv.readonly:
        c = (ctypes.c_char * mv.nbytes).from_buffer(mv)
        keepalive.append(c)
        return ctypes.addressof(c)
    import numpy as np

    arr = np.frombuffer(mv, dtype=np.uint8)
    keepalive.append(arr)
    return arr.ctypes.data


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def crc32c_multi(buffers: Sequence) -> int:
    """Chained CRC32-C over a sequence of buffers == crc of their concat."""
    crc = 0
    for buf in buffers:
        crc = crc32c(buf, seed=crc)
    return crc


def crc32c(data, seed: int = 0) -> int:
    """CRC32-C (Castagnoli) of a bytes-like object."""
    lib = _load()
    mv = _byte_view(data)
    if lib is not None:
        keepalive: List = []
        addr = _addr_of(mv, keepalive)
        return int(lib.rf_crc32c(seed, addr, mv.nbytes))
    return _crc32c_py(mv, seed)


_CRC32C_TABLE: Optional[List[int]] = None


def _crc32c_py(data, seed: int = 0) -> int:
    """Bitwise-compatible pure-Python fallback (slow; small inputs only)."""
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            table.append(crc)
        _CRC32C_TABLE = table
    crc = ~seed & 0xFFFFFFFF
    for b in bytes(data):
        crc = (crc >> 8) ^ _CRC32C_TABLE[(crc ^ b) & 0xFF]
    return (~crc) & 0xFFFFFFFF


def writev_full(fd: int, buffers: Sequence, timeout_ms: int = 60_000) -> int:
    """Drain ``buffers`` to ``fd`` via C++ writev (GIL released).

    Handles partial writes and non-blocking sockets (EAGAIN → poll for
    writability, up to ``timeout_ms`` per stall).  Raises ``OSError`` on
    failure.  Callers must serialize writes per fd themselves (the
    transport client holds its per-connection write lock).
    """
    lib = _load()
    views = [_byte_view(b) for b in buffers]
    views = [mv for mv in views if mv.nbytes]
    if not views:
        return 0
    if lib is None:
        # Fallback: sequential write loop; mirrors the native path's
        # non-blocking handling (EAGAIN → poll for writability).
        import select

        total = 0
        for mv in views:
            off = 0
            while off < mv.nbytes:
                try:
                    off += os.write(fd, mv[off:])
                except (BlockingIOError, InterruptedError):
                    _, writable, _ = select.select([], [fd], [], timeout_ms / 1000)
                    if not writable:
                        raise OSError(110, "write stalled (poll timeout)")
            total += mv.nbytes
        return total
    n = len(views)
    src_arr = (ctypes.c_void_p * n)()
    len_arr = (ctypes.c_uint64 * n)()
    keepalive: List = []
    for i, mv in enumerate(views):
        src_arr[i] = _addr_of(mv, keepalive)
        len_arr[i] = mv.nbytes
    res = int(lib.rf_writev_full(fd, src_arr, len_arr, n, timeout_ms))
    if res < 0:
        raise OSError(-res, os.strerror(-res))
    return res


def gather_copy(buffers: Sequence, with_crc: bool = False):
    """Assemble ``buffers`` into one ``bytearray`` via native memcpy loop.

    With ``with_crc=True`` returns ``(bytearray, crc32c)`` computed in the
    same pass over the sources.  Pure-Python fallback joins + (slow) crc.
    """
    views = [_byte_view(b) for b in buffers]
    total = sum(mv.nbytes for mv in views)
    lib = _load()
    if lib is None:
        out = bytearray(total)
        off = 0
        for mv in views:
            out[off : off + mv.nbytes] = mv
            off += mv.nbytes
        return (out, _crc32c_py(out)) if with_crc else out

    out = bytearray(total)
    n = len(views)
    src_arr = (ctypes.c_void_p * n)()
    len_arr = (ctypes.c_uint64 * n)()
    keepalive: List = []
    for i, mv in enumerate(views):
        src_arr[i] = _addr_of(mv, keepalive)
        len_arr[i] = mv.nbytes
    dst = (ctypes.c_char * total).from_buffer(out)
    if with_crc:
        crc = ctypes.c_uint32(0)
        lib.rf_gather_copy_crc(
            ctypes.addressof(dst), src_arr, len_arr, n, ctypes.byref(crc)
        )
        return out, int(crc.value)
    lib.rf_gather_copy(ctypes.addressof(dst), src_arr, len_arr, n)
    return out


# ---------------------------------------------------------------------------
# Host math XLA:CPU takes its bits from: the x86 rsqrt estimate, libm's
# cosf, sinf and powf
# ---------------------------------------------------------------------------

_MATH_SRC = os.path.join(_HERE, "xla_cpu_math.cc")
_MATH_LIB = os.path.join(_BUILD_DIR, "libxlacpumath.so")
_math_lib: Optional[ctypes.CDLL] = None


def _load_math() -> ctypes.CDLL:
    """Build (g++, AVX, no fast-math) at first use and load the library;
    raises when it cannot be built — there is no other source of its bits."""
    global _math_lib
    with _build_lock:
        if _math_lib is not None:
            return _math_lib
        if not os.path.exists(_MATH_LIB) or (
            os.path.getmtime(_MATH_LIB) < os.path.getmtime(_MATH_SRC)
        ):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{_MATH_LIB}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O2", "-mavx", "-shared", "-fPIC", _MATH_SRC, "-o", tmp],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, _MATH_LIB)
        lib = ctypes.CDLL(_MATH_LIB)
        for name in ("rf_rsqrt_estimate", "rf_libm_cosf", "rf_libm_sinf"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.rf_libm_powf_base.restype = None
        lib.rf_libm_powf_base.argtypes = [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        _math_lib = lib
        return lib


def _elementwise(name: str, x):
    import torch

    src = x.detach().to(torch.float32).contiguous()
    out = torch.empty_like(src)
    getattr(_load_math(), name)(src.data_ptr(), out.data_ptr(), src.numel())
    return out


def rsqrt_estimate(x):
    """The hardware reciprocal square root estimate of every element of a
    CPU f32 tensor (``vrsqrtps``/``rsqrtss``), as a new tensor."""
    return _elementwise("rf_rsqrt_estimate", x)


def libm_cos(x):
    """The C library's ``cosf`` of every element of a CPU f32 tensor, as a
    new tensor."""
    return _elementwise("rf_libm_cosf", x)


def libm_sin(x):
    """The C library's ``sinf`` of every element of a CPU f32 tensor, as a
    new tensor."""
    return _elementwise("rf_libm_sinf", x)


def libm_pow(base: float, x):
    """The C library's ``powf(base, e)`` of every element ``e`` of a CPU
    f32 tensor, as a new tensor."""
    import torch

    src = x.detach().to(torch.float32).contiguous()
    out = torch.empty_like(src)
    _load_math().rf_libm_powf_base(base, src.data_ptr(), out.data_ptr(), src.numel())
    return out
