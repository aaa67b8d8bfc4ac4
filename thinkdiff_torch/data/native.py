"""ctypes bindings of the port's native IO library (counterpart of
thinkdiff_tpu/data/native.py): tar member indexing with ``pread`` sample
reads, libjpeg decode, and a threaded batch decode + antialiased bicubic
resize + normalize into one float32 (N, S, S, 3) array.

The source is the port's own copy, ``thinkdiff_torch/native/thinkdiff_io.cc``.
It is built with ``g++`` at first use into ``build/`` at the repository root,
with the flags of the JAX package's ``native/build.sh``; the library's name
carries a hash of the source and the flags, so an edited source builds anew
and an unchanged one is reused. The library is optional, as the JAX
package's is: without ``g++``, ``jpeglib.h`` or ``libjpeg`` ``available()``
is false, ``unavailable_reason()`` says why, and every caller keeps its
pure-Python path (``tarfile`` reads, PIL decode).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parents[1] / "native" / "thinkdiff_io.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LINK_FLAGS = ("-ljpeg", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_reason: Optional[str] = None
_lock = threading.Lock()

_I64P = ctypes.POINTER(ctypes.c_int64)
_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "tdio_open_tar": (ctypes.c_void_p, [ctypes.c_char_p]),
    "tdio_num_members": (ctypes.c_long, [ctypes.c_void_p]),
    "tdio_member_info": (ctypes.c_long, [ctypes.c_void_p, ctypes.c_long,
                                         _I64P, _I64P, ctypes.c_char_p,
                                         ctypes.c_long]),
    "tdio_close_tar": (None, [ctypes.c_void_p]),
    "tdio_pread": (ctypes.c_long, [ctypes.c_char_p, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_char_p]),
    "tdio_jpeg_info": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_long, _IP,
                                      _IP]),
    "tdio_jpeg_decode": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_long,
                                        ctypes.c_char_p, _IP, _IP]),
    "tdio_decode_batch": (ctypes.c_int, [ctypes.c_char_p, _I64P, _I64P,
                                         ctypes.c_int, ctypes.c_int, _FP,
                                         _FP, _FP, ctypes.c_int]),
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libthinkdiff_io_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless an up-to-date one exists; raises
    ``RuntimeError`` with the compiler's output when g++ fails. Concurrent
    builders each write a file of their own and rename it into place."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LINK_FLAGS],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): "
                               f"{(proc.stderr or proc.stdout).strip()[-600:]}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _reason
    with _lock:
        if _lib is not None or _reason is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _reason = f"{type(e).__name__}: {e}"
            logger.warning("native IO unavailable: %s", _reason)
            return None
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library built and loaded (built on the first call)."""
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why ``available()`` is false (None while it is true)."""
    _load()
    return _reason


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native IO unavailable: {_reason}")
    return lib


class NativeTarIndex:
    """Member table of one tar, [(name, data offset, size)] in archive
    order (regular files only; GNU long names are resolved, a PAX header's
    name is not read, as in the JAX package's library), and ``read`` of a
    member's bytes by ``pread``."""

    def __init__(self, path: str):
        lib = _require()
        self.path = path
        handle = lib.tdio_open_tar(path.encode())
        if not handle:
            raise FileNotFoundError(path)
        try:
            off, size = ctypes.c_int64(), ctypes.c_int64()
            buf = ctypes.create_string_buffer(4096)
            self.members: List[Tuple[str, int, int]] = []
            for i in range(lib.tdio_num_members(handle)):
                lib.tdio_member_info(handle, i, ctypes.byref(off),
                                     ctypes.byref(size), buf, 4096)
                self.members.append((buf.value.decode(), off.value,
                                     size.value))
        finally:
            lib.tdio_close_tar(handle)

    def read(self, offset: int, size: int) -> bytes:
        out = ctypes.create_string_buffer(size)
        got = _require().tdio_pread(self.path.encode(), offset, size, out)
        if got != size:
            raise IOError(f"short read {got}/{size} at {offset} of {self.path}")
        return out.raw


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB."""
    lib = _require()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.tdio_jpeg_info(data, len(data), ctypes.byref(w),
                          ctypes.byref(h)) != 0:
        raise ValueError("bad jpeg")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.tdio_jpeg_decode(data, len(data),
                            out.ctypes.data_as(ctypes.c_char_p),
                            ctypes.byref(w), ctypes.byref(h)) != 0:
        raise ValueError("jpeg decode failed")
    return out


def decode_resize_normalize_batch(jpegs: Sequence[bytes], target: int,
                                  mean, std, nthreads: int = 8) -> np.ndarray:
    """[JPEG bytes] -> (N, target, target, 3) float32, each image decoded,
    resized by PIL's antialiased bicubic rule (the whole image, no crop),
    scaled to [0, 1] and normalized by ``mean`` / ``std``, in a thread pool
    of ``nthreads``."""
    lib = _require()
    n = len(jpegs)
    blob = b"".join(jpegs)
    sizes = np.asarray([len(j) for j in jpegs], np.int64)
    offsets = np.zeros(n, np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    out = np.empty((n, target, target, 3), np.float32)
    mean_arr = np.ascontiguousarray(mean, np.float32)
    std_arr = np.ascontiguousarray(std, np.float32)
    failed = lib.tdio_decode_batch(
        blob, offsets.ctypes.data_as(_I64P), sizes.ctypes.data_as(_I64P), n,
        target, out.ctypes.data_as(_FP), mean_arr.ctypes.data_as(_FP),
        std_arr.ctypes.data_as(_FP), nthreads)
    if failed:
        raise ValueError(f"{failed}/{n} jpegs failed to decode")
    return out
