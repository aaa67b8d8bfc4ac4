"""Hand-written Hopper kernels: the CUDA library, and launch counters.

The CUDA kernels (``csrc/*.cu``) are built with nvcc at first use
(``kernels/_build.py``) and bound with ctypes; the RMSNorm kernel is Triton
and lives in ``ops/norms.py``. Every wrapper adds one to its counter in
``LAUNCHES`` where it launches its kernel, and nowhere else, so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

# kernel name -> launches since the last reset
LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0, "s8_matmul": 0,
                            "rmsnorm": 0}

_lib: Optional[ctypes.CDLL] = None
_build_info: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "thinkdiff_s8_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "thinkdiff_flash_fwd": [_P, _P, _P, _P, _P, _L, _L, _L, _L, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P],
}


def library() -> ctypes.CDLL:
    """The CUDA kernel library, built and loaded on first call."""
    global _lib
    if _lib is None:
        from thinkdiff_torch.kernels import _build

        path, seconds, log = _build.build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _build_info.update(path=str(path), seconds=seconds, log=log)
        _lib = lib
    return _lib


def build_info() -> Dict[str, object]:
    """Path, compile seconds and compiler report of the loaded library."""
    return dict(_build_info)


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def check_launch(rc: int, name: str) -> None:
    """Raise when a C launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def ptr(t) -> Optional[int]:
    """A tensor's device address for ctypes (None for an absent operand)."""
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
