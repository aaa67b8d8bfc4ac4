"""Hand-written Hopper kernels: the CUDA library, and launch counters.

The CUDA kernels (``csrc/*.cu``) are built with nvcc at first use
(``kernels/_build.py``) into one library and bound with ctypes. Every
wrapper adds one to its counter in ``LAUNCHES`` where it launches its
kernel, and nowhere else, so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

# kernel name -> launches since the last reset
LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0, "s8_matmul": 0,
                            "rmsnorm": 0, "paged_attention": 0,
                            "fused_lm_sample": 0, "flash_attention_dq": 0,
                            "flash_attention_dkv": 0, "s8_matmul_bwd": 0,
                            "int8_matmul": 0, "int8_matmul_wide_fwd": 0,
                            "int8_matmul_wide_bwd": 0, "s8_matmul_qx": 0,
                            # the int32 mode of #2 and #7 (sharded
                            # contractions, models/qdense.py)
                            "s8_matmul_i32": 0, "s8_matmul_bwd_i32": 0}

_lib: Optional[ctypes.CDLL] = None
_build_info: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_LP = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "thinkdiff_s8_gemm": [_P] * 6 + [_I] * 7 + [_P],
    "thinkdiff_s8_gemm_bwd": [_P] * 5 + [_I] * 7 + [_P],
    "thinkdiff_s8_gemm_i32": [_P] * 3 + [_I] * 7 + [_P],
    "thinkdiff_s8_gemm_bwd_i32": [_P] * 3 + [_I] * 7 + [_P],
    "thinkdiff_flash_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _LP, _LP,
                            _F, _P],
    "thinkdiff_flash_bwd_dq": [_P] * 11 + [_LP, _LP, _F, _P],
    "thinkdiff_flash_bwd_dkv": [_P] * 12 + [_LP, _LP, _F, _P],
    "thinkdiff_paged_decode": [_P] * 8 + [_I] * 9 + [_F, _P],
    "thinkdiff_fused_sample": [_P] * 13 + [_I] * 6 + [_F] + [_I] * 6 + [_P],
    "thinkdiff_int8_gemv": [_P] * 6 + [_I] * 9 + [_P],
    "thinkdiff_int8_wide_fwd": [_P] * 4 + [_I] * 6 + [_P],
    "thinkdiff_int8_wide_bwd": [_P] * 4 + [_I] * 6 + [_P],
    "thinkdiff_s8_gemm_qx": [_P] * 7 + [_I] * 8 + [_P],
    "thinkdiff_rmsnorm": [_P, _P, _P, _I, _I, _F, _I, _I, _I, _P],
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
    """The raw handle of the current CUDA stream of t's device, which must
    be the current device: the launchers set each kernel's shared-memory
    opt-in and read the SM count on the current device only, so a tensor
    on another card raises here, before any launch, rather than switching
    device or falling back to the plain version."""
    import torch

    current = torch.cuda.current_device()
    if t.device.index != current:
        raise RuntimeError(
            f"a kernel's operand is on {t.device}, but the current device is "
            f"cuda:{current}: call torch.cuda.set_device({t.device.index}) "
            f"first (init_distributed_mode does, for a rank's own card)")
    return torch._C._cuda_getCurrentRawStream(t.device.index)
