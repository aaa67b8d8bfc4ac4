"""Build the CUDA kernels of ``thinkdiff_torch/csrc`` with ``nvcc``.

One shared library with a plain C interface, compiled for ``sm_90a`` at
first use and loaded with ctypes. Each source compiles to an object in its
own ``nvcc`` process, all started together, and one more ``nvcc`` links
them. The library's name carries a hash of the sources, the headers they
include and the flags, so an edited file builds anew and an unchanged tree
is reused from ``build/`` at the repository root.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    """nvcc from PATH, else from the CUDA toolkit PyTorch was built to find."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise FileNotFoundError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libthinkdiff_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless an up-to-date library exists.

    Returns (library path, seconds spent compiling, compiler output — the
    ``-Xptxas -v`` register and shared-memory report; empty when reused).
    The objects and the unlinked library are removed whether or not the
    build succeeds."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        procs = [(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                    str(src)], stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True), src)
                 for src, obj in zip(sources(), objs)]
        log, failed = [], []
        for proc, src in procs:
            text, _ = proc.communicate()
            log.append(text)
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{text}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr}")
        seconds = time.perf_counter() - t0
        os.replace(tmp, out)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return out, seconds, "".join(log) + link.stdout + link.stderr
