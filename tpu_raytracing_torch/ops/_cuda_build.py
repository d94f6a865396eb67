"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` into ``tpu_raytracing_torch/build/<name>-<hash>.so``, keyed by a
hash of the source and the flags, and loaded with ``ctypes``. Nothing is
built or loaded when a module is imported: the first call on a CUDA
tensor does it, so the CPU tests import every module without a toolkit.

The flags keep float arithmetic IEEE and unfused (``-fmad=false``, no fast
math), so a kernel performs the same operations in the same order as its
plain PyTorch version and agrees with it bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence, Tuple

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> (build seconds, nvcc/ptxas output); 0 s when the cached build was reused
BUILD_INFO: Dict[str, Tuple[float, str]] = {}
# name -> the built shared library
LIB_PATHS: Dict[str, Path] = {}


def nvcc_path() -> str:
    """The toolkit's nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def load_library(name: str, src: Optional[Path] = None) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, or the source ``src``
    under ``name``; raises on a failed build."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = SRC_DIR / f"{name}.cu" if src is None else Path(src)
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{name}-{digest}.so"
    log_path = so.with_suffix(".log")
    if so.is_file():
        BUILD_INFO[name] = (0.0, log_path.read_text() if log_path.is_file() else "")
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        seconds = time.perf_counter() - t0
        output = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {src} ({proc.returncode}):\n{output}")
        log_path.write_text(output)
        os.replace(tmp, so)
        BUILD_INFO[name] = (seconds, output)
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    LIB_PATHS[name] = so
    return lib


def load_libraries(names: Sequence[str], sources: Optional[Mapping[str, Path]] = None) -> None:
    """``load_library`` for every name (from ``sources[name]`` where given),
    with the nvcc builds run in parallel (one process per source, all
    started together)."""
    sources = sources or {}
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        list(pool.map(lambda n: load_library(n, sources.get(n)), names))
