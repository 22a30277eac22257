"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C entry point and compiles on its own into
`build/kernels/lib<name>-<hash>.so` beside the package (the hash is of the
source, so an edited kernel is never served from a stale library). Nothing is
compiled when a module is imported: the first wrapper call that needs a kernel
builds it, and `build_all()` builds every source at once, one nvcc process per
file, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("letterbox", "conv3x3", "repack", "nms", "conv_s8", "quantize_s8")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # nvcc's output per kernel (ptxas register/smem report)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Sequence[str] = KERNELS) -> List[Path]:
    """Compile every missing kernel library in parallel; raise on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [_lib_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch entry point."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")
