"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes one shared library with a plain C interface,
compiled for Hopper (`sm_90a`) at first use into `build/kungfu_tpu_torch/`
beside the package. The library's file name carries a hash of its sources
and flags, so an edited source is rebuilt and a stale library is never
loaded. There is no fallback: without nvcc a CUDA tensor cannot be served,
and the error says so.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kungfu_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(Path(os.environ[var]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels of kungfu_tpu_torch are built from source at first "
        "use and have no fallback on a CUDA device"
    )


def _sources(name: str) -> List[Path]:
    cu = CSRC / f"{name}.cu"
    if not cu.is_file():
        raise FileNotFoundError(f"no kernel source {cu}")
    return [cu] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def compile_library(name: str, nvcc: Optional[str] = None) -> Path:
    """Compile csrc/<name>.cu unless the library for these sources exists.
    Safe against concurrent builders: each writes a private file and
    renames it into place."""
    out = library_path(name)
    if out.is_file():
        return out
    nvcc = nvcc or find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed building {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile several kernel sources at once, one nvcc each, in parallel."""
    names = list(names)
    nvcc = find_nvcc()
    out: Dict[str, Path] = {}
    errors: List[BaseException] = []

    def one(n):
        try:
            out[n] = compile_library(n, nvcc)
        except BaseException as e:  # re-raised below, after every build ends
            errors.append(e)

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_library(name)))
            _libs[name] = lib
        return lib
