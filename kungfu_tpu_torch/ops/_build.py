"""Build the package's native libraries and load them with ctypes.

Each `csrc/<name>.cu` becomes one shared library with a plain C interface,
compiled for Hopper (`sm_90a`) at first use into `build/kungfu_tpu_torch/`
beside the package. The host plane's C++ (`csrc/host/*.cpp`) becomes one
more, compiled by the host C++ compiler for the machine it runs on
(`compile_host_library`), and the runner's exec shim `csrc/host/pdeathsig.c`
one executable (`compile_pdeathsig`). A library's file name carries a hash of its
sources and flags (for the host library also of the compiler's target),
so an edited source is rebuilt and a stale library is never loaded. There
is no fallback: without nvcc a CUDA tensor cannot be served, without a
host compiler the host plane cannot reduce, and the error says so.
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
HOST_CSRC = CSRC / "host"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kungfu_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
# the flags of native/build.sh, which builds the JAX package's copy
HOST_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

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


def _compile(out: Path, cmd: List[str], what: str) -> Path:
    """Run `cmd` (which ends in `-o <tmp> <sources>`; the tmp path is
    substituted here) unless `out` exists. Safe against concurrent
    builders: each writes a private file and renames it into place."""
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [str(tmp) if c == "{tmp}" else c for c in cmd]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{cmd[0]} could not run building {what}: {e}") from None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cmd[0]} failed building {what} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def compile_library(name: str, nvcc: Optional[str] = None) -> Path:
    """Compile csrc/<name>.cu unless the library for these sources exists."""
    out = library_path(name)
    if out.is_file():
        return out
    nvcc = nvcc or find_nvcc()
    return _compile(out, [nvcc, *NVCC_FLAGS, "-o", "{tmp}", str(CSRC / f"{name}.cu")], name)


def find_cxx() -> str:
    """The host C++ compiler: $CXX, else g++ or c++ on PATH."""
    names = [os.environ["CXX"]] if os.environ.get("CXX") else ["g++", "c++"]
    for n in names:
        path = shutil.which(n)
        if path:
            return path
    raise RuntimeError(
        f"no host C++ compiler ({' or '.join(names)}) found: the host plane's C++ "
        "(kungfu_tpu_torch/csrc/host) is built at first use and has no fallback"
    )


def _host_target(cxx: str) -> bytes:
    """What `-march=native` means for `cxx` on this machine (its predefined
    macros): a library built for one CPU is never loaded on another."""
    try:
        proc = subprocess.run([cxx, "-march=native", "-E", "-dM", "-x", "c++", os.devnull],
                              capture_output=True)
    except OSError as e:
        raise RuntimeError(f"host C++ compiler {cxx} could not run: {e}") from None
    return proc.stdout + proc.stderr


def host_library_path(cxx: str) -> Path:
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update(_host_target(cxx))
    for src in sorted(HOST_CSRC.glob("*.cpp")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkfhost-{h.hexdigest()[:16]}.so"


def compile_host_library(cxx: Optional[str] = None) -> Path:
    """Compile csrc/host/*.cpp into one library for this machine's CPU,
    unless the library for these sources, flags and target exists."""
    cxx = cxx or find_cxx()
    sources = [str(s) for s in sorted(HOST_CSRC.glob("*.cpp"))]
    return _compile(host_library_path(cxx), [cxx, *HOST_FLAGS, "-o", "{tmp}", *sources],
                    "the host library")


PDEATHSIG_SOURCE = HOST_CSRC / "pdeathsig.c"
PDEATHSIG_FLAGS = ["-x", "c", "-O2"]


def pdeathsig_path(cxx: str) -> Path:
    h = hashlib.sha256(" ".join(PDEATHSIG_FLAGS).encode())
    h.update(_host_target(cxx))
    h.update(PDEATHSIG_SOURCE.read_bytes())
    return BUILD_DIR / f"kf-pdeathsig-{h.hexdigest()[:16]}"


def compile_pdeathsig(cxx: Optional[str] = None) -> Path:
    """Compile the runner's orphan-protection exec shim
    (csrc/host/pdeathsig.c, compiled as C by the host compiler) unless the
    executable for this source and machine exists."""
    cxx = cxx or find_cxx()
    return _compile(pdeathsig_path(cxx),
                    [cxx, *PDEATHSIG_FLAGS, "-o", "{tmp}", str(PDEATHSIG_SOURCE)],
                    "the kf-pdeathsig shim")


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
