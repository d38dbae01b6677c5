"""Build and load the port's native code: the CUDA kernels and the host
replay's sum tree.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into a shared library with
a plain C interface under ``build/`` at the repository root, keyed by a hash
of the source so an edit rebuilds, and loads with ``ctypes``. A host C++
source (``native/sum_tree.cc``) builds the same way with ``g++``. A source
that does not build raises; nothing falls back. What ptxas reports about
each kernel of a source built in this process (registers, shared memory,
spills; ``-Xptxas -v``) is kept in ``PTXAS_REPORT``. A library's first
build-and-load in a process is a compile event of the compile telemetry
(telemetry/compile.py), named ``kernel/<source>``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from r2d2_tpu_torch.telemetry.compile import compile_event

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-Wall"]

_lock = threading.Lock()
_loaded: Dict[Path, ctypes.CDLL] = {}
PTXAS_REPORT: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"the kernels in {CSRC}")


def _cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: it builds the host replay's "
                           "native sum tree")
    return path


def _library_path(source: Path, flags: List[str]) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def _compile(compiler: str, flags: List[str], source: Path, force: bool
             ) -> Tuple[Path, Optional[str]]:
    """(library, the compiler's stderr, or None if it was built already)."""
    lib = _library_path(source, flags)
    if lib.exists() and not force:
        return lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(compiler).name} failed for {source.name}:"
                           f"\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stderr


def build(name: str, force: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built
    (``force``: compile anyway)."""
    lib, report = _compile(_nvcc(), NVCC_FLAGS, CSRC / f"{name}.cu", force)
    if report is not None:
        PTXAS_REPORT[name] = report
    return lib


def _load(lib: Path) -> ctypes.CDLL:
    loaded = _loaded.get(lib)
    if loaded is None:
        loaded = _loaded[lib] = ctypes.CDLL(str(lib))
    return loaded


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _library_path(CSRC / f"{name}.cu", NVCC_FLAGS)
        if lib in _loaded:
            return _loaded[lib]
        with compile_event(f"kernel/{name}", lib.name):
            return _load(build(name))


def load_host(source: Path) -> ctypes.CDLL:
    """The loaded library for a host C++ source, built with g++ on first
    use."""
    with _lock:
        lib = _library_path(source, CXX_FLAGS)
        if lib in _loaded:
            return _loaded[lib]
        with compile_event(f"kernel/{source.stem}", lib.name):
            return _load(_compile(_cxx(), CXX_FLAGS, source, False)[0])
