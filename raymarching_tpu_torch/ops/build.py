"""Build the port's CUDA kernels on first use and load them with ctypes.

``nvcc`` compiles each ``csrc/<name>.cu`` of the package for ``sm_90a``
into its own shared library with a plain C interface, written to
``build/kernels/`` beside the package and named by a hash of the sources
and flags, so an edit rebuilds and an unchanged tree reuses the library.
A kernel adds flags of its own with a ``// nvcc-flags:`` line in its
source, so a precision choice is made and explained per kernel.  Nothing
falls back: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# Every kernel: no --use_fast_math, so sqrtf and division stay IEEE;
# -Xptxas -v writes the register and spill report to the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
FLAGS_TAG = "// nvcc-flags:"

_LOCK = threading.Lock()
_NAME_LOCKS: dict = {}

# Every kernel source of the package, csrc/<name>.cu, one library each:
# K1's reference, extended-shading, raygen and mirror-bounce entries, K2,
# K3, K4's reference and extended-shading entries, the parameter scatter.
SOURCES = ("render_kernel", "render_ext_kernel", "render_raygen_kernel",
           "render_bounce_kernel", "surface_kernel", "march_kernel",
           "shade_kernel", "shade_ext_kernel", "segment_kernel")


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME (default
    /usr/local/cuda); raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels "
                       "cannot be built")


def source(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no kernel source {src}")
    return src


def kernel_flags(src: Path) -> tuple:
    """NVCC_FLAGS plus the flags of the source's ``// nvcc-flags:`` line."""
    extra = [ln[len(FLAGS_TAG):].split()
             for ln in src.read_text().splitlines()
             if ln.startswith(FLAGS_TAG)]
    return NVCC_FLAGS + tuple(f for fl in extra for f in fl)


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` for the current sources and
    flags lives."""
    src = source(name)
    digest = hashlib.sha256(" ".join(kernel_flags(src)).encode())
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile kernel ``name`` unless its library exists; returns its path.
    The compiler's report (ptxas registers, spills) goes to a ``.log``
    file beside it.  A second thread asking for the same kernel waits for
    the first one's ``nvcc``, so ``load_library`` may be called while
    ``build_all`` runs in the background."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        return _build(name)


def _build(name: str) -> Path:
    path = library_path(name)
    if path.exists():
        return path
    src = source(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *kernel_flags(src), "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    path.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout
                                        + proc.stderr)
    os.replace(tmp, path)
    return path


def build_all(names=SOURCES) -> list:
    """Build every named kernel that is not built yet, one ``nvcc`` a
    source, all started together; returns (library path, seconds its
    build took) for each, in the order of ``names``."""
    def timed(name):
        t = time.perf_counter()
        return build(name), time.perf_counter() - t

    with ThreadPoolExecutor(max(len(names), 1)) as pool:
        return list(pool.map(timed, names))


@functools.lru_cache(maxsize=None)
def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """Build kernel ``name`` on first use, then load it once per process.
    Every library exports ``rt_error_string``; the caller declares its
    entry point's signature."""
    path = str(build(name))
    with _LOCK:
        return _load(path)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.rt_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
