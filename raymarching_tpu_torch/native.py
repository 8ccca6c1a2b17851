"""ctypes bindings to the native host runtime (libraymarch_host.so).

The reference's host runtime is C++: scene parsing (scene.cpp:92-190), the
tree -> device-table flattener (render.cpp:246-366), and stb image writing.
Their equivalents live in the repo's ``native/raymarch_host.cpp``, a small
C-ABI shared library.  ``build()`` compiles it with ``g++`` (the flags of
``native/Makefile``) into ``build/native/``, named by a hash of the source
and the flags, so an edit rebuilds and an unchanged tree reuses the file;
``load_library()`` loads what ``build()`` made, and every caller falls
back to the pure-Python implementations when it was not built.

The port's own copy of ``raymarching_tpu.native`` (same names, same C
signatures, same return layout), so the port imports nothing of the JAX
package.

Build:  python -m raymarching_tpu_torch.native
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "native" / "raymarch_host.cpp"
BUILD_DIR = ROOT / "build" / "native"
# native/Makefile's compiler and CXXFLAGS, then its link line (-shared ...
# -lz).  Always g++, whatever CXX says: a compiler that CXX names on some
# machines links a library that crashes in its first call there.
CXX = "g++"
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-Wall", "-Wextra", "-shared")
LIBS = ("-lz",)

_LIB = None
_DIGESTS: dict = {}   # SOURCE -> its hash with the flags, once a process


def library_path(build_dir=None) -> Path:
    """Where the library of the current source and flags lives, in
    ``build_dir`` (default ``build/native/``).  The source is read and
    hashed once a process."""
    if SOURCE not in _DIGESTS:
        digest = hashlib.sha256(" ".join((CXX, *CXX_FLAGS, *LIBS)).encode())
        digest.update(SOURCE.read_bytes())
        _DIGESTS[SOURCE] = digest.hexdigest()[:16]
    return (Path(build_dir) if build_dir is not None else BUILD_DIR) / (
        f"libraymarch_host_{_DIGESTS[SOURCE]}.so")


def build(build_dir=None) -> Path:
    """Compile the library unless it exists; returns its path.  Raises
    RuntimeError without the source, without a ``g++`` on PATH or when the
    compile fails (no zlib headers, say)."""
    if not SOURCE.is_file():
        raise RuntimeError(f"no {SOURCE}: the native host runtime cannot "
                           "be built")
    path = library_path(build_dir)
    if path.exists():
        return path
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"no {CXX} on PATH: the native host runtime "
                           "cannot be built")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def load_library(path=None) -> Optional[ctypes.CDLL]:
    """The native library, loaded once a process: the one at ``path``
    (which then serves every later call), else what ``build()`` made for
    the current source, else None while it is not built (a later call
    after ``build()`` loads it) or where the package stands without the
    repo's ``native/`` source, as an installed package does."""
    global _LIB
    if path is None:
        if _LIB is not None:
            return _LIB
        if not SOURCE.is_file():
            return None
        path = library_path()
        if not path.exists():
            return None
    lib = ctypes.CDLL(str(path))
    _configure(lib)
    _LIB = lib
    return lib


def _configure(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)

    lib.rm_parse_scene_counts.restype = ctypes.c_int
    lib.rm_parse_scene_counts.argtypes = [ctypes.c_char_p, i32p, i32p]

    lib.rm_parse_scene_fill.restype = ctypes.c_int
    lib.rm_parse_scene_fill.argtypes = [
        ctypes.c_char_p,
        i32p,                  # prim_type [P]
        f32p, f32p, f32p,      # prim_pos, prim_aux, prim_color [P,3]
        i32p, i32p,            # group_id [P], group info...
        i32p,                  # group_meta [G, 2]: (gsign, count)
        f32p,                  # prim_scale [P]
        f32p,                  # lights [L,3]
        f32p,                  # camera [10]: pos, dir, up, fov
        f32p,                  # prim_extra [P,4]: Julia constant c
        f32p,                  # light_colors [L,3]: LightColor extension
    ]

    lib.rm_write_png.restype = ctypes.c_int
    lib.rm_write_png.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, u8p]

    lib.rm_write_jpeg.restype = ctypes.c_int
    lib.rm_write_jpeg.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_int, u8p, ctypes.c_int]


def available() -> bool:
    return load_library() is not None


def _pixels(img: np.ndarray, channels) -> np.ndarray:
    """``img`` as a C-contiguous uint8 [H, W, C] array, C in ``channels``;
    raises ValueError otherwise (the C writers read H * W * C bytes)."""
    img = np.asarray(img)
    if (img.dtype != np.uint8 or img.ndim != 3
            or img.shape[2] not in channels):
        raise ValueError(f"expected uint8 [H, W, C], C in {channels}, got "
                         f"{img.dtype} {img.shape}")
    return np.ascontiguousarray(img)


def native_write_png(path: str, img: np.ndarray) -> bool:
    """Write [H, W, 3|4] uint8 as PNG via the native library.
    Returns False if the library isn't built."""
    lib = load_library()
    if lib is None:
        return False
    img = _pixels(img, (3, 4))
    h, w, c = img.shape
    rc = lib.rm_write_png(path.encode(), w, h, c,
                          img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return rc == 0


def native_write_jpeg(path: str, img: np.ndarray, quality: int = 100) -> bool:
    """Write [H, W, 3|4] uint8 (alpha dropped) as baseline JPEG via the
    native library (the stb_image_write twin, main.cpp:80).  Returns False
    if the library isn't built; io/jpeg.py is the pure-Python fallback."""
    lib = load_library()
    if lib is None:
        return False
    img = _pixels(img, (3, 4))[..., :3].copy()
    h, w, _ = img.shape
    rc = lib.rm_write_jpeg(path.encode(), w, h,
                           img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           int(quality))
    return rc == 0


def native_parse_scene(text: str):
    """Parse a scene with the native parser.

    Returns a dict of prim_type [P], prim_pos [P,3], prim_aux [P,3], proc
    (the plan's procedural entries), prim_color [P,3], group_id [P],
    group_meta [G,2], prim_scale [P], lights [L,3], light_colors [L,3] and
    camera [10], or None if the library isn't built.  A cross-check of the
    Python parser and compiler, and the host-side scene loading the
    reference kept in C++."""
    lib = load_library()
    if lib is None:
        return None
    raw = text.encode()
    p_count = ctypes.c_int32(0)
    l_count = ctypes.c_int32(0)
    rc = lib.rm_parse_scene_counts(raw, ctypes.byref(p_count),
                                   ctypes.byref(l_count))
    if rc != 0:
        raise ValueError(f"native scene parse failed with code {rc}")
    P, L = max(p_count.value, 1), max(l_count.value, 1)
    G = P  # at most one group per primitive

    prim_type = np.zeros(P, np.int32)
    prim_pos = np.zeros((P, 3), np.float32)
    prim_aux = np.zeros((P, 3), np.float32)
    prim_color = np.zeros((P, 3), np.float32)
    group_id = np.zeros(P, np.int32)
    group_count = np.zeros(1, np.int32)
    group_meta = np.zeros((G, 2), np.int32)
    prim_extra = np.zeros((P, 4), np.float32)
    light_colors = np.ones((L, 3), np.float32)
    prim_scale = np.zeros(P, np.float32)
    lights = np.zeros((L, 3), np.float32)
    camera = np.zeros(10, np.float32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    rc = lib.rm_parse_scene_fill(
        raw,
        ptr(prim_type, ctypes.c_int32),
        ptr(prim_pos, ctypes.c_float), ptr(prim_aux, ctypes.c_float),
        ptr(prim_color, ctypes.c_float),
        ptr(group_id, ctypes.c_int32), ptr(group_count, ctypes.c_int32),
        ptr(group_meta, ctypes.c_int32),
        ptr(prim_scale, ctypes.c_float),
        ptr(lights, ctypes.c_float),
        ptr(camera, ctypes.c_float),
        ptr(prim_extra, ctypes.c_float),
        ptr(light_colors, ctypes.c_float),
    )
    if rc != 0:
        raise ValueError(f"native scene fill failed with code {rc}")
    g = group_count[0]
    # Procedural rows (type 3 Mandelbox / 4 Mandelbulb / 5 Julia) carry
    # their STRUCTURAL (param, iterations) pair in aux[1:3] — Julia's
    # 4-float quaternion constant rides prim_extra — over the C ABI;
    # split them back out into plan-static form (compile.ScenePlan.proc)
    # and zero the table slots so the differentiable aux tables match
    # scene.compile._prim_arrays.
    n = p_count.value
    _KIND = {3: "mb", 4: "bulb", 5: "julia"}

    def _param(i):
        if prim_type[i] == 5:
            return tuple(float(v) for v in prim_extra[i])
        return float(prim_aux[i, 1])

    proc = tuple(
        (int(i), _KIND[int(prim_type[i])], _param(i), int(prim_aux[i, 2]))
        for i in np.nonzero(np.isin(prim_type[:n], (3, 4, 5)))[0])
    for (i, _, _, _) in proc:
        prim_aux[i, 1:] = 0.0
    return dict(prim_type=prim_type[:n],
                prim_pos=prim_pos[:n],
                prim_aux=prim_aux[:n],
                proc=proc,
                prim_color=prim_color[:n],
                group_id=group_id[:n],
                group_meta=group_meta[:g],
                prim_scale=prim_scale[:n],
                lights=lights[:l_count.value],
                light_colors=light_colors[:l_count.value],
                camera=camera)


def main(argv=None) -> int:
    """``python -m raymarching_tpu_torch.native [BUILD_DIR]``: build the
    library (the twin of ``make native``) and print its path."""
    argv = sys.argv[1:] if argv is None else argv
    print(build(argv[0] if argv else None))
    return 0


if __name__ == "__main__":
    sys.exit(main())
