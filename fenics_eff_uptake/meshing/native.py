"""ctypes bindings for the native C++ mesh kernel (native/meshkernel.cpp).

The native kernel provides Delaunay triangulation + Laplacian smoothing
(the role Gmsh's C++ core played for the reference).  Built on demand with
g++ (no pybind11 in this image); the pure-scipy path remains as fallback,
selectable with FEU_NATIVE_MESHER=0.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

__all__ = ["available", "triangulate", "smooth_and_triangulate",
           "read_msh2_native"]

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libfeumeshkernel.so")

_lib = None
_tried = False


def _build():
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, text=True, timeout=120)
        return True
    except subprocess.CalledProcessError as e:
        print(f"[native] meshkernel build failed: {e}\n{e.stderr}")
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"[native] meshkernel build failed: {e}")
    print("[native] falling back to the scipy mesher")
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("FEU_NATIVE_MESHER", "1") == "0":
        return None
    src = os.path.join(_NATIVE_DIR, "meshkernel.cpp")
    stale = (os.path.exists(src) and os.path.exists(_LIB_PATH)
             and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH))
    if not os.path.exists(_LIB_PATH) or stale:
        if not os.path.exists(src) or not _build():
            if not os.path.exists(_LIB_PATH):
                return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.feu_triangulate.restype = ctypes.c_int64
        lib.feu_triangulate.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.feu_smooth.restype = ctypes.c_int64
        lib.feu_smooth.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        try:  # a .so predating the msh2 parser stays usable for meshing
            lib.feu_msh2_parse.restype = ctypes.c_void_p
            lib.feu_msh2_parse.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
            lib.feu_msh2_copy.restype = ctypes.c_int64
            lib.feu_msh2_copy.argtypes = [ctypes.c_void_p] + [
                ctypes.POINTER(ctypes.c_double)] + [
                ctypes.POINTER(ctypes.c_int64)] * 4
            lib.feu_msh2_free.restype = None
            lib.feu_msh2_free.argtypes = [ctypes.c_void_p]
        except AttributeError:
            pass
        _lib = lib
    except OSError as e:
        print(f"[native] meshkernel load failed: {e}")
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def triangulate(points: np.ndarray) -> Optional[np.ndarray]:
    """Delaunay triangles (T,3) of 2-D points, or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float64)
    n = len(pts)
    max_tris = 2 * n + 16
    out = np.empty((max_tris, 3), dtype=np.int64)
    t = lib.feu_triangulate(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_tris)
    if t < 0:
        return None
    return out[:t].copy()


def read_msh2_native(path):
    """Parse an ASCII MSH 2.x file with the C++ kernel.

    Returns the same dict as ``msh_io.read_msh2`` (vertices / triangles /
    triangle_tags / lines / line_tags / version) or None if the native
    kernel is unavailable or refuses the file (caller falls back to the
    pure-Python parser).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "feu_msh2_parse"):
        return None
    counts = (ctypes.c_int64 * 4)()
    handle = lib.feu_msh2_parse(os.fspath(path).encode(), counts)
    if not handle:
        return None
    try:
        n, t, l, v10 = counts[0], counts[1], counts[2], counts[3]
        verts = np.empty((n, 2), dtype=np.float64)
        tris = np.empty((t, 3), dtype=np.int64)
        tri_tags = np.empty(t, dtype=np.int64)
        lines = np.empty((l, 2), dtype=np.int64)
        line_tags = np.empty(l, dtype=np.int64)
        rc = lib.feu_msh2_copy(
            handle,
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            tri_tags.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            lines.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            line_tags.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if rc != 0:
            return None
    finally:
        lib.feu_msh2_free(handle)
    return {
        "vertices": verts,
        "triangles": tris,
        "triangle_tags": tri_tags,
        "lines": lines,
        "line_tags": line_tags,
        "version": f"{v10 // 10}.{v10 % 10}",
    }


def smooth_and_triangulate(points: np.ndarray, n_fixed: int,
                           n_iters: int):
    """In-place Laplacian smoothing (movable points re-triangulated each
    pass); returns (points, triangles) or None."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float64).copy()
    n = len(pts)
    max_tris = 2 * n + 16
    out = np.empty((max_tris, 3), dtype=np.int64)
    t = lib.feu_smooth(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        n_fixed, n_iters,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_tris)
    if t < 0:
        return None
    return pts, out[:t].copy()
