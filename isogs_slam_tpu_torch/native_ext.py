"""ctypes bindings for the native runtime library (counterpart of
isogs_slam_tpu/native_ext.py). Both packages load the same
native/build_out/libisogs_native.so, built by `native/build.sh`:
  * marching tetrahedra (native/src/marching_tets.cpp) — host-side mesh
    extraction core; same algorithm and winding as mesh/marching.py
  * largest connected component (native/src/components.cpp)
  * npz writer (native/src/npz_io.cpp) — cnpy-role checkpoint writer

`available()` is False when the library has not been built, and callers
fall back to the numpy implementations.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib_path():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, "native", "build_out", "libisogs_native.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.mt_extract.restype = ctypes.c_int
    lib.mt_extract.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_float, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int64)]
    lib.mt_free.argtypes = [ctypes.c_void_p]
    lib.mesh_largest_component.restype = ctypes.c_int64
    lib.mesh_largest_component.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.npz_write.restype = ctypes.c_int
    lib.npz_write.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_void_p)]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def marching_tetrahedra_native(density: np.ndarray, level: float,
                               spacing=(1.0, 1.0, 1.0),
                               origin=(0.0, 0.0, 0.0)):
    """Drop-in for mesh.marching.marching_tetrahedra (same outputs)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built (native/build.sh)")
    d = np.ascontiguousarray(density, np.float32)
    sp = np.asarray(spacing, np.float64)
    og = np.asarray(origin, np.float64)
    vp = ctypes.POINTER(ctypes.c_float)()
    fp = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.mt_extract(
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        d.shape[0], d.shape[1], d.shape[2], ctypes.c_float(level),
        sp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        og.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(vp), ctypes.byref(nv),
        ctypes.byref(fp), ctypes.byref(nf))
    if rc != 0:
        raise RuntimeError(f"mt_extract failed rc={rc}")
    try:
        verts = np.ctypeslib.as_array(vp, (nv.value, 3)).copy() \
            if nv.value else np.zeros((0, 3), np.float32)
        faces = np.ctypeslib.as_array(fp, (nf.value, 3)).copy() \
            if nf.value else np.zeros((0, 3), np.int32)
    finally:
        if nv.value:
            lib.mt_free(vp)
        if nf.value:
            lib.mt_free(fp)
    return verts, faces


def largest_component_native(verts: np.ndarray, faces: np.ndarray):
    """Drop-in for mesh.marching.largest_component: union-find in C++
    (native/src/components.cpp) instead of a scipy sparse adjacency —
    the 10^7-face postprocessing step of mesh extraction."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built (native/build.sh)")
    if faces.shape[0] == 0:
        return verts, faces
    f = np.ascontiguousarray(faces, np.int32)
    V = verts.shape[0]
    face_keep = np.empty(f.shape[0], np.int32)
    new_index = np.empty(V, np.int32)
    n_kept = lib.mesh_largest_component(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        f.shape[0], V,
        face_keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        new_index.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if n_kept < 0:
        raise RuntimeError("mesh_largest_component failed (bad indices)")
    kept_faces = new_index[f[face_keep.astype(bool)]]
    return verts[new_index >= 0], kept_faces.astype(np.int32)


_DTYPE_DESCR = {
    np.dtype(np.float32): b"<f4", np.dtype(np.float64): b"<f8",
    np.dtype(np.int32): b"<i4", np.dtype(np.int64): b"<i8",
    np.dtype(np.uint8): b"|u1", np.dtype(np.uint16): b"<u2",
}


def npz_write_native(path: str, arrays: dict):
    """np.savez-compatible writer through the native library."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built (native/build.sh)")
    names, descrs, ndims, shapes, ptrs, keep = [], [], [], [], [], []
    for k, v in arrays.items():
        a = np.ascontiguousarray(v)
        if a.dtype not in _DTYPE_DESCR:
            a = a.astype(np.float64)
        keep.append(a)
        names.append(k.encode())
        descrs.append(_DTYPE_DESCR[a.dtype])
        ndims.append(max(a.ndim, 0))
        shapes.extend(int(s) for s in a.shape)
        ptrs.append(a.ctypes.data_as(ctypes.c_void_p))
    n = len(names)
    rc = lib.npz_write(
        path.encode(), n,
        (ctypes.c_char_p * n)(*names),
        (ctypes.c_char_p * n)(*descrs),
        (ctypes.c_int * n)(*ndims),
        (ctypes.c_int64 * len(shapes))(*shapes),
        (ctypes.c_void_p * n)(*[p.value for p in ptrs]))
    if rc != 0:
        raise RuntimeError(f"npz_write failed rc={rc}")
