"""ctypes bindings for the native host runtime (native/liorf_runtime.cpp).

Built from source by the Makefile on first use (the library is not kept
in the repository); every class has a documented
pure-python behavioural twin in the test suite, so the bindings are optional —
but production feeds should use them (SPSC rings drain without holding the
GIL on the producer side).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libliorf_runtime.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "liorf_runtime.cpp")

_lib: Optional[ctypes.CDLL] = None


def _build() -> bool:
    """Compile into a name of this process's own and move it into place:
    concurrent first uses (parallel test workers) never load a half-written
    file, and the last finished build wins."""
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR,
                        f"TARGET={os.path.basename(tmp)}"],
                       check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _stale() -> bool:
    return (not os.path.exists(_LIB_PATH)
            or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC_PATH))


def load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if _stale() and not _build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    c = ctypes
    lib.rb_create.restype = c.c_void_p
    lib.rb_create.argtypes = [c.c_size_t, c.c_size_t]
    lib.rb_push.restype = c.c_int
    lib.rb_push.argtypes = [c.c_void_p, c.c_void_p]
    lib.rb_push_overwrite.restype = c.c_int
    lib.rb_push_overwrite.argtypes = [c.c_void_p, c.c_void_p]
    lib.rb_pop.restype = c.c_int
    lib.rb_pop.argtypes = [c.c_void_p, c.c_void_p]
    lib.rb_size.restype = c.c_size_t
    lib.rb_size.argtypes = [c.c_void_p]
    lib.rb_destroy.argtypes = [c.c_void_p]
    lib.sq_create.restype = c.c_void_p
    lib.sq_create.argtypes = [c.c_size_t, c.c_size_t]
    lib.sq_push.restype = c.c_int
    lib.sq_push.argtypes = [c.c_void_p, c.c_double, c.POINTER(c.c_float)]
    lib.sq_window.restype = c.c_int
    lib.sq_window.argtypes = [c.c_void_p, c.c_double, c.c_double, c.c_double,
                              c.POINTER(c.c_double), c.POINTER(c.c_float),
                              c.c_int]
    lib.sq_size.restype = c.c_size_t
    lib.sq_size.argtypes = [c.c_void_p]
    lib.sq_destroy.argtypes = [c.c_void_p]
    lib.pcd_write_binary.restype = c.c_int
    lib.pcd_write_binary.argtypes = [c.c_char_p, c.POINTER(c.c_float),
                                     c.POINTER(c.c_float), c.c_long]
    lib.host_voxel_downsample.restype = c.c_long
    lib.host_voxel_downsample.argtypes = [c.POINTER(c.c_float), c.c_long,
                                          c.c_float, c.POINTER(c.c_float),
                                          c.c_long]
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


class RingBuffer:
    """SPSC ring of fixed-size byte records (the subscriber-queue role)."""

    def __init__(self, record_size: int, capacity: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native runtime not available")
        self._lib = lib
        self._h = lib.rb_create(record_size, capacity)
        self.record_size = record_size

    def push(self, data: bytes, overwrite: bool = True) -> bool:
        assert len(data) == self.record_size
        fn = self._lib.rb_push_overwrite if overwrite else self._lib.rb_push
        return fn(self._h, data) >= 0

    def pop(self) -> Optional[bytes]:
        buf = ctypes.create_string_buffer(self.record_size)
        if self._lib.rb_pop(self._h, buf) != 0:
            return None
        return buf.raw

    def __len__(self) -> int:
        return self._lib.rb_size(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rb_destroy(self._h)
            self._h = None


class SampleQueue:
    """Timestamped float-vector queue with windowed extraction (the IMU/odom
    queue + stale-pop semantics of imageProjection.cpp:359-418)."""

    def __init__(self, dim: int, capacity: int = 4096):
        lib = load()
        if lib is None:
            raise RuntimeError("native runtime not available")
        self._lib = lib
        self.dim = dim
        self._h = lib.sq_create(dim, capacity)

    def push(self, t: float, vals) -> None:
        v = np.ascontiguousarray(vals, np.float32)
        assert v.size == self.dim
        self._lib.sq_push(self._h, float(t),
                          v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))

    def window(self, t0: float, t1: float, margin: float = 0.01,
               max_n: int = 2048):
        ts = np.empty(max_n, np.float64)
        vals = np.empty((max_n, self.dim), np.float32)
        n = self._lib.sq_window(
            self._h, float(t0), float(t1), float(margin),
            ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_n)
        return ts[:n], vals[:n]

    def __len__(self) -> int:
        return self._lib.sq_size(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sq_destroy(self._h)
            self._h = None


def pcd_write_binary(path: str, xyz: np.ndarray,
                     intensity: Optional[np.ndarray] = None) -> bool:
    lib = load()
    if lib is None:
        return False
    xyz = np.ascontiguousarray(xyz, np.float32)
    inten_ptr = None
    if intensity is not None:
        intensity = np.ascontiguousarray(intensity, np.float32)
        inten_ptr = intensity.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    rc = lib.pcd_write_binary(
        path.encode(), xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        inten_ptr, xyz.shape[0])
    return rc == 0


def host_voxel_downsample(xyz: np.ndarray, leaf: float,
                          max_out: int = 1 << 20) -> np.ndarray:
    lib = load()
    xyz = np.ascontiguousarray(xyz, np.float32)
    if lib is None:
        raise RuntimeError("native runtime not available")
    out = np.empty((max_out, 3), np.float32)
    m = lib.host_voxel_downsample(
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), xyz.shape[0],
        float(leaf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_out)
    return out[:m].copy()
