"""Native (C++) runtime components, loaded via ctypes.

The compute path is JAX/Pallas; these are the host-side runtime pieces the
reference implements in C++ (PPM image codec, BVH construction —
Code/image.cpp, Code/acceleration.cpp), rebuilt as a shared library with
pure-Python fallbacks.  The library compiles on first import (g++ -O3) and
is cached next to this file; set RTT_NO_NATIVE=1 to force the fallbacks.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "_rtt_native.so")
_SRC = [
    os.path.join(_HERE, "src", "ppm_codec.cpp"),
    os.path.join(_HERE, "src", "lbvh.cpp"),
]


def _build() -> bool:
    try:
        newest_src = max(os.path.getmtime(s) for s in _SRC)
        if os.path.exists(_SO) and os.path.getmtime(_SO) >= newest_src:
            return True
        cmd = ["g++", "-std=c++17", "-O3", "-shared", "-fPIC", "-o", _SO, *_SRC]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception as e:  # pragma: no cover - toolchain-dependent
        print(f"ray_tracying.native: build failed ({e}); "
              "using Python fallbacks", file=sys.stderr)
        return False


_lib = None
if not os.environ.get("RTT_NO_NATIVE"):
    if _build():
        try:
            _lib = ctypes.CDLL(_SO)
            _lib.ppm_read_header.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            _lib.ppm_read_header.restype = ctypes.c_int
            _lib.ppm_read_pixels.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
            ]
            _lib.ppm_read_pixels.restype = ctypes.c_int
            _lib.ppm_write.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ]
            _lib.ppm_write.restype = ctypes.c_int
            _lib.lbvh_build.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            _lib.lbvh_build.restype = ctypes.c_int64
        except OSError as e:  # pragma: no cover
            print(f"ray_tracying.native: load failed ({e})", file=sys.stderr)
            _lib = None


class _PpmNative:
    """ctypes wrapper; read_ppm returns None on any native failure so the
    Python codec can take over."""

    @staticmethod
    def read_ppm(path: str):
        import numpy as np

        if _lib is None:
            return None
        w = ctypes.c_int32()
        h = ctypes.c_int32()
        if _lib.ppm_read_header(path.encode(), ctypes.byref(w), ctypes.byref(h)):
            return None
        out = np.empty((h.value, w.value, 3), np.uint8)
        rc = _lib.ppm_read_pixels(
            path.encode(), out.ctypes.data_as(ctypes.c_void_p), out.size
        )
        return out if rc == 0 else None

    @staticmethod
    def write_ppm(path: str, img) -> bool:
        import numpy as np

        if _lib is None:
            return False
        img = np.ascontiguousarray(img)
        h, w, _ = img.shape
        rc = _lib.ppm_write(
            path.encode(), img.ctypes.data_as(ctypes.c_void_p), w, h
        )
        return rc == 0


class _LbvhNative:
    @staticmethod
    def build(aabbs, leaf_size: int):
        import numpy as np

        if _lib is None:
            raise RuntimeError("native library unavailable")
        aabbs = np.ascontiguousarray(aabbs, np.float32)
        g = aabbs.shape[0]
        boxes = np.empty((max(2 * g - 1, 1), 6), np.float32)
        topo = np.empty((max(2 * g - 1, 1), 4), np.int32)
        order = np.empty(g, np.int64)
        n = _lib.lbvh_build(
            aabbs.ctypes.data_as(ctypes.c_void_p),
            g,
            leaf_size,
            boxes.ctypes.data_as(ctypes.c_void_p),
            topo.ctypes.data_as(ctypes.c_void_p),
            order.ctypes.data_as(ctypes.c_void_p),
        )
        if n < 0:
            raise RuntimeError("lbvh_build failed")
        return boxes[:n].copy(), topo[:n].copy(), order


ppm_native = _PpmNative if _lib is not None else None
lbvh_native = _LbvhNative if _lib is not None else None
