"""ctypes bindings for the native host runtime (native/picsong_native.cpp).

The shared library is built from the tracked source by `make` (g++) at
first use in each process; make is a no-op when the library is newer than
its source, so a stale binary is always rebuilt. Every entry point has a
NumPy fallback, so the framework works without a toolchain; the native
path is preferred for large frames (the relocation is memory-bound host
work — here on the host, where the reference runs its BitStreamBuilder
GPU kernels + CUB prefix sum).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import warnings

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libpicsong_native.so")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.picsong_stream_length.restype = ctypes.c_int64
        lib.picsong_stream_length.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.picsong_pack.restype = None
        lib.picsong_pack.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int64]
        lib.picsong_unpack.restype = None
        lib.picsong_unpack.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)]
        lib.picsong_load_frame_padded.restype = ctypes.c_int
        lib.picsong_load_frame_padded.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
    except Exception as e:                              # noqa: BLE001
        detail = getattr(e, "stderr", b"") or b""
        warnings.warn(f"native library unavailable, using the NumPy "
                      f"relocation: {e} {detail.decode(errors='replace')}"
                      .strip(), RuntimeWarning, stacklevel=2)
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def pack_streams(streams: np.ndarray, sizes: np.ndarray,
                 header: np.ndarray | None) -> np.ndarray:
    """Native pack; falls back to assembly.pack on missing toolchain."""
    lib = _load()
    if lib is None:
        from ..assembly.pack import pack_streams as py_pack
        return py_pack(streams, sizes, header)
    streams = np.ascontiguousarray(streams, dtype=np.int32)
    sizes64 = np.ascontiguousarray(sizes, dtype=np.int64)
    ncb = streams.shape[0]
    length = int(lib.picsong_stream_length(_ptr(sizes64, ctypes.c_int64), ncb))
    out = np.empty(length, dtype=np.uint16)
    hdr_ptr = None
    if header is not None:
        header = np.ascontiguousarray(header, dtype=np.uint16)
        hdr_ptr = header.ctypes.data_as(ctypes.c_void_p)
    lib.picsong_pack(_ptr(streams, ctypes.c_int32),
                     _ptr(sizes64, ctypes.c_int64), ncb, hdr_ptr,
                     _ptr(out, ctypes.c_uint16), length)
    return out


def unpack_streams(stream: np.ndarray, ncb: int) -> tuple[np.ndarray, np.ndarray]:
    lib = _load()
    if lib is None:
        from ..assembly.pack import unpack_streams as py_unpack
        return py_unpack(stream, ncb)
    stream = np.ascontiguousarray(stream, dtype=np.uint16)
    out = np.empty((ncb, 4096), dtype=np.int32)
    sizes = np.empty(ncb, dtype=np.int64)
    lib.picsong_unpack(_ptr(stream, ctypes.c_uint16), ncb,
                       _ptr(out, ctypes.c_int32), _ptr(sizes, ctypes.c_int64))
    return out, sizes


def load_frame_padded(path: str, width: int, height: int, frame: int,
                      adapted_w: int, adapted_h: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        from ..core.image_io import mirror_pad, read_raw_frame
        return mirror_pad(read_raw_frame(path, width, height, frame),
                          adapted_w, adapted_h)
    out = np.empty((adapted_h, adapted_w), dtype=np.uint8)
    rc = lib.picsong_load_frame_padded(
        path.encode(), width, height, frame, adapted_w, adapted_h,
        _ptr(out, ctypes.c_uint8))
    if rc != 0:
        raise IOError(f"picsong_load_frame_padded({path}) failed: {rc}")
    return out
