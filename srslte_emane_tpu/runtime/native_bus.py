"""ctypes bindings for the native runtime core (native/emanelte_bus.cpp).

Auto-builds on first import if the toolchain is present; falls back to the
pure-NumPy path (runtime/sinr.py) otherwise.  The SINR results are bit-compared
against the NumPy implementation in tests.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

_DIR = pathlib.Path(__file__).parent.parent / "native"
_SO = _DIR / "libemanelte.so"
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _SO.exists():
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 "-o", str(_SO), str(_DIR / "emanelte_bus.cpp")],
                check=True, capture_output=True)
        except Exception:
            return None
    lib = ctypes.CDLL(str(_SO))
    lib.sinr_per_rb.argtypes = [
        ctypes.POINTER(ctypes.c_float)] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    lib.sinr_per_rb_cells.argtypes = [
        ctypes.POINTER(ctypes.c_float)] * 3 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    lib.bus_create.restype = ctypes.c_void_p
    lib.bus_send.argtypes = [ctypes.c_void_p, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                             ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.bus_recv.restype = ctypes.c_int
    lib.bus_recv.argtypes = [ctypes.c_void_p, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.bus_destroy.argtypes = [ctypes.c_void_p]
    lib.bus_step_tti.argtypes = [ctypes.c_void_p]
    lib.bus_step_tti.restype = ctypes.c_uint64
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def sinr_per_rb_native(tx_power_dbm, prb_used, pathloss_db, noise_floor_dbm,
                       cells=None):
    """Same contract as runtime.sinr.per_rb_sinr, computed in C++."""
    lib = _load()
    tx_mw = (10.0 ** (np.asarray(tx_power_dbm, np.float64) / 10.0)).astype(np.float32)
    gain = (10.0 ** (-np.asarray(pathloss_db, np.float64) / 10.0)).astype(np.float32)
    used = np.ascontiguousarray(prb_used, np.float32)
    T, R = gain.shape
    P = used.shape[1]
    out = np.zeros((T, R, P), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    noise = ctypes.c_float(10.0 ** (noise_floor_dbm / 10.0))
    if cells is None:
        lib.sinr_per_rb(
            np.ascontiguousarray(tx_mw).ctypes.data_as(fp),
            np.ascontiguousarray(gain).ctypes.data_as(fp),
            used.ctypes.data_as(fp), noise,
            T, R, P, out.ctypes.data_as(fp))
        return out
    # dense cell indices for the per-cell energy accumulators
    uniq, dense = np.unique(np.asarray(cells), return_inverse=True)
    dense = np.ascontiguousarray(dense, np.int32)
    lib.sinr_per_rb_cells(
        np.ascontiguousarray(tx_mw).ctypes.data_as(fp),
        np.ascontiguousarray(gain).ctypes.data_as(fp),
        used.ctypes.data_as(fp),
        dense.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(uniq),
        noise, T, R, P, out.ctypes.data_as(fp))
    return out


class NativeBus:
    """Frame queue in C++ (multi-threaded-safe); Python keeps the schema."""

    def __init__(self):
        self._lib = _load()
        self._h = ctypes.c_void_p(self._lib.bus_create())

    def send(self, src: int, rx_nodes, data: bytes):
        arr = (ctypes.c_int * len(rx_nodes))(*rx_nodes)
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        self._lib.bus_send(self._h, src, arr, len(rx_nodes), buf, len(data))

    def recv(self, node: int, max_bytes: int = 1 << 20, max_frames: int = 256):
        buf = (ctypes.c_uint8 * max_bytes)()
        srcs = (ctypes.c_int * max_frames)()
        offs = (ctypes.c_int * max_frames)()
        lens = (ctypes.c_int * max_frames)()
        n = self._lib.bus_recv(self._h, node, buf, max_bytes, srcs, offs, lens,
                               max_frames)
        out = []
        for i in range(n):
            out.append((srcs[i], bytes(buf[offs[i] : offs[i] + lens[i]])))
        return out

    def step_tti(self) -> int:
        return int(self._lib.bus_step_tti(self._h))

    def __del__(self):
        try:
            self._lib.bus_destroy(self._h)
        except Exception:
            pass
