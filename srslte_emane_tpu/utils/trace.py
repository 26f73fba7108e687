"""Lightweight ring-buffer tracer + device-timing helpers.

Reference behavior: `lib/include/srslte/common/trace.h:38-79` —
`srslte::trace<T>` with push_cur_time_us(tti) and binary dump; per-call
`meas_time_en` timing in PDSCH/PUSCH cfg.

Additions: `device_timer` wraps a jitted callable with a forced-completion
wall-clock measurement; `jax_profile` context manager drives the jax profiler
(the "replace with jax profiler + per-stage device timing" item of
SURVEY.md §5).
"""

from __future__ import annotations

import contextlib
import struct
import time

import numpy as np


class Trace:
    """Fixed-size ring buffer of (tag, value, t_us) samples."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = capacity
        self.tags = np.zeros(capacity, dtype=np.int32)
        self.values = np.zeros(capacity, dtype=np.float64)
        self.t_us = np.zeros(capacity, dtype=np.int64)
        self.n = 0
        self._t0 = time.monotonic()

    def push(self, tag: int, value: float = 0.0):
        i = self.n % self.capacity
        self.tags[i] = tag
        self.values[i] = value
        self.t_us[i] = int((time.monotonic() - self._t0) * 1e6)
        self.n += 1

    def push_cur_time_us(self, tti: int):
        self.push(tti)

    def dump(self, path: str):
        """Binary dump: n records of (i32 tag, f64 value, i64 t_us)."""
        k = min(self.n, self.capacity)
        with open(path, "wb") as f:
            f.write(struct.pack("<I", k))
            for i in range(k):
                f.write(struct.pack("<iqd", int(self.tags[i]),
                                    int(self.t_us[i]), float(self.values[i])))

    @staticmethod
    def load(path: str):
        with open(path, "rb") as f:
            (k,) = struct.unpack("<I", f.read(4))
            out = []
            for _ in range(k):
                tag, t, v = struct.unpack("<iqd", f.read(20))
                out.append((tag, t, v))
        return out


def device_timer(fn, *args, iters: int = 10):
    """Steady-state wall time of a jitted callable (single final forced
    completion — see bench.py methodology)."""
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args)
    np.asarray(jax.tree_util.tree_leaves(out)[0])
    return (time.time() - t0) / iters


@contextlib.contextmanager
def jax_profile(logdir: str):
    """jax profiler session (view with tensorboard/xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
