"""Resampling: polyphase arbitrary-ratio resampler, linear interpolators,
decimators, and software AGC.

Reference behavior: `lib/src/phy/resampling/{resample_arb.c,interp.c,decim.c}`
(32-filter polyphase bank) and `lib/src/phy/agc/agc.c`.

Design: the polyphase filter bank is a (n_out, taps) gather + matmul —
each output sample picks its phase filter and input window; fully batched.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from . import cplx

N_PHASES = 32
N_TAPS = 8


@functools.lru_cache(maxsize=None)
def _polyphase_bank(n_phases: int = N_PHASES, taps: int = N_TAPS) -> np.ndarray:
    """Windowed-sinc low-pass split into polyphase branches: (phases, taps)."""
    n = n_phases * taps
    t = (np.arange(n) - n / 2 + 0.5) / n_phases
    h = np.sinc(t) * np.hamming(n)
    h = h / np.sum(h) * n_phases
    return h.reshape(taps, n_phases).T.astype(np.float32)  # (phases, taps)


def resample_arb(x, ratio: float, n_out: int = None):
    """Arbitrary-ratio polyphase resample of cf tensor (..., T, 2).

    ratio = f_out / f_in. Static n_out (default floor(T*ratio))."""
    T = x.shape[-2]
    if n_out is None:
        n_out = int(T * ratio)
    bank = _polyphase_bank()
    pos = np.arange(n_out) / ratio
    base = np.floor(pos).astype(np.int64)
    frac = pos - base
    phase = np.minimum((frac * N_PHASES).astype(np.int64), N_PHASES - 1)
    # input windows: x[base - taps/2 + 1 + j], j in [0, taps)
    off = np.arange(N_TAPS) - N_TAPS // 2 + 1
    idx = np.clip(base[:, None] + off[None, :], 0, T - 1).astype(np.int32)
    win = jnp.take(x, jnp.asarray(idx.reshape(-1)), axis=-2)
    win = win.reshape(x.shape[:-2] + (n_out, N_TAPS, 2))
    coef = jnp.asarray(bank[phase])  # (n_out, taps)
    return jnp.einsum("...otc,ot->...oc", win, coef)


def interp_linear(x, factor: int):
    """Integer-factor linear interpolation of cf tensor (interp.c)."""
    T = x.shape[-2]
    t = np.arange(T * factor) / factor
    j0 = np.clip(np.floor(t).astype(np.int64), 0, T - 2)
    w = (t - j0).astype(np.float32)
    a = jnp.take(x, jnp.asarray(j0.astype(np.int32)), axis=-2)
    b = jnp.take(x, jnp.asarray((j0 + 1).astype(np.int32)), axis=-2)
    return a * (1 - w)[..., None] + b * w[..., None]


def decimate(x, factor: int):
    """Averaging decimator (decim.c)."""
    T = (x.shape[-2] // factor) * factor
    y = x[..., :T, :].reshape(x.shape[:-2] + (T // factor, factor, 2))
    return jnp.mean(y, axis=-2)


class Agc:
    """Software AGC (agc.c): per-frame gain toward a power target."""

    def __init__(self, target: float = 1.0, bw: float = 0.7):
        self.gain = 1.0
        self.target = target
        self.bw = bw

    def process(self, x):
        p = float(jnp.mean(cplx.abs2(x)))
        y = x * np.float32(self.gain)
        if p > 0:
            desired = np.sqrt(self.target / (p * self.gain**2 + 1e-12))
            self.gain = (1 - self.bw) * self.gain + self.bw * self.gain * desired
        return y
