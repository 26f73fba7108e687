"""NB-IoT synchronization signals: NPSS / NSSS (36.211 §10.2.7).

Reference behavior: `lib/src/phy/sync/{npss.c,nsss.c,sync_nbiot.c}` (the
19.09 NB-IoT feature, CHANGELOG:5-7): NPSS = length-11 ZC(u=5) with a
per-symbol cover over symbols 3..13 of subframe 5; NSSS = length-132
ZC x Hadamard x frame phase on subframe 9 of even frames, encoding
N_id_ncell in 0..503.

Detection: batched correlation over all (cell id, frame-phase) hypotheses —
one matmul, replacing the serial search of sync_nbiot.c.
"""

from __future__ import annotations

import functools
import pathlib

import jax.numpy as jnp
import numpy as np

from ..ops import cplx

NPSS_COVER = np.array([1, 1, 1, 1, -1, -1, 1, 1, 1, -1, 1], dtype=np.float32)
NPSS_SYMS = tuple(range(3, 14))
# 36.211 Table 10.2.7.2.1-1 (extracted spec data)
B_Q_M = np.load(pathlib.Path(__file__).parent / "nsss_tables.npz")["b_q_m"]


@functools.lru_cache(maxsize=None)
def npss_grid() -> np.ndarray:
    """(11 symbols, 11 subcarriers) complex NPSS block (one PRB, sc 0..10)."""
    n = np.arange(11)
    zc = np.exp(-1j * np.pi * 5 * n * (n + 1) / 11)
    return (NPSS_COVER[:, None] * zc[None, :]).astype(np.complex64)


def _b_q(i: int) -> np.ndarray:
    """b_q(m) spec sequence, cycled m = n mod 128 to length 132."""
    return B_Q_M[i][np.arange(132) % 128].astype(np.float32)


@functools.lru_cache(maxsize=None)
def nsss_sequence(n_id_ncell: int, frame_idx: int) -> np.ndarray:
    """Length-132 NSSS (36.211 §10.2.7.2)."""
    u = n_id_ncell % 126 + 3
    q = n_id_ncell // 126
    theta = 33.0 / 132.0 * ((frame_idx // 2) % 4)
    n = np.arange(132)
    np_ = n % 131
    zc = np.exp(-1j * np.pi * u * np_ * (np_ + 1) / 131)
    b = _b_q(q)
    return (b * np.exp(-2j * np.pi * theta * n) * zc).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _nsss_bank() -> np.ndarray:
    """(132, 504*4) all (cell, frame-phase) hypotheses."""
    cols = []
    for nid in range(504):
        for f in range(4):
            cols.append(nsss_sequence(nid, 2 * f))
    return np.stack(cols, axis=1)


def npss_detect(grid_prb):
    """grid_prb: (B, 14, 12, 2) one NB-IoT PRB.  Correlate against the NPSS
    block.  Returns metric (B,) (normalized 0..1)."""
    ref = cplx.from_numpy(npss_grid())  # (11, 11, 2)
    y = grid_prb[:, NPSS_SYMS, :11, :]
    num = jnp.sum(cplx.mul_conj(y, jnp.asarray(ref)), axis=(-3, -2))
    e = jnp.sum(cplx.abs2(y), axis=(-2, -1)) + 1e-9
    return jnp.sqrt(cplx.abs2(num)) / jnp.sqrt(e * 121)


def nsss_detect(nsss_res):
    """nsss_res: (B, 132, 2) extracted NSSS REs.
    Returns (n_id_ncell (B,), frame_phase (B,), metric (B,))."""
    bank = _nsss_bank()
    br = jnp.asarray(bank.real.astype(np.float32))
    bi = jnp.asarray(bank.imag.astype(np.float32))
    yr, yi = nsss_res[..., 0], nsss_res[..., 1]
    cr = yr @ br + yi @ bi  # Re<y, conj(s)>
    ci = yi @ br - yr @ bi
    m = cr * cr + ci * ci
    best = jnp.argmax(m, axis=-1)
    return (best // 4).astype(jnp.int32), (best % 4).astype(jnp.int32), jnp.max(m, -1)
