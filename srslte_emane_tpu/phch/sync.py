"""PSS/SSS synchronization and cell search.

Reference behavior: `lib/src/phy/sync/pss.c` (ZC u in {25,29,34}, FFT-based
cross-correlation at 1.92 Msps, peak-to-sidelobe quality, CFO estimate),
`sync/sss.c` + `find_sss.c` (m-sequence SSS, N_id_1 + subframe detection),
`ue/ue_cell_search.c` (composite search over N_id_2).

Design: PSS correlation for all 3 roots and all time lags is one
sliding-window gather + (B, lags, 128) x (128, 3*2) matmul; SSS detection is a
(B, 62) x (62, 2*168*2) correlation matmul over every (N_id_1, subframe)
hypothesis; CFO hypotheses batch as phase ramps on the input (BASELINE
config #4's "batched frequency hypotheses").
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..ops import cplx, dft, ofdm

PSS_ROOTS = {0: 25, 1: 29, 2: 34}


@functools.lru_cache(maxsize=None)
def pss_freq(n_id_2: int) -> np.ndarray:
    """62-length ZC PSS (36.211 §6.11.1)."""
    u = PSS_ROOTS[n_id_2]
    n = np.arange(31)
    a = np.exp(-1j * np.pi * u * n * (n + 1) / 63)
    b = np.exp(-1j * np.pi * u * (n + 31 + 1) * (n + 31 + 2) / 63)
    return np.concatenate([a, b]).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def pss_time(n_id_2: int, fft_size: int = 128) -> np.ndarray:
    """Time-domain PSS replica (one OFDM symbol, no CP), unit energy."""
    x = np.zeros(fft_size, dtype=np.complex64)
    d = pss_freq(n_id_2)
    # subcarriers -31..-1, +1..+31
    x[fft_size - 31 :] = d[:31]
    x[1:32] = d[31:]
    t = np.fft.ifft(x)
    return (t / np.linalg.norm(t)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _mseq(poly_taps: tuple) -> np.ndarray:
    """31-length m-sequence in bipolar form, x(0..4) init = (0,0,0,0,1)."""
    x = np.zeros(31, dtype=np.int64)
    x[4] = 1
    for i in range(26):
        x[i + 5] = sum(x[i + t] for t in poly_taps) % 2
    return (1 - 2 * x).astype(np.float32)


def _s_tilde():
    return _mseq((0, 2))  # x^5 + x^2 + 1


def _c_tilde():
    return _mseq((0, 3))  # x^5 + x^3 + 1


def _z_tilde():
    return _mseq((0, 1, 2, 4))  # x^5 + x^4 + x^2 + x + 1


def _m0m1(n_id_1: int):
    qp = n_id_1 // 30
    q = (n_id_1 + qp * (qp + 1) // 2) // 30
    mp = n_id_1 + q * (q + 1) // 2
    m0 = mp % 31
    m1 = (m0 + mp // 31 + 1) % 31
    return m0, m1


@functools.lru_cache(maxsize=None)
def sss_sequence(n_id_1: int, n_id_2: int, sf_idx: int) -> np.ndarray:
    """62-length bipolar SSS (36.211 §6.11.2); sf_idx in {0, 5}."""
    m0, m1 = _m0m1(n_id_1)
    s, c, z = _s_tilde(), _c_tilde(), _z_tilde()
    n = np.arange(31)
    s0 = s[(n + m0) % 31]
    s1 = s[(n + m1) % 31]
    c0 = c[(n + n_id_2) % 31]
    c1 = c[(n + n_id_2 + 3) % 31]
    z0 = z[(n + (m0 % 8)) % 31]
    z1 = z[(n + (m1 % 8)) % 31]
    d = np.zeros(62, dtype=np.float32)
    if sf_idx == 0:
        d[0::2] = s0 * c0
        d[1::2] = s1 * c1 * z0
    else:
        d[0::2] = s1 * c0
        d[1::2] = s0 * c1 * z1
    return d


@functools.lru_cache(maxsize=None)
def _sss_bank(n_id_2: int) -> np.ndarray:
    """(62, 336) matrix: all (N_id_1 x {sf0, sf5}) SSS hypotheses."""
    cols = []
    for n1 in range(168):
        for sf in (0, 5):
            cols.append(sss_sequence(n1, n_id_2, sf))
    return np.stack(cols, axis=1)


def pss_correlate(samples, fft_size: int = 128):
    """samples (B, T, 2) -> correlation energy (B, 3, T-fft_size+1) and
    complex corr (B, 3, lags, 2) for CFO use."""
    B, T, _ = samples.shape
    lags = T - fft_size + 1
    # sliding windows via gather
    idx = (np.arange(lags)[:, None] + np.arange(fft_size)[None, :]).astype(np.int32)
    win = jnp.take(samples, jnp.asarray(idx.reshape(-1)), axis=-2)
    win = win.reshape(B, lags, fft_size, 2)
    reps = np.stack([pss_time(i, fft_size) for i in range(3)], axis=1)  # (fft, 3)
    # corr = win @ conj(reps):  (B, lags, fft, 2) x (fft, 3) -> (B, lags, 3, 2)
    corr = cplx.matmul(
        win, reps.real.astype(np.float32), (-reps.imag).astype(np.float32)
    )
    e = cplx.abs2(corr)  # (B, lags, 3)
    return e.swapaxes(-1, -2), corr


def pss_find(samples, fft_size: int = 128):
    """Peak search: returns (n_id_2 (B,), peak_pos (B,), quality (B,))."""
    e, _ = pss_correlate(samples, fft_size)  # (B, 3, lags)
    B = e.shape[0]
    flat = e.reshape(B, -1)
    best = jnp.argmax(flat, axis=-1)
    n_id_2 = (best // e.shape[-1]).astype(jnp.int32)
    pos = (best % e.shape[-1]).astype(jnp.int32)
    peak = jnp.max(flat, axis=-1)
    mean = jnp.mean(e, axis=(-1, -2))
    return n_id_2, pos, peak / (mean + 1e-12)


def put_pss_sss(grid, cell, sf_idx: int):
    """eNB-side: place PSS (last symbol of slot 0) and SSS (one earlier) on
    sf 0/5 (enb_dl.c put_base equivalent).  Normal CP: symbols 6/5;
    extended CP: symbols 5/4 (6-symbol slots, 36.211 6.11)."""
    if sf_idx not in (0, 5):
        return grid
    nre = cell.nre
    l_pss = 6 if cell.cp == "normal" else 5
    n_id_2 = cell.cell_id % 3
    n_id_1 = cell.cell_id // 3
    ks = np.arange(nre // 2 - 31, nre // 2 + 31, dtype=np.int32)
    pss = cplx.from_numpy(pss_freq(n_id_2))
    sss = cplx.from_numpy(sss_sequence(n_id_1, n_id_2, sf_idx).astype(np.complex64))
    flat = grid.reshape(grid.shape[0], -1, 2)
    bshape = (grid.shape[0],) + pss.shape
    flat = flat.at[:, jnp.asarray(l_pss * nre + ks), :].set(
        jnp.broadcast_to(pss, bshape))
    flat = flat.at[:, jnp.asarray((l_pss - 1) * nre + ks), :].set(
        jnp.broadcast_to(sss, bshape))
    return flat.reshape(grid.shape)


def pss_symbol_start(n_prb: int, cp: str = "normal") -> int:
    """Sample index of PSS symbol (no CP) within the subframe."""
    p = ofdm.params(n_prb, cp=cp)
    n_before = 6 if cp == "normal" else 5  # symbols preceding the PSS
    return (p["cp0"] + p["n"]) + (n_before - 1) * (p["cp"] + p["n"]) + p["cp"]


def _sss_hypothesis(samples, pos, n_id_2, fft_size: int, cp: int):
    """SSS decode under one CP-length hypothesis: the SSS symbol starts
    (fft_size + cp) samples before the PSS peak.  Returns per-batch
    (n_id_1, sf_idx, metric) for the detected n_id_2."""
    start = jnp.maximum(pos - fft_size - cp, 0)
    idx = start[:, None] + jnp.arange(fft_size)[None, :]
    sss_td = jnp.take_along_axis(samples, idx[..., None], axis=1)  # (B, fft, 2)
    f = dft.dft(sss_td, ortho=True)
    # center 62 bins: negative freqs at [-31..-1] -> bins N-31..N-1, +1..+31
    bins = np.concatenate(
        [np.arange(fft_size - 31, fft_size), np.arange(1, 32)]).astype(np.int32)
    sss62 = jnp.take(f, jnp.asarray(bins), axis=-2)
    # try each n_id_2 bank, pick by metric (n_id_2 is per-batch; compute all 3)
    n1s, sfs, ms = [], [], []
    for h in range(3):
        n1, sf, m = sss_find(sss62, h)
        n1s.append(n1)
        sfs.append(sf)
        ms.append(m)
    sel = n_id_2[:, None].astype(jnp.int32)
    n_id_1 = jnp.take_along_axis(jnp.stack(n1s, 1), sel, axis=1)[:, 0]
    sf_idx = jnp.take_along_axis(jnp.stack(sfs, 1), sel, axis=1)[:, 0]
    metric = jnp.take_along_axis(jnp.stack(ms, 1), sel, axis=1)[:, 0]
    return n_id_1, sf_idx, metric


def cell_search(samples, fft_size: int = 128, detect_cp: bool = False):
    """Composite search on (B, T, 2) 1.92 Msps-equivalent samples (6-PRB wide).

    Returns dict(n_id_2, pss_pos, quality, n_id_1, sf_idx, cell_id[, cp_ext])
    — the ue_cell_search.c equivalent, fully batched.  Assumes T covers at
    least one PSS occurrence; SSS is read one symbol (+CP) before the PSS
    peak.

    detect_cp=True runs the SSS decode under BOTH cyclic-prefix hypotheses
    (normal: 144/2048·N, extended: 512/2048·N — only the SSS offset before
    the PSS differs) and picks per-batch by correlation metric, the
    sync.c:68-78 CP auto-detection role recast as two extra batched matmuls
    in the same graph instead of a second serial probe."""
    n_id_2, pos, quality = pss_find(samples, fft_size)
    cp_norm = 9 * fft_size // 128
    n_id_1, sf_idx, metric = _sss_hypothesis(
        samples, pos, n_id_2, fft_size, cp_norm)
    out = dict(n_id_2=n_id_2, pss_pos=pos, quality=quality)
    if detect_cp:
        cp_ext = 32 * fft_size // 128
        n1_e, sf_e, m_e = _sss_hypothesis(
            samples, pos, n_id_2, fft_size, cp_ext)
        is_ext = m_e > metric
        n_id_1 = jnp.where(is_ext, n1_e, n_id_1)
        sf_idx = jnp.where(is_ext, sf_e, sf_idx)
        out["cp_ext"] = is_ext
    out.update(n_id_1=n_id_1, sf_idx=sf_idx, cell_id=3 * n_id_1 + n_id_2)
    return out


def sss_find(sss_freq_62, n_id_2: int):
    """sss_freq_62: (B, 62, 2) equalized/raw SSS subcarriers.
    Coherent correlation against all hypotheses (real part).
    Returns (n_id_1 (B,), sf_idx (B,), metric (B,))."""
    bank = _sss_bank(n_id_2)  # (62, 336) real
    re = sss_freq_62[..., 0] @ jnp.asarray(bank)
    im = sss_freq_62[..., 1] @ jnp.asarray(bank)
    m = re * re + im * im  # non-coherent: phase-agnostic
    best = jnp.argmax(m, axis=-1)
    return (best // 2).astype(jnp.int32), jnp.where(best % 2 == 0, 0, 5).astype(jnp.int32), jnp.max(m, axis=-1)
