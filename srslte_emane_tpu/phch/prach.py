"""PRACH: Zadoff-Chu preamble generation + eNB correlation detection.

Reference behavior: `lib/src/phy/phch/prach.c` — 839-length ZC roots
(logical order table 36.211 5.7.2-4, extracted to prach_tables.npz), N_cs
zero-correlation-zone shifts (Table 5.7.2-2, unrestricted set), freq-domain
root correlation detection with per-shift window peak search
(prach.c:235-266), and restricted set type A (high-speed) cyclic-shift
derivation per 36.211 §5.7.2 (d_u, n_shift_RA/d_start/n_group_RA groups).

Design: sequence-level (frequency-domain, 839 bins) — the representation
the eNB detector and the EMANE message mode actually consume.  Detection for
all roots of a cell is one batched complex-matmul IDFT; peak search is a
windowed max.  The 1.25 kHz waveform embedding rides a two-stage CT DFT (below).
"""

from __future__ import annotations

import functools
import pathlib

import jax.numpy as jnp
import numpy as np

from ..ops import cplx

_DATA = np.load(pathlib.Path(__file__).parent / "prach_tables.npz")
ZC_ROOTS = _DATA["zc_roots"]  # logical order, formats 0-3
ZC_ROOTS_F4 = _DATA["zc_roots_f4"]  # logical order, format 4 (N_ZC=139)
N_ZC = 839
N_ZC_F4 = 139
# 36.211 Table 5.7.2-2 (unrestricted and restricted set type A)
NCS_UNRESTRICTED = [0, 13, 15, 18, 22, 26, 32, 38, 46, 59, 76, 93, 119, 167, 279, 419]
NCS_RESTRICTED = [15, 18, 22, 26, 32, 38, 46, 55, 68, 82, 100, 128, 158, 202, 237]
NCS_F4 = [2, 4, 6, 8, 10, 12, 15]  # 36.211 Table 5.7.2-3 (preamble format 4)

# 36.211 Table 5.7.1-1, in 30.72 Msps samples: format -> (T_CP, n_repeats)
# of the base sequence (24576 samples at 1.25 kHz for 0-3; 4096 at 7.5 kHz
# for format 4).  prach.c:235-266 prach_Tcp / prach_Tseq.
FORMAT_CP = {0: 3168, 1: 21024, 2: 6240, 3: 21024, 4: 448}
FORMAT_REPS = {0: 1, 1: 1, 2: 2, 3: 2, 4: 1}


def nzc_for(fmt: int) -> int:
    return N_ZC_F4 if fmt == 4 else N_ZC


def _d_u(u: int, nzc: int = N_ZC) -> int:
    """Cyclic-shift distance due to Doppler: d_u = p or N_ZC - p where
    (p u) mod N_ZC = 1 (36.211 §5.7.2)."""
    p = pow(u, -1, nzc)
    return p if p < nzc // 2 else nzc - p


def _restricted_shifts(u: int, n_cs: int):
    """Valid cyclic shifts Cv of root u in restricted set type A."""
    du = _d_u(u)
    if n_cs <= du < N_ZC // 3:
        n_shift = du // n_cs
        d_start = 2 * du + n_shift * n_cs
        n_group = N_ZC // d_start
        n_shift_bar = max(0, (N_ZC - 2 * du - n_group * d_start) // n_cs)
    elif N_ZC // 3 <= du <= (N_ZC - n_cs) // 2:
        n_shift = (N_ZC - 2 * du) // n_cs
        d_start = N_ZC - 2 * du + n_shift * n_cs
        n_group = du // d_start
        n_shift_bar = min(max(0, (du - n_group * d_start) // n_cs), n_shift)
    else:
        return []
    total = n_shift * n_group + n_shift_bar
    return [d_start * (v // n_shift) + (v % n_shift) * n_cs
            for v in range(total)]


@functools.lru_cache(maxsize=None)
def _zc_freq(u: int, nzc: int = N_ZC) -> np.ndarray:
    n = np.arange(nzc)
    x = np.exp(-1j * np.pi * u * n * (n + 1) / nzc)
    return np.fft.fft(x).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def preamble_params(root_seq_idx: int, zczc: int, fmt: int = 0):
    """(roots list, n_cs, shifts per root) for 64 preambles."""
    nzc = nzc_for(fmt)
    n_cs = (NCS_F4 if fmt == 4 else NCS_UNRESTRICTED)[zczc]
    n_shifts = nzc // n_cs if n_cs > 0 else 1
    n_roots = -(-64 // n_shifts)
    tbl = ZC_ROOTS_F4 if fmt == 4 else ZC_ROOTS
    roots = [int(tbl[(root_seq_idx + i) % len(tbl)]) for i in range(n_roots)]
    return roots, n_cs, n_shifts


@functools.lru_cache(maxsize=None)
def shift_list(root_seq_idx: int, zczc: int, hs: bool = False, fmt: int = 0):
    """The 64 (root u, cyclic shift Cv) preamble assignments + n_cs.
    hs=True uses restricted set type A (variable shifts per root; formats
    0-3 only — 36.211 defines no restricted set for format 4)."""
    if not hs or fmt == 4:
        roots, n_cs, n_shifts = preamble_params(root_seq_idx, zczc, fmt)
        out = [(roots[i // n_shifts], (i % n_shifts) * n_cs) for i in range(64)]
        return out, n_cs
    n_cs = NCS_RESTRICTED[zczc]
    out = []
    i = 0
    while len(out) < 64:
        u = int(ZC_ROOTS[(root_seq_idx + i) % 838])
        for cv in _restricted_shifts(u, n_cs):
            out.append((u, cv))
            if len(out) == 64:
                break
        i += 1
    return out, n_cs


@functools.lru_cache(maxsize=None)
def preamble_freq_table(root_seq_idx: int, zczc: int, hs: bool = False,
                        fmt: int = 0) -> np.ndarray:
    """(64, N_ZC) complex64 frequency-domain preambles."""
    pairs, n_cs = shift_list(root_seq_idx, zczc, hs, fmt)
    nzc = nzc_for(fmt)
    out = np.zeros((64, nzc), dtype=np.complex64)
    k = np.arange(nzc)
    for i, (u, cv) in enumerate(pairs):
        # time shift x((n + Cv) mod Nzc) <-> freq X[k] * e^{+j 2 pi k Cv / Nzc}
        out[i] = _zc_freq(u, nzc) * np.exp(1j * 2 * np.pi * k * cv / nzc)
    return out


def gen(preamble_idx, root_seq_idx: int = 0, zczc: int = 1,
        hs: bool = False, fmt: int = 0) -> jnp.ndarray:
    """(B,) preamble indices -> (B, N_ZC, 2) frequency-domain preambles."""
    tbl = preamble_freq_table(root_seq_idx, zczc, hs, fmt)
    tbl_cf = np.stack([tbl.real, tbl.imag], -1).astype(np.float32)
    return jnp.take(jnp.asarray(tbl_cf), jnp.asarray(preamble_idx), axis=0)


def detect(rx_freq, root_seq_idx: int = 0, zczc: int = 1, threshold: float = 8.0,
           hs: bool = False, fmt: int = 0):
    """eNB detection: rx_freq (B, N_ZC, 2) -> per-preamble metrics.

    Returns (detected (B, 64) bool, metric (B, 64), t_offset (B, 64) int32
    in ZC samples)."""
    pairs, n_cs = shift_list(root_seq_idx, zczc, hs, fmt)
    nzc = nzc_for(fmt)
    B = rx_freq.shape[0]
    # correlate with each root: IDFT(X_rx * conj(X_u)) — one matmul per root
    idft_re = np.cos(2 * np.pi * np.outer(np.arange(nzc), np.arange(nzc)) / nzc).astype(np.float32) / nzc
    idft_im = np.sin(2 * np.pi * np.outer(np.arange(nzc), np.arange(nzc)) / nzc).astype(np.float32) / nzc
    det, metric, toff = [], [], []
    corr_by_root = {}
    for u, cv in pairs:
        if u not in corr_by_root:
            xu = _zc_freq(u, nzc)
            xu_cf = jnp.asarray(np.stack([xu.real, xu.imag], -1).astype(np.float32))
            prod = cplx.mul_conj(rx_freq, xu_cf)  # (B, N_ZC, 2)
            pr, pi = prod[..., 0], prod[..., 1]
            cr = pr @ idft_re - pi @ idft_im
            ci = pr @ idft_im + pi @ idft_re
            corr = cr * cr + ci * ci  # (B, N_ZC) |corr(t)|^2
            corr_by_root[u] = (corr, jnp.mean(corr, axis=-1) + 1e-20)
        corr, mean_c = corr_by_root[u]
        # shift Cv appears at correlation lag (N_ZC - Cv + delay) mod N_ZC;
        # its zero-correlation window is [N-Cv, N-Cv+Ncs)
        if n_cs > 0:
            widx = (nzc - cv + np.arange(n_cs)) % nzc
            win = jnp.take(corr, jnp.asarray(widx.astype(np.int32)), axis=-1)
        else:
            win = corr
        peak = jnp.max(win, axis=-1)
        pos = jnp.argmax(win, axis=-1)
        m = peak / mean_c
        det.append(m > threshold)
        metric.append(m)
        toff.append(pos.astype(jnp.int32))
    return (
        jnp.stack(det, axis=1),
        jnp.stack(metric, axis=1),
        jnp.stack(toff, axis=1),
    )


# ---------------- waveform embedding (formats 0-4) ----------------
# Formats 0-3 (1.25 kHz numerology): base sequence T_SEQ = 800 us -> 24576
# samples at 30.72 Msps, repeated once (formats 0/1) or twice (2/3), with
# per-format CP lengths (36.211 Table 5.7.1-1; prach.c:235-266).  Format 4
# (7.5 kHz, TDD UpPTS): 139-length ZC over 4096 samples, 448-sample CP.
# The synthesis IDFT over the sparse bins factors as a two-stage
# Cooley-Tukey split n = B a + b: a small per-k twiddle stage then one
# (nzc -> A) matmul — avoiding a 24576x839 constant.

N_SEQ = 24576
N_SEQ_F4 = 4096
N_CP_F0 = 3168
_CT_B = 24
_CT_A = N_SEQ // _CT_B  # 1024


def _ct_split(fmt: int, srate_div: int = 1):
    """(n_seq, ct_b, ct_a) of one base-sequence repetition.

    srate_div scales the synthesis to the cell sample rate (prach.c sizes
    its IFFT as N_ifft_prach = 24576 * srate / 30.72 Msps): 16 for a
    1.92 Msps 6-PRB cell, 2 for 10 MHz, 1 for 20 MHz."""
    if fmt == 4:
        return N_SEQ_F4 // srate_div, 16, N_SEQ_F4 // srate_div // 16
    return N_SEQ // srate_div, _CT_B, _CT_A // srate_div


@functools.lru_cache(maxsize=None)
def _ct_tables(k0: int, fmt: int = 0, srate_div: int = 1):
    """Constants for the two-stage synthesis at bin offset k0."""
    n_seq, ct_b, ct_a = _ct_split(fmt, srate_div)
    k = np.arange(nzc_for(fmt)) + k0
    b = np.arange(ct_b)
    a = np.arange(ct_a)
    tw = np.exp(2j * np.pi * np.outer(k, b) / n_seq)  # (nzc, ct_b)
    e = np.exp(2j * np.pi * np.outer(k, a * ct_b) / n_seq)  # (nzc, ct_a)
    return (tw.astype(np.complex64), e.astype(np.complex64))


def waveform_len(fmt: int = 0, srate_div: int = 1) -> int:
    """CP + repeated sequence, in (30.72 / srate_div) Msps samples."""
    n_seq, _, _ = _ct_split(fmt, srate_div)
    return FORMAT_CP[fmt] // srate_div + FORMAT_REPS[fmt] * n_seq


def gen_waveform(preamble_idx, root_seq_idx: int = 0, zczc: int = 1,
                 hs: bool = False, k0: int = 12 * 12 + 7,
                 fmt: int = 0, srate_div: int = 1) -> jnp.ndarray:
    """(B,) preamble indices -> (B, waveform_len(fmt), 2) time samples at
    30.72 Msps (prach.c srslte_prach_gen waveform path, formats 0-4).

    k0: first occupied PRACH bin (1.25 kHz spacing for formats 0-3, 7.5 kHz
    for format 4; default centers the 6-PRB region near
    prach_freq_offset=12 PRB)."""
    x = gen(preamble_idx, root_seq_idx, zczc, hs, fmt)  # (B, nzc, 2) freq
    n_seq, ct_b, ct_a = _ct_split(fmt, srate_div)
    tw, e = _ct_tables(k0, fmt, srate_div)
    twc = cplx.from_numpy(tw)  # (nzc, ct_b, 2)
    ec = cplx.from_numpy(e)  # (nzc, ct_a, 2)
    # stage 1: Y[k, b] = X[k] * tw[k, b]
    y = cplx.mul(x[:, :, None, :], jnp.asarray(twc)[None])  # (B, nzc, ct_b, 2)
    # stage 2: x[a, b] = sum_k Y[k, b] E[k, a]
    yr, yi = y[..., 0], y[..., 1]
    er, ei = jnp.asarray(ec)[..., 0], jnp.asarray(ec)[..., 1]
    xr = jnp.einsum("bkc,ka->bac", yr, er) - jnp.einsum("bkc,ka->bac", yi, ei)
    xi = jnp.einsum("bkc,ka->bac", yr, ei) + jnp.einsum("bkc,ka->bac", yi, er)
    t = jnp.stack([xr, xi], axis=-1).reshape(
        x.shape[0], n_seq, 2) / np.sqrt(nzc_for(fmt))
    reps = FORMAT_REPS[fmt]
    if reps > 1:
        t = jnp.concatenate([t] * reps, axis=-2)
    n_cp = FORMAT_CP[fmt] // srate_div
    cp = t[:, t.shape[-2] - n_cp :, :]
    return jnp.concatenate([cp, t], axis=-2)


def rx_waveform_to_freq(samples, k0: int = 12 * 12 + 7,
                        fmt: int = 0, srate_div: int = 1) -> jnp.ndarray:
    """eNB side: (B, >= waveform_len(fmt), 2) -> (B, nzc, 2) PRACH bins.

    The analysis DFT over the same sparse bins, two-stage transposed;
    formats 2/3 average their two sequence repetitions coherently (the
    reference accumulates repetitions the same way, prach.c detection)."""
    n_seq, ct_b, ct_a = _ct_split(fmt, srate_div)
    n_cp, reps = FORMAT_CP[fmt] // srate_div, FORMAT_REPS[fmt]
    t = samples[:, n_cp : n_cp + reps * n_seq, :]
    B = t.shape[0]
    y = t.reshape(B, reps, ct_a, ct_b, 2).mean(axis=1)
    tw, e = _ct_tables(k0, fmt, srate_div)
    ec = cplx.from_numpy(np.conj(e))
    twc = cplx.from_numpy(np.conj(tw))
    yr, yi = y[..., 0], y[..., 1]
    er, ei = jnp.asarray(ec)[..., 0], jnp.asarray(ec)[..., 1]
    # stage 1 (transpose of synthesis stage 2): Z[k, b] = sum_a y[a, b] E*[k, a]
    zr = jnp.einsum("bac,ka->bkc", yr, er) - jnp.einsum("bac,ka->bkc", yi, ei)
    zi = jnp.einsum("bac,ka->bkc", yr, ei) + jnp.einsum("bac,ka->bkc", yi, er)
    z = jnp.stack([zr, zi], axis=-1)  # (B, nzc, ct_b, 2)
    # stage 2: X[k] = sum_b Z[k, b] tw*[k, b]
    out = jnp.sum(cplx.mul(z, jnp.asarray(twc)[None]), axis=-2)
    return out / np.sqrt(nzc_for(fmt)) / ct_b
