"""Downlink channel estimation: LS at CRS + freq/time linear interpolation.

Reference behavior: `lib/src/phy/ch_estimation/chest_dl.c` — LS estimates at
pilot REs, `interp_linear` in frequency and `interp_linear_vector` in time
(chest_dl.c:125-141), optional smoothing, noise/RSRP/RSRQ/SNR measurements
(chest_dl.h:49-74).

Design: interpolation is expressed as two constant matrices (host-built
per static layout) applied with einsum — (pilots -> NRE) in frequency and
(pilot syms -> 14) in time — so the whole estimator is a couple of small
matmuls over the batch.  Noise is estimated from the residual between raw LS
pilots and the smoothed estimate re-sampled at pilot positions (the
REFS method of chest_dl.h:70-74).
"""

from __future__ import annotations

import functools
import typing

import jax.numpy as jnp
import numpy as np

from ..ops import cplx
from . import grid as grid_mod


@functools.lru_cache(maxsize=None)
def _freq_interp_matrix(n_prb: int, fidx0: int) -> np.ndarray:
    """(NRE, 2*n_prb) linear interp/extrapolation from pilots at
    k = fidx0 + 6m to all NRE subcarriers."""
    nre = 12 * n_prb
    npil = 2 * n_prb
    pk = fidx0 + 6 * np.arange(npil)
    m = np.zeros((nre, npil), dtype=np.float32)
    for k in range(nre):
        # surrounding pilots (linear, with edge extrapolation)
        j = np.clip((k - fidx0) / 6.0, 0, npil - 1)
        j0 = int(np.clip(np.floor(j), 0, npil - 2))
        t = (k - pk[j0]) / 6.0
        m[k, j0] = 1 - t
        m[k, j0 + 1] = t
    return m


@functools.lru_cache(maxsize=None)
def _time_interp_matrix(syms: tuple, n_sym: int = grid_mod.N_SYM) -> np.ndarray:
    """(n_sym, len(syms)) linear interp/extrapolation across OFDM symbols."""
    s = np.asarray(syms, dtype=np.float64)
    m = np.zeros((n_sym, len(s)), dtype=np.float32)
    for l in range(n_sym):
        if l <= s[0]:
            j0 = 0
        elif l >= s[-1]:
            j0 = len(s) - 2
        else:
            j0 = int(np.searchsorted(s, l, side="right")) - 1
            j0 = min(j0, len(s) - 2)
        t = (l - s[j0]) / (s[j0 + 1] - s[j0])
        m[l, j0] = 1 - t
        m[l, j0 + 1] = t
    return m


class ChestResult(typing.NamedTuple):
    ce: jnp.ndarray  # (..., 14, NRE, 2) channel estimate
    noise_est: jnp.ndarray  # (...,) noise variance estimate
    rsrp: jnp.ndarray  # (...,) reference signal received power
    snr_db: jnp.ndarray  # (...,)
    rssi: jnp.ndarray = None  # (...,) mean RE power over the grid
    rsrq_db: jnp.ndarray = None  # (...,) N_PRB * RSRP / RSSI
    sync_err: jnp.ndarray = None  # (...,) timing offset estimate (samples)


@functools.lru_cache(maxsize=None)
def _crs_values10(cell_id: int, n_prb: int, port: int, cp: str) -> np.ndarray:
    """(10, S, P) CRS values for every subframe — the gather table that
    lets sf_idx be a TRACED argument (one compiled estimator serves all
    subframes; pilot POSITIONS don't depend on sf)."""
    return np.stack([grid_mod.crs_values(cell_id, s, n_prb, port, cp)
                     for s in range(10)])


def estimate(rx_grid, cell: grid_mod.CellConfig, sf_idx, port: int = 0) -> ChestResult:
    """LS + 2D linear interpolation channel estimate from port-`port` CRS.

    rx_grid: (..., 14, NRE, 2) received grid.  sf_idx may be TRACED: the
    per-sf CRS values are then gathered from a (10, ...) constant table.
    """
    ks = grid_mod.crs_k(cell.cell_id, cell.n_prb, port, cell.cp)  # (S, 2*n_prb)
    syms = grid_mod.pilot_syms(port, cell.cp)
    # gather pilots: rx at (sym, k)
    flat = rx_grid.reshape(rx_grid.shape[:-3] + (cell.n_sym * cell.nre, 2))
    pidx = (np.asarray(syms)[:, None] * cell.nre + ks).astype(np.int32)  # (S, P)
    y_p = jnp.take(flat, jnp.asarray(pidx.reshape(-1)), axis=-2)
    y_p = y_p.reshape(rx_grid.shape[:-3] + pidx.shape + (2,))  # (..., S, P, 2)
    if isinstance(sf_idx, (int, np.integer)):
        vals = grid_mod.crs_values(cell.cell_id, int(sf_idx), cell.n_prb,
                                   port, cell.cp)
        r_p = jnp.asarray(cplx.from_numpy(vals))  # (S, P, 2)
    else:
        v10 = _crs_values10(cell.cell_id, cell.n_prb, port, cell.cp)
        r_p = jnp.take(jnp.asarray(cplx.from_numpy(v10)), sf_idx, axis=0)
    h_ls = cplx.mul_conj(y_p, r_p)  # |r|^2 = 1

    # frequency interpolation per pilot symbol (offsets differ by symbol)
    h_f = []
    for i in range(len(syms)):
        fm = _freq_interp_matrix(cell.n_prb, int(ks[i][0]))
        h_f.append(jnp.einsum("kp,...pc->...kc", jnp.asarray(fm), h_ls[..., i, :, :]))
    h_f = jnp.stack(h_f, axis=-3)  # (..., S, NRE, 2)
    # time interpolation
    tm = _time_interp_matrix(tuple(syms), cell.n_sym)
    ce = jnp.einsum("ls,...skc->...lkc", jnp.asarray(tm), h_f)

    # noise: residual between raw LS pilots and interpolated estimate at pilots
    ce_flat = ce.reshape(ce.shape[:-3] + (cell.n_sym * cell.nre, 2))
    h_at_p = jnp.take(ce_flat, jnp.asarray(pidx.reshape(-1)), axis=-2).reshape(y_p.shape)
    # 3-tap freq smoothing of LS for the reference point
    h_sm = (h_ls + jnp.roll(h_ls, 1, axis=-2) + jnp.roll(h_ls, -1, axis=-2)) / 3.0
    resid = cplx.abs2(h_ls - h_sm)
    noise = jnp.mean(resid.reshape(resid.shape[:-2] + (-1,)), axis=-1) * 1.5
    # 1.5 compensates the variance reduction of the 3-tap average (2/3 factor)
    rsrp = jnp.mean(cplx.abs2(h_at_p).reshape(resid.shape[:-2] + (-1,)), axis=-1)
    snr = rsrp / jnp.maximum(noise, 1e-12)
    # RSSI / RSRQ (36.214 wideband definitions; chest_dl.h:49-68 outputs)
    p_grid = cplx.abs2(rx_grid)  # (..., 14, NRE)
    rssi = jnp.mean(p_grid.reshape(p_grid.shape[:-2] + (-1,)), axis=-1)
    rsrq = cell.n_prb * rsrp / jnp.maximum(rssi * cell.nre / 12.0, 1e-12)
    # timing offset from the mean per-subcarrier phase ramp of the LS pilots
    # (refsignal_dl_sync.c role): h[k+1] conj(h[k]) angle ~ -2 pi d / N_fft
    prod = cplx.mul_conj(h_ls[..., 1:, :], h_ls[..., :-1, :])
    acc = jnp.sum(prod.reshape(prod.shape[:-3] + (-1, 2)), axis=-2)
    ang = jnp.arctan2(acc[..., 1], acc[..., 0])
    n_fft = {6: 128, 15: 256, 25: 512, 50: 1024, 75: 1536, 100: 2048}[cell.n_prb]
    sync_err = -ang * n_fft / (2.0 * np.pi * 6.0)  # pilots are 6 sc apart
    return ChestResult(ce, noise, rsrp,
                       10.0 * jnp.log10(jnp.maximum(snr, 1e-12)),
                       rssi, 10.0 * jnp.log10(jnp.maximum(rsrq, 1e-12)),
                       sync_err)


def equalize_zf(rx, ce, eps: float = 1e-9):
    """ZF: x = y * conj(h) / |h|^2 ; also returns per-RE CSI weight |h|^2
    (for the csi-weighted LLR scaling of pdsch.c:574-686)."""
    csi = cplx.abs2(ce)
    x = cplx.mul_conj(rx, ce) / jnp.maximum(csi, eps)[..., None]
    return x, csi


def equalize_mmse(rx, ce, noise, eps: float = 1e-9):
    csi = cplx.abs2(ce)
    extra = csi.ndim - jnp.ndim(noise)
    noise_b = jnp.reshape(noise, jnp.shape(noise) + (1,) * extra)
    den = csi + noise_b + eps
    x = cplx.mul_conj(rx, ce) / den[..., None]
    return x, csi


@functools.lru_cache(maxsize=None)
def interp_matrix(pk: tuple, nre: int) -> np.ndarray:
    """(NRE, len(pk)) linear interp/extrapolation from pilots at arbitrary
    subcarriers pk (ascending) to all NRE subcarriers."""
    pk = np.asarray(pk, dtype=np.float64)
    m = np.zeros((nre, len(pk)), dtype=np.float32)
    for k in range(nre):
        if k <= pk[0]:
            j0 = 0
        elif k >= pk[-1]:
            j0 = len(pk) - 2
        else:
            j0 = min(int(np.searchsorted(pk, k, side="right")) - 1, len(pk) - 2)
        t = (k - pk[j0]) / (pk[j0 + 1] - pk[j0])
        m[k, j0] = 1 - t
        m[k, j0 + 1] = t
    return m
