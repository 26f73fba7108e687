"""NB-IoT downlink channels: NRS, NPBCH (MIB-NB) and NPDSCH.

Reference behavior: srsLTE's NB-IoT additions (CHANGELOG 19.09: NPSS/NSSS,
NPBCH, NPDSCH in `lib/src/phy/phch/npbch.c` / `npdsch.c` era code paths and
`ch_estimation/chest_dl_nbiot.c`) — single-PRB (12-subcarrier) downlink,
tail-biting-convolutionally coded (no turbo in NB-IoT DL), QPSK only, with
narrowband reference signals (NRS) on the last two symbols of each slot.

Design: one anchor-PRB subframe is a (14, 12) grid slice; NPBCH's 64
radio frames batch naturally along the leading axis, and the TBCC decode
reuses the batched Viterbi (ops/fec/viterbi.py).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..ops import cplx, modem, scrambling, sequence
from ..ops.fec import convcoder, crc as crc_mod, viterbi
from . import chest, grid as grid_mod

NRE = 12
N_SYM = 14
# NRS: port-0 positions — symbols 5, 6 of each slot (l = 5, 6, 12, 13),
# 2 pilots per symbol at spacing 6
NRS_SYMS = (5, 6, 12, 13)


@functools.lru_cache(maxsize=None)
def nrs_k(n_id_ncell: int) -> np.ndarray:
    """(4, 2) NRS subcarriers: v = {0, 3} alternating + cell shift."""
    vshift = n_id_ncell % 6
    out = np.zeros((len(NRS_SYMS), 2), dtype=np.int32)
    for i in range(len(NRS_SYMS)):
        v = 0 if i % 2 == 0 else 3
        out[i] = (v + vshift) % 6 + 6 * np.arange(2)
    return out


@functools.lru_cache(maxsize=None)
def nrs_values(n_id_ncell: int, sf_idx: int) -> np.ndarray:
    """(4, 2) complex NRS values (gold sequence, CRS-style c_init with the
    narrowband cell id)."""
    out = np.zeros((len(NRS_SYMS), 2), dtype=np.complex64)
    for i, sym in enumerate(NRS_SYMS):
        ns = 2 * sf_idx + sym // 7
        l = sym % 7
        c_init = (1024 * (7 * (ns + 1) + l + 1) * (2 * n_id_ncell + 1)
                  + 2 * n_id_ncell + 1)
        c = sequence.gold_sequence_host(c_init, 4 * grid_mod.MAX_PRB)
        m = np.arange(2) + grid_mod.MAX_PRB - 1
        out[i] = ((1 - 2 * c[2 * m]) + 1j * (1 - 2 * c[2 * m + 1])) / np.sqrt(2)
    return out


@functools.lru_cache(maxsize=None)
def _re_indices(n_id_ncell: int, sf_idx: int, l_start: int,
                skip_sync: bool = False) -> np.ndarray:
    """Data RE indices (sym*12 + k) of one anchor-PRB subframe, skipping NRS
    (and optionally legacy-CRS positions: NB-IoT in-band leaves l_start
    control symbols empty instead — covered by l_start)."""
    res = np.zeros((N_SYM, NRE), dtype=bool)
    res[:l_start] = True
    ks = nrs_k(n_id_ncell)
    for i, sym in enumerate(NRS_SYMS):
        res[sym, ks[i]] = True
    idx = []
    for sym in range(l_start, N_SYM):
        idx.append(sym * NRE + np.flatnonzero(~res[sym]))
    return np.concatenate(idx).astype(np.int32)


def put_nrs(grid, n_id_ncell: int, sf_idx: int):
    """grid (B, 14, 12, 2) with NRS placed."""
    ks = nrs_k(n_id_ncell)
    vals = nrs_values(n_id_ncell, sf_idx)
    flat = grid.reshape(grid.shape[0], N_SYM * NRE, 2)
    idx = (np.asarray(NRS_SYMS)[:, None] * NRE + ks).reshape(-1)
    v = cplx.from_numpy(vals.reshape(-1))
    flat = flat.at[:, jnp.asarray(idx.astype(np.int32)), :].set(
        jnp.broadcast_to(v, (grid.shape[0],) + v.shape))
    return flat.reshape(grid.shape)


def _chest_nrs(rx, n_id_ncell: int, sf_idx: int):
    """LS at NRS, averaged over the subframe (the channel is static within
    1 ms at NB-IoT speeds — chest_dl_nbiot averages likewise), then a single
    frequency interpolation from all 4 distinct pilot subcarriers."""
    B = rx.shape[0]
    ks = nrs_k(n_id_ncell)
    vals = nrs_values(n_id_ncell, sf_idx)
    flat = rx.reshape(B, N_SYM * NRE, 2)
    by_k = {}
    for i, sym in enumerate(NRS_SYMS):
        idx = (sym * NRE + ks[i]).astype(np.int32)
        y = jnp.take(flat, jnp.asarray(idx), axis=-2)
        r = cplx.from_numpy(vals[i])
        h_ls = cplx.mul_conj(y, jnp.asarray(r))  # (B, 2, 2)
        for j, k in enumerate(ks[i].tolist()):
            by_k.setdefault(k, []).append(h_ls[:, j])
    pk = sorted(by_k)
    h_p = jnp.stack([sum(by_k[k]) / len(by_k[k]) for k in pk], axis=-2)
    fm = jnp.asarray(chest.interp_matrix(tuple(pk), NRE))
    h_k = jnp.einsum("kp,...pc->...kc", fm, h_p)  # (B, NRE, 2)
    return jnp.broadcast_to(h_k[:, None], (B, N_SYM, NRE, 2))


# ---------------- NPBCH (36.211 §10.2.4, 36.212 §5.3.1.1) ----------------

MIB_NB_BITS = 34


def _tbcc_encode_block(bits, e: int):
    """CRC16 + tail-biting convolutional code + rate matching to e bits."""
    with_crc = crc_mod.crc_attach(bits, crc_mod.LTE_CRC16)
    d = convcoder.conv_encode(with_crc)  # (B, 3, K)
    return convcoder.rate_match_cc(d, e)


def npbch_encode(mib_bits, n_id_ncell: int) -> jnp.ndarray:
    """(B, 34) MIB-NB -> (B, 8, 14, 12, 2) — the 8 self-decodable blocks of
    the 640 ms NPBCH TTI (each block repeats over 8 frames on sf 0)."""
    e_idx = _re_indices(n_id_ncell, 0, 3)  # NPBCH starts at symbol 3
    e = len(e_idx) * 2
    cw = _tbcc_encode_block(mib_bits, 8 * e)  # (B, 8e) whole-TTI codeword
    B = cw.shape[0]
    grids = []
    for blk in range(8):
        seg = cw[:, blk * e : (blk + 1) * e]
        c_init = n_id_ncell + 1
        scr = scrambling.scramble_bits(seg, c_init)
        syms = modem.modulate(scr, modem.QPSK)
        g = cplx.zeros((B, N_SYM, NRE))
        flat = g.reshape(B, N_SYM * NRE, 2)
        flat = flat.at[:, jnp.asarray(e_idx), :].set(syms)
        g = flat.reshape(B, N_SYM, NRE, 2)
        grids.append(put_nrs(g, n_id_ncell, 0))
    return jnp.stack(grids, axis=1)


def npbch_decode(rx_blocks, n_id_ncell: int):
    """(B, 8, 14, 12, 2) -> (mib (B, 34), crc_ok (B,))."""
    B = rx_blocks.shape[0]
    e_idx = _re_indices(n_id_ncell, 0, 3)
    e = len(e_idx) * 2
    llrs = []
    for blk in range(8):
        rx = rx_blocks[:, blk]
        ce = _chest_nrs(rx, n_id_ncell, 0)
        flat = rx.reshape(B, N_SYM * NRE, 2)
        cef = ce.reshape(B, N_SYM * NRE, 2)
        y = jnp.take(flat, jnp.asarray(e_idx), axis=-2)
        h = jnp.take(cef, jnp.asarray(e_idx), axis=-2)
        x, _ = chest.equalize_zf(y, h)
        llr = modem.demod_soft(x, modem.QPSK)
        llrs.append(scrambling.scramble_llrs(llr, n_id_ncell + 1))
    cw_llr = jnp.concatenate(llrs, axis=1)  # (B, 8e)
    d_llr = convcoder.rate_unmatch_cc(cw_llr, MIB_NB_BITS + 16)
    bits = viterbi.viterbi_decode(d_llr)
    ok = crc_mod.crc_ok(bits, crc_mod.LTE_CRC16)
    return bits[:, :MIB_NB_BITS], ok


# ---------------- NPDSCH (36.211 §10.2.3) ----------------

def npdsch_encode(tb_bits, n_sf: int, n_id_ncell: int, rnti: int,
                  sf_indices: tuple = None, l_start: int = 0) -> jnp.ndarray:
    """(B, tbs) -> (B, n_sf, 14, 12, 2): TBCC-coded QPSK over n_sf anchor
    subframes (no turbo in NB-IoT DL)."""
    if sf_indices is None:
        sf_indices = tuple(4 + i for i in range(n_sf))
    e_per_sf = [len(_re_indices(n_id_ncell, s, l_start)) * 2 for s in sf_indices]
    e = sum(e_per_sf)
    cw = _tbcc_encode_block(tb_bits, e)
    B = cw.shape[0]
    grids = []
    off = 0
    for i, s in enumerate(sf_indices):
        seg = cw[:, off : off + e_per_sf[i]]
        off += e_per_sf[i]
        c_init = (rnti << 15) + (s << 9) + n_id_ncell
        scr = scrambling.scramble_bits(seg, c_init)
        syms = modem.modulate(scr, modem.QPSK)
        g = cplx.zeros((B, N_SYM, NRE))
        flat = g.reshape(B, N_SYM * NRE, 2)
        flat = flat.at[:, jnp.asarray(_re_indices(n_id_ncell, s, l_start)), :].set(syms)
        g = flat.reshape(B, N_SYM, NRE, 2)
        grids.append(put_nrs(g, n_id_ncell, s))
    return jnp.stack(grids, axis=1)


def npdsch_decode(rx_sfs, tbs: int, n_id_ncell: int, rnti: int,
                  sf_indices: tuple = None, l_start: int = 0):
    """(B, n_sf, 14, 12, 2) -> (bits (B, tbs), ok (B,))."""
    B, n_sf = rx_sfs.shape[:2]
    if sf_indices is None:
        sf_indices = tuple(4 + i for i in range(n_sf))
    llrs = []
    for i, s in enumerate(sf_indices):
        rx = rx_sfs[:, i]
        ce = _chest_nrs(rx, n_id_ncell, s)
        e_idx = _re_indices(n_id_ncell, s, l_start)
        flat = rx.reshape(B, N_SYM * NRE, 2)
        cef = ce.reshape(B, N_SYM * NRE, 2)
        y = jnp.take(flat, jnp.asarray(e_idx), axis=-2)
        h = jnp.take(cef, jnp.asarray(e_idx), axis=-2)
        x, _ = chest.equalize_zf(y, h)
        llr = modem.demod_soft(x, modem.QPSK)
        c_init = (rnti << 15) + (s << 9) + n_id_ncell
        llrs.append(scrambling.scramble_llrs(llr, c_init))
    cw_llr = jnp.concatenate(llrs, axis=1)
    d_llr = convcoder.rate_unmatch_cc(cw_llr, tbs + 16)
    bits = viterbi.viterbi_decode(d_llr)
    ok = crc_mod.crc_ok(bits, crc_mod.LTE_CRC16)
    return bits[:, :tbs], ok
