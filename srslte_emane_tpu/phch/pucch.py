"""PUCCH: uplink control channel, formats 1/1a/1b (SR/ACK) and 2 (CQI).

Reference behavior: `lib/src/phy/phch/pucch.c` — cyclic-shifted base
sequences with per-symbol cell shifts n_cs_cell, orthogonal covers (format 1),
(20,A)-coded QPSK (format 2), DMRS per `refsignal_ul.c` pucch section,
edge-PRB mapping with slot hopping, eNB-side correlation detection.

Config defaults: deltaPUCCH-Shift=1, n_cs_1=0, n_rb_2=0 (the srsLTE defaults).
Design: detection for all (n_pucch, hypothesis) pairs batches as matmul
correlations against precomputed reference waveforms.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from ..ops import cplx, sequence
from . import grid as grid_mod, refsignal_ul, uci

# normal CP, format 1: per slot, data symbols and DMRS symbols
F1_DATA_SYMS = (0, 1, 5, 6)
F1_DMRS_SYMS = (2, 3, 4)
F2_DATA_SYMS = (0, 2, 3, 4, 6)
F2_DMRS_SYMS = (1, 5)
# orthogonal covers (36.211 Table 5.4.1-2), length 4 for data
W_F1_DATA = np.array([[1, 1, 1, 1], [1, -1, 1, -1], [1, -1, -1, 1]], dtype=np.float32)
# length-3 DFT covers for DMRS (Table 5.5.2.2.1-2)
W_F1_DMRS = np.stack([
    np.ones(3, np.complex64),
    np.exp(2j * np.pi / 3 * np.arange(3) * 1).astype(np.complex64),
    np.exp(2j * np.pi / 3 * np.arange(3) * 2).astype(np.complex64),
])


@functools.lru_cache(maxsize=None)
def n_cs_cell(cell_id: int) -> np.ndarray:
    """(20 slots, 7 symbols) cell cyclic shifts (36.211 §5.4)."""
    c = sequence.gold_sequence_host(cell_id, 8 * 7 * 20)
    out = np.zeros((20, 7), dtype=np.int64)
    for ns in range(20):
        for l in range(7):
            out[ns, l] = sum(int(c[8 * 7 * ns + 8 * l + i]) << i for i in range(8)) % 12
    return out


def _f1_resources(n_pucch: int):
    """(cyclic shift index per symbol base, orthogonal cover index).
    With delta_shift=1: n'(ns) = n_pucch % 36 within the resource's PRB
    (c=3 covers x 12 shifts per PRB; the PRB itself is n_pucch // 36,
    pucch_prb)."""
    r = n_pucch % 36
    return r % 12, r // 12


def pucch_prb(n_pucch: int, ns: int, n_prb_cell: int) -> int:
    """Edge PRB with slot hopping (36.211 §5.4.3): m=0 resources at the band
    edges, alternating per slot."""
    m = n_pucch // 36  # resources per PRB region (12 shifts x 3 covers)
    if (m + ns) % 2 == 0:
        return m // 2
    return n_prb_cell - 1 - m // 2


@functools.lru_cache(maxsize=None)
def _f1_waveform(cell_id: int, sf_idx: int, n_pucch: int):
    """Unit reference waveform per slot for format 1: (2 slots, 7 syms, 12)
    complex, to be scaled by d(0); plus DMRS mask (which syms are DMRS)."""
    ncs = n_cs_cell(cell_id)
    alpha_base, n_oc = _f1_resources(n_pucch)
    u_tab = refsignal_ul.f_gh_table(cell_id, False)
    out = np.zeros((2, 7, 12), dtype=np.complex64)
    for s, ns in enumerate((2 * sf_idx, 2 * sf_idx + 1)):
        u = (int(u_tab[ns]) + cell_id % 30) % 30
        base = refsignal_ul.base_sequence(u, 0, 12)
        for i, l in enumerate(F1_DATA_SYMS):
            alpha = 2 * np.pi * ((alpha_base + int(ncs[ns, l])) % 12) / 12
            out[s, l] = base * np.exp(1j * alpha * np.arange(12)) * W_F1_DATA[n_oc][i]
        for i, l in enumerate(F1_DMRS_SYMS):
            alpha = 2 * np.pi * ((alpha_base + int(ncs[ns, l])) % 12) / 12
            out[s, l] = base * np.exp(1j * alpha * np.arange(12)) * W_F1_DMRS[n_oc][i]
    return out


def encode_f1(d0, cell: grid_mod.CellConfig, sf_idx: int, n_pucch: int, grid):
    """Format 1/1a/1b: d0 (B, 2) cf symbol (1+0j for format 1/SR).
    Places PUCCH into the UL grid (B, 14, NRE, 2)."""
    wf = _f1_waveform(cell.cell_id, sf_idx, n_pucch)  # (2, 7, 12)
    B = grid.shape[0]
    wf_cf = cplx.from_numpy(wf)
    # DMRS symbols carry the bare waveform; data symbols carry d0 * waveform
    dmask = np.zeros((2, 7, 1), np.float32)
    for l in F1_DATA_SYMS:
        dmask[:, l] = 1.0
    dm = jnp.asarray(dmask)
    d = d0[:, None, None, None, :]  # (B,1,1,1,2)
    data_part = cplx.mul(jnp.broadcast_to(d, (B, 2, 7, 1, 2)), wf_cf[None])
    sig = jnp.where(dm[None, ..., None] > 0, data_part, wf_cf[None] + jnp.zeros((B, 2, 7, 12, 2)))
    flat = grid.reshape(B, -1, 2)
    for s in range(2):
        prb = pucch_prb(n_pucch, 2 * sf_idx + s, cell.n_prb)
        ks = 12 * prb + np.arange(12)
        for l in range(7):
            sym = 7 * s + l
            idx = (sym * cell.nre + ks).astype(np.int32)
            flat = flat.at[:, jnp.asarray(idx), :].set(sig[:, s, l])
    return flat.reshape(grid.shape)


def detect_f1(rx_grid, cell: grid_mod.CellConfig, sf_idx: int, n_pucch: int):
    """eNB format-1 detection: returns (corr (B, 2) cf — the matched-filter
    estimate of d0 per slot-combined, energy (B,)).

    Caller thresholds |corr| for SR and takes sign for 1a/1b bits."""
    wf = _f1_waveform(cell.cell_id, sf_idx, n_pucch)
    B = rx_grid.shape[0]
    flat = rx_grid.reshape(B, -1, 2)
    parts = []
    for s in range(2):
        prb = pucch_prb(n_pucch, 2 * sf_idx + s, cell.n_prb)
        ks = 12 * prb + np.arange(12)
        for l in F1_DATA_SYMS:
            sym = 7 * s + l
            idx = (sym * cell.nre + ks).astype(np.int32)
            y = jnp.take(flat, jnp.asarray(idx), axis=-2)  # (B, 12, 2)
            ref = cplx.from_numpy(wf[s, l])
            parts.append(jnp.sum(cplx.mul_conj(y, jnp.asarray(ref)), axis=-2))
    corr = sum(parts) / (12 * len(parts))
    energy = cplx.abs2(corr)
    return corr, energy


def encode_f2(cqi_bits, cell: grid_mod.CellConfig, sf_idx: int, n_pucch2: int, grid):
    """Format 2: (B, <=13) CQI bits -> (20, A) code -> QPSK -> 10 symbols."""
    from ..ops import modem

    coded = uci.encode_rm20(cqi_bits)  # (B, 20)
    d = modem.modulate(coded, modem.QPSK)  # (B, 10, 2)
    ncs = n_cs_cell(cell.cell_id)
    u_tab = refsignal_ul.f_gh_table(cell.cell_id, False)
    B = grid.shape[0]
    flat = grid.reshape(B, -1, 2)
    di = 0
    for s in range(2):
        ns = 2 * sf_idx + s
        u = (int(u_tab[ns]) + cell.cell_id % 30) % 30
        base = refsignal_ul.base_sequence(u, 0, 12)
        prb = pucch_prb(n_pucch2, ns, cell.n_prb)
        ks = 12 * prb + np.arange(12)
        for l in range(7):
            alpha = 2 * np.pi * ((n_pucch2 % 12 + int(ncs[ns, l])) % 12) / 12
            ref = base * np.exp(1j * alpha * np.arange(12))
            idx = ((7 * s + l) * cell.nre + ks).astype(np.int32)
            refc = cplx.from_numpy(ref)
            if l in F2_DATA_SYMS:
                val = cplx.mul(d[:, di : di + 1, :], jnp.asarray(refc)[None])
                di += 1
            else:
                val = jnp.broadcast_to(refc, (B, 12, 2))
            flat = flat.at[:, jnp.asarray(idx), :].set(val)
    return flat.reshape(grid.shape)


def decode_f2(rx_grid, cell: grid_mod.CellConfig, sf_idx: int, n_pucch2: int,
              n_bits: int):
    """eNB format-2 decode: DMRS channel estimate -> equalize -> RM20 ML."""
    from ..ops import modem

    ncs = n_cs_cell(cell.cell_id)
    u_tab = refsignal_ul.f_gh_table(cell.cell_id, False)
    B = rx_grid.shape[0]
    flat = rx_grid.reshape(B, -1, 2)
    llr_parts = []
    for s in range(2):
        ns = 2 * sf_idx + s
        u = (int(u_tab[ns]) + cell.cell_id % 30) % 30
        base = refsignal_ul.base_sequence(u, 0, 12)
        prb = pucch_prb(n_pucch2, ns, cell.n_prb)
        ks = 12 * prb + np.arange(12)
        # channel from DMRS symbols
        h_acc = []
        for l in F2_DMRS_SYMS:
            alpha = 2 * np.pi * ((n_pucch2 % 12 + int(ncs[ns, l])) % 12) / 12
            ref = cplx.from_numpy(base * np.exp(1j * alpha * np.arange(12)))
            idx = ((7 * s + l) * cell.nre + ks).astype(np.int32)
            y = jnp.take(flat, jnp.asarray(idx), axis=-2)
            h_acc.append(cplx.mul_conj(y, jnp.asarray(ref)))
        h = sum(h_acc) / len(h_acc)  # (B, 12, 2)
        for l in F2_DATA_SYMS:
            alpha = 2 * np.pi * ((n_pucch2 % 12 + int(ncs[ns, l])) % 12) / 12
            ref = cplx.from_numpy(base * np.exp(1j * alpha * np.arange(12)))
            idx = ((7 * s + l) * cell.nre + ks).astype(np.int32)
            y = jnp.take(flat, jnp.asarray(idx), axis=-2)
            z = cplx.mul_conj(y, jnp.asarray(ref))  # remove base+shift
            # combine across the 12 subcarriers with channel weights
            num = jnp.sum(cplx.mul_conj(z, h), axis=-2)
            llr_parts.append(num)
    d = jnp.stack(llr_parts, axis=1)  # (B, 10, 2) soft QPSK symbols
    llr = modem.demod_soft(d / (jnp.sqrt(cplx.abs2(d))[..., None] + 1e-9), modem.QPSK)
    bits, metric = uci.decode_rm(llr, n_bits, "rm20")
    return bits, metric


# ---------------- formats 2a/2b: CQI + 1-2 ACK bits (36.211 §5.4.2) --------

def _ack_symbol_2ab(ack_bits) -> jnp.ndarray:
    """(B, 1|2) ACK bits -> (B, 2) cf modulation symbol d(10).
    2a (1 bit): BPSK 0->+1, 1->-1.  2b (2 bits): Table 5.4.2-1."""
    ack_bits = jnp.asarray(ack_bits)
    if ack_bits.shape[-1] == 1:
        re = 1.0 - 2.0 * ack_bits[..., 0].astype(jnp.float32)
        return jnp.stack([re, jnp.zeros_like(re)], axis=-1)
    b0 = ack_bits[..., 0].astype(jnp.float32)
    b1 = ack_bits[..., 1].astype(jnp.float32)
    # (0,0)->1, (0,1)->-j, (1,0)->j, (1,1)->-1
    re = (1 - b0) * (1 - b1) - b0 * b1
    im = b0 * (1 - b1) - (1 - b0) * b1
    return jnp.stack([re, im], axis=-1)


def encode_f2ab(cqi_bits, ack_bits, cell: grid_mod.CellConfig, sf_idx: int,
                n_pucch2: int, grid):
    """Format 2a/2b: format-2 CQI with d(10) = ACK symbol modulating the
    SECOND DMRS symbol (l=5) of each slot (pucch.c format2a/2b path)."""
    grid = encode_f2(cqi_bits, cell, sf_idx, n_pucch2, grid)
    d10 = _ack_symbol_2ab(ack_bits)  # (B, 2)
    ncs = n_cs_cell(cell.cell_id)
    u_tab = refsignal_ul.f_gh_table(cell.cell_id, False)
    B = grid.shape[0]
    flat = grid.reshape(B, -1, 2)
    l = F2_DMRS_SYMS[1]  # the modulated DMRS symbol
    for s in range(2):
        ns = 2 * sf_idx + s
        u = (int(u_tab[ns]) + cell.cell_id % 30) % 30
        base = refsignal_ul.base_sequence(u, 0, 12)
        prb = pucch_prb(n_pucch2, ns, cell.n_prb)
        ks = 12 * prb + np.arange(12)
        alpha = 2 * np.pi * ((n_pucch2 % 12 + int(ncs[ns, l])) % 12) / 12
        ref = cplx.from_numpy(base * np.exp(1j * alpha * np.arange(12)))
        idx = ((7 * s + l) * cell.nre + ks).astype(np.int32)
        val = cplx.mul(d10[:, None, :], jnp.asarray(ref)[None])
        flat = flat.at[:, jnp.asarray(idx), :].set(val)
    return flat.reshape(grid.shape)


def decode_f2ab(rx_grid, cell: grid_mod.CellConfig, sf_idx: int,
                n_pucch2: int, n_cqi_bits: int, n_ack_bits: int):
    """Format 2a/2b decode: CQI via the format-2 path with the channel taken
    from the FIRST DMRS only; ACK by correlating the second DMRS against it."""
    from ..ops import modem

    ncs = n_cs_cell(cell.cell_id)
    u_tab = refsignal_ul.f_gh_table(cell.cell_id, False)
    B = rx_grid.shape[0]
    flat = rx_grid.reshape(B, -1, 2)
    llr_parts, ack_corr = [], []
    for s in range(2):
        ns = 2 * sf_idx + s
        u = (int(u_tab[ns]) + cell.cell_id % 30) % 30
        base = refsignal_ul.base_sequence(u, 0, 12)
        prb = pucch_prb(n_pucch2, ns, cell.n_prb)
        ks = 12 * prb + np.arange(12)

        def grab(l):
            alpha = 2 * np.pi * ((n_pucch2 % 12 + int(ncs[ns, l])) % 12) / 12
            ref = cplx.from_numpy(base * np.exp(1j * alpha * np.arange(12)))
            idx = ((7 * s + l) * cell.nre + ks).astype(np.int32)
            y = jnp.take(flat, jnp.asarray(idx), axis=-2)
            return cplx.mul_conj(y, jnp.asarray(ref))  # (B, 12, 2)

        h = grab(F2_DMRS_SYMS[0])  # unmodulated DMRS
        z10 = grab(F2_DMRS_SYMS[1])  # carries d(10) * h
        ack_corr.append(jnp.sum(cplx.mul_conj(z10, h), axis=-2))  # ~ d(10)
        for l in F2_DATA_SYMS:
            z = grab(l)
            llr_parts.append(jnp.sum(cplx.mul_conj(z, h), axis=-2))
    d = jnp.stack(llr_parts, axis=1)  # (B, 10, 2)
    llr = modem.demod_soft(d / (jnp.sqrt(cplx.abs2(d))[..., None] + 1e-9), modem.QPSK)
    cqi_bits, metric = uci.decode_rm(llr, n_cqi_bits, "rm20")
    d10 = sum(ack_corr)
    if n_ack_bits == 1:
        ack = (d10[..., 0] < 0).astype(jnp.int8)[:, None]
    else:
        # invert Table 5.4.2-1: sign(re)/sign(im) quadrants
        re, im = d10[..., 0], d10[..., 1]
        b0 = (im > jnp.abs(re)) | (re < -jnp.abs(im))  # j or -1 side
        b1 = (im < -jnp.abs(re)) | (re < -jnp.abs(im))
        ack = jnp.stack([b0, b1], axis=-1).astype(jnp.int8)
    return cqi_bits, ack, metric


# ---------------- format 3: multi-bit ACK (Rel-10, 36.211 §5.4.2A) ---------

F3_DATA_SYMS = (0, 2, 3, 4, 6)
F3_DMRS_SYMS = (1, 5)
# length-5 DFT orthogonal covers (36.211 Table 5.4.2A-1)
W_F3 = np.exp(-2j * np.pi / 5 *
              np.outer(np.arange(5), np.arange(5))).astype(np.complex64)


def encode_f3_bits(ack_bits) -> jnp.ndarray:
    """(B, O<=11) -> (B, 48) coded bits: RM(32,O) + circular repetition
    (36.212 §5.2.3.1 for O <= 11)."""
    c32 = uci.encode_rm(ack_bits, 32)
    return jnp.concatenate([c32, c32[:, :16]], axis=1)


def encode_f3(ack_bits, cell: grid_mod.CellConfig, sf_idx: int,
              n_pucch3: int, grid):
    """Format 3: 48 coded bits -> 24 QPSK -> 12 per slot, block-spread with a
    length-5 OCC over the data symbols; DMRS on l=1,5 per slot."""
    from ..ops import modem

    coded = encode_f3_bits(ack_bits)
    d = modem.modulate(coded, modem.QPSK)  # (B, 24, 2)
    n_oc = n_pucch3 % 5
    prb_m = n_pucch3 // 5
    ncs = n_cs_cell(cell.cell_id)
    u_tab = refsignal_ul.f_gh_table(cell.cell_id, False)
    B = grid.shape[0]
    flat = grid.reshape(B, -1, 2)
    for s in range(2):
        ns = 2 * sf_idx + s
        u = (int(u_tab[ns]) + cell.cell_id % 30) % 30
        base = refsignal_ul.base_sequence(u, 0, 12)
        prb = prb_m // 2 if (prb_m + ns) % 2 == 0 else cell.n_prb - 1 - prb_m // 2
        ks = 12 * prb + np.arange(12)
        y = d[:, 12 * s : 12 * (s + 1), :]  # (B, 12, 2) this slot's block
        for i, l in enumerate(F3_DATA_SYMS):
            w = W_F3[n_oc, i]
            wc = jnp.asarray([w.real, w.imag], dtype=jnp.float32)
            val = cplx.mul(y, jnp.broadcast_to(wc, y.shape))
            idx = ((7 * s + l) * cell.nre + ks).astype(np.int32)
            flat = flat.at[:, jnp.asarray(idx), :].set(val)
        for j, l in enumerate(F3_DMRS_SYMS):
            alpha = 2 * np.pi * (int(ncs[ns, l]) % 12) / 12
            ref = cplx.from_numpy(base * np.exp(1j * alpha * np.arange(12)))
            idx = ((7 * s + l) * cell.nre + ks).astype(np.int32)
            flat = flat.at[:, jnp.asarray(idx), :].set(
                jnp.broadcast_to(jnp.asarray(ref), (B, 12, 2)))
    return flat.reshape(grid.shape)


def decode_f3(rx_grid, cell: grid_mod.CellConfig, sf_idx: int,
              n_pucch3: int, n_bits: int):
    """Format 3 decode: DMRS channel estimate, OCC despread, RM32 ML over the
    48 repeated coded bits."""
    from ..ops import modem

    n_oc = n_pucch3 % 5
    prb_m = n_pucch3 // 5
    ncs = n_cs_cell(cell.cell_id)
    u_tab = refsignal_ul.f_gh_table(cell.cell_id, False)
    B = rx_grid.shape[0]
    flat = rx_grid.reshape(B, -1, 2)
    slots = []
    for s in range(2):
        ns = 2 * sf_idx + s
        u = (int(u_tab[ns]) + cell.cell_id % 30) % 30
        base = refsignal_ul.base_sequence(u, 0, 12)
        prb = prb_m // 2 if (prb_m + ns) % 2 == 0 else cell.n_prb - 1 - prb_m // 2
        ks = 12 * prb + np.arange(12)
        h_acc = []
        for l in F3_DMRS_SYMS:
            alpha = 2 * np.pi * (int(ncs[ns, l]) % 12) / 12
            ref = cplx.from_numpy(base * np.exp(1j * alpha * np.arange(12)))
            idx = ((7 * s + l) * cell.nre + ks).astype(np.int32)
            y = jnp.take(flat, jnp.asarray(idx), axis=-2)
            h_acc.append(cplx.mul_conj(y, jnp.asarray(ref)))
        h = sum(h_acc) / 2.0  # (B, 12, 2)
        acc = None
        for i, l in enumerate(F3_DATA_SYMS):
            idx = ((7 * s + l) * cell.nre + ks).astype(np.int32)
            y = jnp.take(flat, jnp.asarray(idx), axis=-2)
            w = W_F3[n_oc, i]
            wc = jnp.asarray([w.real, w.imag], dtype=jnp.float32)
            z = cplx.mul_conj(y, jnp.broadcast_to(wc, y.shape))  # undo OCC
            zz = cplx.mul_conj(z, h)  # equalize
            acc = zz if acc is None else acc + zz
        slots.append(acc / len(F3_DATA_SYMS))
    d = jnp.concatenate(slots, axis=1)  # (B, 24, 2)
    llr = modem.demod_soft(
        d / (jnp.sqrt(cplx.abs2(d))[..., None] + 1e-9), modem.QPSK)  # (B, 48)
    # fold the circular repetition back onto the 32 coded positions
    llr32 = llr.at[:, :16].add(llr[:, 32:]) if hasattr(llr, "at") else llr
    llr32 = llr32[:, :32]
    bits, metric = uci.decode_rm(llr32, n_bits, "rm32")
    return bits, metric
