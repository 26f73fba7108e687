"""PDCCH: control channel encode + batched blind search decode.

Reference behavior: `lib/src/phy/phch/pdcch.c` — DCI CRC16 scrambled by RNTI,
K=7 conv code + rate matching to 72*L bits, CCE aggregation L in {1,2,4,8},
REG interleaving via regs.c; the UE blind search walks candidates serially
(`lib/src/phy/ue/ue_dl.c:422-478`).

Design: the blind search is a dense hypothesis tensor — every candidate
(aggregation x CCE offset x DCI size) is descrambled, de-rate-matched and
Viterbi-decoded in one batch; RNTI-masked CRCs adjudicate.  This is the
batched replacement for the serial loop the reference runs per TTI.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import modem, scrambling, sequence
from ..ops.fec import convcoder, crc as crc_mod, viterbi
from . import chest, grid as grid_mod, regs as regs_mod

CCE_BITS = 72  # 9 REGs x 4 REs x 2 bits (QPSK)


@functools.lru_cache(maxsize=None)
def n_cce(cell: grid_mod.CellConfig) -> int:
    ch = regs_mod.channel_regs(cell.n_prb, cell.cell_id, cell.n_ports)
    return len(ch["pdcch"][cell.cfi]) // 9


@functools.lru_cache(maxsize=None)
def cce_re_indices(cell: grid_mod.CellConfig) -> np.ndarray:
    """(n_cce, 36) flat grid RE indices per CCE (sequence order -> regs)."""
    ch = regs_mod.channel_regs(cell.n_prb, cell.cell_id, cell.n_ports)
    seq = ch["pdcch"][cell.cfi]
    ncce = len(seq) // 9
    res = regs_mod.reg_re_indices(
        cell.n_prb, cell.cell_id, cell.n_ports, seq[: ncce * 9]
    )  # (9*ncce, 4)
    return res.reshape(ncce, 36)


def _crc_rnti_attach(dci_bits, rnti: int):
    """(B, n) -> (B, n+16) with CRC16 xored by RNTI (pdcch.c)."""
    w = crc_mod.crc_attach(dci_bits, crc_mod.LTE_CRC16)
    mask = np.array([(rnti >> (15 - i)) & 1 for i in range(16)], dtype=np.int8)
    n = dci_bits.shape[-1]
    return jnp.concatenate([w[:, :n], w[:, n:] ^ jnp.asarray(mask)], axis=1)


def encode(dci_bits, rnti: int, l_aggr: int, cce_start: int,
           cell: grid_mod.CellConfig, sf_idx: int, grid):
    """Encode one DCI onto CCEs [cce_start, cce_start+l_aggr) of `grid`."""
    coded = convcoder.conv_encode(_crc_rnti_attach(dci_bits, rnti))
    e = CCE_BITS * l_aggr
    bits = convcoder.rate_match_cc(coded, e)
    # scramble with the position-dependent slice of the control-region sequence
    c_init = scrambling.pdcch_cinit(sf_idx, cell.cell_id)
    c_all = sequence.gold_sequence(c_init, CCE_BITS * n_cce(cell))
    c = c_all[CCE_BITS * cce_start : CCE_BITS * cce_start + e]
    scr = (bits ^ c).astype(jnp.int8)
    syms = modem.modulate(scr, modem.QPSK)  # (B, e/2, 2)
    idx = cce_re_indices(cell)[cce_start : cce_start + l_aggr].reshape(-1)
    flat = grid.reshape(grid.shape[0], -1, 2)
    flat = flat.at[:, jnp.asarray(idx), :].set(syms)
    return flat.reshape(grid.shape)


def rnti_mask_bits(rnti) -> jnp.ndarray:
    """(16,) int8 MSB-first CRC16 mask from a (possibly traced) rnti."""
    r = jnp.asarray(rnti, jnp.uint32)
    sh = jnp.arange(15, -1, -1, dtype=jnp.uint32)
    return ((r[..., None] >> sh) & 1).astype(jnp.int8)


def encode_dyn(dci_bits, rnti, l_aggr: int, cce_start,
               cell: grid_mod.CellConfig, sf_idx: int, grid):
    """encode() with rnti and cce_start as (possibly traced) scalars.

    Semantics identical to encode() (pdcch.c), but ONE compiled kernel
    serves every (rnti, CCE position) at a given aggregation level — the
    waveform runtime's kernel-cache stays UE-count-independent."""
    w = crc_mod.crc_attach(dci_bits, crc_mod.LTE_CRC16)
    n = dci_bits.shape[-1]
    bits_in = jnp.concatenate([w[:, :n], w[:, n:] ^ rnti_mask_bits(rnti)],
                              axis=1)
    coded = convcoder.conv_encode(bits_in)
    e = CCE_BITS * l_aggr
    bits = convcoder.rate_match_cc(coded, e)
    c_init = scrambling.pdcch_cinit(sf_idx, cell.cell_id)
    c_all = sequence.gold_sequence(c_init, CCE_BITS * n_cce(cell))
    start = jnp.asarray(cce_start, jnp.int32)
    c = jax.lax.dynamic_slice_in_dim(c_all, start * CCE_BITS, e, axis=0)
    scr = (bits ^ c).astype(jnp.int8)
    syms = modem.modulate(scr, modem.QPSK)
    rows = jax.lax.dynamic_slice_in_dim(
        jnp.asarray(cce_re_indices(cell)), start, l_aggr, axis=0)
    flat = grid.reshape(grid.shape[0], -1, 2)
    flat = flat.at[:, rows.reshape(-1), :].set(syms)
    return flat.reshape(grid.shape)


@functools.lru_cache(maxsize=None)
def full_space(cell: grid_mod.CellConfig) -> tuple:
    """Every l-aligned (l_aggr, cce_start) position — the superset of any
    RNTI's 36.213 search space (common and UE-specific starts are both
    multiples of l)."""
    ncce = n_cce(cell)
    return tuple((l, s) for l in (1, 2, 4, 8)
                 for s in range(0, ncce - l + 1, l))


def blind_search_all(rx_grid, ce, cell: grid_mod.CellConfig, sf_idx: int,
                     dci_len: int):
    """Decode EVERY aligned CCE position once per subframe.

    Returns (bits (B, n_pos, dci_len), resid (B, n_pos) int32, positions):
    a candidate decoded for RNTI r iff resid == r (the CRC16 residual IS
    the scrambling RNTI).  One compiled kernel adjudicates all listeners:
    the per-RNTI check is a host-side integer compare, so the waveform
    UE's blind search costs the same whether it watches one RNTI or ten
    (ue_dl.c:422-478 runs the candidate loop per RNTI instead)."""
    cands = full_space(cell)
    B = rx_grid.shape[0]
    idx_all = cce_re_indices(cell)
    flat_rx = rx_grid.reshape(B, -1, 2)
    flat_ce = ce.reshape(B, -1, 2)
    c_init = scrambling.pdcch_cinit(sf_idx, cell.cell_id)
    c_all = sequence.gold_sequence_host(c_init, CCE_BITS * n_cce(cell))
    weights = jnp.asarray([1 << (15 - i) for i in range(16)], jnp.int32)

    bits_out, resid_out, pos_out = [], [], []
    for l in (1, 2, 4, 8):
        starts = [s for (ll, s) in cands if ll == l]
        if not starts:
            continue
        idx = np.stack([idx_all[s : s + l].reshape(-1) for s in starts])
        y = jnp.take(flat_rx, jnp.asarray(idx.reshape(-1)), axis=-2)
        h = jnp.take(flat_ce, jnp.asarray(idx.reshape(-1)), axis=-2)
        x_eq, csi = chest.equalize_zf(y, h)
        llr = modem.demod_soft(x_eq, modem.QPSK) * jnp.repeat(csi, 2, axis=-1)
        llr = llr.reshape(B, len(starts), l * CCE_BITS)
        scr = np.stack(
            [1.0 - 2.0 * c_all[CCE_BITS * s : CCE_BITS * (s + l)]
             for s in starts]).astype(np.float32)
        llr = llr * jnp.asarray(scr)[None]
        flat = llr.reshape(B * len(starts), l * CCE_BITS)
        streams = convcoder.rate_unmatch_cc(flat, dci_len + 16)
        bits = viterbi.viterbi_decode(streams)  # (B*n, dci_len+16)
        calc = crc_mod.crc_bits(bits[:, :dci_len], crc_mod.LTE_CRC16)
        resid_bits = (calc ^ bits[:, dci_len:]).astype(jnp.int32)
        resid = (resid_bits * weights).sum(-1)
        bits_out.append(bits[:, :dci_len].reshape(B, len(starts), dci_len))
        resid_out.append(resid.reshape(B, len(starts)))
        pos_out.extend((l, s) for s in starts)
    return (jnp.concatenate(bits_out, axis=1),
            jnp.concatenate(resid_out, axis=1), pos_out)


def ue_yk(rnti: int, sf_idx: int) -> int:
    """UE-specific search space hash Y_k (36.213 §9.1.1)."""
    y = rnti
    for _ in range(sf_idx + 1):
        y = (39827 * y) % 65537
    return y


@functools.lru_cache(maxsize=65536)
def candidates(cell: grid_mod.CellConfig, rnti: int, sf_idx: int) -> list:
    """(l_aggr, cce_start) candidate list: common (L=4,8) + UE-specific."""
    ncce = n_cce(cell)
    out = []
    # common search space
    for l, n_cand in ((4, 4), (8, 2)):
        for m in range(n_cand):
            start = m * l
            if start + l <= ncce:
                out.append((l, start))
    # UE-specific
    yk = ue_yk(rnti, sf_idx)
    for l, n_cand in ((1, 6), (2, 6), (4, 2), (8, 2)):
        if ncce // l == 0:
            continue
        for m in range(n_cand):
            start = l * ((yk + m) % (ncce // l))
            if start + l <= ncce:
                out.append((l, start))
    # dedupe preserving order
    seen, uniq = set(), []
    for c in out:
        if c not in seen:
            seen.add(c)
            uniq.append(c)
    return uniq


def allocate_cces(cell: grid_mod.CellConfig, rntis, sf_idx: int,
                  l_pref: int = 1) -> dict:
    """Greedy per-TTI CCE allocation over each UE's true 36.213 search
    space: every grant gets a candidate from candidates(cell, rnti, sf_idx)
    whose CCEs overlap no earlier grant (scheduler_grid.cc alloc_dci role).

    Returns {rnti: (l_aggr, cce_start)}; UEs that cannot be placed without
    a collision are OMITTED (the scheduler must defer them a TTI)."""
    used = set()
    out = {}
    for rnti in rntis:
        cands = candidates(cell, rnti, sf_idx)
        # prefer the requested aggregation level, then smaller ones (more
        # candidates -> fewer collisions), then larger
        cands = sorted(cands, key=lambda c: (c[0] != l_pref, c[0]))
        for l, start in cands:
            cces = set(range(start, start + l))
            if not (cces & used):
                used |= cces
                out[rnti] = (l, start)
                break
    return out


def blind_search(rx_grid, ce, cell: grid_mod.CellConfig, sf_idx: int,
                 rnti: int, dci_len: int):
    """Decode every candidate for (rnti, dci_len) as one batch.

    rx_grid/ce: (B, 14, NRE, 2).  Returns (bits (B, n_cand, dci_len),
    ok (B, n_cand), cand list) — caller picks the passing candidate(s)."""
    cands = candidates(cell, rnti, sf_idx)
    B = rx_grid.shape[0]
    idx_all = cce_re_indices(cell)
    flat_rx = rx_grid.reshape(B, -1, 2)
    flat_ce = ce.reshape(B, -1, 2)
    c_init = scrambling.pdcch_cinit(sf_idx, cell.cell_id)
    c_all = sequence.gold_sequence_host(c_init, CCE_BITS * n_cce(cell))
    mask = np.array([(rnti >> (15 - i)) & 1 for i in range(16)], dtype=np.int8)

    bits_out, ok_out = [], []
    # group candidates by aggregation level so each level is one batched call
    for l in sorted({l for l, _ in cands}):
        starts = [s for (ll, s) in cands if ll == l]
        idx = np.stack([idx_all[s : s + l].reshape(-1) for s in starts])  # (n, 36l)
        y = jnp.take(flat_rx, jnp.asarray(idx.reshape(-1)), axis=-2)
        h = jnp.take(flat_ce, jnp.asarray(idx.reshape(-1)), axis=-2)
        x_eq, csi = chest.equalize_zf(y, h)
        llr = modem.demod_soft(x_eq, modem.QPSK) * jnp.repeat(csi, 2, axis=-1)
        llr = llr.reshape(B, len(starts), l * CCE_BITS)
        scr = np.stack(
            [1.0 - 2.0 * c_all[CCE_BITS * s : CCE_BITS * (s + l)] for s in starts]
        ).astype(np.float32)
        llr = llr * jnp.asarray(scr)[None]
        flat = llr.reshape(B * len(starts), l * CCE_BITS)
        streams = convcoder.rate_unmatch_cc(flat, dci_len + 16)
        bits = viterbi.viterbi_decode(streams)  # (B*n, dci_len+16)
        unmasked = jnp.concatenate(
            [bits[:, :dci_len], bits[:, dci_len:] ^ jnp.asarray(mask)], axis=1
        )
        ok = crc_mod.crc_ok(unmasked, crc_mod.LTE_CRC16)
        bits_out.append(bits[:, :dci_len].reshape(B, len(starts), dci_len))
        ok_out.append(ok.reshape(B, len(starts)))
    return (
        jnp.concatenate(bits_out, axis=1),
        jnp.concatenate(ok_out, axis=1),
        [c for l in sorted({l for l, _ in cands}) for c in [(l, s) for (ll, s) in cands if ll == l]],
    )
