"""UCI coding: Reed-Muller block codes for CQI/ACK/RI + CQI report packing.

Reference behavior: `lib/src/phy/phch/uci.c` — (32, O) RM code (M_basis_seq,
uci.c:43, encode at :206), PUCCH (20, A) code (uci.c:79, :137-152); and
`lib/src/phy/phch/cqi.c` report pack/unpack.

Design: encode is a GF(2) matmul with the basis matrix; decode is soft ML
correlation against all 2^O codewords (O <= 13 on PUCCH, O <= 11 per RM32
block) — one (B, N) x (N, 2^O) matmul, a brute force that costs one matrix
product.
"""

from __future__ import annotations

import functools
import pathlib

import jax.numpy as jnp
import numpy as np

_DATA = np.load(pathlib.Path(__file__).parent / "uci_tables.npz")
RM32 = _DATA["rm32"].astype(np.int64)  # (32, 11)
RM20 = _DATA["rm20"].astype(np.int64)  # (20, 13)


def encode_rm(bits, n_out: int, basis: np.ndarray = RM32):
    """(B, O) info bits -> (B, n_out) coded bits; circular repetition beyond
    the mother code length (uci.c:617)."""
    bits = jnp.asarray(bits, jnp.int32)
    n, k = basis.shape
    b = bits.shape[-1]
    cw = (bits @ jnp.asarray(basis[:, :b].T, dtype=jnp.int32)) & 1  # (B, n)
    idx = np.arange(n_out) % n
    return jnp.take(cw, jnp.asarray(idx), axis=-1).astype(jnp.int8)


def encode_rm20(bits, basis: np.ndarray = RM20):
    return encode_rm(bits, 20, basis)


@functools.lru_cache(maxsize=None)
def _codebook(n_bits: int, n_out: int, which: str):
    basis = RM32 if which == "rm32" else RM20
    n = basis.shape[0]
    msgs = np.array([[(v >> i) & 1 for i in range(n_bits)]
                     for v in range(1 << n_bits)], dtype=np.int64)
    cw = (msgs @ basis[:, :n_bits].T) % 2
    cw = cw[:, np.arange(n_out) % n]
    return msgs.astype(np.int8), (1.0 - 2.0 * cw).astype(np.float32)


def decode_rm(llrs, n_bits: int, which: str = "rm32"):
    """Soft ML decode: (B, E) LLRs (positive = bit 0) -> ((B, n_bits) bits,
    (B,) correlation metric)."""
    msgs, book = _codebook(n_bits, llrs.shape[-1], which)
    corr = llrs @ jnp.asarray(book.T)  # (B, 2^O)
    best = jnp.argmax(corr, axis=-1)
    bits = jnp.take(jnp.asarray(msgs), best, axis=0)
    return bits, jnp.max(corr, axis=-1)


# ---- CQI channel coding on PUSCH (36.212 §5.2.2.6) ----

def encode_cqi_pusch(bits, q_bits: int):
    """O <= 11 payload bits -> RM(32, O); O > 11 -> CRC8 + tail-biting
    convolutional code + circular rate matching (36.212 §5.2.2.6.4 —
    `lib/src/phy/phch/uci.c` encode_cqi_long).  Long aperiodic reports
    (HL subband at wide bandwidths) always take the second path."""
    from ..ops.fec import convcoder, crc as crc_mod

    O = bits.shape[-1]
    if O <= 11:
        return encode_rm(bits, q_bits)
    w = crc_mod.crc_attach(bits, crc_mod.LTE_CRC8)
    streams = convcoder.conv_encode(w)
    return convcoder.rate_match_cc(streams, q_bits)


def decode_cqi_pusch(llrs, n_bits: int):
    """Inverse of encode_cqi_pusch.  Returns (bits (B, n_bits), ok (B,))
    where ok is the RM correlation metric sign proxy for short reports
    and the CRC8 verdict for long ones (uci.c decode_cqi_long)."""
    from ..ops.fec import convcoder, crc as crc_mod, viterbi

    if n_bits <= 11:
        bits, metric = decode_rm(llrs, n_bits, "rm32")
        return bits, metric > 0
    streams = convcoder.rate_unmatch_cc(llrs, n_bits + 8)
    bits = viterbi.viterbi_decode(streams)
    ok = crc_mod.crc_ok(bits, crc_mod.LTE_CRC8)
    return bits[:, :n_bits], ok


# ---- CQI report packing (cqi.c, all four report formats) ----

def _ubits(v: int, n: int) -> list:
    return [(v >> (n - 1 - i)) & 1 for i in range(n)]


def _take(bits, pos: int, n: int):
    return int("".join(str(int(b)) for b in bits[pos : pos + n]), 2), pos + n


def pack_cqi_wideband(cqi: int, pmi: int = None, ri_bits: int = 0,
                      rank2: bool = False, four_ports: bool = False,
                      spatial_diff: int = 0) -> np.ndarray:
    """Periodic wideband report, 36.212 Tables 5.2.3.3.1-1/-2
    (cqi.c cqi_format2_wideband_pack): 4-bit CQI; with PMI the layout
    depends on rank and antenna-port count (3-bit spatial-differential CQI
    for rank>1; PMI width 4 for 4 ports, else 1/2 bits by rank)."""
    bits = _ubits(cqi, 4)
    if pmi is not None:
        if four_ports:
            if rank2:
                bits += _ubits(spatial_diff, 3)
            bits += _ubits(pmi, 4)
        elif rank2:
            bits += _ubits(spatial_diff, 3) + _ubits(pmi, 1)
        else:
            bits += _ubits(pmi, 2)
    return np.array(bits, dtype=np.int8)


def unpack_cqi_wideband(bits, has_pmi: bool = False, rank2: bool = False,
                        four_ports: bool = False) -> dict:
    bits = np.asarray(bits)
    cqi, p = _take(bits, 0, 4)
    out = dict(cqi=cqi)
    if has_pmi:
        if four_ports:
            if rank2:
                out["spatial_diff_cqi"], p = _take(bits, p, 3)
            out["pmi"], p = _take(bits, p, 4)
        elif rank2:
            out["spatial_diff_cqi"], p = _take(bits, p, 3)
            out["pmi"], p = _take(bits, p, 1)
        else:
            out["pmi"], p = _take(bits, p, 2)
    return out


def pack_cqi_format2_subband(sb_cqi: int, label: int,
                             label_2_bits: bool) -> np.ndarray:
    """Periodic UE-selected subband report (cqi_format2_subband_pack):
    4-bit subband CQI + 1/2-bit subband label."""
    return np.array(_ubits(sb_cqi, 4) + _ubits(label, 2 if label_2_bits else 1),
                    dtype=np.int8)


def unpack_cqi_format2_subband(bits, label_2_bits: bool) -> dict:
    bits = np.asarray(bits)
    cqi, p = _take(bits, 0, 4)
    label, _ = _take(bits, p, 2 if label_2_bits else 1)
    return dict(subband_cqi=cqi, subband_label=label)


def cqi_ue_subband_label_bits(n_prb: int) -> int:
    """L = ceil(log2(ceil(N_prb/k) choose M))-ish position field; the
    reference uses L = ceil(log2(nof_prb/subband k)) (cqi.c srslte_cqi_
    hl_get_L role simplified to bandwidth-part position bits)."""
    n_sb = cqi_hl_subband_size(n_prb)
    return max(1, int(np.ceil(np.log2(max(2, n_sb)))))


def pack_cqi_ue_subband(wb_cqi: int, sb_diff: int, position: int,
                        n_prb: int) -> np.ndarray:
    """Aperiodic UE-selected subband report, 36.212 Table 5.2.2.6.3-1
    (cqi.c cqi_ue_subband_pack): 4-bit wideband CQI + 2-bit differential
    CQI for the preferred subbands + L-bit subband position.  (The
    reference packs the diff field twice in place of the position —
    cqi.c:81-83 — this implements the spec layout.)"""
    L = cqi_ue_subband_label_bits(n_prb)
    return np.array(_ubits(wb_cqi, 4) + _ubits(sb_diff, 2)
                    + _ubits(position, L), dtype=np.int8)


def unpack_cqi_ue_subband(bits, n_prb: int) -> dict:
    bits = np.asarray(bits)
    L = cqi_ue_subband_label_bits(n_prb)
    wb, p = _take(bits, 0, 4)
    diff, p = _take(bits, p, 2)
    pos, _ = _take(bits, p, L)
    return dict(wideband_cqi=wb, subband_diff_cqi=diff, position=pos)


def cqi_hl_subband_size(n_prb: int) -> int:
    """Number of higher-layer-configured subbands (36.213 Table 7.2.1-3:
    subband size k by bandwidth)."""
    if n_prb <= 7:
        return 0
    k = 4 if n_prb <= 26 else 6 if n_prb <= 63 else 8
    return -(-n_prb // k)


def pack_cqi_hl_subband(wb_cqi: int, sb_diffs, n_prb: int, cw1: tuple = None,
                        pmi: int = None, four_ports: bool = False) -> np.ndarray:
    """Aperiodic higher-layer-configured subband report, 36.212 Tables
    5.2.2.6.2-1/-2 (cqi.c cqi_hl_subband_pack): per codeword 4-bit
    wideband CQI + 2-bit differential CQI per subband; optional second
    codeword (rank>1) and trailing PMI (4 bits for 4 ports, else 1 bit
    rank>1 / 2 bits rank 1)."""
    n_sb = cqi_hl_subband_size(n_prb)
    assert len(sb_diffs) == n_sb, (len(sb_diffs), n_sb)
    bits = _ubits(wb_cqi, 4)
    for d in sb_diffs:
        assert 0 <= d <= 3
        bits += _ubits(d, 2)
    if cw1 is not None:
        wb1, diffs1 = cw1
        assert len(diffs1) == n_sb
        bits += _ubits(wb1, 4)
        for d in diffs1:
            bits += _ubits(d, 2)
    if pmi is not None:
        bits += _ubits(pmi, 4 if four_ports else (1 if cw1 is not None else 2))
    return np.array(bits, dtype=np.int8)


def unpack_cqi_hl_subband(bits, n_prb: int, rank2: bool = False,
                          has_pmi: bool = False,
                          four_ports: bool = False) -> dict:
    bits = np.asarray(bits).astype(int)
    n_sb = cqi_hl_subband_size(n_prb)

    def cw(p):
        wb, p = _take(bits, p, 4)
        diffs = []
        for _ in range(n_sb):
            d, p = _take(bits, p, 2)
            diffs.append(d)
        return wb, diffs, p

    wb, diffs, p = cw(0)
    out = dict(wideband_cqi=wb, subband_diff_cqi=diffs)
    if rank2:
        wb1, diffs1, p = cw(p)
        out["wideband_cqi_cw1"] = wb1
        out["subband_diff_cqi_cw1"] = diffs1
    if has_pmi:
        out["pmi"], p = _take(bits, p, 4 if four_ports else (1 if rank2 else 2))
    return out


# offset applied to the wideband CQI per differential value (36.213 7.2.1-2)
SUBBAND_DIFF_OFFSET = {0: 0, 1: 1, 2: 2, 3: -1}
