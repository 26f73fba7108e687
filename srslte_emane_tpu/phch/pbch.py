"""PBCH: physical broadcast channel (MIB).

Reference behavior: `lib/src/phy/phch/pbch.c` — 24-bit MIB + CRC16 masked by
the antenna-port pattern, K=7 tail-biting conv code, rate match to 1920 bits
(normal CP), 40 ms scrambling period, QPSK, 4 radio frames x 240 symbols on
subframe 0 symbols 7-10 (center 72 subcarriers, CRS holes assume 4 ports);
decoder tries all 4 frame offsets and port hypotheses with soft combining
(pbch.c:153).

Design: all (frame offset x port mask) hypotheses decode as one batched
Viterbi call; CRC adjudicates.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..ops import modem, scrambling
from ..ops.fec import convcoder, crc as crc_mod, viterbi
from . import grid as grid_mod

MIB_LEN = 24
CODED = 1920  # normal CP
SEG = CODED // 4  # 480 bits / 240 symbols per radio frame

# 36.212 Table 5.3.1.1-1 CRC masks
PORT_MASKS = {
    1: np.zeros(16, dtype=np.int8),
    2: np.ones(16, dtype=np.int8),
    4: np.tile(np.array([0, 1], dtype=np.int8), 8),
}


@functools.lru_cache(maxsize=None)
def re_indices(cell: grid_mod.CellConfig) -> np.ndarray:
    """(240,) flat grid indices of PBCH REs in one subframe-0 grid."""
    nre = cell.nre
    center = nre // 2
    vshift3 = cell.cell_id % 3
    idx = []
    for sym in (7, 8, 9, 10):
        for k in range(center - 36, center + 36):
            if sym in (7, 8) and (k % 3) == vshift3:
                continue  # CRS holes (4-port assumption per spec)
            idx.append(sym * nre + k)
    out = np.array(idx, dtype=np.int32)
    assert len(out) == 240
    return out


def _coded_bits(mib_bits, n_ports: int):
    """(B, 24) -> (B, 1920) scrambled-ready coded bits (before scrambling)."""
    mask = jnp.asarray(PORT_MASKS[n_ports])
    with_crc = crc_mod.crc_attach(mib_bits, crc_mod.LTE_CRC16)
    with_crc = jnp.concatenate(
        [with_crc[:, :MIB_LEN], with_crc[:, MIB_LEN:] ^ mask], axis=1
    )
    streams = convcoder.conv_encode(with_crc)  # (B, 3, 40)
    return convcoder.rate_match_cc(streams, CODED)


def encode(mib_bits, cell: grid_mod.CellConfig, sfn: int, grid):
    """Place this radio frame's PBCH segment (sfn mod 4) into the sf0 grid."""
    off = sfn % 4
    coded = _coded_bits(mib_bits, cell.n_ports)
    scr = scrambling.scramble_bits(coded, cell.cell_id)
    seg = scr[:, off * SEG : (off + 1) * SEG]
    syms = modem.modulate(seg, modem.QPSK)  # (B, 240, 2)
    flat = grid.reshape(grid.shape[0], -1, 2)
    flat = flat.at[:, jnp.asarray(re_indices(cell)), :].set(syms)
    return flat.reshape(grid.shape)


def _llrs_port_hyp(rx_grid, ces, cell: grid_mod.CellConfig, n_ports: int):
    """PBCH symbol LLRs under a port-count hypothesis: SISO ZF for 1 port,
    SFBC/Alamouti combining over ports 0/1 for 2 (and, approximately, 4)."""
    from . import chest
    from ..ops import mimo

    B = rx_grid.shape[0]
    idx = jnp.asarray(re_indices(cell))
    y = jnp.take(rx_grid.reshape(B, -1, 2), idx, axis=-2)
    if n_ports == 1:
        h = jnp.take(ces[0].reshape(B, -1, 2), idx, axis=-2)
        x_eq, csi = chest.equalize_zf(y, h)
        return modem.demod_soft(x_eq, modem.QPSK) * jnp.repeat(csi, 2, axis=-1)
    h = jnp.stack(
        [jnp.take(ces[p].reshape(B, -1, 2), idx, axis=-2) for p in (0, 1)],
        axis=1,
    )  # (B, 2, 240, 2)
    layers, csi = mimo.decode_sfbc(y, h)  # (B, 2, 120, 2), (B, 2, 120)
    x = mimo.layer_demap(layers, 1)[0]  # (B, 240, 2) symbol stream
    w = csi.swapaxes(-1, -2).reshape(csi.shape[0], -1)  # interleave layers
    return modem.demod_soft(x, modem.QPSK) * jnp.repeat(w, 2, axis=-1)


def decode(rx_grid, ce, cell: grid_mod.CellConfig, ce_port1=None):
    """Hypothesis decode over (4 frame offsets x 3 port counts).

    ce: port-0 channel estimate; ce_port1: optional port-1 estimate (enables
    true SFBC hypotheses for 2/4-port cells).
    Returns (mib (B, 24), n_ports (B,), sfn_offset (B,), ok (B,))."""
    B = rx_grid.shape[0]
    ces = [ce, ce_port1 if ce_port1 is not None else ce]
    all_bits, all_ok = [], []
    for p_hyp, nport in ((0, 1), (1, 2), (2, 4)):
        llr = _llrs_port_hyp(rx_grid, ces, cell, 1 if nport == 1 else 2)
        segs = []
        for off in range(4):
            buf = jnp.zeros((B, CODED), llr.dtype)
            segs.append(buf.at[:, off * SEG : (off + 1) * SEG].set(llr))
        hyp = jnp.stack(segs, axis=1).reshape(B * 4, CODED)
        hyp = scrambling.scramble_llrs(hyp, cell.cell_id)
        streams = convcoder.rate_unmatch_cc(hyp, 40)
        bits = viterbi.viterbi_decode(streams)  # (B*4, 40)
        mask = jnp.asarray(PORT_MASKS[nport])
        unmasked = jnp.concatenate(
            [bits[:, :MIB_LEN], bits[:, MIB_LEN:] ^ mask], axis=1
        )
        ok = crc_mod.crc_ok(unmasked, crc_mod.LTE_CRC16)
        all_bits.append(bits.reshape(B, 4, 40))
        all_ok.append(ok.reshape(B, 4))
    okp = jnp.stack(all_ok, axis=2)  # (B, off, port_idx)
    bitsp = jnp.stack(all_bits, axis=2)  # (B, off, port_idx, 40)
    flat_ok = okp.reshape(B, 12)
    best = jnp.argmax(flat_ok.astype(jnp.int32), axis=1)
    ok = jnp.any(flat_ok, axis=1)
    off_best = best // 3
    port_best = jnp.asarray(np.array([1, 2, 4]))[best % 3]
    mib = jnp.take_along_axis(
        bitsp.reshape(B, 12, 40), best[:, None, None], axis=1
    )[:, 0, :MIB_LEN]
    return mib.astype(jnp.int8), port_best, off_best, ok


def pack_mib(n_prb: int, sfn: int, phich_res: str = "1", phich_dur: int = 0) -> np.ndarray:
    """MIB payload bits (24,): bw(3) phich_dur(1) phich_res(2) sfn_msb(8) spare(10)."""
    bw_map = {6: 0, 15: 1, 25: 2, 50: 3, 75: 4, 100: 5}
    res_map = {"1/6": 0, "1/2": 1, "1": 2, "2": 3}
    bits = np.zeros(24, dtype=np.int8)
    v = bw_map[n_prb]
    bits[0:3] = [(v >> (2 - i)) & 1 for i in range(3)]
    bits[3] = phich_dur
    r = res_map[phich_res]
    bits[4:6] = [(r >> 1) & 1, r & 1]
    s = (sfn >> 2) & 0xFF
    bits[6:14] = [(s >> (7 - i)) & 1 for i in range(8)]
    return bits


def unpack_mib(bits: np.ndarray) -> dict:
    bits = np.asarray(bits)
    bw_inv = {0: 6, 1: 15, 2: 25, 3: 50, 4: 75, 5: 100}
    res_inv = {0: "1/6", 1: "1/2", 2: "1", 3: "2"}
    v = int("".join(map(str, bits[0:3])), 2)
    s = int("".join(map(str, bits[6:14])), 2)
    return dict(
        n_prb=bw_inv.get(v, -1),
        phich_dur=int(bits[3]),
        phich_res=res_inv[int("".join(map(str, bits[4:6])), 2)],
        sfn_msb=s,
    )
