"""PUSCH: uplink shared channel with SC-FDMA transform precoding.

Reference behavior: `lib/src/phy/phch/pusch.c` (UL-SCH + UCI mux + DFT
precoding + PUSCH scrambling; eNB-side decode) and `lib/src/phy/dft/
dft_precoding.c` (transform precoding, valid sizes 2^a 3^b 5^c).

Design: the UL channel interleaver (36.212 §5.2.2.8) is a static
reshape/transpose; DFT precoding rides the same matmul-DFT engine; DMRS-based
UL channel estimation averages the two slot pilots with linear time
interpolation.  Data symbols: l in {0..6}\\{3} per slot (DMRS at l=3).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..ops import cplx, dft, modem, scrambling
from . import chest as chest_dl  # for equalize helpers
from . import grid as grid_mod, refsignal_ul, sch

DATA_SYMS = tuple(l for l in range(14) if l not in (3, 10))
DMRS_SYMS = (3, 10)
N_DATA_SYMS = len(DATA_SYMS)  # 12


def valid_n_prb(n_prb: int) -> bool:
    """Transform precoding sizes: 2^a 3^b 5^c (dft_precoding.c)."""
    n = n_prb
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


def interleave(bits: jnp.ndarray, qm: int) -> jnp.ndarray:
    """UL channel interleaver, data-only (36.212 §5.2.2.8): write row-wise in
    Qm-bit groups over C_mux=12 columns, read column-wise."""
    B, G = bits.shape
    r = G // (qm * N_DATA_SYMS)
    x = bits.reshape(B, r, N_DATA_SYMS, qm)
    return x.transpose(0, 2, 1, 3).reshape(B, G)


def deinterleave(llrs: jnp.ndarray, qm: int) -> jnp.ndarray:
    B, G = llrs.shape
    r = G // (qm * N_DATA_SYMS)
    x = llrs.reshape(B, N_DATA_SYMS, r, qm)
    return x.transpose(0, 2, 1, 3).reshape(B, G)


@functools.lru_cache(maxsize=None)
def re_indices(n_prb_cell: int, rb_start: int, l_prb: int):
    """(12, 12*l_prb) flat grid indices of PUSCH data REs (freq within symbol),
    plus (2, 12*l_prb) DMRS indices."""
    nre = 12 * n_prb_cell
    ks = 12 * rb_start + np.arange(12 * l_prb)
    data = np.stack([l * nre + ks for l in DATA_SYMS]).astype(np.int32)
    dmrs = np.stack([l * nre + ks for l in DMRS_SYMS]).astype(np.int32)
    return data, dmrs


@functools.lru_cache(maxsize=None)
def _dmrs10(cell_id: int, l_prb: int) -> np.ndarray:
    """(10, 2, 12*l_prb) PUSCH DMRS for every subframe — gather table for
    a TRACED sf_idx (group/sequence hopping varies per slot)."""
    return np.stack([refsignal_ul.pusch_dmrs(cell_id, s, l_prb)
                     for s in range(10)])


def _dmrs_for(cell_id: int, sf_idx, l_prb: int):
    """(2, 12*l_prb, 2) cf DMRS values; sf_idx may be traced."""
    if isinstance(sf_idx, (int, np.integer)):
        return jnp.asarray(cplx.from_numpy(
            refsignal_ul.pusch_dmrs(cell_id, int(sf_idx), l_prb)))
    d10 = _dmrs10(cell_id, l_prb)
    v = jnp.take(jnp.asarray(cplx.from_numpy(d10.reshape(10, -1))),
                 sf_idx, axis=0)
    return v.reshape(2, 12 * l_prb, 2)


def _re_idx(n_prb_cell: int, rb_start, l_prb: int):
    """re_indices that also accepts a TRACED rb_start: the index tables are
    plain arithmetic, so one compiled PUSCH kernel serves every contiguous
    allocation of the same width (kernel-population cap for the waveform
    runtime; shapes depend only on l_prb)."""
    if isinstance(rb_start, (int, np.integer)):
        return re_indices(n_prb_cell, int(rb_start), l_prb)
    nre = 12 * n_prb_cell
    ks = 12 * rb_start + jnp.arange(12 * l_prb, dtype=jnp.int32)
    data = jnp.asarray(DATA_SYMS, jnp.int32)[:, None] * nre + ks[None, :]
    dmrs = jnp.asarray(DMRS_SYMS, jnp.int32)[:, None] * nre + ks[None, :]
    return data, dmrs


def uci_dims(l_prb: int, qm: int, n_ack: int, n_ri: int, n_cqi: int,
             beta_ack: float = 20.0, beta_ri: float = 12.5, beta_cqi: float = 5.0):
    """(q_ack, q_ri, q_cqi) coded bit counts and the SCH data size G_data."""
    from . import pusch_uci

    g_total = 12 * l_prb * N_DATA_SYMS * qm
    q_ack = pusch_uci.n_uci_symbols(n_ack, beta_ack, qm, g_total) * qm if n_ack else 0
    q_ri = pusch_uci.n_uci_symbols(n_ri, beta_ri, qm, g_total) * qm if n_ri else 0
    q_cqi = pusch_uci.n_uci_symbols(max(n_cqi, 32 // max(qm, 1)), beta_cqi, qm, g_total) * qm if n_cqi else 0
    g_data = g_total - q_ri - q_cqi
    return q_ack, q_ri, q_cqi, g_data


def encode(tb_bits, cfg: sch.SchConfig, cell: grid_mod.CellConfig, sf_idx: int,
           rnti: int, rb_start: int, l_prb: int, grid=None, uci=None):
    """UE-side PUSCH encode into a UL subframe grid (B, 14, NRE, 2).

    uci: optional dict(ack=(B,n) bits, ri=(B,n) bits, cqi=(B,n) bits) —
    multiplexed per 36.212 §5.2.2.6/5.2.2.8 (sch.c UL-SCH path)."""
    from . import pusch_uci, uci as uci_codes

    assert valid_n_prb(l_prb), l_prb
    m_sc = 12 * l_prb
    g_total = m_sc * N_DATA_SYMS * cfg.Qm
    cw = sch.encode_tb(tb_bits, cfg)
    if uci:
        def _nz(x):
            return x if x is not None and x.shape[-1] else None

        ack = _nz(uci.get("ack"))
        ri = _nz(uci.get("ri"))
        cqi = _nz(uci.get("cqi"))
        q_ack, q_ri, q_cqi, g_data = uci_dims(
            l_prb, cfg.Qm, 0 if ack is None else ack.shape[-1],
            0 if ri is None else ri.shape[-1],
            0 if cqi is None else cqi.shape[-1])
        assert cfg.G == g_data, (cfg.G, g_data)
        parts = []
        if cqi is not None:
            parts.append(uci_codes.encode_cqi_pusch(cqi, q_cqi))
        parts.append(cw)
        data = jnp.concatenate(parts, axis=-1)
        ri_c = pusch_uci.encode_ack_ri(ri, q_ri // cfg.Qm, cfg.Qm) if ri is not None else None
        ack_c = pusch_uci.encode_ack_ri(ack, q_ack // cfg.Qm, cfg.Qm) if ack is not None else None
        il = pusch_uci.multiplex(data, ri_c, ack_c, cfg.Qm)
    else:
        assert cfg.G == g_total
        il = interleave(cw, cfg.Qm)
    c_init = scrambling.pusch_cinit(rnti, sf_idx, cell.cell_id)
    scr = scrambling.scramble_bits(il, c_init)
    syms = modem.modulate(scr, modem.MOD_FROM_QM[cfg.Qm])  # (B, 12*m_sc, 2)
    B = syms.shape[0]
    # transform precoding per SC-FDMA symbol
    x = syms.reshape(B, N_DATA_SYMS, m_sc, 2)
    x = dft.dft(x, ortho=True)
    data_idx, dmrs_idx = _re_idx(cell.n_prb, rb_start, l_prb)
    if grid is None:
        grid = cplx.zeros((B, grid_mod.N_SYM, cell.nre))
    flat = grid.reshape(B, -1, 2)
    flat = flat.at[:, jnp.asarray(data_idx.reshape(-1)), :].set(x.reshape(B, -1, 2))
    dv = _dmrs_for(cell.cell_id, sf_idx, l_prb).reshape(-1, 2)
    flat = flat.at[:, jnp.asarray(dmrs_idx.reshape(-1)), :].set(
        jnp.broadcast_to(dv, (B,) + dv.shape)
    )
    return flat.reshape(B, grid_mod.N_SYM, cell.nre, 2)


def estimate_ul(rx_grid, cell: grid_mod.CellConfig, sf_idx: int,
                rb_start: int, l_prb: int):
    """eNB UL channel estimate from the two DMRS symbols (chest_ul.c): LS per
    slot pilot, 5-tap frequency smoothing, linear time interpolation.
    Returns (ce (B, 12, M_sc, 2) at data symbols, noise_est (B,))."""
    m_sc = 12 * l_prb
    _, dmrs_idx = _re_idx(cell.n_prb, rb_start, l_prb)
    B = rx_grid.shape[0]
    flat = rx_grid.reshape(B, -1, 2)
    y = jnp.take(flat, jnp.asarray(dmrs_idx.reshape(-1)), axis=-2).reshape(B, 2, m_sc, 2)
    r = _dmrs_for(cell.cell_id, sf_idx, l_prb)
    h_ls = cplx.mul_conj(y, r)  # (B, 2, m_sc, 2)
    # frequency smoothing (moving average, 5 taps, edge-safe via same-pad)
    k = 5
    kernel = np.ones(k, np.float32) / k
    pad = jnp.pad(h_ls, ((0, 0), (0, 0), (k // 2, k // 2), (0, 0)), mode="edge")
    sm = sum(pad[:, :, i : i + m_sc, :] * kernel[i] for i in range(k))
    noise = jnp.mean(
        cplx.abs2(h_ls - sm).reshape(B, -1), axis=-1
    ) * (k / max(k - 1, 1))
    # time interpolation: DMRS at symbols 3, 10 -> data symbols
    t = (np.array(DATA_SYMS, np.float32) - 3.0) / 7.0  # 0 at sym3, 1 at sym10
    w1 = jnp.asarray(1.0 - t)[None, :, None, None]
    w2 = jnp.asarray(t)[None, :, None, None]
    ce = w1 * sm[:, 0:1] + w2 * sm[:, 1:2]
    return ce, noise


def decode(rx_grid, cfg: sch.SchConfig, cell: grid_mod.CellConfig, sf_idx: int,
           rnti: int, rb_start: int, l_prb: int, softbuf=None, max_iter: int = 8,
           uci_dims_in=None, llr_bits: int = 32):
    """eNB-side PUSCH decode.  Returns (payload, ok, softbuf, noise_est)
    or, with uci_dims_in=(q_ack, q_ri, q_cqi, n_ack, n_ri, n_cqi), a dict
    also carrying decoded ack/ri/cqi."""
    m_sc = 12 * l_prb
    data_idx, _ = _re_idx(cell.n_prb, rb_start, l_prb)
    B = rx_grid.shape[0]
    flat = rx_grid.reshape(B, -1, 2)
    y = jnp.take(flat, jnp.asarray(data_idx.reshape(-1)), axis=-2).reshape(B, N_DATA_SYMS, m_sc, 2)
    ce, noise = estimate_ul(rx_grid, cell, sf_idx, rb_start, l_prb)
    x_eq, csi = chest_dl.equalize_mmse(y, ce, noise)
    # inverse transform precoding
    x_td = dft.idft(x_eq, ortho=True)  # (B, 12, m_sc, 2)
    llr = modem.demod_soft(x_td.reshape(B, N_DATA_SYMS * m_sc, 2), modem.MOD_FROM_QM[cfg.Qm])
    # per-symbol CSI weight: SC-FDMA spreads each QAM symbol over the whole
    # allocation; weight by the mean CSI of its SC-FDMA symbol
    w = jnp.mean(csi, axis=-1)  # (B, 12)
    w = jnp.repeat(w, m_sc * cfg.Qm, axis=-1)
    llr = llr * w
    c_init = scrambling.pusch_cinit(rnti, sf_idx, cell.cell_id)
    llr = scrambling.scramble_llrs(llr, c_init)
    if uci_dims_in is not None:
        from . import pusch_uci, uci as uci_codes

        q_ack, q_ri, q_cqi, n_ack, n_ri, n_cqi = uci_dims_in
        data, ri_llr, ack_llr = pusch_uci.demultiplex(llr, cfg.Qm, q_ri, q_ack)
        cqi_bits = None
        if q_cqi:
            cqi_llr, data = data[..., :q_cqi], data[..., q_cqi:]
            cqi_bits, _ = uci_codes.decode_cqi_pusch(cqi_llr, n_cqi)
        payload, ok, softbuf, _ = sch.decode_tb(data, cfg, softbuf, max_iter,
                                                llr_bits=llr_bits)
        out = dict(payload=payload, ok=ok, softbuf=softbuf, noise=noise,
                   cqi=cqi_bits)
        out["ri"] = pusch_uci.decode_ack_ri(ri_llr, n_ri, cfg.Qm) if q_ri else None
        out["ack"] = pusch_uci.decode_ack_ri(ack_llr, n_ack, cfg.Qm) if q_ack else None
        return out
    llr = deinterleave(llr, cfg.Qm)
    payload, ok, softbuf, _ = sch.decode_tb(llr, cfg, softbuf, max_iter,
                                            llr_bits=llr_bits)
    return payload, ok, softbuf, noise
