"""PDSCH: downlink shared channel symbol chain (SISO/TM1 first).

Reference behavior: `lib/src/phy/phch/pdsch.c` — encode: scrambling ->
modulation -> layer map -> precoding -> RE mapping honoring holes
(pdsch.c:81-233); decode: predecoding -> soft demod -> descramble -> DL-SCH
decode with CSI-weighted LLR scaling (pdsch.c:574-686).

Design: the RE map is a host-precomputed flat index table (grid.py); the
device path is gathers, matmul DFTs, elementwise demod, and the batched SCH
codec.  Everything is batched over subframes (axis B) — the batched analogue of the
reference's sf_worker pipeline parallelism (txrx.cc:105-145).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops import cplx, mimo, modem, scrambling
from . import chest, grid as grid_mod, sch


def put_crs(grid, cell: grid_mod.CellConfig, sf_idx, port: int = 0):
    """Scatter CRS pilots for `port` into grid (..., 14, NRE, 2).
    sf_idx may be TRACED (values gathered from a per-sf constant table)."""
    ks = grid_mod.crs_k(cell.cell_id, cell.n_prb, port, cell.cp)
    syms = grid_mod.pilot_syms(port, cell.cp)
    pidx = (np.asarray(syms)[:, None] * cell.nre + ks).reshape(-1).astype(np.int32)
    flat = grid.reshape(grid.shape[:-3] + (cell.n_sym * cell.nre, 2))
    if isinstance(sf_idx, (int, np.integer)):
        vals = grid_mod.crs_values(cell.cell_id, int(sf_idx), cell.n_prb,
                                   port, cell.cp)
        v = jnp.asarray(cplx.from_numpy(vals.reshape(-1)))
    else:
        v10 = chest._crs_values10(cell.cell_id, cell.n_prb, port, cell.cp)
        v10 = v10.reshape(10, -1)
        v = jnp.take(jnp.asarray(cplx.from_numpy(v10)), sf_idx, axis=0)
    flat = flat.at[..., jnp.asarray(pidx), :].set(
        jnp.broadcast_to(v, flat.shape[:-2] + v.shape))
    return flat.reshape(grid.shape)


def assemble_grid(syms, cell: grid_mod.CellConfig, sf_idx: int,
                  prb_mask: tuple, port: int = 0, max_sym: int = 0):
    """(B, n_re, 2) PDSCH symbols -> (B, 14, NRE, 2) grid with CRS, as ONE
    gather (see grid.tx_gather_table).  Unused REs are zero."""
    tbl = grid_mod.tx_gather_table(cell, sf_idx, prb_mask, port, max_sym)
    crs = grid_mod.crs_values(cell.cell_id, sf_idx, cell.n_prb, port, cell.cp)
    crs_v = cplx.from_numpy(crs.reshape(-1))  # (n_crs, 2)
    B = syms.shape[0]
    src = jnp.concatenate(
        [syms, jnp.broadcast_to(crs_v, (B,) + crs_v.shape),
         jnp.zeros((B, 1, 2), syms.dtype)], axis=-2)
    flat = jnp.take(src, jnp.asarray(tbl), axis=-2)
    return flat.reshape(B, cell.n_sym, cell.nre, 2)


def encode(tb_bits, cfg: sch.SchConfig, cell: grid_mod.CellConfig, sf_idx: int,
           rnti: int, prb_mask: tuple, grid=None, codeword_q: int = 0,
           max_sym: int = 0, re_idx=None):
    """Encode one PDSCH grant into a subframe grid.

    tb_bits: (B, tbs). Returns grid (B, 14, NRE, 2) with CRS + PDSCH placed.
    re_idx: optional (n_re,) RE index array — may be a TRACED argument, so
    one compiled kernel serves every rb_start with the same allocation
    width (the waveform runtime's kernel-population cap).
    """
    static_idx = re_idx is None
    if static_idx:
        re_idx = grid_mod.pdsch_re_indices(cell, sf_idx, prb_mask, max_sym)
        assert cfg.G == len(re_idx) * cfg.Qm, (cfg.G, len(re_idx), cfg.Qm)
        re_idx = jnp.asarray(re_idx)
    else:
        assert cfg.G == re_idx.shape[0] * cfg.Qm, (cfg.G, re_idx.shape)
    cw = sch.encode_tb(tb_bits, cfg)  # (B, G)
    c_init = scrambling.pdsch_cinit(rnti, codeword_q, sf_idx, cell.cell_id)
    scr = scrambling.scramble_bits(cw, c_init)
    syms = modem.modulate(scr, modem.MOD_FROM_QM[cfg.Qm])  # (B, n_re, 2)
    B = syms.shape[0]
    if grid is None and static_idx:
        # fresh grid: one-gather assembly (fast path; scatters serialize)
        return assemble_grid(syms, cell, sf_idx, prb_mask, 0, max_sym)
    if grid is None:
        grid = cplx.zeros((B, cell.n_sym, cell.nre))
    flat = grid.reshape(B, cell.n_sym * cell.nre, 2)
    flat = flat.at[:, re_idx, :].set(syms)
    grid = flat.reshape(B, cell.n_sym, cell.nre, 2)
    return put_crs(grid, cell, sf_idx)


def encode_tm(tb_list, cfg_list, cell: grid_mod.CellConfig, sf_idx: int,
              rnti: int, prb_mask: tuple, tm: str, pmi: int = 0, grids=None):
    """Multi-antenna PDSCH encode (TM2/TM3/TM4, 2 ports).

    tb_list: list of (B, tbs) payloads (1 cw for TM2, 2 for TM3/TM4).
    Returns per-port grids (B, n_ports, 14, NRE, 2) with CRS on both ports.
    """
    re_idx = grid_mod.pdsch_re_indices(cell, sf_idx, prb_mask)
    n_re = len(re_idx)
    cw_syms = []
    for q, (tb, cfg) in enumerate(zip(tb_list, cfg_list)):
        cw = sch.encode_tb(tb, cfg)
        c_init = scrambling.pdsch_cinit(rnti, q, sf_idx, cell.cell_id)
        scr = scrambling.scramble_bits(cw, c_init)
        cw_syms.append(modem.modulate(scr, modem.MOD_FROM_QM[cfg.Qm]))
    B = cw_syms[0].shape[0]
    if tm == "tm2" and cell.n_ports == 4:
        assert n_re % 4 == 0, "4-port SFBC-FSTD needs n_re % 4 == 0"
        layers = mimo.layer_map(cw_syms, 4)
        ports = mimo.precode_sfbc_fstd(layers)  # (B, 4, n_re, 2)
    elif tm == "tm2":
        layers = mimo.layer_map(cw_syms, 2)  # one cw -> 2 layers
        ports = mimo.precode_sfbc(layers)  # (B, 2, n_re, 2)
    elif tm == "tm3":
        layers = mimo.layer_map(cw_syms, 2)
        ports = mimo.precode_cdd2(layers)
    elif tm == "tm4":
        layers = mimo.layer_map(cw_syms, 2)
        ports = mimo.precode_sm2(layers, pmi)
    elif tm in ("tm5", "tm6"):
        # rank-1 closed loop (TM6); TM5 is the same transmission with the
        # MU-MIMO power offset handled at scheduling level
        layers = mimo.layer_map(cw_syms, 1)
        ports = mimo.precode_sm1(layers, pmi)
    else:
        raise ValueError(tm)
    n_ports = ports.shape[-3]
    assert ports.shape[-2] == n_re, (ports.shape, n_re)
    if grids is None:
        # fresh grids: one gather per port (fast path; scatters serialize)
        return jnp.stack(
            [assemble_grid(ports[:, p], cell, sf_idx, prb_mask, port=p)
             for p in range(n_ports)], axis=1)
    flat = grids.reshape(B, n_ports, cell.n_sym * cell.nre, 2)
    flat = flat.at[:, :, jnp.asarray(re_idx), :].set(ports)
    grids = flat.reshape(B, n_ports, cell.n_sym, cell.nre, 2)
    for p in range(n_ports):
        grids = grids.at[:, p].set(put_crs(grids[:, p], cell, sf_idx, port=p))
    return grids


def estimate_mimo(rx_grids, cell: grid_mod.CellConfig, sf_idx: int, n_tx: int = 2):
    """Per-(rx, tx) channel estimates.

    rx_grids: (B, n_rx, 14, NRE, 2) -> ce (B, n_rx, n_tx, 14, NRE, 2), noise (B,)."""
    B, n_rx = rx_grids.shape[:2]
    flat = rx_grids.reshape((B * n_rx,) + rx_grids.shape[2:])
    ces, noises = [], []
    for p in range(n_tx):
        ch = chest.estimate(flat, cell, sf_idx, port=p)
        ces.append(ch.ce.reshape((B, n_rx) + ch.ce.shape[1:]))
        noises.append(ch.noise_est.reshape(B, n_rx))
    ce = jnp.stack(ces, axis=2)
    noise = jnp.mean(jnp.stack(noises, 2), axis=(1, 2))
    return ce, noise


def decode_tm(rx_grids, cfg_list, cell: grid_mod.CellConfig, sf_idx: int,
              rnti: int, prb_mask: tuple, tm: str, pmi: int = 0,
              softbufs=None, max_iter: int = 8, llr_bits: int = 32):
    """Multi-antenna PDSCH decode.  rx_grids: (B, n_rx, 14, NRE, 2).

    Returns (payload list, ok list, softbuf list)."""
    re_idx = grid_mod.pdsch_re_indices(cell, sf_idx, prb_mask)
    B, n_rx = rx_grids.shape[:2]
    n_tx = 4 if (tm == "tm2" and cell.n_ports == 4) else 2
    ce, noise = estimate_mimo(rx_grids, cell, sf_idx, n_tx)
    take = lambda a: jnp.take(
        a.reshape(a.shape[:-3] + (cell.n_sym * cell.nre, 2)),
        jnp.asarray(re_idx), axis=-2,
    )
    y = take(rx_grids)  # (B, n_rx, n_re, 2)
    h = take(ce)  # (B, n_rx, n_tx, n_re, 2)
    n_cw = len(cfg_list)
    if tm == "tm2":
        # SFBC: combine across rx antennas by summing per-antenna combiners
        dec = mimo.decode_sfbc_fstd if n_tx == 4 else mimo.decode_sfbc
        xs, csis = [], []
        for r in range(n_rx):
            x_r, csi_r = dec(y[:, r], h[:, r])
            xs.append(x_r * csi_r[..., None])
            csis.append(csi_r)
        csi_sum = sum(csis)
        x = sum(xs) / csi_sum[..., None]
        layers, csi = x, csi_sum
        streams = mimo.layer_demap(layers, 1)
        csi_streams = [csi.swapaxes(-1, -2).reshape(B, -1)]
    elif tm in ("tm5", "tm6"):
        # rank-1 closed loop: fold the codebook vector into the channel
        w = mimo.PMI_2TX_1L[pmi]
        h_eff = None
        for p in range(2):
            wr, wi = float(w[p].real), float(w[p].imag)
            hp = h[..., p, :, :]  # (B, rx, m, 2)
            term = jnp.stack([hp[..., 0] * wr - hp[..., 1] * wi,
                              hp[..., 0] * wi + hp[..., 1] * wr], axis=-1)
            h_eff = term if h_eff is None else h_eff + term
        x, csi = mimo.decode_mrc_eff(y, h_eff)
        streams = [x]
        csi_streams = [csi]
    elif tm in ("tm3", "tm4"):
        m = len(re_idx)
        if tm == "tm3":
            sign = np.where(np.arange(m) % 2 == 0, 1.0, -1.0).astype(np.float32)
            u = np.array([[1, 1], [1, -1]], dtype=np.complex64) / np.sqrt(2)
            # W D(i) U with W = I/sqrt2: rows=tx, cols=layers
            base = (np.eye(2) / np.sqrt(2)).astype(np.complex64)
            w0 = base @ np.diag([1.0, 1.0]).astype(np.complex64) @ u
            w1 = base @ np.diag([1.0, -1.0]).astype(np.complex64) @ u
            w_eff = np.where(
                (np.arange(m) % 2 == 0)[:, None, None], w0[None], w1[None]
            ).astype(np.complex64)
        else:
            w_eff = np.broadcast_to(
                np.asarray(mimo.PMI_2TX_2L[pmi], dtype=np.complex64), (m, 2, 2)
            )
        wr = jnp.asarray(w_eff.real.astype(np.float32))
        wi = jnp.asarray(w_eff.imag.astype(np.float32))
        hr, hi = h[..., 0], h[..., 1]  # (B, rx, tx, m)
        heff_r = jnp.einsum("brtm,mtl->brlm", hr, wr) - jnp.einsum("brtm,mtl->brlm", hi, wi)
        heff_i = jnp.einsum("brtm,mtl->brlm", hr, wi) + jnp.einsum("brtm,mtl->brlm", hi, wr)
        heff = jnp.stack([heff_r, heff_i], axis=-1)
        x, csi = mimo.decode_zf2(y, heff, noise=None)
        streams = mimo.layer_demap(x, n_cw)
        if n_cw == 2:
            csi_streams = [csi[..., 0, :], csi[..., 1, :]]
        else:
            csi_streams = [csi.swapaxes(-1, -2).reshape(B, -1)]
    else:
        raise ValueError(tm)

    if softbufs is None:
        softbufs = [None] * n_cw
    llr_list = []
    for q, cfg in enumerate(cfg_list):
        llr = modem.demod_soft(streams[q], modem.MOD_FROM_QM[cfg.Qm])
        w = jnp.repeat(csi_streams[q], cfg.Qm, axis=-1)
        llr = llr * w
        c_init = scrambling.pdsch_cinit(rnti, q, sf_idx, cell.cell_id)
        llr_list.append(scrambling.scramble_llrs(llr, c_init))
    # At small batch the MAP recursions are latency-bound, so two equal-shaped
    # codewords share one decode_tb call (2B batch) — the same reasoning as the
    # per-K merge inside decode_tb (the reference instead spawns a coworker
    # thread per codeword, pdsch.c:333-390).  At large batch the decoder is
    # already throughput-bound and the concat only costs, so gate on B (static
    # at trace time): +14% at B=32, -2% at B=128 unmerged.
    if (n_cw == 2 and cfg_list[0] == cfg_list[1] and B <= 64
            and (softbufs[0] is None) == (softbufs[1] is None)):
        # (mixed None/non-None softbufs take the per-codeword path below:
        # merging would silently drop the one accumulated HARQ buffer)
        stacked = jnp.concatenate(llr_list, axis=0)
        sb_in = None
        if softbufs[0] is not None and softbufs[1] is not None:
            sb_in = [jnp.concatenate([a, b], axis=0)
                     for a, b in zip(softbufs[0], softbufs[1])]
        payload, ok, sb, _ = sch.decode_tb(stacked, cfg_list[0], sb_in,
                                           max_iter, llr_bits=llr_bits)
        outs = [payload[:B], payload[B:]]
        oks = [ok[:B], ok[B:]]
        sbs = [[w_[:B] for w_ in sb], [w_[B:] for w_ in sb]]
        return outs, oks, sbs
    outs, oks, sbs = [], [], []
    for q, cfg in enumerate(cfg_list):
        payload, ok, sb, _ = sch.decode_tb(llr_list[q], cfg, softbufs[q],
                                           max_iter, llr_bits=llr_bits)
        outs.append(payload)
        oks.append(ok)
        sbs.append(sb)
    return outs, oks, sbs


def decode(rx_grid, cfg: sch.SchConfig, cell: grid_mod.CellConfig, sf_idx: int,
           rnti: int, prb_mask: tuple, softbuf=None, max_iter: int = 8,
           codeword_q: int = 0, use_csi: bool = True,
           max_sym: int = 0, equalizer: str = "zf", llr_bits: int = 32,
           re_idx=None):
    """Decode one PDSCH grant from a received subframe grid (B, 14, NRE, 2).

    re_idx: optional (n_re,) RE index array, may be TRACED (see encode).
    Returns (payload bits (B, tbs), crc ok (B,), softbuf', ChestResult)."""
    llr, ch = soft_bits(rx_grid, cfg, cell, sf_idx, rnti, prb_mask,
                        codeword_q, use_csi, max_sym, equalizer, re_idx)
    payload, ok, softbuf, n_it = sch.decode_tb(llr, cfg, softbuf, max_iter,
                                               llr_bits=llr_bits)
    return payload, ok, softbuf, ch


def soft_bits(rx_grid, cfg: sch.SchConfig, cell: grid_mod.CellConfig,
              sf_idx: int, rnti: int, prb_mask: tuple, codeword_q: int = 0,
              use_csi: bool = True, max_sym: int = 0, equalizer: str = "zf",
              re_idx=None):
    """The receive front end of `decode`: channel estimate, equalize, soft
    demod, CSI weighting, descramble.  Returns (codeword LLRs (B, G),
    ChestResult)."""
    if re_idx is None:
        re_idx = jnp.asarray(
            grid_mod.pdsch_re_indices(cell, sf_idx, prb_mask, max_sym))
    ch = chest.estimate(rx_grid, cell, sf_idx)
    flat_rx = rx_grid.reshape(rx_grid.shape[:-3] + (cell.n_sym * cell.nre, 2))
    flat_ce = ch.ce.reshape(flat_rx.shape)
    y = jnp.take(flat_rx, re_idx, axis=-2)
    h = jnp.take(flat_ce, re_idx, axis=-2)
    if equalizer == "mmse":
        x_eq, csi = chest.equalize_mmse(y, h, ch.noise_est)
    else:
        x_eq, csi = chest.equalize_zf(y, h)
    llr = modem.demod_soft(x_eq, modem.MOD_FROM_QM[cfg.Qm])  # (B, G)
    if use_csi:
        qm = cfg.Qm
        w = jnp.repeat(csi, qm, axis=-1)
        llr = llr * w
    c_init = scrambling.pdsch_cinit(rnti, codeword_q, sf_idx, cell.cell_id)
    return scrambling.scramble_llrs(llr, c_init), ch


# ---------------- TM7: single-layer beamforming on port 5 ----------------

def encode_tm7(tb_bits, cfg: sch.SchConfig, cell: grid_mod.CellConfig,
               sf_idx: int, rnti: int, prb_mask: tuple, beam):
    """TM7: one layer beamformed over the physical antennas with UE-specific
    RS on port 5 (pdsch.c TM7 / refsignal_dl.c UE-RS; 36.211 §6.10.3).

    beam: (n_tx, 2) cf beamforming vector (transparent to the UE).
    Returns per-antenna grids (B, n_tx, n_sym, NRE, 2) with CRS per cell port
    and the UE-RS + PDSCH beamformed."""
    re_idx = grid_mod.pdsch_re_indices_tm7(cell, sf_idx, prb_mask)
    assert cfg.G == len(re_idx) * cfg.Qm, (cfg.G, len(re_idx), cfg.Qm)
    cw = sch.encode_tb(tb_bits, cfg)
    c_init = scrambling.pdsch_cinit(rnti, 0, sf_idx, cell.cell_id)
    scr = scrambling.scramble_bits(cw, c_init)
    x = modem.modulate(scr, modem.MOD_FROM_QM[cfg.Qm])  # (B, n_re, 2)
    B = x.shape[0]
    n_tx = beam.shape[0]
    # UE-RS values and positions (within allocated PRBs only)
    ks = grid_mod.uers5_k(cell.cell_id, cell.n_prb)
    vals = grid_mod.uers5_values(cell.cell_id, sf_idx, rnti, cell.n_prb)
    alloc = np.zeros(cell.nre, dtype=bool)
    for prb, on in enumerate(prb_mask):
        if on:
            alloc[12 * prb : 12 * (prb + 1)] = True
    uers_idx, uers_vals = [], []
    for i, sym in enumerate(grid_mod.UERS5_SYMS):
        sel = alloc[ks[i]]
        uers_idx.append(sym * cell.nre + ks[i][sel])
        uers_vals.append(vals[i][sel])
    uers_idx = np.concatenate(uers_idx).astype(np.int32)
    uers_vals = cplx.from_numpy(np.concatenate(uers_vals))

    grids = cplx.zeros((B, n_tx, cell.n_sym, cell.nre))
    flat = grids.reshape(B, n_tx, cell.n_sym * cell.nre, 2)
    for a in range(n_tx):
        b_a = beam[a]  # (2,)
        bx = cplx.mul(x, jnp.broadcast_to(b_a, x.shape))
        br = cplx.mul(jnp.asarray(uers_vals),
                      jnp.broadcast_to(b_a, uers_vals.shape))
        flat = flat.at[:, a, jnp.asarray(re_idx), :].set(bx)
        flat = flat.at[:, a, jnp.asarray(uers_idx), :].set(
            jnp.broadcast_to(br, (B,) + br.shape))
    grids = flat.reshape(B, n_tx, cell.n_sym, cell.nre, 2)
    for p in range(min(cell.n_ports, n_tx)):
        grids = grids.at[:, p].set(put_crs(grids[:, p], cell, sf_idx, port=p))
    return grids


def decode_tm7(rx_grids, cfg: sch.SchConfig, cell: grid_mod.CellConfig,
               sf_idx: int, rnti: int, prb_mask: tuple,
               softbuf=None, max_iter: int = 8):
    """TM7 decode: effective (beamformed) channel estimated directly from the
    port-5 UE-RS — the beam is transparent; MRC over rx antennas."""
    B, n_rx = rx_grids.shape[:2]
    re_idx = grid_mod.pdsch_re_indices_tm7(cell, sf_idx, prb_mask)
    ks = grid_mod.uers5_k(cell.cell_id, cell.n_prb)
    vals = grid_mod.uers5_values(cell.cell_id, sf_idx, rnti, cell.n_prb)
    flat = rx_grids.reshape(B, n_rx, cell.n_sym * cell.nre, 2)
    # LS at UE-RS, then freq+time interpolation to the full grid
    h_f = []
    for i, sym in enumerate(grid_mod.UERS5_SYMS):
        idx = (sym * cell.nre + ks[i]).astype(np.int32)
        y = jnp.take(flat, jnp.asarray(idx), axis=-2)  # (B, rx, P, 2)
        r = cplx.from_numpy(vals[i])
        h_ls = cplx.mul_conj(y, jnp.asarray(r))
        fm = chest.interp_matrix(tuple(ks[i].tolist()), cell.nre)
        h_f.append(jnp.einsum("kp,...pc->...kc", jnp.asarray(fm), h_ls))
    h_f = jnp.stack(h_f, axis=-3)  # (B, rx, 4, NRE, 2)
    tm = chest._time_interp_matrix(grid_mod.UERS5_SYMS, cell.n_sym)
    ce = jnp.einsum("ls,...skc->...lkc", jnp.asarray(tm), h_f)
    ce_flat = ce.reshape(B, n_rx, cell.n_sym * cell.nre, 2)
    y = jnp.take(flat, jnp.asarray(re_idx), axis=-2)
    h = jnp.take(ce_flat, jnp.asarray(re_idx), axis=-2)
    x, csi = mimo.decode_mrc_eff(y, h)
    llr = modem.demod_soft(x, modem.MOD_FROM_QM[cfg.Qm])
    llr = llr * jnp.repeat(csi, cfg.Qm, axis=-1)
    c_init = scrambling.pdsch_cinit(rnti, 0, sf_idx, cell.cell_id)
    llr = scrambling.scramble_llrs(llr, c_init)
    return sch.decode_tb(llr, cfg, softbuf, max_iter)


# ---------------- TM8: dual-layer beamforming on ports 7/8 ----------------

def encode_tm8(tb_list, cfg_list, cell: grid_mod.CellConfig, sf_idx: int,
               rnti: int, prb_mask: tuple, beams):
    """TM8 (Rel-9): up to 2 layers, each beamformed over the physical
    antennas, DMRS on ports 7/8 sharing REs separated by a length-2 OCC
    over adjacent symbol pairs (36.211 §6.10.3; pdsch.c TM8).

    beams: (n_layers, n_tx, 2) cf.  Returns (B, n_tx, n_sym, NRE, 2)."""
    n_layers = beams.shape[0]
    n_tx = beams.shape[1]
    assert len(tb_list) == len(cfg_list) <= 2
    re_idx = grid_mod.pdsch_re_indices_tm8(cell, sf_idx, prb_mask)
    cw_syms = []
    for q, (tb, cfg) in enumerate(zip(tb_list, cfg_list)):
        cw = sch.encode_tb(tb, cfg)
        c_init = scrambling.pdsch_cinit(rnti, q, sf_idx, cell.cell_id)
        scr = scrambling.scramble_bits(cw, c_init)
        cw_syms.append(modem.modulate(scr, modem.MOD_FROM_QM[cfg.Qm]))
    layers = mimo.layer_map(cw_syms, n_layers)  # (B, L, n_re, 2)
    B = layers.shape[0]
    assert layers.shape[-2] == len(re_idx), (layers.shape, len(re_idx))

    # DMRS (within allocated PRBs)
    ks = grid_mod.uers78_k(cell.cell_id, cell.n_prb)
    vals = grid_mod.uers78_values(cell.cell_id, sf_idx, 0, cell.n_prb)
    alloc = np.zeros(cell.nre, dtype=bool)
    for prb, on in enumerate(prb_mask):
        if on:
            alloc[12 * prb : 12 * (prb + 1)] = True
    sel = alloc[ks]
    grids = cplx.zeros((B, n_tx, cell.n_sym, cell.nre))
    flat = grids.reshape(B, n_tx, cell.n_sym * cell.nre, 2)
    for a in range(n_tx):
        # PDSCH: sum of beamformed layers
        acc = None
        for l in range(n_layers):
            b_al = beams[l, a]
            term = cplx.mul(layers[:, l], jnp.broadcast_to(b_al, layers[:, l].shape))
            acc = term if acc is None else acc + term
        flat = flat.at[:, a, jnp.asarray(re_idx), :].set(acc / np.sqrt(n_layers))
        # DMRS: per port OCC over each adjacent symbol pair
        for l in range(n_layers):
            port = 7 + l
            occ = grid_mod.UERS78_OCC[port]
            b_al = beams[l, a]
            for i, sym in enumerate(grid_mod.UERS78_SYMS):
                w = occ[i % 2]
                r = cplx.from_numpy(vals[i][sel] * w)
                br = cplx.mul(jnp.asarray(r), jnp.broadcast_to(b_al, r.shape))
                idx = (sym * cell.nre + ks[sel]).astype(np.int32)
                cur = flat[:, a, jnp.asarray(idx), :]
                flat = flat.at[:, a, jnp.asarray(idx), :].set(
                    cur + jnp.broadcast_to(br, cur.shape))
    grids = flat.reshape(B, n_tx, cell.n_sym, cell.nre, 2)
    for p in range(min(cell.n_ports, n_tx)):
        grids = grids.at[:, p].set(put_crs(grids[:, p], cell, sf_idx, port=p))
    return grids


def decode_tm8(rx_grids, cfg_list, cell: grid_mod.CellConfig, sf_idx: int,
               rnti: int, prb_mask: tuple, softbufs=None, max_iter: int = 8):
    """TM8 decode: OCC despreading separates the per-layer effective
    channels from the shared DMRS REs; 2x2 ZF across layers."""
    B, n_rx = rx_grids.shape[:2]
    n_layers = 2
    re_idx = grid_mod.pdsch_re_indices_tm8(cell, sf_idx, prb_mask)
    ks = grid_mod.uers78_k(cell.cell_id, cell.n_prb)
    vals = grid_mod.uers78_values(cell.cell_id, sf_idx, 0, cell.n_prb)
    alloc = np.zeros(cell.nre, dtype=bool)
    for prb, on in enumerate(prb_mask):
        if on:
            alloc[12 * prb : 12 * (prb + 1)] = True
    sel = alloc[ks]
    flat = rx_grids.reshape(B, n_rx, cell.n_sym * cell.nre, 2)
    kp = tuple(ks[sel].tolist())
    fm = jnp.asarray(chest.interp_matrix(kp, cell.nre))
    # LS per DMRS symbol
    h_ls = []
    for i, sym in enumerate(grid_mod.UERS78_SYMS):
        idx = (sym * cell.nre + ks[sel]).astype(np.int32)
        y = jnp.take(flat, jnp.asarray(idx), axis=-2)
        r = cplx.from_numpy(vals[i][sel])
        h_ls.append(cplx.mul_conj(y, jnp.asarray(r)))
    ces = []
    for l in range(n_layers):
        occ = grid_mod.UERS78_OCC[7 + l]
        # despread each symbol pair -> one estimate per pair
        pair_h = [(h_ls[0] * occ[0] + h_ls[1] * occ[1]) / 2.0,
                  (h_ls[2] * occ[0] + h_ls[3] * occ[1]) / 2.0]
        pair_syms = (grid_mod.UERS78_SYMS[0], grid_mod.UERS78_SYMS[2])
        h_f = jnp.stack([
            jnp.einsum("kp,...pc->...kc", fm, ph) for ph in pair_h], axis=-3)
        tmm = jnp.asarray(chest._time_interp_matrix(pair_syms, cell.n_sym))
        ces.append(jnp.einsum("ls,...skc->...lkc", tmm, h_f))
    ce = jnp.stack(ces, axis=2)  # (B, rx, L, n_sym, NRE, 2)
    ce_flat = ce.reshape(B, n_rx, n_layers, cell.n_sym * cell.nre, 2)
    y = jnp.take(flat, jnp.asarray(re_idx), axis=-2)
    # data REs carry sum(b_l x_l)/sqrt(L) while DMRS carries b_l unscaled:
    # scale the estimated channel down to match the data REs
    h = jnp.take(ce_flat, jnp.asarray(re_idx), axis=-2) / np.sqrt(n_layers)
    x, csi = mimo.decode_zf2(y, h)
    n_cw = len(cfg_list)
    streams = mimo.layer_demap(x, n_cw)
    if n_cw == 2:
        csi_streams = [csi[..., 0, :], csi[..., 1, :]]
    else:
        csi_streams = [csi.swapaxes(-1, -2).reshape(B, -1)]
    outs, oks, sbs = [], [], []
    if softbufs is None:
        softbufs = [None] * n_cw
    for q, cfg in enumerate(cfg_list):
        llr = modem.demod_soft(streams[q], modem.MOD_FROM_QM[cfg.Qm])
        llr = llr * jnp.repeat(csi_streams[q], cfg.Qm, axis=-1)
        c_init = scrambling.pdsch_cinit(rnti, q, sf_idx, cell.cell_id)
        llr = scrambling.scramble_llrs(llr, c_init)
        payload, ok, sb, _ = sch.decode_tb(llr, cfg, softbufs[q], max_iter)
        outs.append(payload)
        oks.append(ok)
        sbs.append(sb)
    return outs, oks, sbs
