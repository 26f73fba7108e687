"""Device-resident waveform steady state: T TTIs per device call.

After attach, an SPS-configured cell's steady state is a fixed per-UE
periodic grant pattern with no per-TTI PDCCH (36.213 §10.1/§8.1.2
semi-persistent scheduling; the repo's MAC SPS lives in stack/sps.py and
the reference's in srsenb mac/scheduler).  This module compiles ONE XLA
program that runs T TTIs x n_ues of the FULL PHY in both directions:

  eNB DL:  per-sf base grid (CRS / PSS+SSS / PCFICH / PBCH, gathered
           from a (10, ...) constant stack) + all UEs' SPS PDSCH
           encodes -> OFDM modulate -> per-link pathloss + fresh AWGN
  UE rx:   OFDM demod -> CRS chest (traced-sf value gather) -> per-UE
           PDSCH gather/equalize/demod/descramble -> turbo decode + CRC
  UE tx:   SPS PUSCH encode (SC-FDMA) + PUCCH format-1 HARQ-ACK on the
           UE's dedicated resource (the n1PUCCH-AN-persistent role,
           rrc_wire.py sps-config) -> OFDM modulate -> superpose + AWGN
  eNB rx:  OFDM demod -> per-UE DMRS chest -> PUSCH decode + CRC ->
           PUCCH matched filter (ACK detect + value)

The T axis is a BATCH axis (SURVEY §7.7 "time-block batch"): given the
payloads, TTIs are independent — SPS TBs carry no per-TTI HARQ state
(losses recover via RLC AM, exactly the stack's own SPS convention in
ue_stack.tb_decoded), so the whole block is an embarrassingly parallel
(T * n_ues)-deep batch that keeps the device busy.  The host's
only per-block work is moving MAC PDU payload bits in and decoded bits
out; all per-TTI control flow is gone.  This is the batched analogue of the
reference's sf_worker TTI pipeline (srsenb/src/phy/txrx.cc:105-145) with
the pipeline depth promoted to a device batch axis.

Constraints (checked at build): all SPS DL allocations avoid the centre
6 PRBs (PSS/SSS/PBCH region), so the PDSCH RE map is identical for every
subframe and one static per-UE index table serves the whole block.  The
PBCH content is the block-start frame's MIB (camped UEs don't re-read
it; the REs stay occupied at true power, so overhead is honest).
"""

from __future__ import annotations

import functools
import typing

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import cplx, dft, mimo, modem, ofdm, scrambling
from ..phch import chest, grid as grid_mod, pbch as pbch_mod
from ..phch import pcfich as pcfich_mod, pdsch as pdsch_mod
from ..phch import pucch as pucch_mod, pusch as pusch_mod, ra
from ..phch import sch, sync as sync_mod


class BlockConfig(typing.NamedTuple):
    """Static SPS steady-state description (one compiled program each)."""

    cell: grid_mod.CellConfig
    rntis: tuple  # per-UE C-RNTI
    dl_rb_start: tuple  # per-UE DL alloc start (contiguous, equal width)
    dl_l_crbs: int
    dl_mcs: int
    ul_rb_start: tuple  # per-UE UL alloc start
    ul_l_prb: int
    ul_mcs: int
    ack_res: tuple  # per-UE dedicated PUCCH format-1 resource
    snr_db: tuple  # per-UE link SNR (pathloss + powers folded in)
    T: int  # TTIs per block
    llr_bits: int = 32
    # TM3 large-delay-CDD 2x2 downlink (36.211 §6.3.4.2.2): two
    # codewords, one per layer, through a fixed per-UE 2x2 channel with
    # condition number mimo_cond_db (0 = unitary; ~60 dB ~= rank-1, the
    # rank-fallback control).  Requires cell.n_ports == 2.  Sync/PBCH/
    # PCFICH stay on port 0 (the block models steady state, not
    # acquisition).  UL stays SISO, like the reference's eNB.
    tm3: bool = False
    mimo_cond_db: float = 0.0
    mimo_seed: int = 1

    @property
    def n_ues(self) -> int:
        return len(self.rntis)

    @property
    def dl_tbs(self) -> int:
        return ra.dl_tbs(self.dl_mcs, self.dl_l_crbs)

    @property
    def ul_tbs(self) -> int:
        return ra.ul_tbs(self.ul_mcs, self.ul_l_prb)


def centre_prbs(n_prb: int) -> tuple:
    """[lo, hi) PRBs touched by the centre-72-subcarrier PSS/SSS/PBCH
    region — NOT PRB-aligned for odd n_prb (the region spans half-PRBs,
    e.g. 4.5..10.5 at 15 PRB)."""
    lo = (6 * n_prb - 36) // 12
    hi = -(-(6 * n_prb + 36) // 12)
    return lo, hi


def _dl_re_tables(cfg: BlockConfig) -> np.ndarray:
    """(n_ues, n_re) PDSCH RE indices, proven subframe-invariant."""
    cell = cfg.cell
    c0, c1 = centre_prbs(cell.n_prb)
    idx = []
    for rb in cfg.dl_rb_start:
        assert rb + cfg.dl_l_crbs <= c0 or rb >= c1, (
            f"SPS DL alloc [{rb}, {rb + cfg.dl_l_crbs}) overlaps the"
            f" centre PRBs [{c0}, {c1}) (PSS/SSS/PBCH region)")
        mask = ra.type2_to_prb_mask(rb, cfg.dl_l_crbs, cell.n_prb)
        per_sf = [grid_mod.pdsch_re_indices(cell, sf, mask)
                  for sf in (0, 1, 5)]
        assert all(np.array_equal(per_sf[0], p) for p in per_sf[1:]), \
            "DL RE map varies with sf despite centre avoidance"
        idx.append(np.asarray(per_sf[0], np.int32))
    lens = {len(i) for i in idx}
    assert len(lens) == 1, f"unequal DL RE counts: {lens}"
    return np.stack(idx)


def _base_grids(cfg: BlockConfig, sfn0: int) -> np.ndarray:
    """(10, n_sym, NRE, 2) base subframes: CRS + PSS/SSS + PCFICH + PBCH
    (phase sfn0%4, MIB of frame sfn0).  With tm3: (10, 2, n_sym, NRE, 2)
    per-port grids — port 1 carries only its own CRS (zeros at port-0
    CRS positions and vice versa, per 36.211 §6.10.1.2)."""
    cell = cfg.cell
    mib = np.asarray(pbch_mod.pack_mib(cell.n_prb, sfn0))[None].astype(np.int8)
    outs = []
    for sf in range(10):
        g = cplx.zeros((1, grid_mod.N_SYM, cell.nre))
        g = sync_mod.put_pss_sss(g, cell, sf)
        g = pdsch_mod.put_crs(g, cell, sf)
        g = pcfich_mod.encode(jnp.full((1,), cell.cfi, jnp.int32),
                              cell, sf, g)
        if sf == 0:
            g = pbch_mod.encode(jnp.asarray(mib), cell, sfn0 % 4, g)
        if cfg.tm3:
            g1 = pdsch_mod.put_crs(
                cplx.zeros((1, grid_mod.N_SYM, cell.nre)), cell, sf, port=1)
            outs.append(np.stack([np.asarray(g)[0], np.asarray(g1)[0]]))
        else:
            outs.append(np.asarray(g)[0])
    return np.stack(outs)


def _pucch_tables(cfg: BlockConfig):
    """Per-UE format-1 tables on the UE's dedicated resource.

    Returns (pos (n, 2, 7, 12) int32 flat grid indices,
             vals (10, n, 2, 7, 12, 2) float per-sf unit waveforms,
             data_mask (7,) float 1.0 on data symbols).
    Positions are sf-independent (slot-hop parity (m + ns) % 2 depends
    on the slot index parity only through ns%2, which matches s)."""
    cell = cfg.cell
    n = cfg.n_ues
    pos = np.zeros((n, 2, 7, 12), np.int32)
    vals = np.zeros((10, n, 2, 7, 12), np.complex64)
    for u, res in enumerate(cfg.ack_res):
        for sf in range(10):
            wf = pucch_mod._f1_waveform(cell.cell_id, sf, res)
            vals[sf, u] = wf
        for s in range(2):
            prb = pucch_mod.pucch_prb(res, s, cell.n_prb)
            # check the slot-hop parity really is sf-independent
            for sf in range(10):
                assert pucch_mod.pucch_prb(res, 2 * sf + s, cell.n_prb) \
                    == prb
            ks = 12 * prb + np.arange(12)
            for l in range(7):
                pos[u, s, l] = (7 * s + l) * cell.nre + ks
    dmask = np.zeros(7, np.float32)
    for l in pucch_mod.F1_DATA_SYMS:
        dmask[l] = 1.0
    return pos, cplx.from_numpy(vals), dmask


def _cell_consts(cfg: BlockConfig, sfn0: int = 0) -> dict:
    """Every cell-identity-dependent table the block body needs, as plain
    arrays — so one traced body can serve MANY cells (the sharded
    multi-cell path gathers/receives these per shard)."""
    cell = cfg.cell
    dl_idx = _dl_re_tables(cfg)
    ul_data = np.stack([pusch_mod.re_indices(cell.n_prb, rb, cfg.ul_l_prb)[0]
                        for rb in cfg.ul_rb_start])  # (n, 12, m_sc)
    ul_dmrs = np.stack([pusch_mod.re_indices(cell.n_prb, rb, cfg.ul_l_prb)[1]
                        for rb in cfg.ul_rb_start])  # (n, 2, m_sc)
    # the shared-UL-grid scatter (.set) requires disjoint PUSCH allocs —
    # overlaps would drop a UE's REs instead of superposing them
    flat_ul = np.concatenate([ul_data.reshape(-1), ul_dmrs.reshape(-1)])
    assert len(np.unique(flat_ul)) == flat_ul.size, \
        "overlapping UL PUSCH allocations"
    p_pos, p_vals, p_dmask = _pucch_tables(cfg)
    # DL CRS chest tables, RE-SPARSE: the block UE never materializes a
    # full-grid channel estimate — the 2D interpolation (chest.estimate's
    # freq matrix x time matrix) is pre-restricted to the REs the UE
    # actually equalizes.  Per UE: its K unique PDSCH subcarriers
    # (dl_kfm = freq-interp rows at those columns), a column index per
    # data RE (dl_col), and the time-interp weights per data RE (dl_tw,
    # the tmat row of the RE's OFDM symbol).
    ports = (0, 1) if cfg.tm3 else (0,)
    pidx_p, crs10_p, kfm_p = [], [], []
    K = 12 * cfg.dl_l_crbs
    dl_col, dl_tw = [], []
    for port in ports:
        ks = grid_mod.crs_k(cell.cell_id, cell.n_prb, port, cell.cp)
        syms = grid_mod.pilot_syms(port, cell.cp)
        assert syms == grid_mod.pilot_syms(0, cell.cp)  # shared dl_tw
        pidx_p.append(
            (np.asarray(syms)[:, None] * cell.nre + ks).astype(np.int32))
        crs10_p.append(
            chest._crs_values10(cell.cell_id, cell.n_prb, port, cell.cp))
        fm = np.stack([chest._freq_interp_matrix(cell.n_prb, int(ks[i][0]))
                       for i in range(len(syms))])  # (S_pil, NRE, P)
        tmat = chest._time_interp_matrix(tuple(syms), cell.n_sym)
        kfm_u = []
        for u in range(cfg.n_ues):
            sym_u, k_u = dl_idx[u] // cell.nre, dl_idx[u] % cell.nre
            kcols, inv = np.unique(k_u, return_inverse=True)
            assert len(kcols) == K, (len(kcols), K)
            if port == 0:
                dl_col.append(inv)
                dl_tw.append(tmat[sym_u])   # (n_re, S_pil)
            kfm_u.append(fm[:, kcols, :])   # (S_pil, K, P)
        kfm_p.append(np.stack(kfm_u))
    pidx = pidx_p[0] if not cfg.tm3 else np.stack(pidx_p)
    crs10 = crs10_p[0] if not cfg.tm3 else np.stack(crs10_p)
    extra = {}
    if cfg.tm3:
        assert cell.n_ports == 2, "tm3 requires CellConfig(n_ports=2)"
        # fixed per-UE 2x2 channel: unitary x diag(1, 10^(-cond/20)) x
        # unitary, mean |h|^2 normalized to 1 (the per-link amp/snr_db
        # scaling stays in charge of the link budget)
        rng = np.random.default_rng(cfg.mimo_seed)
        h2 = np.zeros((cfg.n_ues, 2, 2, 2), np.float32)
        for u in range(cfg.n_ues):
            q1 = np.linalg.qr(rng.normal(size=(2, 2))
                              + 1j * rng.normal(size=(2, 2)))[0]
            q2 = np.linalg.qr(rng.normal(size=(2, 2))
                              + 1j * rng.normal(size=(2, 2)))[0]
            h = q1 @ np.diag(
                [1.0, 10.0 ** (-cfg.mimo_cond_db / 20.0)]) @ q2.conj().T
            h = h / np.sqrt((np.abs(h) ** 2).mean())
            h2[u, ..., 0], h2[u, ..., 1] = h.real, h.imag
        extra["h2"] = h2
    return dict(
        **extra,
        cell_id=np.int32(cell.cell_id),
        rntis=np.asarray(cfg.rntis, np.int64),
        amp=(10.0 ** (-np.asarray(cfg.snr_db, np.float32) / 20.0)),
        base10=np.asarray(_base_grids(cfg, sfn0)),
        dl_idx=dl_idx.astype(np.int32),
        ul_data=ul_data.astype(np.int32), ul_dmrs=ul_dmrs.astype(np.int32),
        dmrs10=np.asarray(cplx.from_numpy(
            pusch_mod._dmrs10(cell.cell_id, cfg.ul_l_prb))),
        p_pos=p_pos.astype(np.int32), p_vals=np.asarray(p_vals),
        p_dmask=np.asarray(p_dmask),
        ch_pidx=pidx, ch_vals10=np.asarray(cplx.from_numpy(crs10)),
        dl_col=np.stack(dl_col).astype(np.int32),
        dl_tw=np.stack(dl_tw).astype(np.float32),
        dl_kfm=(kfm_p[0] if not cfg.tm3
                else np.stack(kfm_p)).astype(np.float32),
    )


def _step_body(cfg: BlockConfig, c: dict, dl_bits, ul_bits, key, tti0):
    """One T-TTI block; `c` holds every cell-dependent table (may be
    traced — the sharded path feeds per-device slices)."""
    cell = cfg.cell
    n, T = cfg.n_ues, cfg.T
    qm_d = ra.dl_mcs_to_qm(cfg.dl_mcs)
    qm_u = ra.ul_mcs_to_qm(cfg.ul_mcs)
    n_re_d = c["dl_idx"].shape[-1]
    cfg_d = sch.SchConfig(tbs=cfg.dl_tbs, G=n_re_d * qm_d, Qm=qm_d, Nl=1)
    m_sc = 12 * cfg.ul_l_prb
    cfg_u = sch.SchConfig(tbs=cfg.ul_tbs, G=m_sc * 12 * qm_u, Qm=qm_u, Nl=1)
    S = grid_mod.N_SYM * cell.nre
    dl_idx, ul_data, ul_dmrs = c["dl_idx"], c["ul_data"], c["ul_dmrs"]
    p_pos, p_vals, p_dmask = c["p_pos"], c["p_vals"], c["p_dmask"]
    rntis, amp = c["rntis"], c["amp"]
    if True:
        sfs = (tti0 + jnp.arange(T, dtype=jnp.int32)) % 10  # (T,)
        k_dl, k_ul = jax.random.split(key)

        # ---------------- eNB DL encode ----------------
        cinit_d = ((rntis[None, :] << 14) + (sfs[:, None] << 9)
                   + c["cell_id"]).reshape(-1)  # (T*n,)
        if cfg.tm3:
            # two codewords, one per layer (36.211 two-layer mapping);
            # q rides bit 13 of the scrambling cinit (36.211 §6.3.1)
            cinits = [cinit_d + (q << 13) for q in (0, 1)]
            layers = jnp.stack([
                modem.modulate(scrambling.scramble_bits(
                    sch.encode_tb(dl_bits[:, :, q].reshape(T * n, cfg.dl_tbs),
                                  cfg_d), cinits[q]),
                    modem.MOD_FROM_QM[qm_d])
                for q in (0, 1)], axis=-3)  # (T*n, 2, n_re, 2)
            ports = mimo.precode_cdd2(layers)  # (T*n, 2p, n_re, 2)
            grids = jnp.take(c["base10"], sfs, axis=0)  # (T, 2, 14, NRE, 2)
            flat = grids.reshape(T, 2, S, 2)
            pp = ports.reshape(T, n, 2, n_re_d, 2)
            for p in (0, 1):
                flat = flat.at[:, p, dl_idx.reshape(-1), :].set(
                    pp[:, :, p].reshape(T, n * n_re_d, 2))
            tx = ofdm.modulate(
                flat.reshape(T * 2, grid_mod.N_SYM, cell.nre, 2),
                cell.n_prb)
        else:
            cw = sch.encode_tb(dl_bits.reshape(T * n, cfg.dl_tbs), cfg_d)
            scr = scrambling.scramble_bits(cw, cinit_d)
            syms = modem.modulate(scr, modem.MOD_FROM_QM[qm_d])  # (T*n, re, 2)
            grids = jnp.take(c["base10"], sfs, axis=0)  # (T, 14, NRE, 2)
            flat = grids.reshape(T, S, 2)
            flat = flat.at[:, dl_idx.reshape(-1), :].set(
                syms.reshape(T, n * n_re_d, 2))
            tx = ofdm.modulate(flat.reshape(T, grid_mod.N_SYM, cell.nre, 2),
                               cell.n_prb)  # (T, sf_len, 2)

        # ---------------- DL channel + UE receive (RE-sparse) --------
        # ONE OFDM demod of the cell waveform serves every UE; per-link
        # AWGN is drawn directly on the demodulated REs each UE consumes
        # (its PDSCH REs + CRS pilots).  The DFT is unitary (ops/dft.py
        # ortho), so white noise added per-RE after the FFT is
        # distribution-identical to time-domain injection — but costs
        # O(REs used) instead of O(n_ues x waveform), and the full-grid
        # per-UE demod/CE intermediates (the block's former HBM
        # bottleneck: 2 x (T*n, 14, NRE) float arrays) never exist.
        S_pil, P = c["ch_pidx"].shape[-2:]
        k_d1, k_d2 = jax.random.split(k_dl)
        a2 = amp / np.sqrt(2)
        if cfg.tm3:
            rg_tx = ofdm.demodulate(tx, cell.n_prb).reshape(T, 2, S, 2)
            h2 = jnp.asarray(c["h2"])  # (n, 2rx, 2tx, 2)
            # data REs: mix both ports through the per-UE 2x2, per-rx
            # independent AWGN at the link amp
            tp = jnp.stack([
                jnp.take(rg_tx[:, p], dl_idx.reshape(-1), axis=-2)
                .reshape(T, n, n_re_d, 2) for p in (0, 1)],
                axis=2)  # (T, n, 2tx, re, 2)
            y = (cplx.mul(h2[None, :, :, :, None], tp[:, :, None]).sum(3)
                 + a2[None, :, None, None, None]
                 * jax.random.normal(k_d1, (T, n, 2, n_re_d, 2)))
            # pilots: at port-p CRS positions the other port is silent,
            # so LS per (rx, port) comes straight from the mixed signal
            pt = jnp.stack([
                jnp.take(rg_tx[:, p], c["ch_pidx"][p].reshape(-1), axis=-2)
                for p in (0, 1)], axis=1)  # (T, 2tx, S_pil*P, 2)
            y_pil = (cplx.mul(
                h2[None, :, :, :, None],
                pt.reshape(T, 1, 1, 2, S_pil * P, 2))
                + a2[None, :, None, None, None, None]
                * jax.random.normal(
                    k_d2, (T, n, 2, 2, S_pil * P, 2)))
            r_p = jnp.take(c["ch_vals10"], sfs, axis=1)  # (2, T, S_pil, P, 2)
            h_ls = cplx.mul_conj(
                y_pil.reshape(T, n, 2, 2, S_pil, P, 2),
                jnp.moveaxis(r_p, 0, 1)[:, None, None])  # (T,n,a,p,S,P,2)
            # a = rx antenna, p = tx port, s = pilot symbol, k = unique
            # subcarrier column, q = pilot index, e = data RE
            h_f = jnp.einsum("puskq,tuapsqc->tuapskc", c["dl_kfm"], h_ls)
            h_re = jnp.take_along_axis(
                h_f, c["dl_col"][None, :, None, None, None, :, None],
                axis=5)
            h = jnp.einsum("ues,tuapsec->tuapec", c["dl_tw"], h_re)
            # fold the CDD precoder into the channel:
            # P(i) = (1/2) [[1, 1], [s_i, -s_i]]  (s_i = (-1)^i)
            sgn = jnp.asarray(np.where(
                np.arange(n_re_d) % 2 == 0, 1.0, -1.0).astype(np.float32))
            hp0, hp1 = h[:, :, :, 0], h[:, :, :, 1]  # (T,n,r,re,2)
            heff = jnp.stack(
                [(hp0 + hp1 * sgn[None, None, None, :, None]) * 0.5,
                 (hp0 - hp1 * sgn[None, None, None, :, None]) * 0.5],
                axis=3)  # (T, n, r, p=layer, re, 2)
            x_eq, csi2 = mimo.decode_zf2(y, heff)
            oks, outs = [], []
            for q in (0, 1):
                llr = modem.demod_soft(
                    x_eq[:, :, q].reshape(T * n, n_re_d, 2),
                    modem.MOD_FROM_QM[qm_d])
                llr = llr * jnp.repeat(
                    jnp.clip(csi2[:, :, q], 0.0, 1e3)
                    .reshape(T * n, n_re_d), qm_d, axis=-1)
                llr = scrambling.scramble_llrs(llr, cinits[q])
                o, k, _, _ = sch.decode_tb(llr, cfg_d,
                                           llr_bits=cfg.llr_bits)
                outs.append(o)
                oks.append(k)
            dl_out = jnp.stack(outs, axis=1).reshape(T, n, 2, -1)
            dl_ok2 = jnp.stack(oks, axis=1).reshape(T, n, 2)
            dl_ok = dl_ok2.all(-1)  # spatial-bundled ACK (both codewords)
        else:
            rg_tx = ofdm.demodulate(tx, cell.n_prb).reshape(T, S, 2)
            y = (jnp.take(rg_tx, dl_idx.reshape(-1), axis=-2)
                 .reshape(T, n, n_re_d, 2)
                 + a2[None, :, None, None]
                 * jax.random.normal(k_d1, (T, n, n_re_d, 2)))
            p_tx = jnp.take(rg_tx, c["ch_pidx"].reshape(-1), axis=-2)
            y_p = (p_tx.reshape(T, 1, S_pil, P, 2)
                   + a2[None, :, None, None, None]
                   * jax.random.normal(k_d2, (T, n, S_pil, P, 2)))
            r_p = jnp.take(c["ch_vals10"], sfs, axis=0)  # (T, S_pil, P, 2)
            h_ls = cplx.mul_conj(y_p, r_p[:, None])  # (T, n, S_pil, P, 2)
            h_f = jnp.einsum("uskp,tuspc->tuskc", c["dl_kfm"], h_ls)
            h_re = jnp.take_along_axis(
                h_f, c["dl_col"][None, :, None, :, None], axis=3)
            h = jnp.einsum("urs,tusrc->turc", c["dl_tw"], h_re)
            x_eq, csi = chest.equalize_zf(y, h)
            llr = modem.demod_soft(x_eq.reshape(T * n, n_re_d, 2),
                                   modem.MOD_FROM_QM[qm_d])
            llr = llr * jnp.repeat(csi.reshape(T * n, n_re_d), qm_d, axis=-1)
            llr = scrambling.scramble_llrs(llr, cinit_d)
            dl_out, dl_ok, _, _ = sch.decode_tb(llr, cfg_d,
                                                llr_bits=cfg.llr_bits)

        # ---------------- UE transmit: SPS PUSCH + PUCCH ACK ----------
        cinit_u = ((rntis[None, :] << 14) + (sfs[:, None] << 9)
                   + c["cell_id"]).reshape(-1)
        cw_u = sch.encode_tb(ul_bits.reshape(T * n, cfg.ul_tbs), cfg_u)
        il = pusch_mod.interleave(cw_u, qm_u)
        scr_u = scrambling.scramble_bits(il, cinit_u)
        s_u = modem.modulate(scr_u, modem.MOD_FROM_QM[qm_u])
        x_u = dft.dft(s_u.reshape(T * n, 12, m_sc, 2), ortho=True)
        # ONE shared UL grid per TTI: UE allocations are disjoint, and
        # sum-of-waveforms == waveform-of-summed-grids (the IDFT is
        # linear), so the per-UE grids + per-UE modulates collapse into
        # one scatter + one OFDM modulate per subframe.  PUCCH rides on
        # .add — overlapping format-1 resources (same PRB, different
        # cyclic shift / orthogonal cover) superpose exactly as the
        # per-UE waveforms did.
        ug = jnp.zeros((T, S, 2))
        ug = ug.at[:, ul_data.reshape(-1), :].set(
            x_u.reshape(T, n * 12 * m_sc, 2))
        dv = jnp.take(c["dmrs10"].reshape(10, -1, 2), sfs,
                      axis=0)  # (T, 2*m_sc, 2)
        ug = ug.at[:, ul_dmrs.reshape(-1), :].set(jnp.tile(dv, (1, n, 1)))
        # PUCCH format 1a on the dedicated resource: d0 = +1 ack, -1 nack
        d0 = jnp.where(dl_ok.reshape(T, n), 1.0, -1.0)  # (T, n)
        pv = jnp.take(p_vals, sfs, axis=0)  # (T, n, 2, 7, 12, 2)
        scale = (p_dmask[None, None, None, :, None] *
                 d0[..., None, None, None] +
                 (1.0 - p_dmask)[None, None, None, :, None])
        pcontrib = pv * scale[..., None]
        ug = ug.at[:, p_pos.reshape(-1), :].add(
            pcontrib.reshape(T, n * 2 * 7 * 12, 2))
        # superpose at the eNB: unit-power per UE (UL power control ideal),
        # one shared noise floor scaled by the worst link
        utx = ofdm.modulate(ug.reshape(T, grid_mod.N_SYM, cell.nre, 2),
                            cell.n_prb)  # (T, sf_len, 2)
        un = jax.random.normal(k_ul, utx.shape) / np.sqrt(2)
        urx = utx + jnp.max(amp) * un

        # ---------------- eNB receive ----------------
        urg = ofdm.demodulate(urx, cell.n_prb)  # (T, 14, NRE, 2)
        yd = jnp.take(urg.reshape(T, S, 2),
                      ul_dmrs.reshape(-1), axis=-2)
        yd = yd.reshape(T, n, 2, m_sc, 2)
        rref = jnp.take(c["dmrs10"], sfs, axis=0)
        h_ls = cplx.mul_conj(yd, rref[:, None])  # (T, n, 2, m_sc, 2)
        k5 = 5
        pad = jnp.pad(h_ls, ((0, 0),) * 3 + ((k5 // 2, k5 // 2), (0, 0)),
                      mode="edge")
        sm = sum(pad[..., i : i + m_sc, :] for i in range(k5)) / k5
        noise_u = jnp.mean(cplx.abs2(h_ls - sm).reshape(T, n, -1), -1) * 1.25
        t_w = (np.array(pusch_mod.DATA_SYMS, np.float32) - 3.0) / 7.0
        ce_u = (jnp.asarray(1.0 - t_w)[None, None, :, None, None] * sm[:, :, 0:1]
                + jnp.asarray(t_w)[None, None, :, None, None] * sm[:, :, 1:2])
        yu = jnp.take(urg.reshape(T, S, 2),
                      ul_data.reshape(-1), axis=-2)
        yu = yu.reshape(T, n, 12, m_sc, 2)
        xeq_u, csi_u = chest.equalize_mmse(yu, ce_u, noise_u)
        xtd = dft.idft(xeq_u.reshape(T * n, 12, m_sc, 2), ortho=True)
        llr_u = modem.demod_soft(xtd.reshape(T * n, 12 * m_sc, 2),
                                 modem.MOD_FROM_QM[qm_u])
        w_u = jnp.mean(csi_u.reshape(T * n, 12, m_sc), axis=-1)
        llr_u = llr_u * jnp.repeat(w_u, m_sc * qm_u, axis=-1)
        llr_u = scrambling.scramble_llrs(llr_u, cinit_u)
        llr_u = pusch_mod.deinterleave(llr_u, qm_u)
        ul_out, ul_ok, _, _ = sch.decode_tb(llr_u, cfg_u,
                                            llr_bits=cfg.llr_bits)

        # PUCCH matched filter on each UE's dedicated resource
        yp = jnp.take(urg.reshape(T, S, 2),
                      p_pos.reshape(-1), axis=-2)
        yp = yp.reshape(T, n, 2, 7, 12, 2)
        prod = cplx.mul_conj(yp, pv)
        dm = p_dmask[None, None, None, :, None]
        corr = (prod * dm[..., None]).sum(axis=(-4, -3, -2)) / (
            12 * 2 * len(pucch_mod.F1_DATA_SYMS))
        return dict(
            dl_ok=dl_ok.reshape(T, n), dl_out=dl_out.reshape(T, n, -1),
            ul_ok=ul_ok.reshape(T, n), ul_out=ul_out.reshape(T, n, -1),
            ack_energy=cplx.abs2(corr), ack_val=corr[..., 0],
            **({"dl_ok_cw": dl_ok2} if cfg.tm3 else {}))


def make_block_step(cfg: BlockConfig, sfn0: int = 0):
    """Compile the single-cell T-TTI block program.

    Returns jitted fn(dl_bits (T, n, dl_tbs) int8,
                      ul_bits (T, n, ul_tbs) int8,
                      key, tti0 int32 (multiple of 10 recommended))
      -> dict(dl_ok (T, n) bool, dl_out (T, n, dl_tbs) int8,
              ul_ok (T, n) bool, ul_out (T, n, ul_tbs) int8,
              ack_energy (T, n) f32, ack_val (T, n) f32)
    """
    consts = _cell_consts(cfg, sfn0)

    def step(dl_bits, ul_bits, key, tti0):
        return _step_body(cfg, consts, dl_bits, ul_bits, key, tti0)

    return jax.jit(step)


def make_block_step_sharded(cfg: BlockConfig, mesh, cell_ids,
                            sfn0: int = 0):
    """MULTI-CELL block step: one cell per mesh device, sharded over the
    flattened ('node','sf') axes with shard_map — the waveform network's
    scaling path (SURVEY §2.8: 'node' shards emulated cells).  Every
    cell-dependent table rides as a sharded argument, so ONE traced body
    serves all cells and the per-device module is collective-free by
    construction (cells don't talk; inter-cell interference would be the
    one communicating phase, as in parallel/ota_collective.py).

    Returns (jitted fn(dl (C, T, n, tbs), ul (C, T, n, tbs),
                       keys (C, 2) uint32, tti0) -> dict with leading C,
             consts_sharded) where C = number of devices in the mesh.
    """
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    devs = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    assert len(cell_ids) == devs, (len(cell_ids), devs)
    consts = []
    for cid in cell_ids:
        c = cfg._replace(cell=grid_mod.CellConfig(
            n_prb=cfg.cell.n_prb, cell_id=int(cid), cfi=cfg.cell.cfi))
        consts.append(_cell_consts(c, sfn0))
    stacked = {k: jnp.asarray(np.stack([np.asarray(d[k]) for d in consts]))
               for k in consts[0]}
    ax = P(("node", "sf"))
    sharding = NamedSharding(mesh, ax)
    stacked = {k: jax.device_put(v, sharding) for k, v in stacked.items()}

    def body(cl, dl, ul, key, tti0):
        # local slice: exactly one cell per device (leading axis 1)
        out = _step_body(cfg, {k: v[0] for k, v in cl.items()},
                         dl[0], ul[0], key[0], tti0)
        return {k: v[None] for k, v in out.items()}

    spec = {k: ax for k in stacked}
    f = shard_map(body, mesh=mesh, check_vma=False,
                  in_specs=(spec, ax, ax, ax, P()), out_specs=ax)
    return jax.jit(lambda dl, ul, keys, tti0:
                   f(stacked, dl, ul, keys, tti0)), stacked


def _pack_segments(n_prb: int, n: int, segments) -> tuple:
    """Pack n equal-width contiguous allocations into the PRB segments.
    Returns (starts tuple, width)."""
    total = sum(b - a for a, b in segments)
    w = max(1, total // n)
    while w > 1:
        fit = sum((b - a) // w for a, b in segments)
        if fit >= n:
            break
        w -= 1
    starts, si = [], 0
    cur = segments[0][0]
    for _ in range(n):
        while cur + w > segments[si][1]:
            si += 1
            assert si < len(segments), f"{n} UEs don't fit {segments}"
            cur = segments[si][0]
        starts.append(cur)
        cur += w
    return tuple(starts), w


class SpsBlockRunner:
    """Bridge between an ATTACHED WaveformNetwork's L2/L3 stacks and the
    device-resident block program: per block, the host drains T TTIs of
    MAC PDUs from the eNB's and UEs' RLC entities (pure byte work), runs
    ONE device call for the whole block's PHY, and feeds the decoded TBs
    back into the stacks.  Feedback loops (RLC AM status, etc.) see a
    T-TTI latency — the block is the speculation window, the same
    trade the reference makes pipelining TTIs across sf_workers
    (txrx.cc:105-145), deepened to a device batch.

    The per-UE dedicated SR PUCCH resource doubles as the SPS persistent
    HARQ-ACK resource (the n1PUCCH-AN-persistentList role — rrc_wire.py
    sps-config carries that list)."""

    def __init__(self, net, T: int = 20, dl_mcs: int = 10,
                 ul_mcs: int = 10):
        from ..stack import pdu as pdu_mod

        self.pdu = pdu_mod
        self.net = net
        mac = net.enb.mac
        cell = net.cell
        rntis = sorted(r for r, u in mac.ues.items()
                       if u.state == "RRC_CONNECTED"
                       and getattr(u, "sr_pucch_res", None) is not None)
        assert rntis, "no RRC-connected UEs to run in block mode"
        n_prb = cell.n_prb
        c0, c1 = centre_prbs(n_prb)
        dl_starts, dl_w = _pack_segments(
            n_prb, len(rntis), [(0, c0), (c1, n_prb)])
        lo, hi = mac.ul_prb_lo, mac.ul_prb_hi
        wu = max(1, (hi - lo) // len(rntis))
        while wu > 1 and not pusch_mod.valid_n_prb(wu):
            wu -= 1
        ul_starts = tuple(lo + i * wu for i in range(len(rntis)))
        med = net.medium
        by_crnti = {ue.stack.crnti: i for i, ue in enumerate(net.ues)}
        self.ue_idx = [by_crnti[r] for r in rntis]
        snr = tuple(
            float(med.tx_power_dbm - med.pathloss_db[self.ue_idx[i]]
                  - med.noise_floor_dbm)
            for i in range(len(rntis)))
        self.cfg = BlockConfig(
            cell=cell, rntis=tuple(rntis),
            dl_rb_start=dl_starts, dl_l_crbs=dl_w, dl_mcs=dl_mcs,
            ul_rb_start=ul_starts, ul_l_prb=wu, ul_mcs=ul_mcs,
            ack_res=tuple(mac.ues[r].sr_pucch_res for r in rntis),
            snr_db=snr, T=T)
        self.step = make_block_step(self.cfg, sfn0=(net.tti // 10) % 1024)
        self._key = jax.random.PRNGKey(net.tti + 17)
        self.metrics = dict(blocks=0, dl_tb=0, dl_ok=0, ul_tb=0, ul_ok=0,
                            ack_det=0)

    def _mux(self, rlc_map, tbs_bytes: int) -> bytes:
        """One MAC PDU from a dict of RLC entities (36.321 mux role),
        padded to the TBS with real padding subheaders."""
        subs, room = [], tbs_bytes - 4
        for lcid in sorted(rlc_map):
            while room > 8 and rlc_map[lcid].has_data():
                p = rlc_map[lcid].read_pdu(room - 4)
                if p is None:
                    break
                subs.append((lcid, p))
                room -= len(p) + 3
        return self.pdu.pack(subs, tb_size=tbs_bytes)

    def run_block(self) -> dict:
        """Run T TTIs device-resident.  Returns the block's outputs."""
        net, cfg = self.net, self.cfg
        T, n = cfg.T, cfg.n_ues
        mac = net.enb.mac
        dtb, utb = cfg.dl_tbs // 8, cfg.ul_tbs // 8
        dl = np.zeros((T, n, dtb), np.uint8)
        ul = np.zeros((T, n, utb), np.uint8)
        for t in range(T):
            for i, r in enumerate(cfg.rntis):
                dl[t, i] = np.frombuffer(
                    self._mux(mac.ues[r].rlc, dtb), np.uint8)
                ust = net.ues[self.ue_idx[i]].stack
                ul[t, i] = np.frombuffer(self._mux(ust.rlc, utb), np.uint8)
            getattr(mac, "tick", lambda: None)()
        self._key, k = jax.random.split(self._key)
        out = self.step(
            jnp.asarray(np.unpackbits(dl, axis=-1).astype(np.int8)),
            jnp.asarray(np.unpackbits(ul, axis=-1).astype(np.int8)),
            k, jnp.asarray(net.tti % 10240, jnp.int32))
        dl_ok = np.asarray(out["dl_ok"])
        ul_ok = np.asarray(out["ul_ok"])
        dl_out = np.packbits(np.asarray(out["dl_out"], np.uint8), axis=-1)
        ul_out = np.packbits(np.asarray(out["ul_out"], np.uint8), axis=-1)
        ack = np.asarray(out["ack_energy"]) > 0.25
        for t in range(T):
            tti = net.tti + t
            for i, r in enumerate(cfg.rntis):
                ust = net.ues[self.ue_idx[i]].stack
                self.metrics["dl_tb"] += 1
                self.metrics["ul_tb"] += 1
                if dl_ok[t, i]:
                    self.metrics["dl_ok"] += 1
                    ust.tb_decoded(tti, dl_out[t, i].tobytes(),
                                   cfg.snr_db[i], rnti=r)
                    ust.get_pucch(tti)  # PHY-level ACK already carried
                if ul_ok[t, i]:
                    self.metrics["ul_ok"] += 1
                    mac.ul_pdu(tti, r, ul_out[t, i].tobytes(),
                               cfg.snr_db[i])
                self.metrics["ack_det"] += int(ack[t, i])
                if hasattr(ust, "tick"):
                    ust.tick()
        net.tti += T
        self.metrics["blocks"] += 1
        return out


def make_bench_step(cfg: BlockConfig, sfn0: int = 0):
    """Bench variant: same program, but reduces outputs ON DEVICE to a
    handful of scalars so the timed loop never pays a bulk readback over
    the (possibly remote) device link."""
    step = make_block_step(cfg, sfn0)

    def bench(dl_bits, ul_bits, key, tti0):
        out = step(dl_bits, ul_bits, key, tti0)
        dl_ok = out["dl_ok_cw"] if cfg.tm3 else out["dl_ok"]
        return (dl_ok.sum(), out["ul_ok"].sum(),
                (out["ack_energy"] > 1e-2).sum())

    return jax.jit(bench)
