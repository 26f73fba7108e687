"""Waveform-mode data plane: DL user data through the real PHY pipeline.

Reference context: srsLTE-emane replaces the waveform PHY with a message
bus + SINR model (SURVEY §2.3); stock srsLTE runs the full waveform over RF
or ZMQ IQ transport (rf_zmq_imp.c).  This module is the ZMQ-mode equivalent
for this framework: the control plane (RA, RRC, NAS) stays on the message
bus, and once a UE is attached its downlink IP packets are carried by the
actual device pipeline — PDCCH DCI + PDSCH encode -> OFDM -> per-link
pathloss + AWGN -> OFDM demod -> chest -> blind DCI search -> PDSCH decode —
batched over all packets of a TTI burst.

Design: each attached UE gets a STATIC grant slot (rnti, prb_mask, Qm,
tbs), so the whole eNB->channel->UE chain compiles once per (cell, sf_idx)
and every subsequent burst reuses the compiled graph; packets batch along
the leading axis.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..models import enb_dl, ue_dl
from ..ops import bits as bits_mod, channel, cplx, ofdm
from ..phch import grid as grid_mod


@dataclasses.dataclass
class UeSlot:
    rnti: int
    prb_mask: tuple
    qm: int = 4
    l_aggr: int = 4
    cce_start: int = 0

    def tbs(self, cell, sf_idx) -> int:
        n_re = grid_mod.nof_re(cell, sf_idx, self.prb_mask)
        return max(16, (n_re * self.qm // 3) // 8 * 8)


class WaveformDataPlane:
    """Carries DL PDCP PDUs of attached UEs over the waveform pipeline."""

    def __init__(self, cell: grid_mod.CellConfig, noise_floor_dbm: float = -104.0,
                 tx_power_dbm: float = 30.0):
        self.cell = cell
        self.noise_floor_dbm = noise_floor_dbm
        self.tx_power_dbm = tx_power_dbm
        self.slots: dict = {}  # rnti -> UeSlot
        self._key = jax.random.PRNGKey(0)
        self.metrics = {"sf_tx": 0, "crc_ok": 0, "crc_fail": 0}

    def add_ue(self, rnti: int, prb_mask: tuple, qm: int = 4,
               cce_start: int = 0, l_aggr: int = 1):
        slot = UeSlot(rnti, prb_mask, qm, l_aggr=l_aggr,
                      cce_start=cce_start)
        # reconfiguring an rnti invalidates the (sf_idx, rnti)-keyed
        # compiled graphs — stale allocations would otherwise serve it
        if self.slots.get(rnti) not in (None, slot):
            self._cfg.cache_clear()
            self._link_fn.cache_clear()
        self.slots[rnti] = slot

    @functools.lru_cache(maxsize=None)
    def _cfg(self, sf_idx: int, rnti: int):
        s = self.slots[rnti]
        return enb_dl.DlSubframeConfig(
            cell=self.cell, sf_idx=sf_idx,
            grants=((rnti, s.prb_mask, s.qm, s.tbs(self.cell, sf_idx),
                     s.l_aggr, s.cce_start),))

    @functools.lru_cache(maxsize=None)
    def _link_fn(self, sf_idx: int, rnti: int):
        cfg = self._cfg(sf_idx, rnti)

        def run(payload_bits, key, gain, snr_db):
            tx = enb_dl.build_subframe(cfg, [payload_bits])
            rx = channel.awgn(key, tx * gain, snr_db)
            res, _ = ue_dl.decode_subframe(rx, cfg)
            return res.dci_found[:, 0], res.payloads[0], res.crc_ok[0], res.snr_db

        return jax.jit(run)

    # ---- whole-TTI path: ONE compiled graph serves every attached UE ----

    def _plan(self, sf_idx: int) -> tuple:
        return tuple((r, self.slots[r].prb_mask, self.slots[r].qm,
                      self.slots[r].tbs(self.cell, sf_idx),
                      self.slots[r].l_aggr, self.slots[r].cce_start)
                     for r in sorted(self.slots))

    @functools.lru_cache(maxsize=None)
    def _tti_fn(self, sf_idx: int, plan: tuple):
        """One jitted graph per (sf_idx, attached-set): the eNB builds a
        single multi-grant subframe (all UEs' PDCCH DCIs + PDSCH), then each
        UE's receiver decodes ITS grant through its own channel (per-UE SNR
        is data).  Compile count is per subframe plan, NOT per UE — the
        sf_worker serving N grants per TTI (srsenb/src/phy/sf_worker.cc),
        where the old path compiled per (sf_idx, rnti)."""
        cfg_all = enb_dl.DlSubframeConfig(cell=self.cell, sf_idx=sf_idx,
                                          grants=plan)
        cfg_one = [enb_dl.DlSubframeConfig(cell=self.cell, sf_idx=sf_idx,
                                           grants=(g,)) for g in plan]

        def run(payloads, key, snrs_db):
            tx = enb_dl.build_subframe(cfg_all, list(payloads))
            keys = jax.random.split(key, len(cfg_one))
            out = []
            for u, cu in enumerate(cfg_one):
                rx = channel.awgn(keys[u], tx, snrs_db[u])
                res, _ = ue_dl.decode_subframe(rx, cu)
                out.append((res.dci_found[:, 0], res.payloads[0],
                            res.crc_ok[0], res.snr_db))
            return out

        return jax.jit(run)

    def send_tti(self, pdus: dict, pathloss_db: dict, sf_idx: int = 1):
        """Carry one DL burst for EVERY attached UE in shared subframes.

        pdus: {rnti: [pdu bytes, ...]}; UEs with shorter (or no) bursts ride
        zero-length padding PDUs.  Returns {rnti: [(bytes|None, snr_db),
        ...]} aligned with each UE's input list."""
        plan = self._plan(sf_idx)
        rntis = [g[0] for g in plan]
        B = max((len(v) for v in pdus.values()), default=0)
        if B == 0:
            return {}
        payloads = []
        for g in plan:
            rnti, tbs = g[0], g[3]
            nbytes = tbs // 8
            buf = np.zeros((B, nbytes), dtype=np.uint8)
            for i, p in enumerate(pdus.get(rnti, ())):
                assert len(p) + 2 <= nbytes, (len(p), nbytes)
                buf[i, 0] = len(p) >> 8
                buf[i, 1] = len(p) & 0xFF
                buf[i, 2 : 2 + len(p)] = np.frombuffer(p, np.uint8)
            payloads.append(bits_mod.unpack_bits(jnp.asarray(buf))[:, :tbs])
        snrs = np.asarray([self.tx_power_dbm - pathloss_db[r]
                           - self.noise_floor_dbm for r in rntis], np.float32)
        self._key, sub = jax.random.split(self._key)
        outs = self._tti_fn(sf_idx, plan)(tuple(payloads), sub,
                                          jnp.asarray(snrs))
        results = {}
        for u, rnti in enumerate(rntis):
            found, out_bits, ok, snr_est = outs[u]
            found = np.asarray(found)
            ok = np.asarray(ok)
            out_bytes = np.asarray(bits_mod.pack_bits(out_bits))
            snr_h = np.asarray(snr_est)
            res_u = []
            for i in range(len(pdus.get(rnti, ()))):
                self.metrics["sf_tx"] += 1
                if found[i] and ok[i]:
                    n = (int(out_bytes[i, 0]) << 8) | int(out_bytes[i, 1])
                    res_u.append((bytes(out_bytes[i, 2 : 2 + n]),
                                  float(snr_h[i])))
                    self.metrics["crc_ok"] += 1
                else:
                    res_u.append((None, float(snr_h[i])))
                    self.metrics["crc_fail"] += 1
            results[rnti] = res_u
        return results

    def send(self, rnti: int, pdus: list, pathloss_db: float, sf_idx: int = 1):
        """Transmit a burst of DL byte-PDUs to one UE through the PHY.

        Returns list of (delivered_bytes | None, snr_db) per PDU — None when
        the PDSCH CRC failed at this pathloss."""
        s = self.slots[rnti]
        cfg = self._cfg(sf_idx, rnti)
        tbs = cfg.grants[0][3]
        nbytes = tbs // 8
        B = len(pdus)
        buf = np.zeros((B, nbytes), dtype=np.uint8)
        for i, p in enumerate(pdus):
            assert len(p) + 2 <= nbytes, (len(p), nbytes)
            buf[i, 0] = len(p) >> 8
            buf[i, 1] = len(p) & 0xFF
            buf[i, 2 : 2 + len(p)] = np.frombuffer(p, np.uint8)
        payload_bits = bits_mod.unpack_bits(jnp.asarray(buf))[:, :tbs]
        rx_dbm = self.tx_power_dbm - pathloss_db
        snr_db = rx_dbm - self.noise_floor_dbm
        self._key, sub = jax.random.split(self._key)
        found, out_bits, ok, snr_est = self._link_fn(sf_idx, rnti)(
            payload_bits, sub, 1.0, snr_db)
        found = np.asarray(found)
        ok = np.asarray(ok)
        out_bytes = np.asarray(bits_mod.pack_bits(out_bits))
        snrs = np.asarray(snr_est)
        self.metrics["sf_tx"] += B
        results = []
        for i in range(B):
            if found[i] and ok[i]:
                n = (int(out_bytes[i, 0]) << 8) | int(out_bytes[i, 1])
                results.append((bytes(out_bytes[i, 2 : 2 + n]), float(snrs[i])))
                self.metrics["crc_ok"] += 1
            else:
                results.append((None, float(snrs[i])))
                self.metrics["crc_fail"] += 1
        return results


class MbsfnPlane:
    """Waveform-mode eMBMS: MTCH payloads through the real PMCH pipeline.

    One broadcast waveform per burst (pmch.encode: area scrambling +
    MBSFN-RS in the hybrid-CP subframe, `lib/src/phy/phch/pmch.c` role)
    is heard by every receiver through its own pathloss+AWGN channel —
    one encode, N independent decodes, batched over the burst (the
    multicast analogue of WaveformDataPlane.send_tti's per-UE grants)."""

    def __init__(self, cell: grid_mod.CellConfig, area_id: int = 1,
                 qm: int = 2, code_rate: float = 0.4,
                 tx_power_dbm: float = 30.0,
                 noise_floor_dbm: float = -104.0, seed: int = 5):
        from ..phch import pmch as pmch_mod, sch as sch_mod

        self.cell = cell
        self.area_id = area_id
        n_re = pmch_mod.nof_re(cell.n_prb)
        g = n_re * qm
        tbs = max(8, (int(g * code_rate) - 24) // 8 * 8)
        self.cfg = sch_mod.SchConfig(tbs=tbs, G=g, Qm=qm, Nl=1)
        self.tx_power_dbm = tx_power_dbm
        self.noise_floor_dbm = noise_floor_dbm
        self._key = jax.random.PRNGKey(seed)
        self.metrics = {"sf_tx": 0, "crc_ok": 0, "crc_fail": 0}

    @functools.lru_cache(maxsize=None)
    def _fn(self, sf_idx: int, n_rx: int):
        from ..phch import pmch as pmch_mod

        cell, cfg, area = self.cell, self.cfg, self.area_id
        nre = 12 * cell.n_prb

        def run(payload_bits, key, snrs_db):
            b = payload_bits.shape[0]
            mb = pmch_mod.encode(payload_bits, cfg, cell.n_prb, area, sf_idx)
            ctrl = cplx.zeros((b, 2, nre))
            t = ofdm.modulate_mbsfn(ctrl, mb, cell.n_prb)
            keys = jax.random.split(key, n_rx)
            outs, oks = [], []
            for r in range(n_rx):
                rx = channel.awgn(keys[r], t, snrs_db[r])
                _, mb_rx = ofdm.demodulate_mbsfn(rx, cell.n_prb)
                out, ok = pmch_mod.decode(mb_rx, cfg, cell.n_prb, area,
                                          sf_idx)
                outs.append(out)
                oks.append(ok)
            return jnp.stack(outs), jnp.stack(oks)

        return jax.jit(run)

    def send(self, pdus: list, pathloss_db: dict, sf_idx: int = 3):
        """Broadcast a burst of MTCH byte-PDUs to every listed receiver.

        pathloss_db: {receiver_id: pathloss}.  Returns {receiver_id:
        [delivered bytes | None per PDU]} — None where that receiver's
        channel failed the PMCH CRC."""
        rx_ids = sorted(pathloss_db)
        nbytes = self.cfg.tbs // 8
        b = len(pdus)
        buf = np.zeros((b, nbytes), dtype=np.uint8)
        for i, p in enumerate(pdus):
            assert len(p) + 2 <= nbytes, (len(p), nbytes)
            buf[i, 0] = len(p) >> 8
            buf[i, 1] = len(p) & 0xFF
            buf[i, 2 : 2 + len(p)] = np.frombuffer(p, np.uint8)
        bits = bits_mod.unpack_bits(jnp.asarray(buf))[:, : self.cfg.tbs]
        snrs = np.asarray([self.tx_power_dbm - pathloss_db[r]
                           - self.noise_floor_dbm for r in rx_ids],
                          np.float32)
        self._key, sub = jax.random.split(self._key)
        outs, oks = self._fn(sf_idx, len(rx_ids))(bits, sub,
                                                  jnp.asarray(snrs))
        oks = np.asarray(oks)
        out_bytes = np.asarray(bits_mod.pack_bits(outs.reshape(-1, self.cfg.tbs)))
        out_bytes = out_bytes.reshape(len(rx_ids), b, -1)
        self.metrics["sf_tx"] += b
        results = {}
        for u, rid in enumerate(rx_ids):
            res = []
            for i in range(b):
                if oks[u, i]:
                    n = (int(out_bytes[u, i, 0]) << 8) | int(out_bytes[u, i, 1])
                    res.append(bytes(out_bytes[u, i, 2 : 2 + n]))
                    self.metrics["crc_ok"] += 1
                else:
                    res.append(None)
                    self.metrics["crc_fail"] += 1
            results[rid] = res
        return results


class UlControlPlane:
    """Waveform-mode PUCCH: each attached UE transmits HARQ-ACK/SR on its
    own format-1/1a resource; the eNB receives the SUPERPOSITION of every
    UE's uplink waveform plus noise and matched-filters each resource.

    This carries the true code/resource-domain orthogonality of
    `lib/src/phy/phch/pucch.c` + `srsenb/src/phy/sf_worker.cc` UL control
    decoding — simultaneous PUCCHs on different cyclic shifts of the SAME
    PRB separate cleanly, which the message-level per-RB SINR model treats
    as interference.

    Design: the whole (encode x U UEs) -> sum -> AWGN -> (detect x U)
    chain compiles once per (sf_idx, resource tuple); UEs batch along the
    leading axis inside one jitted graph.
    """

    # detection threshold on matched-filter energy, relative to the
    # noise-only expectation (enb_ul.c pucch threshold role)
    DETECT_SNR = 4.0

    def __init__(self, cell: grid_mod.CellConfig,
                 noise_floor_dbm: float = -104.0, tx_power_dbm: float = 23.0):
        self.cell = cell
        self.noise_floor_dbm = noise_floor_dbm
        self.tx_power_dbm = tx_power_dbm
        self.resources: dict = {}  # rnti -> n_pucch
        self._key = jax.random.PRNGKey(1)
        self.metrics = {"pucch_tx": 0, "pucch_det": 0, "pucch_dtx": 0}

    def add_ue(self, rnti: int, n_pucch: int):
        self.resources[rnti] = n_pucch

    @functools.lru_cache(maxsize=None)
    def _fn(self, sf_idx: int, resources: tuple):
        from ..phch import pucch as pucch_mod

        cell = self.cell

        def run(d0, amp, key, noise_amp):
            # d0: (U, 2) BPSK ack symbol per UE (0 amplitude = DTX),
            # amp: (U,) linear per-UE received amplitude at the eNB
            rx = None
            for u, n_pucch in enumerate(resources):
                g = cplx.zeros((1, 14, cell.nre))
                g = pucch_mod.encode_f1(d0[u : u + 1], cell, sf_idx, n_pucch, g)
                s = ofdm.modulate(g, cell.n_prb) * amp[u]
                rx = s if rx is None else rx + s
            noise = noise_amp * jax.random.normal(key, rx.shape) / jnp.sqrt(2.0)
            rg = ofdm.demodulate(rx + noise, cell.n_prb)
            corrs, energies = [], []
            for n_pucch in resources:
                corr, energy = pucch_mod.detect_f1(rg, cell, sf_idx, n_pucch)
                corrs.append(corr[0])
                energies.append(energy[0])
            return jnp.stack(corrs), jnp.stack(energies)

        return jax.jit(run)

    def step(self, tx: dict, pathloss_db: dict, sf_idx: int = 2):
        """tx: {rnti: ack_bit | None}  (None = SR-only presence; absent
        rnti = DTX).  Returns {rnti: (detected, ack_bit, metric_db)}."""
        resources = tuple(self.resources[r] for r in sorted(self.resources))
        rntis = sorted(self.resources)
        U = len(rntis)
        d0 = np.zeros((U, 2), np.float32)
        amp = np.zeros(U, np.float32)
        # unit noise at the demodulated grid <-> per-UE amplitude from SNR
        for u, r in enumerate(rntis):
            if r in tx:
                bit = tx[r]
                d0[u, 0] = 1.0 if bit in (None, 1) else -1.0
                snr_db = (self.tx_power_dbm - pathloss_db[r]
                          - self.noise_floor_dbm)
                amp[u] = 10.0 ** (snr_db / 20.0)
        self._key, sub = jax.random.split(self._key)
        corr, energy = self._fn(sf_idx, resources)(
            jnp.asarray(d0), jnp.asarray(amp), sub, 1.0)
        corr = np.asarray(corr)
        energy = np.asarray(energy)
        out = {}
        for u, r in enumerate(rntis):
            det = bool(energy[u] > self.DETECT_SNR)
            ack = int(corr[u, 0] > 0)
            out[r] = (det, ack if det else None,
                      float(10.0 * np.log10(energy[u] + 1e-12)))
            self.metrics["pucch_tx" if r in tx else "pucch_dtx"] += 1
            self.metrics["pucch_det"] += int(det)
        return out


class UlSchPlane:
    """Waveform-mode PUSCH with aperiodic CQI multiplexed on UL-SCH: the
    DCI-0 csi_request path carried through the REAL device PHY.

    Reference behavior: `lib/src/phy/phch/pusch.c` UCI multiplexing +
    `cqi.c` aperiodic HL-subband reporting; `srsenb/src/phy/sf_worker.cc`
    decodes data and CQI from the same PUSCH.  Each UE's transmission runs
    SC-FDMA encode (turbo + DFT precode) with the packed 36.212 §5.2.2.6
    CQI report punctured in, AWGN at the link SNR, then the eNB-side MMSE
    equalize + decode recovering payload AND report.

    Design: one jitted graph per allocation shape; the (encode ->
    channel -> decode) chain is a single compiled module per UE slot."""

    def __init__(self, cell: grid_mod.CellConfig,
                 noise_floor_dbm: float = -104.0, tx_power_dbm: float = 23.0):
        self.cell = cell
        self.noise_floor_dbm = noise_floor_dbm
        self.tx_power_dbm = tx_power_dbm
        self.slots: dict = {}  # rnti -> (rb_start, l_prb, qm)
        self._key = jax.random.PRNGKey(5)
        self.metrics = {"pusch_tx": 0, "pusch_crc_ok": 0, "cqi_rx": 0}

    def add_ue(self, rnti: int, rb_start: int, l_prb: int, qm: int = 2):
        if self.slots.get(rnti) not in (None, (rb_start, l_prb, qm)):
            self._fn.cache_clear()  # reconfigured: drop compiled graphs
        self.slots[rnti] = (rb_start, l_prb, qm)

    def _dims(self, rnti: int):
        from ..phch import pusch, sch, uci as uci_codes

        rb_start, l_prb, qm = self.slots[rnti]
        n_cqi = 4 + 2 * uci_codes.cqi_hl_subband_size(self.cell.n_prb)
        q_ack, q_ri, q_cqi, g_data = pusch.uci_dims(l_prb, qm, 0, 0, n_cqi)
        tbs = max(8, (int(g_data * 0.4) - 24) // 8 * 8)
        cfg = sch.SchConfig(tbs=tbs, G=g_data, Qm=qm, Nl=1)
        return cfg, n_cqi, (q_ack, q_ri, q_cqi, 0, 0, n_cqi)

    @functools.lru_cache(maxsize=None)
    def _fn(self, rnti: int, sf_idx: int):
        from ..phch import pusch

        cell = self.cell
        rb_start, l_prb, qm = self.slots[rnti]
        cfg, n_cqi, dims = self._dims(rnti)

        def run(payload, cqi_bits, key, snr_db):
            g = pusch.encode(payload, cfg, cell, sf_idx, rnti, rb_start,
                             l_prb, uci=dict(cqi=cqi_bits))
            t = ofdm.modulate(g, cell.n_prb)
            rx = channel.awgn(key, t, snr_db)
            rg = ofdm.demodulate(rx, cell.n_prb)
            return pusch.decode(rg, cfg, cell, sf_idx, rnti, rb_start,
                                l_prb, uci_dims_in=dims)

        return jax.jit(run), cfg, n_cqi

    def step(self, tx: dict, pathloss_db: dict, sf_idx: int = 4):
        """tx: {rnti: (payload_bytes, wb_cqi_int)}.  Returns
        {rnti: (payload_bytes|None, crc_ok, decoded_wb_cqi|None)}."""
        from ..phch import uci as uci_codes

        out = {}
        for rnti, (pkt, wb_cqi) in tx.items():
            fn, cfg, n_cqi = self._fn(rnti, sf_idx)
            payload = np.zeros((1, cfg.tbs), np.int8)
            raw = bits_mod.bytes_to_bits(pkt[: cfg.tbs // 8])
            payload[0, : raw.size] = raw
            n_sb = uci_codes.cqi_hl_subband_size(self.cell.n_prb)
            bits = uci_codes.pack_cqi_hl_subband(wb_cqi, [0] * n_sb,
                                                 self.cell.n_prb)
            cqi = np.asarray(bits, np.int8)[None, :n_cqi]
            snr_db = (self.tx_power_dbm - pathloss_db[rnti]
                      - self.noise_floor_dbm)
            self._key, sub = jax.random.split(self._key)
            res = fn(jnp.asarray(payload), jnp.asarray(cqi), sub,
                     float(snr_db))
            ok = bool(np.asarray(res["ok"])[0])
            self.metrics["pusch_tx"] += 1
            if not ok:
                out[rnti] = (None, False, None)
                continue
            self.metrics["pusch_crc_ok"] += 1
            got = bits_mod.bits_to_bytes(
                np.asarray(res["payload"][0]))[: len(pkt)]
            rep = uci_codes.unpack_cqi_hl_subband(
                np.asarray(res["cqi"][0]), self.cell.n_prb)
            self.metrics["cqi_rx"] += 1
            out[rnti] = (bytes(got), True, rep["wideband_cqi"])
        return out


class MimoDataPlane:
    """TM3 2x2 open-loop spatial-multiplexing DL data plane: two transport
    blocks per subframe per UE through the full device pipeline —
    encode_tm -> per-port OFDM -> 2x2 flat channel -> ZF predecode ->
    per-codeword turbo decode (the reference's 150 Mb/s headline config,
    `debian/man/srsenb.txt:17`).

    Same static-slot compile-once design as WaveformDataPlane; the channel
    is drawn per burst with a conditioning boost on the diagonal (EPA-class
    rank-2 behavior)."""

    def __init__(self, cell: grid_mod.CellConfig, noise_floor_dbm: float = -104.0,
                 tx_power_dbm: float = 30.0, cond_boost: float = 3.5):
        assert cell.n_ports == 2, "TM3 plane needs a 2-port cell"
        self.cell = cell
        self.noise_floor_dbm = noise_floor_dbm
        self.tx_power_dbm = tx_power_dbm
        self.cond_boost = cond_boost
        self.slots = {}
        self._key = jax.random.PRNGKey(2)
        self.metrics = {"sf_tx": 0, "crc_ok": 0, "crc_fail": 0}

    def add_ue(self, rnti: int, prb_mask: tuple, qm: int = 4):
        slot = UeSlot(rnti, prb_mask, qm)
        if self.slots.get(rnti) not in (None, slot):
            self._link_fn.cache_clear()  # reconfigured: drop graphs
        self.slots[rnti] = slot

    def _sch_cfgs(self, sf_idx: int, rnti: int):
        from ..phch import sch

        s = self.slots[rnti]
        n_re = grid_mod.nof_re(self.cell, sf_idx, s.prb_mask)
        tbs = max(16, (n_re * s.qm // 3) // 8 * 8)
        return [sch.SchConfig(tbs=tbs, G=n_re * s.qm, Qm=s.qm, Nl=1)
                for _ in range(2)]

    @functools.lru_cache(maxsize=None)
    def _link_fn(self, sf_idx: int, rnti: int):
        from ..phch import pdsch

        cell = self.cell
        s = self.slots[rnti]
        cfgs = self._sch_cfgs(sf_idx, rnti)

        def run(tb0, tb1, key, h, snr_db):
            grids = pdsch.encode_tm([tb0, tb1], cfgs, cell, sf_idx, rnti,
                                    s.prb_mask, "tm3")
            tx = ofdm.modulate(grids, cell.n_prb)
            rx = channel.mimo_flat(key, tx, h, snr_db)
            rg = ofdm.demodulate(rx, cell.n_prb)
            outs, oks, _ = pdsch.decode_tm(rg, cfgs, cell, sf_idx, rnti,
                                           s.prb_mask, "tm3")
            return outs[0], outs[1], oks[0], oks[1]

        return jax.jit(run)

    def send(self, rnti: int, pdus: list, pathloss_db: float, sf_idx: int = 1):
        """Burst of DL PDUs, two per subframe (cw0, cw1).  Returns a list of
        (delivered_bytes | None) aligned with `pdus`."""
        cfgs = self._sch_cfgs(sf_idx, rnti)
        nbytes = cfgs[0].tbs // 8
        n_req = len(pdus)
        if len(pdus) % 2:
            pdus = pdus + [b""]  # cw1 padding; trimmed from the results
        B = len(pdus) // 2
        buf = np.zeros((2, B, nbytes), dtype=np.uint8)
        for i, p in enumerate(pdus):
            assert len(p) + 2 <= nbytes, (len(p), nbytes)
            q, b = i % 2, i // 2
            buf[q, b, 0] = len(p) >> 8
            buf[q, b, 1] = len(p) & 0xFF
            buf[q, b, 2 : 2 + len(p)] = np.frombuffer(p, np.uint8)
        tbs = cfgs[0].tbs
        tb0 = bits_mod.unpack_bits(jnp.asarray(buf[0]))[:, :tbs]
        tb1 = bits_mod.unpack_bits(jnp.asarray(buf[1]))[:, :tbs]
        snr_db = self.tx_power_dbm - pathloss_db - self.noise_floor_dbm
        self._key, k1, k2 = jax.random.split(self._key, 3)
        h = (jax.random.normal(k1, (B, 2, 2, 2)) / np.sqrt(2.0))
        h = h + self.cond_boost * jnp.eye(2)[None, :, :, None]
        o0, o1, ok0, ok1 = self._link_fn(sf_idx, rnti)(tb0, tb1, k2, h, snr_db)
        outs = [np.asarray(bits_mod.pack_bits(o)) for o in (o0, o1)]
        oks = [np.asarray(ok0), np.asarray(ok1)]
        self.metrics["sf_tx"] += B
        results = []
        for i in range(len(pdus)):
            q, b = i % 2, i // 2
            if oks[q][b]:
                n = (int(outs[q][b, 0]) << 8) | int(outs[q][b, 1])
                results.append(bytes(outs[q][b, 2 : 2 + n]))
                self.metrics["crc_ok"] += 1
            else:
                results.append(None)
                self.metrics["crc_fail"] += 1
        return results[:n_req]
