"""netsim: whole-network LTE emulation in one process — the operational
equivalent of running srsepc + srsenb + N x srsue under EMANE (README.md:3-7
of the reference), faster than real time.

Usage:
    python -m srslte_emane_tpu.apps.netsim [--ues 2] [--ttis 200] [--paced]
           [--conf netsim.conf] [--pathloss 80] [--csv metrics.csv]
           [--pcap /tmp/mac.pcap] [--ostat-port 47100]

Prints a metrics summary and (optionally) serves the ostatistic endpoint.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..epc import hss as hss_mod, mme as mme_mod, spgw as spgw_mod
from ..runtime import otabus, phy_adapter, sinr, ttiloop
from ..stack import enb_stack, security, ue_stack
from ..utils import metrics as metrics_mod, pcap as pcap_mod


def build_network(n_ues: int, pathloss_db: float, n_prb: int = 25,
                  paced: bool = False, ue_pathloss: list = None,
                  sched_policy: str = "rr", n_carriers: int = 1,
                  tdd_config: int = None):
    n = 1 + n_ues
    pl = np.full((n, n), pathloss_db, np.float32)
    np.fill_diagonal(pl, 0)
    if ue_pathloss:
        for i, v in enumerate(ue_pathloss[:n_ues]):
            pl[0, 1 + i] = pl[1 + i, 0] = v
    prop = sinr.Propagation(pathloss_db=pl)
    roles = {0: "enb", **{1 + i: "ue" for i in range(n_ues)}}
    bus = otabus.OtaBus(prop, node_ids=list(range(n)), n_prb=n_prb,
                        paced=paced, roles=roles)
    net = ttiloop.Network(bus)
    hss = hss_mod.Hss()
    spgw = spgw_mod.Spgw()
    mme = mme_mod.Mme(hss, spgw)
    enb = enb_stack.EnbStack(mme, enb_id=1, n_prb=n_prb,
                             sched_policy=sched_policy,
                             n_carriers=n_carriers)
    net.add(phy_adapter.EnbPhyAdapter(bus, 0, cell_id=1, n_prb=n_prb,
                                      mac=enb, tdd_config=tdd_config))
    ues = []
    for i in range(n_ues):
        imsi = f"0010100000000{i:02d}"
        key = bytes(range(16))
        hss.add(hss_mod.Subscriber(imsi=imsi, key=key))
        opc = security.milenage_opc(key, b"\x00" * 16)
        ue = ue_stack.UeStack(ue_stack.Usim(imsi, key, opc), preamble=(7 + i) % 64)
        net.add(phy_adapter.UePhyAdapter(bus, 1 + i, cell_id=1,
                                         n_prb=n_prb, stack=ue,
                                         tdd_config=tdd_config))
        ues.append(ue)
    return dict(net=net, bus=bus, mme=mme, spgw=spgw, enb=enb, ues=ues, hss=hss)


def run_waveform_full(args):
    """--waveform-full: the whole UE life cycle through the device PHY.

    No message bus below L2 anywhere — `runtime/wavenet.WaveformNetwork`
    carries cell search -> MIB -> PRACH -> RA -> RRC/NAS attach -> IP
    traffic as OFDM waveforms over per-link AWGN channels, the posture of
    the reference's ZMQ IQ mode (lib/src/phy/rf/rf_zmq_imp.c)."""
    from ..runtime import wavenet

    hss = hss_mod.Hss()
    spgw = spgw_mod.Spgw()
    mme = mme_mod.Mme(hss, spgw)
    enb = enb_stack.EnbStack(mme, enb_id=1, n_prb=args.prb)
    ues = []
    for i in range(args.ues):
        imsi = f"0010100000000{i:02d}"
        key = bytes(range(16))
        hss.add(hss_mod.Subscriber(imsi=imsi, key=key))
        opc = security.milenage_opc(key, b"\x00" * 16)
        ues.append(ue_stack.UeStack(ue_stack.Usim(imsi, key, opc),
                                    preamble=(7 + i) % 64))
    net = wavenet.WaveformNetwork(
        enb, ues, pathloss_db=np.full(args.ues, args.pathloss),
        n_prb=args.prb, fading_profile=args.fading or None,
        dyn_delay=(tuple(float(x) for x in args.dyn_delay.split(","))
                   if args.dyn_delay else None),
        hst_fd_hz=args.hst or None,
        rlf=(tuple(float(x) for x in args.rlf.split(","))
             if args.rlf else None))

    t0 = time.time()
    attach_tti = {}
    limit = max(args.ttis, 200 + 100 * args.ues)
    while net.tti < limit:
        net.run(10)
        for i, u in enumerate(ues):
            if i not in attach_tti and u.emm_state == "REGISTERED":
                attach_tti[i] = net.tti
        if len(attach_tti) == args.ues:
            break
    attach_wall = time.time() - t0
    attached = [u for u in ues if u.emm_state == "REGISTERED"]

    # IP traffic over the waveform PDSCH/PUSCH
    for u in attached:
        pkt = spgw_mod.make_ipv4("8.8.8.8", u.ip_addr, b"d" * 120)
        for _ in range(4):
            spgw.handle_sgi_pdu(pkt)
        u.gw_send(spgw_mod.make_ipv4(u.ip_addr, "8.8.8.8", b"u" * 120))
    t1 = time.time()
    steady = 60
    net.run(steady)
    steady_wall = time.time() - t1

    summary = dict(
        mode="waveform-full",
        ttis=net.tti,
        ues=args.ues,
        attached=len(attached),
        attach_tti=attach_tti,
        attach_wall_s=round(attach_wall, 1),
        steady_sf_per_sec=round(steady / steady_wall, 1),
        dl_ip_bytes=sum(sum(len(p) for p in u.gw_rx) for u in ues),
        ul_ip_bytes=spgw.metrics["ul_bytes"],
        enb_phy=net.enb.metrics,
        ue0_phy=net.ues[0].metrics,
    )
    print(json.dumps(summary))
    return summary


def run_waveform_block(args):
    """--waveform-block: attach over the host-paced waveform network,
    then run the steady state DEVICE-RESIDENT — T TTIs x n_ues of the
    full PHY both directions per compiled call (runtime/waveblock.py,
    the SURVEY §7.7 time-block batch).  Reports steady-state TTIs/s
    with the host out of the per-TTI loop."""
    from ..runtime import waveblock, wavenet

    hss = hss_mod.Hss()
    spgw = spgw_mod.Spgw()
    mme = mme_mod.Mme(hss, spgw)
    enb = enb_stack.EnbStack(mme, enb_id=1, n_prb=args.prb)
    ues = []
    for i in range(args.ues):
        imsi = f"0010100000000{i:02d}"
        key = bytes(range(16))
        hss.add(hss_mod.Subscriber(imsi=imsi, key=key))
        opc = security.milenage_opc(key, b"\x00" * 16)
        ues.append(ue_stack.UeStack(ue_stack.Usim(imsi, key, opc),
                                    preamble=(7 + i) % 64))
    net = wavenet.WaveformNetwork(
        enb, ues, pathloss_db=np.full(args.ues, args.pathloss),
        n_prb=args.prb)
    t0 = time.time()
    limit = max(args.ttis, 200 + 100 * args.ues)
    while net.tti < limit:
        net.run(10)
        if all(u.emm_state == "REGISTERED" for u in ues):
            break
    attach_wall = time.time() - t0
    attached = [u for u in ues if u.emm_state == "REGISTERED"]

    runner = waveblock.SpsBlockRunner(net, T=args.block_ttis)
    for u in attached:
        pkt = spgw_mod.make_ipv4("8.8.8.8", u.ip_addr, b"d" * 120)
        for _ in range(4):
            spgw.handle_sgi_pdu(pkt)
        u.gw_send(spgw_mod.make_ipv4(u.ip_addr, "8.8.8.8", b"u" * 120))
    runner.run_block()  # compile + first block outside the timed window
    t1 = time.time()
    n_blocks = max(2, args.ttis // args.block_ttis)
    for _ in range(n_blocks):
        runner.run_block()
    steady_wall = time.time() - t1
    ttis_run = n_blocks * runner.cfg.T
    summary = dict(
        mode="waveform-block",
        ues=args.ues,
        attached=len(attached),
        attach_wall_s=round(attach_wall, 1),
        block_ttis=runner.cfg.T,
        blocks=n_blocks,
        steady_ttis_per_sec=round(ttis_run / steady_wall, 1),
        realtime_factor=round(ttis_run / steady_wall / 1000.0, 2),
        block_metrics=runner.metrics,
        dl_ip_bytes=sum(sum(len(p) for p in u.gw_rx) for u in ues),
        ul_ip_bytes=spgw.metrics["ul_bytes"],
    )
    print(json.dumps(summary))
    return summary


def run_waveform_dyn(args):
    """--waveform-dyn: attach over the host-paced waveform network, then
    run the steady state DEVICE-RESIDENT with DYNAMIC per-TTI scheduling:
    PDCCH DCI at true search-space CCEs, UE blind decode, 8-process
    IR-HARQ soft buffers, PUCCH ACK + PHICH over the air — one compiled
    call per R rounds of 8 TTIs (runtime/waveblock_dyn.py)."""
    from ..runtime import waveblock_dyn, wavenet

    hss = hss_mod.Hss()
    spgw = spgw_mod.Spgw()
    mme = mme_mod.Mme(hss, spgw)
    enb = enb_stack.EnbStack(mme, enb_id=1, n_prb=args.prb)
    ues = []
    for i in range(args.ues):
        imsi = f"0010100000000{i:02d}"
        key = bytes(range(16))
        hss.add(hss_mod.Subscriber(imsi=imsi, key=key))
        opc = security.milenage_opc(key, b"\x00" * 16)
        ues.append(ue_stack.UeStack(ue_stack.Usim(imsi, key, opc),
                                    preamble=(7 + i) % 64))
    net = wavenet.WaveformNetwork(
        enb, ues, pathloss_db=np.full(args.ues, args.pathloss),
        n_prb=args.prb)
    # the block's PDCCH plan is static: attach on C-RNTIs whose search
    # spaces admit every UE's two grants in every subframe (the eNB's
    # RNTI-assignment freedom; spares cover RACH retries)
    enb.use_rnti_pool(waveblock_dyn.feasible_rntis(
        net.cell, args.ues + 4, start=enb.next_rnti))
    t0 = time.time()
    limit = max(args.ttis, 200 + 100 * args.ues)
    while net.tti < limit:
        net.run(10)
        if all(u.emm_state == "REGISTERED" for u in ues):
            break
    attach_wall = time.time() - t0
    attached = [u for u in ues if u.emm_state == "REGISTERED"]

    runner = waveblock_dyn.DynBlockRunner(
        net, R=max(1, args.block_ttis // 8))
    for u in attached:
        pkt = spgw_mod.make_ipv4("8.8.8.8", u.ip_addr, b"d" * 120)
        for _ in range(4):
            spgw.handle_sgi_pdu(pkt)
        u.gw_send(spgw_mod.make_ipv4(u.ip_addr, "8.8.8.8", b"u" * 120))
    runner.run_block()  # compile + first block outside the timed window
    t1 = time.time()
    n_blocks = max(2, args.ttis // runner.cfg.T)
    for _ in range(n_blocks):
        runner.run_block()
    steady_wall = time.time() - t1
    ttis_run = n_blocks * runner.cfg.T
    summary = dict(
        mode="waveform-dyn",
        ues=args.ues,
        attached=len(attached),
        attach_wall_s=round(attach_wall, 1),
        block_ttis=runner.cfg.T,
        blocks=n_blocks,
        steady_ttis_per_sec=round(ttis_run / steady_wall, 1),
        realtime_factor=round(ttis_run / steady_wall / 1000.0, 2),
        block_metrics=runner.metrics,
        dl_ip_bytes=sum(sum(len(p) for p in u.gw_rx) for u in ues),
        ul_ip_bytes=spgw.metrics["ul_bytes"],
    )
    print(json.dumps(summary))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ues", type=int, default=2)
    ap.add_argument("--ttis", type=int, default=300)
    ap.add_argument("--prb", type=int, default=25)
    ap.add_argument("--pathloss", type=float, default=80.0)
    ap.add_argument("--paced", action="store_true")
    ap.add_argument("--csv", default="")
    ap.add_argument("--pcap", default="")
    ap.add_argument("--ostat-port", type=int, default=0)
    ap.add_argument("--traffic-bytes", type=int, default=10000)
    ap.add_argument("--carriers", type=int, default=1,
                    help="component carriers (1 = no CA; N-1 SCells are"
                         " configured by RRC and activated by MAC CE)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the JAX CPU backend")
    ap.add_argument("--mbms", action="store_true",
                    help="start an eMBMS session (M2AP -> SIB13 -> MCCH),"
                         " subscribe every UE, and multicast 5 packets;"
                         " the summary reports per-UE MTCH delivery")
    ap.add_argument("--waveform", action="store_true",
                    help="after attach, carry each UE's DL burst through the"
                         " real device PHY (runtime/wavesim) and report"
                         " delivery + measured SNR")
    ap.add_argument("--fading", default="",
                    help="with --waveform-full: carry every link through"
                         " a 36.101 tapped-delay-line profile"
                         " (epa/eva/etu) with 5 Hz Doppler")
    ap.add_argument("--waveform-full", action="store_true",
                    help="run the ENTIRE network over waveforms: no message"
                         " bus below L2 — cell search, MIB, PRACH, RA, RRC,"
                         " NAS and IP traffic all ride OFDM through AWGN"
                         " links (runtime/wavenet, the reference's ZMQ IQ"
                         " mode); reports attach latency + steady sf/s")
    ap.add_argument("--tdd", type=int, default=-1,
                    help="TDD UL/DL configuration 0-6 (36.211 Table"
                         " 4.2-2): DL only on D/S subframes, UL held to"
                         " U subframes, DCI-0 on k-associated subframes"
                         " (-1 = FDD)")
    ap.add_argument("--dyn-delay", default="",
                    help="with --waveform-full: sinusoidal path delay"
                         " 'min_us,max_us,period_s' (channel/delay.c)")
    ap.add_argument("--hst", type=float, default=0.0,
                    help="with --waveform-full: high-speed-train Doppler"
                         " trajectory, peak shift in Hz (36.101 B.3)")
    ap.add_argument("--rlf", default="",
                    help="with --waveform-full: periodic outage"
                         " 'period_s,outage_s' (channel/rlf.c); the UE"
                         " recovers via RRC reestablishment")
    ap.add_argument("--waveform-dyn", action="store_true",
                    help="device-resident DYNAMIC block mode: per-TTI "
                         "PDCCH DCI + 8-process IR-HARQ on device "
                         "(runtime/waveblock_dyn.py)")
    ap.add_argument("--waveform-block", action="store_true",
                    help="like --waveform-full, but after attach the"
                         " steady state runs DEVICE-RESIDENT: T TTIs x"
                         " n_ues of full PHY per compiled call"
                         " (runtime/waveblock); reports TTIs/s")
    ap.add_argument("--block-ttis", type=int, default=20,
                    help="TTIs per device block for --waveform-block")
    args = ap.parse_args(argv)
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    if args.waveform_dyn:
        return run_waveform_dyn(args)
    if args.waveform_block:
        return run_waveform_block(args)
    if args.waveform_full:
        return run_waveform_full(args)

    sysd = build_network(args.ues, args.pathloss, args.prb, args.paced,
                         n_carriers=args.carriers,
                         tdd_config=args.tdd if args.tdd >= 0 else None)
    net, mme, spgw, enb, ues = (sysd[k] for k in ("net", "mme", "spgw", "enb", "ues"))

    hub = metrics_mod.MetricsHub()
    hub.add_source("enb", lambda: dict(enb.metrics))
    hub.add_source("epc", lambda: dict(spgw.metrics, **mme.metrics))
    for i, ue in enumerate(ues):
        hub.add_source(f"ue{i}", lambda u=ue: dict(u.metrics, emm=u.emm_state))
    if args.csv:
        hub.add_listener(metrics_mod.CsvMetrics(args.csv))
    ostat = None
    if args.ostat_port:
        ostat = metrics_mod.OStatServer(hub, port=args.ostat_port)

    mac_pcap = pcap_mod.MacPcap(args.pcap) if args.pcap else None

    mbms_gw_obj = None
    if args.mbms:
        from ..epc import mbms_gw as mbms_mod

        mbms_gw_obj = mbms_mod.MbmsGw(area_id=1)
        mbms_gw_obj.add_enb_m2(enb.m2_endpoint())
        mbms_gw_obj.add_enb(mbms_mod.enb_pmch_sink(enb.mbms_queue))
        assert mbms_gw_obj.session_start(1)
        for u in ues:
            u.mbms_service_start(1)
        # the demo needs attach + one MCCH repetition occasion (320 TTIs)
        # + a few MBSFN subframes of MTCH drain — extend short runs
        args.ttis = max(args.ttis, 100 + 20 * args.ues + 400)

    t0 = time.time()
    # phase 1: attach
    net.run(min(args.ttis, 100 + 20 * args.ues))
    attached = [u for u in ues if u.emm_state == "REGISTERED"]
    # phase 2: traffic to every attached UE + uplink
    for u in attached:
        pkt = spgw_mod.make_ipv4("8.8.8.8", u.ip_addr, b"d" * 400)
        for _ in range(max(1, args.traffic_bytes // 400)):
            spgw.handle_sgi_pdu(pkt)
        u.gw_send(spgw_mod.make_ipv4(u.ip_addr, "8.8.8.8", b"u" * 400))
    remaining = max(0, args.ttis - (100 + 20 * args.ues))
    if mbms_gw_obj is not None:
        # let an MCCH repetition occasion (every 320 TTIs) pass first so
        # every UE has the area config — MTCH sent before a UE catches
        # the MCCH is lost to it, as for any late joiner in real eMBMS
        warm = min(remaining, 340)
        net.run(warm)
        remaining -= warm
        mpkt = spgw_mod.make_ipv4("10.0.0.1", "239.0.0.1", b"mb" * 50)
        for _ in range(5):
            mbms_gw_obj.handle_sgi_mb_pdu(mpkt)
    net.run(remaining)
    wall = time.time() - t0
    hub.poll()

    wf_summary = None
    if args.waveform and attached:
        from ..phch import grid as grid_mod
        from ..runtime import wavesim

        from ..phch import pdcch as pdcch_mod

        # widen the control region with load, as the reference's scheduler
        # does when the CCE tree fills (scheduler_grid.cc cfi escalation)
        cfi = 1 if len(attached) <= 2 else (2 if len(attached) <= 4 else 3)
        cell = grid_mod.CellConfig(n_prb=args.prb, cell_id=1, cfi=cfi)
        dp = wavesim.WaveformDataPlane(cell)
        per_ue = max(1, args.prb // max(1, len(attached)) - 1)
        # whole-TTI data plane: every attached UE rides SHARED multi-grant
        # subframes through ONE compiled graph (send_tti); CCEs from each
        # UE's true 36.213 search space, collision-free
        alloc = pdcch_mod.allocate_cces(cell, [u.crnti for u in attached],
                                        sf_idx=1)
        placed = [u for u in attached if u.crnti in alloc]
        pls = {}
        for i, u in enumerate(placed):
            mask = tuple(1 if i * per_ue <= p < (i + 1) * per_ue else 0
                         for p in range(args.prb))
            l, start = alloc[u.crnti]
            dp.add_ue(u.crnti, mask, qm=4, l_aggr=l, cce_start=start)
            pls[u.crnti] = float(sysd["bus"].prop.pathloss_db[0, 1 + ues.index(u)])
        nb = min(dp.slots[u.crnti].tbs(cell, 1) // 8 - 2 for u in placed)
        pkt = (b"wf" * 50)[:nb]
        outs = dp.send_tti({u.crnti: [pkt] * 4 for u in placed}, pls)
        results = []
        for u in placed:
            out = outs[u.crnti]
            ok = sum(1 for got, _ in out if got == pkt)
            results.append(dict(rnti=u.crnti, delivered=ok, of=4,
                                snr_db=round(out[0][1], 1)))
        # UL control: every attached UE ACKs its burst on its own PUCCH
        # format-1a resource in ONE subframe — superposed waveforms,
        # matched-filter detection at the eNB
        cp = wavesim.UlControlPlane(cell)
        pls = {}
        for i, u in enumerate(attached):
            cp.add_ue(u.crnti, i)
            pls[u.crnti] = float(sysd["bus"].prop.pathloss_db[0, 1 + ues.index(u)])
        det = cp.step({u.crnti: 1 for u in attached}, pls)
        for r in results:
            d, ack, metric = det[r["rnti"]]
            r["pucch_ack"] = bool(d and ack == 1)
            r["pucch_db"] = round(metric, 1)
        # UL data + aperiodic CQI: the DCI-0 csi_request path through the
        # real PUSCH (UCI multiplexed per 36.212, decoded at the eNB)
        up = wavesim.UlSchPlane(cell)
        from ..phch import pusch as pusch_mod
        ul_prb = max(2, args.prb // max(1, len(placed)) - 1)
        while not pusch_mod.valid_n_prb(ul_prb):  # DFT sizes: 2^a 3^b 5^c
            ul_prb -= 1
        pls_ul = {}
        for i, u in enumerate(placed):
            up.add_ue(u.crnti, min(i * ul_prb, args.prb - ul_prb), ul_prb)
            pls_ul[u.crnti] = float(
                sysd["bus"].prop.pathloss_db[0, 1 + ues.index(u)])
        wb = {u.crnti: min(15, max(1, int(round(
            (up.tx_power_dbm - pls_ul[u.crnti] - up.noise_floor_dbm) / 2
            + 2)))) for u in placed}
        ul = up.step({u.crnti: (b"ul" * 6, wb[u.crnti]) for u in placed},
                     pls_ul)
        for r in results:
            pkt, ok, cqi = ul[r["rnti"]]
            r["pusch_ok"] = bool(ok and pkt == b"ul" * 6)
            r["aperiodic_cqi"] = cqi
            r["cqi_exact"] = bool(cqi == wb[r["rnti"]])
        wf_summary = results

    summary = dict(
        ttis=net.bus.curr_tti if net.bus.curr_tti else args.ttis,
        wall_s=round(wall, 3),
        ttis_per_sec=round(args.ttis / wall, 1),
        realtime_factor=round(args.ttis / wall / 1000.0, 2),
        attached=len(attached),
        ues=args.ues,
        dl_ip_bytes=sum(u.metrics.get("dl_ip_bytes", 0) for u in ues),
        ul_ip_bytes=spgw.metrics["ul_bytes"],
    )
    if mbms_gw_obj is not None:
        got = [len(getattr(u, "mbms_rx", ())) for u in ues]
        summary["mbms"] = dict(sent=5, ues_all5=sum(1 for g in got if g == 5),
                               min_rx=min(got), max_rx=max(got))
    if wf_summary is not None:
        summary["waveform"] = wf_summary
    print(json.dumps(summary))
    if mac_pcap:
        mac_pcap.close()
    if ostat:
        ostat.stop()
    return summary


if __name__ == "__main__":
    main()
