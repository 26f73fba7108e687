"""srsenb-equivalent app shell: one eNB node process.

Reference behavior: `srsenb/src/main.cc` — config/CLI parsing, daemonize,
metrics sinks, wiring radio->phy->stack; the -emane build replaces the radio
with the MHAL.  Here the MHAL role is the distributed OTA hub
(runtime/distrib); S1AP toward the MME rides the epc_app's TCP endpoint.

Usage:
    python -m srslte_emane_tpu.apps.enb_app --conf enb.conf \
        --hub HOST:PORT --node-id 0 --epc HOST:PORT --ttis 1000
"""

from __future__ import annotations

import argparse
import json

from ..runtime import distrib, phy_adapter
from ..stack import enb_stack
from ..utils import config as config_mod, metrics as metrics_mod, pcap as pcap_mod
from . import rpc


def main(argv=None):
    distrib.keep_off_accelerator()
    ap = argparse.ArgumentParser()
    ap.add_argument("--conf", default=None)
    ap.add_argument("--hub", required=True)
    ap.add_argument("--node-id", type=int, default=0)
    ap.add_argument("--epc", required=True)
    ap.add_argument("--ttis", type=int, default=1000)
    ap.add_argument("--native-hub", action="store_true",
                    help="the hub is the C++ ota_hub daemon (binary OTA"
                         " protocol) instead of the python OtaHub")
    args, rest = ap.parse_known_args(argv)
    cfg = config_mod.load(config_mod.EnbConfig, args.conf, rest)

    host, port = args.hub.rsplit(":", 1)
    if args.native_hub:
        bus = distrib.NativeRemoteBus(host, int(port), args.node_id,
                                      n_prb=cfg.n_prb)
    else:
        bus = distrib.RemoteBus(host, int(port), args.node_id)
    ehost, eport = args.epc.rsplit(":", 1)
    mme = rpc.RemoteMme(ehost, int(eport))  # S1AP over TCP to the MME process
    enb = enb_stack.EnbStack(mme, enb_id=cfg.enb_id, n_prb=cfg.n_prb,
                             mcs=cfg.mcs, pci=cfg.cell_id, plmn=cfg.plmn)
    if cfg.max_rrc_users:
        enb.max_rrc_users = cfg.max_rrc_users
    enb.q_hyst_db = cfg.q_hyst_db
    if cfg.embms_enable:
        # config-enabled eMBMS (enb.conf [embms] role): announce the
        # configured session as if an M2AP Session Start had arrived
        enb.mbms_area_id = cfg.embms_area_id
        enb.mbms_sessions[cfg.embms_service_id] = 1
    node = phy_adapter.EnbPhyAdapter(bus, args.node_id, cell_id=cfg.cell_id,
                                     n_prb=cfg.n_prb, mac=enb,
                                     tx_power_mw=cfg.tx_power_mw)
    pcap = pcap_mod.MacPcap(cfg.pcap_filename) if cfg.pcap_enable else None
    hub = metrics_mod.MetricsHub()
    hub.add_source("enb", lambda: dict(enb.metrics))
    for _ in range(args.ttis):
        node.run_tti(bus.curr_tti)
        bus.step_tti()
        if bus.curr_tti % cfg.metrics_period_ttis == 0:
            hub.poll()
    print(json.dumps(dict(enb.metrics)))
    if pcap:
        pcap.close()
    bus.close()


if __name__ == "__main__":
    main()
