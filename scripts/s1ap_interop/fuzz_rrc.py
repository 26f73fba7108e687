"""Differential RRC codec fuzzer: randomized messages from the repo's
36.331 schema, round-tripped through the REFERENCE's generated codec.

Usage:
    python fuzz_rrc.py [n_per_channel] [seed]        # emit harness lines
    python fuzz_rrc.py [n] [seed] | ./unpack_rrc     # the differential run
    python check_rrc.py < unpack_rrc_output          # verdict

Every line is `<channel> <name> <hex>`; `unpack_rrc` (see README.md)
unpacks with rrc_asn1.cc and echoes `REPACK <name> <hex>` — byte-equality
with the input proves field-for-field agreement.  Names are
`fz_<channel>_<i>`; the checker joins on them.

The avoid-list excludes (a) schema nodes that stand in for structured
types as opaque octets, (b) post-REL-8 extension arms outside the
reference vintage's repack discipline — every exclusion is a known,
listed subset boundary, not silent luck.
"""

import sys
import zlib

import os
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np

from srslte_emane_tpu.stack.asn1 import fuzz, rrc36331 as rrc
from srslte_emane_tpu.stack.asn1.runtime import uper_decode, uper_encode

# opaque stand-ins for structured types + inter-RAT containers the repo
# does not model structurally (random octets are not valid contents)
AVOID = {
    "non_crit_ext",

    # (rn_recfg_r10 / rn_recfg_complete_r10 are real schemas as of r4 —
    # the last DL/UL-DCCH octet stand-ins are gone)

    # REFERENCE limitation: DRB-CountInfo's INTEGER (0..4294967295) hits
    # a ceil(log2(range)) uint32 overflow in the generated codec, which
    # therefore packs/unpacks the two counts in ZERO bits (X.691 says
    # 32); counterCheckResponse can never round-trip spec-exact
    "counter_check_resp",
    # (every structured container of the v1250..v1430 chain is a real
    # schema as of r4: SCG dual connectivity, V2X sidelink,
    # LWA/LWIP/RCLWI, WLAN offload, sidelink disc/comm/sync, SCell ext
    # lists)
    # (the UE-EUTRA-Capability chain is structural ALL the way:
    # v920..v1360 as of r4, and round 5 closed the rel-14/rel-15 tail —
    # v1430 (CE enhancements, FD-MIMO CSI r14, V2X band combinations,
    # LAA/LWA/LWIP, MMTel/mobility/HST), v1440/v1450/v1460 (MUST band
    # combinations, overheating ind), v1510 (EN-DC, NR band list, EUTRA
    # feature sets, NR PDCP), v1520/v1530 (sTTI/SPT, URLLC, UDC,
    # 1024QAM, sidelink r15) — the chain terminates at v1530 exactly as
    # the reference vintage does)
    # empty future-extension arms: legal but informationless
    "msg_class_ext", "crit_exts_future",
    # REFERENCE CRASH: sl_comm_tx_pool_sensing_cfg_r14_s::unpack
    # dereferences the copy_ptr thres_pssch_rsrp_list_r14 without
    # allocating it (unpack_fixed_seq_of on a null array) — ANY message
    # carrying SL-CommTxPoolSensingConfig-r14 segfaults the reference
    # codec (INTEROP.md R6); both fields that embed it are excluded
    "v2x_res_sel_cfg_r14", "v2x_comm_tx_pool_sensing_cfg_r14",
    # REFERENCE limitation: rrc_asn1.cc's generated pack/unpack for
    # lateNonCriticalExtension carries ONLY the presence flag and drops
    # the octet-string body (sib_type2_s::pack group_flags[0]) — a
    # non-empty value can never repack byte-exact through the reference
    "late_non_crit_ext",
}

CHANNELS = [
    ("ul_ccch", rrc.UL_CCCH_MSG),
    ("dl_ccch", rrc.DL_CCCH_MSG),
    ("ul_dcch", rrc.UL_DCCH_MSG),
    ("dl_dcch", rrc.DL_DCCH_MSG),
    ("pcch", rrc.PCCH_MSG),
    ("bcch_dl_sch", rrc.BCCH_DL_SCH_MSG),
]


def _c1_alts(schema, avoid):
    """Names of the generatable messages under the channel's c1 CHOICE."""
    msg = dict((n, t) for n, t, *_ in
               [(f[0], f[1]) for f in schema.fields])["msg"]
    c1 = dict(msg.alts)["c1"]
    return [n for n, _ in c1.alts
            if not n.startswith("spare") and n not in avoid]


def recfg_chain_corpus(n: int, seed: int):
    """Chain-heavy lane: every message is an RRCConnectionReconfiguration
    carrying a random-depth v890->..->v1510 nonCriticalExtension chain —
    the round-robin corpus reaches these levels only a handful of times,
    so the r10/r12/r13 arms (SCell lists, LWA/LWIP/RCLWI, sidelink sync)
    get their fuzz pressure here."""
    cfg = fuzz.FuzzConfig(avoid=AVOID)
    rng = np.random.default_rng(seed ^ zlib.crc32(b"recfg_chain"))
    out = []
    made = tries = 0
    while made < n:
        tries += 1
        assert tries < 300 * n, "recfg chain generator stuck"
        v = fuzz.rand_value(rrc.DL_DCCH_MSG, rng, cfg)
        alt, inner = v["msg"]
        if alt != "c1" or inner[0] != "rrc_conn_recfg":
            continue
        crit = inner[1]["crit_exts"]
        if crit[0] != "c1" or crit[1][1] is None:
            continue
        crit[1][1]["non_crit_ext"] = _recfg_chain(rng, cfg)
        b = uper_encode(rrc.DL_DCCH_MSG, v)
        if len(b) > 1000:
            continue
        v2 = uper_decode(rrc.DL_DCCH_MSG, b)
        assert uper_encode(rrc.DL_DCCH_MSG, v2) == b
        out.append(("dl_dcch", f"fz_recfg_chain_{made}", b))
        made += 1
    return out


# UE-EUTRA-Capability nonCriticalExtension chain, shallow -> deep.
# Random generation reaches the v1130+ levels only ~4% of the time
# (eight nested 50% presence choices), so the rel-9..rel-11 levels get
# their fuzz pressure from an explicitly-grafted chain, like the
# reconfiguration chain lane below.
_UE_CAP_CHAIN = (
    ("UE_EUTRA_CAP_V920", "non_crit_ext_v940"),
    ("UE_EUTRA_CAP_V940", "non_crit_ext_v1020"),
    ("UE_EUTRA_CAP_V1020", "non_crit_ext_v1060"),
    ("UE_EUTRA_CAP_V1060", "non_crit_ext_v1090"),
    ("UE_EUTRA_CAP_V1090", "non_crit_ext_v1130"),
    ("UE_EUTRA_CAP_V1130", "non_crit_ext_v1170"),
    ("UE_EUTRA_CAP_V1170", "non_crit_ext_v1180"),
    ("UE_EUTRA_CAP_V1180", "non_crit_ext_v11a0"),
    ("UE_EUTRA_CAP_V11A0", "non_crit_ext_v1250"),
    ("UE_EUTRA_CAP_V1250", "non_crit_ext_v1260"),
    ("UE_EUTRA_CAP_V1260", "non_crit_ext_v1270"),
    ("UE_EUTRA_CAP_V1270", "non_crit_ext_v1280"),
    ("UE_EUTRA_CAP_V1280", "non_crit_ext_v1310"),
    ("UE_EUTRA_CAP_V1310", "non_crit_ext_v1320"),
    ("UE_EUTRA_CAP_V1320", "non_crit_ext_v1330"),
    ("UE_EUTRA_CAP_V1330", "non_crit_ext_v1340"),
    ("UE_EUTRA_CAP_V1340", "non_crit_ext_v1350"),
    ("UE_EUTRA_CAP_V1350", "non_crit_ext_v1360"),
    ("UE_EUTRA_CAP_V1360", "non_crit_ext_v1430"),
    ("UE_EUTRA_CAP_V1430", "non_crit_ext_v1440"),
    ("UE_EUTRA_CAP_V1440", "non_crit_ext_v1450"),
    ("UE_EUTRA_CAP_V1450", "non_crit_ext_v1460"),
    ("UE_EUTRA_CAP_V1460", "non_crit_ext_v1510"),
    ("UE_EUTRA_CAP_V1510", "non_crit_ext_v1520"),
    ("UE_EUTRA_CAP_V1520", "non_crit_ext_v1530"),
    ("UE_EUTRA_CAP_V1530", None),
)


def ue_cap_chain_corpus(n: int, seed: int):
    """Chain-heavy capability lane: every message carries the
    v920->..->v1530 nonCriticalExtension chain to a random depth."""
    cfg = fuzz.FuzzConfig(avoid=AVOID)
    rng = np.random.default_rng(seed ^ zlib.crc32(b"ue_cap_chain"))
    out = []
    made = 0
    while made < n:
        depth = int(rng.integers(1, len(_UE_CAP_CHAIN) + 1))
        vals = [fuzz.rand_value(getattr(rrc, name), rng, cfg)
                for name, _ in _UE_CAP_CHAIN[:depth]]
        for (_, link), parent, child in zip(_UE_CAP_CHAIN, vals, vals[1:]):
            parent[link] = child
        root = fuzz.rand_value(rrc.UE_EUTRA_CAPABILITY, rng, cfg)
        root["non_crit_ext_v920"] = vals[0]
        b = uper_encode(rrc.UE_EUTRA_CAPABILITY, root)
        if len(b) > 1000:
            continue
        v2 = uper_decode(rrc.UE_EUTRA_CAPABILITY, b)
        assert uper_encode(rrc.UE_EUTRA_CAPABILITY, v2) == b
        out.append(("ue_cap", f"fz_ue_cap_chain_{made}", b))
        made += 1
    return out


def ue_cap_corpus(n: int, seed: int):
    """Randomized bare UE-EUTRA-Capability values (the type rides OCTET
    STRING containers on the wire; the harness 'ue_cap' channel
    round-trips it directly through rrc_asn1.cc)."""
    cfg = fuzz.FuzzConfig(avoid=AVOID)
    rng = np.random.default_rng(seed ^ zlib.crc32(b"ue_cap"))
    out = []
    for i in range(n):
        v = fuzz.rand_value(rrc.UE_EUTRA_CAPABILITY, rng, cfg)
        b = uper_encode(rrc.UE_EUTRA_CAPABILITY, v)
        v2 = uper_decode(rrc.UE_EUTRA_CAPABILITY, b)
        assert uper_encode(rrc.UE_EUTRA_CAPABILITY, v2) == b
        out.append(("ue_cap", f"fz_ue_cap_{i}", b))
    return out


# reconfiguration nonCriticalExtension chain, shallow -> deep.  The
# global "non_crit_ext" AVOID (fuzz.DEFAULT_AVOID) suppresses every link
# of this chain during plain rand_value, so the v920..v1510 levels are
# fuzzed by GRAFTING an explicitly-built chain into generated
# RRCConnectionReconfiguration messages (half of that corpus lane).
_RECFG_CHAIN = (
    "RRC_CONN_RECFG_V920", "RRC_CONN_RECFG_V1020", "RRC_CONN_RECFG_V1130",
    "RRC_CONN_RECFG_V1250", "RRC_CONN_RECFG_V1310", "RRC_CONN_RECFG_V1430",
    "RRC_CONN_RECFG_V1510")


def _recfg_chain(rng, cfg):
    """A random-depth v890->v920->..->v1510 nonCriticalExtension value."""
    depth = int(rng.integers(1, len(_RECFG_CHAIN) + 1))
    vals = [fuzz.rand_value(getattr(rrc, name), rng, cfg)
            for name in _RECFG_CHAIN[:depth]]
    for parent, child in zip(vals, vals[1:]):
        parent["non_crit_ext"] = child
    return {"non_crit_ext": vals[0]}  # the v890 wrapper (late ext avoided)


def corpus(n_per_channel: int, seed: int, avoid=frozenset()):
    """[(channel, name, bytes)] — deterministic for (n, seed).  Spreads
    each channel's corpus round-robin over its c1 message types so every
    message schema gets equal fuzz pressure."""
    cfg = fuzz.FuzzConfig(avoid=AVOID | set(avoid))
    out = []
    for chan, schema in CHANNELS:
        rng = np.random.default_rng(seed ^ zlib.crc32(chan.encode()))
        alts = _c1_alts(schema, cfg.avoid)
        made = 0
        tries = 0
        while made < n_per_channel:
            tries += 1
            assert tries < 300 * n_per_channel, f"{chan}: generator stuck"
            v = fuzz.rand_value(schema, rng, cfg)
            alt, inner = v["msg"]
            if alt != "c1" or inner[0] != alts[made % len(alts)]:
                continue  # round-robin the message type
            if inner[0] == "rrc_conn_recfg" and rng.random() < 0.5:
                # graft the v920..v1510 nonCriticalExtension chain the
                # global non_crit_ext AVOID otherwise suppresses
                crit = inner[1]["crit_exts"]
                if crit[0] == "c1" and crit[1][1] is not None:
                    crit[1][1]["non_crit_ext"] = _recfg_chain(rng, cfg)
            b = uper_encode(schema, v)
            if len(b) > 1000:
                continue  # harness line-length bound
            # self round-trip must be byte-stable before we blame anyone
            v2 = uper_decode(schema, b)
            b2 = uper_encode(schema, v2)
            assert b2 == b, (chan, v, b.hex(), b2.hex())
            out.append((chan, f"fz_{chan}_{made}", b))
            made += 1
    return out


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    for chan, name, b in (corpus(n, seed) + ue_cap_corpus(n, seed)
                          + ue_cap_chain_corpus(n, seed)
                          + recfg_chain_corpus(n, seed)):
        print(chan, name, b.hex())


if __name__ == "__main__":
    main()
