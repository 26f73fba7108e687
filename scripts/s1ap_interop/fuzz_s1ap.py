"""Differential S1AP fuzzer: randomized PDUs from the repo's 36.413
builders, round-tripped through the reference's liblte_s1ap codec.

Usage:
    python fuzz_s1ap.py [n_per_proc] [seed]          # emit hex lines
    python fuzz_s1ap.py [n] [seed] | /tmp/s1ap_harness

The harness (harness.cpp + liblte_s1ap.cc) unpacks every line and echoes
`REPACK <hex>` — byte-equality proves field-for-field agreement across
the whole randomized parameter space of every S1AP procedure the stack
emits (InitialUEMessage, UL/DL NASTransport, UEContextRelease
Command/Request, Paging, InitialContextSetupRequest).
"""

import sys
import zlib

import os
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np

from srslte_emane_tpu.stack.asn1 import s1ap36413 as s1

CAUSES = ("emergency", "highPriorityAccess", "mt-Access",
          "mo-Signalling", "mo-Data")


def _bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _tai(rng):
    return dict(plmn=_bytes(rng, 3), tac=_bytes(rng, 2))


def _cgi(rng):
    return dict(plmn=_bytes(rng, 3), cell_id=int(rng.integers(0, 1 << 28)))


def _erab(rng):
    n_addr = int(rng.integers(1, 3)) * 4  # IPv4 or IPv8-style multiples
    return dict(erab_id=int(rng.integers(0, 15)),
                qci=int(rng.integers(0, 256)),
                arp_priority=int(rng.integers(0, 16)),
                pre_emption_capability=int(rng.integers(0, 2)),
                pre_emption_vulnerability=int(rng.integers(0, 2)),
                addr=_bytes(rng, n_addr), addr_bits=8 * n_addr,
                teid=int(rng.integers(0, 1 << 32)),
                nas_pdu=(_bytes(rng, int(rng.integers(1, 40)))
                         if rng.random() < 0.5 else None))


def gen(rng, kind: str) -> s1.S1apPdu:
    mme_id = int(rng.integers(0, 1 << 32))
    enb_id = int(rng.integers(0, 1 << 24))
    nas = _bytes(rng, int(rng.integers(1, 64)))
    if kind == "initial_ue":
        s_tmsi = (dict(mmec=int(rng.integers(0, 256)),
                       m_tmsi=int(rng.integers(0, 1 << 32)))
                  if rng.random() < 0.5 else None)
        return s1.initial_ue_message(
            enb_id, nas, _tai(rng), _cgi(rng),
            cause=CAUSES[int(rng.integers(0, len(CAUSES)))],
            s_tmsi=s_tmsi)
    if kind == "dl_nas":
        return s1.downlink_nas_transport(mme_id, enb_id, nas)
    if kind == "ul_nas":
        return s1.uplink_nas_transport(mme_id, enb_id, nas, _cgi(rng),
                                       _tai(rng))
    if kind == "release_cmd":
        return s1.ue_context_release_command(
            mme_id, enb_id, cause=("nas", int(rng.integers(0, 4))))
    if kind == "release_req":
        return s1.ue_context_release_request(
            mme_id, enb_id,
            cause=("radioNetwork", int(rng.integers(0, 36))))
    if kind == "paging":
        return s1.paging(_bytes(rng, 1), _bytes(rng, 4), _tai(rng),
                         cn_domain="ps" if rng.random() < 0.7 else "cs",
                         ue_identity_index=int(rng.integers(0, 1024)))
    if kind == "ctx_setup":
        n_erab = int(rng.integers(1, 4))
        return s1.initial_context_setup_request(
            mme_id, enb_id, _bytes(rng, 32),
            [_erab(rng) for _ in range(n_erab)],
            # REFERENCE limitation: liblte_s1ap.h stores BitRate in a
            # uint32 (BITRATE_STRUCT), so spec-legal values in
            # [2^32, 10^10] truncate on ITS side; cap the draw to the
            # range the reference can round-trip
            ambr_dl=int(rng.integers(0, 1 << 32)),
            ambr_ul=int(rng.integers(0, 1 << 32)),
            security_caps=dict(eea=int(rng.integers(0, 1 << 16)),
                               eia=int(rng.integers(0, 1 << 16))))
    if kind == "ho_required":
        genb = (dict(plmn=_bytes(rng, 3),
                     home_enb_id=int(rng.integers(0, 1 << 28)))
                if rng.random() < 0.3 else
                dict(plmn=_bytes(rng, 3),
                     macro_enb_id=int(rng.integers(0, 1 << 20))))
        return s1.handover_required(
            mme_id, enb_id, genb, _tai(rng),
            _bytes(rng, int(rng.integers(1, 80))),
            cause=("radioNetwork", int(rng.integers(0, 36))))
    if kind == "ho_command":
        return s1.handover_command(mme_id, enb_id,
                                   _bytes(rng, int(rng.integers(1, 80))))
    if kind == "ho_request":
        items = [dict(_erab(rng), nas_pdu=None)
                 for _ in range(int(rng.integers(1, 4)))]
        return s1.handover_request(
            mme_id, items, _bytes(rng, int(rng.integers(1, 60))),
            _bytes(rng, 32), nhcc=int(rng.integers(0, 8)),
            cause=("radioNetwork", int(rng.integers(0, 36))),
            ambr_dl=int(rng.integers(0, 1 << 32)),
            ambr_ul=int(rng.integers(0, 1 << 32)),
            security_caps=dict(eea=int(rng.integers(0, 1 << 16)),
                               eia=int(rng.integers(0, 1 << 16))))
    if kind == "ho_request_ack":
        adm = []
        for _ in range(int(rng.integers(1, 4))):
            it = dict(erab_id=int(rng.integers(0, 15)),
                      addr=_bytes(rng, 4),
                      teid=int(rng.integers(0, 1 << 32)))
            if rng.random() < 0.3:
                it["dl_addr"] = _bytes(rng, 4)
            if rng.random() < 0.3:
                it["dl_teid"] = int(rng.integers(0, 1 << 32))
            if rng.random() < 0.3:
                it["ul_addr"] = _bytes(rng, 4)
            if rng.random() < 0.3:
                it["ul_teid"] = int(rng.integers(0, 1 << 32))
            adm.append(it)
        return s1.handover_request_acknowledge(
            mme_id, enb_id, adm, _bytes(rng, int(rng.integers(1, 60))))
    if kind == "ho_notify":
        return s1.handover_notify(mme_id, enb_id, _cgi(rng), _tai(rng))
    if kind == "path_switch":
        sw = [dict(erab_id=int(rng.integers(0, 15)),
                   addr=_bytes(rng, 4),
                   teid=int(rng.integers(0, 1 << 32)))
              for _ in range(int(rng.integers(1, 4)))]
        return s1.path_switch_request(
            enb_id, sw, mme_id, _cgi(rng), _tai(rng),
            security_caps=dict(eea=int(rng.integers(0, 1 << 16)),
                               eia=int(rng.integers(0, 1 << 16))))
    if kind == "path_switch_ack":
        return s1.path_switch_request_acknowledge(
            mme_id, enb_id, _bytes(rng, 32), nhcc=int(rng.integers(0, 8)))
    if kind == "erab_setup_req":
        items = [dict(_erab(rng),
                      nas_pdu=_bytes(rng, int(rng.integers(1, 40))))
                 for _ in range(int(rng.integers(1, 4)))]
        return s1.erab_setup_request(
            mme_id, enb_id, items,
            ambr_dl=int(rng.integers(0, 1 << 32)),
            ambr_ul=int(rng.integers(0, 1 << 32)))
    if kind == "erab_setup_res":
        items = [dict(erab_id=int(rng.integers(0, 15)),
                      addr=_bytes(rng, 4),
                      teid=int(rng.integers(0, 1 << 32)))
                 for _ in range(int(rng.integers(1, 4)))]
        return s1.erab_setup_response(mme_id, enb_id, items)
    if kind == "erab_release_cmd":
        items = [dict(erab_id=int(rng.integers(0, 15)),
                      cause=("radioNetwork", int(rng.integers(0, 36))))
                 for _ in range(int(rng.integers(1, 4)))]
        return s1.erab_release_command(
            mme_id, enb_id, items,
            nas_pdu=(_bytes(rng, int(rng.integers(1, 30)))
                     if rng.random() < 0.5 else None),
            ambr_dl=int(rng.integers(0, 1 << 32)),
            ambr_ul=int(rng.integers(0, 1 << 32)))
    if kind == "erab_release_res":
        # REFERENCE limitation: liblte's list UNPACKs never re-align
        # after an item, but its PACKs do (liblte_s1ap.cc
        # unpack_e_rabreleaselistbearerrelcomp vs the pack side).  The
        # ReleaseItemBearerRelComp body is 7 bits, so any SECOND item's
        # header is read 1 bit off and the reference cannot decode its
        # own multi-item encoding.  Fuzz single-item lists; the
        # asymmetry is cataloged in docs/INTEROP.md.
        return s1.erab_release_response(
            mme_id, enb_id, [dict(erab_id=int(rng.integers(0, 15)))])
    raise KeyError(kind)


KINDS = ("initial_ue", "dl_nas", "ul_nas", "release_cmd", "release_req",
         "paging", "ctx_setup", "ho_required", "ho_command", "ho_request",
         "ho_request_ack", "ho_notify", "path_switch", "path_switch_ack",
         "erab_setup_req", "erab_setup_res", "erab_release_cmd",
         "erab_release_res")


def corpus(n_per_kind: int, seed: int):
    """[(kind, bytes)] — deterministic; every PDU self-round-trips."""
    out = []
    for kind in KINDS:
        rng = np.random.default_rng(seed ^ zlib.crc32(kind.encode()))
        for i in range(n_per_kind):
            pdu = gen(rng, kind)
            b = s1.encode_pdu(pdu)
            # our decode -> re-encode must be byte-stable first
            b2 = s1.encode_pdu(s1.decode_pdu(b))
            assert b2 == b, (kind, b.hex(), b2.hex())
            out.append((kind, b))
    return out


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 150
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    for kind, b in corpus(n, seed):
        print(b.hex())


if __name__ == "__main__":
    main()
