"""The live NAS wire carries true 24.301 bytes (stack/nas_wire.py).

Every NAS dataclass the stacks exchange must round-trip through real
24.301 wire encoding — the same liblte_mme-compatible layout the codec
interop tests prove byte-exact against reference vectors — and the
resulting bytes must independently re-decode through nas24301 as valid
spec messages (not the internal codec framing).
"""

import dataclasses

import pytest

from srslte_emane_tpu.stack import nas_msgs, nas_wire
from srslte_emane_tpu.stack.asn1 import nas24301


MESSAGES = [
    nas_msgs.AttachRequest(imsi="001010123456789", pdn_type="ipv4v6"),
    nas_msgs.AttachRequest(imsi="001017700000001",
                           esm_pdn_connectivity=False),
    nas_msgs.AttachAccept(ip_addr="172.16.3.9", guti=4711,
                          eps_bearer_id=5),
    nas_msgs.AttachComplete(),
    nas_msgs.AuthenticationRequest(rand=bytes(range(16)),
                                   autn=bytes(range(16, 32))),
    nas_msgs.AuthenticationResponse(res=b"\x11" * 8),
    nas_msgs.AuthenticationFailure(cause="synch-failure",
                                   auts=b"\x22" * 14),
    nas_msgs.AuthenticationFailure(cause="mac-failure", auts=b""),
    nas_msgs.AuthenticationReject(),
    nas_msgs.NasSecurityModeCommand(eea=0, eia=2),
    nas_msgs.NasSecurityModeComplete(),
    nas_msgs.EmmInformation(),
    nas_msgs.EmmInformation(full_name="LTE Emulator 1", short_name="emuLTE"),
    nas_msgs.DetachRequest(switch_off=True),
    nas_msgs.DetachRequest(switch_off=False),
    nas_msgs.ServiceRequest(guti=77),
    nas_msgs.ExtendedServiceRequest(guti=912, service_type="mt-csfb"),
    nas_msgs.CsServiceNotification(caller_id="15551234567"),
    nas_msgs.ServiceAccept(),
    nas_msgs.ServiceReject(cause=9),
    nas_msgs.TrackingAreaUpdateRequest(guti=31337, tac=1),
    nas_msgs.ActivateDedicatedEpsBearerRequest(
        eps_bearer_id=6, linked_bearer_id=5, qci=1,
        tft=b"\x21\x06\x30\x01\x02\x03"),
    nas_msgs.ActivateDedicatedEpsBearerAccept(eps_bearer_id=6),
]


@pytest.mark.parametrize("msg", MESSAGES, ids=lambda m: type(m).__name__)
def test_roundtrip(msg):
    data = nas_wire.encode(msg)
    # independently parses as a spec 24.301 message
    parsed = nas24301.decode(data)
    assert "msg_name" in parsed
    # and the typed message survives the wire exactly
    assert nas_wire.decode(data) == msg


def test_tau_accept_roundtrips_to_gprs_timer_granularity():
    """T3412 rides a real GPRS timer octet (2 s / 1 min units), so the
    value snaps to spec granularity on the wire."""
    out = nas_wire.decode(nas_wire.encode(
        nas_msgs.TrackingAreaUpdateAccept(t3412=500)))
    assert out.t3412 == 480  # 8 x 1 min
    out = nas_wire.decode(nas_wire.encode(
        nas_msgs.TrackingAreaUpdateAccept(t3412=60)))
    assert out.t3412 == 60


def test_nas_integrity_protection():
    """NasSecurity produces the 24.301 §9.1 security-protected format
    (sec-hdr | MAC | SQN | plain) with a verifiable EIA2 MAC; tampering
    fails verification; COUNTs advance per direction."""
    kasme = bytes(range(32))
    mme = nas_wire.NasSecurity(kasme, eia=2)
    ue = nas_wire.NasSecurity(kasme, eia=2)
    plain = nas_wire.encode(nas_msgs.NasSecurityModeCommand(eea=0, eia=2))
    prot = mme.protect(plain, downlink=True, new_ctx=True)
    assert prot[0] == 0x37  # sec-hdr 3 (new ctx) | PD EMM
    assert prot[6:] == plain
    out, ok = ue.unprotect(prot, downlink=True)
    assert ok and out == plain
    # transparent decode still yields the typed message
    assert nas_wire.decode(prot) == nas_msgs.NasSecurityModeCommand(
        eea=0, eia=2)
    # tampered MAC is rejected
    bad = bytes([prot[0]]) + b"\x00\x00\x00\x01" + prot[5:]
    _, ok = ue.unprotect(bad, downlink=True)
    assert not ok
    # counts advance and stay per-direction
    p2 = mme.protect(plain, downlink=True)
    assert p2[5] == 1 and mme.count[1] == 2 and mme.count[0] == 0
    out, ok = ue.unprotect(p2, downlink=True)
    assert ok and ue.count[1] == 2


def test_nas_ciphering_eea2():
    """With EEA2 the inner NAS message is actually encrypted on the wire
    (header 2), the MAC covers the ciphertext, and only the peer context
    can read it — transparent decode refuses ciphered bytes."""
    kasme = bytes(range(32))
    mme = nas_wire.NasSecurity(kasme, eia=2, eea=2)
    ue = nas_wire.NasSecurity(kasme, eia=2, eea=2)
    msg = nas_msgs.AttachAccept(ip_addr="172.16.0.5", guti=9)
    plain = nas_wire.encode(msg)
    prot = mme.protect(plain, downlink=True)
    assert prot[0] == 0x27  # sec-hdr 2 (integrity + ciphered) | PD EMM
    assert plain not in prot  # body actually encrypted
    with pytest.raises(Exception):
        nas_wire.decode(prot)  # no peeking without the context
    out, ok = ue.unprotect(prot, downlink=True)
    assert ok and out == plain
    assert nas_wire.decode(out) == msg
    # SMC stays integrity-only (header 3) so the UE can read it pre-keys
    smc = mme.protect(nas_wire.encode(
        nas_msgs.NasSecurityModeCommand(eea=2, eia=2)),
        downlink=True, new_ctx=True, cipher=False)
    assert smc[0] == 0x37
    assert nas_wire.decode(smc) == nas_msgs.NasSecurityModeCommand(
        eea=2, eia=2)


def test_service_request_short_mac():
    """The 4-byte Service Request carries a genuine short MAC (nas.cc
    gen_service_request layout: EIA MAC bytes [2:4] over the first two
    octets) that the MME-side context verifies; tampering fails."""
    kasme = bytes(range(32))
    ue = nas_wire.NasSecurity(kasme)
    mme = nas_wire.NasSecurity(kasme)
    sr = ue.service_request()
    assert len(sr) == 4 and sr[0] == 0xC7  # sec-hdr 12 | PD EMM
    assert mme.verify_service_request(sr)
    sr2 = ue.service_request()
    assert sr2[1] & 0x1F == 1  # UL COUNT advanced
    bad = sr2[:2] + b"\x00\x00"
    assert not mme.verify_service_request(bad)
    assert mme.verify_service_request(sr2)


def test_e2e_attach_activates_nas_security():
    """After a full attach the UE and MME share a live NAS security
    context: DL and UL NAS rode the wire integrity-protected."""
    from tests import test_e2e_attach as h

    net, mme, spgw, enb, (ue,) = h._build()
    net.run(60)
    assert ue.emm_state == "REGISTERED"
    assert ue.nas_sec is not None
    sec = mme.ues[1]["nas_sec"]
    assert sec is not None
    # SMC + Attach Accept downlink; SMC complete + Attach Complete uplink
    assert sec.count[1] >= 2 and sec.count[0] >= 2
    assert ue.metrics.get("nas_mac_fail", 0) == 0
    # the post-attach EMM Information arrived (ciphered) with the
    # srsepc network names
    assert ue.metrics.get("emm_info_rx", 0) == 1
    assert ue.network_name == "Software Radio Systems LTE"


def test_plain_nas_downgrade_rejected_after_security():
    """24.301 §4.4.4.2: once the security context is active, a PLAIN NAS
    message fails verification (downgrade protection) — except the
    §4.4.4.3 exemption list (e.g. Service Reject from a context-less
    network), which still processes."""
    from tests import test_e2e_attach as h

    net, mme, spgw, enb, (ue,) = h._build()
    net.run(60)
    assert ue.emm_state == "REGISTERED"
    before = ue.metrics.get("nas_mac_fail", 0)
    # spoofed plain detach: must be dropped, UE stays registered
    ue._rx_nas_pdu(nas_wire.encode(nas_msgs.DetachRequest()))
    assert ue.metrics.get("nas_mac_fail", 0) == before + 1
    assert ue.emm_state == "REGISTERED"
    # exempt message: plain ServiceReject still processes (context loss)
    ue._rx_nas_pdu(nas_wire.encode(nas_msgs.ServiceReject(cause=9)))
    assert ue.metrics.get("service_reject", 0) == 1
    assert ue.emm_state == "DEREGISTERED"


def test_attach_request_is_liblte_layout():
    """Spot-check the actual octets: PD/type header, BCD IMSI identity,
    ESM PDN connectivity container."""
    data = nas_wire.encode(nas_msgs.AttachRequest(imsi="001010123456789"))
    assert data[0] == 0x07 and data[1] == 0x41  # plain EMM attach request
    d = nas24301.decode(data)
    assert d["msg_name"] == "attach_request"
    assert d["esm"]["msg_name"] == "pdn_connectivity_request"
    # identity: odd 15-digit IMSI, type 1
    ident = d["eps_mobile_identity"]
    assert ident[0] & 0x0F == 0x09  # odd flag + IMSI type


def test_guti_attach_and_identity_procedure():
    """GUTI re-attach (24.301 §5.5.1.2.2): after detach the UE attaches
    with its stored GUTI.  A known GUTI resolves straight to the stored
    IMSI; after an MME context wipe the identity procedure (Identity
    Request -> IMSI Identity Response) recovers it — both end REGISTERED."""
    from tests import test_e2e_attach as h

    # --- known GUTI: no identity procedure
    net, mme, spgw, enb, (ue,) = h._build()
    net.run(60)
    assert ue.emm_state == "REGISTERED"
    old_guti = ue.guti
    ue.switch_off()
    net.run(20)
    assert ue.emm_state == "DEREGISTERED" and ue.guti == old_guti
    ue.rrc_state = "IDLE"
    ue.mac_state = "IDLE"
    ue.crnti = None
    ue._connect_pending = True
    net.run(120)
    assert ue.emm_state == "REGISTERED"
    assert mme.metrics.get("identity_req", 0) == 0
    assert mme.metrics["attach_ok"] == 2

    # --- unknown GUTI (MME restart): identity procedure runs
    net, mme, spgw, enb, (ue,) = h._build()
    net.run(60)
    assert ue.emm_state == "REGISTERED"
    ue.switch_off()
    net.run(20)
    mme.ues.clear()  # MME lost all contexts
    ue.rrc_state = "IDLE"
    ue.mac_state = "IDLE"
    ue.crnti = None
    ue._connect_pending = True
    net.run(200)
    assert mme.metrics.get("identity_req", 0) == 1
    assert ue.metrics.get("identity_resp", 0) == 1
    assert ue.emm_state == "REGISTERED"
