"""The reference's captured M2AP PDUs decode and re-encode byte-exact.

Vectors from `lib/test/asn1/srslte_asn1_m2ap_test.cc` — the same bytes
liblte_m2ap.cc's own test suite unpacks and repacks.  IEs the tests
assert on are decoded semantically; the rest ride as raw open-type bytes
(still byte-exact on re-encode)."""

from srslte_emane_tpu.stack.asn1 import m2ap36443 as m2ap

M2_SETUP_REQUEST = bytes([
    0x00, 0x05, 0x00, 0x37, 0x00, 0x00, 0x03, 0x00, 0x0d, 0x00, 0x08, 0x00,
    0x00, 0xf1, 0x10, 0x00, 0x1a, 0x2d, 0x00, 0x00, 0x0e, 0x40, 0x0a, 0x03,
    0x80, 0x65, 0x6e, 0x62, 0x31, 0x61, 0x32, 0x64, 0x30, 0x00, 0x0f, 0x00,
    0x16, 0x00, 0x00, 0x10, 0x00, 0x11, 0x00, 0x00, 0xf1, 0x10, 0x1a, 0x2d,
    0x00, 0x10, 0x27, 0x10, 0x01, 0x02, 0x00, 0x01, 0x02, 0x00, 0x02])

M2_SETUP_RESPONSE = bytes([
    0x20, 0x05, 0x00, 0x24, 0x00, 0x00, 0x02, 0x00, 0x11, 0x00, 0x06, 0x00,
    0x00, 0xf1, 0x10, 0x00, 0x50, 0x00, 0x13, 0x00, 0x13, 0x00, 0x00, 0x14,
    0x00, 0x0e, 0x40, 0x01, 0x50, 0x40, 0x00, 0x00, 0x00, 0x00, 0xf1, 0x10,
    0x1a, 0x2d, 0x00, 0x14])

SESSION_START_REQUEST = bytes([
    0x00, 0x00, 0x00, 0x2d, 0x00, 0x00, 0x04, 0x00, 0x00, 0x00, 0x02, 0x00,
    0x00, 0x00, 0x02, 0x00, 0x07, 0x00, 0x00, 0xf1, 0x10, 0x00, 0x00, 0x01,
    0x00, 0x06, 0x00, 0x03, 0x02, 0x00, 0x01, 0x00, 0x07, 0x00, 0x0e, 0x00,
    0x7f, 0x00, 0x02, 0x01, 0x00, 0x7f, 0x00, 0x01, 0xc8, 0x00, 0x00, 0x00,
    0x01])

SESSION_START_RESPONSE = bytes([
    0x20, 0x00, 0x00, 0x0f, 0x00, 0x00, 0x02, 0x00, 0x00, 0x00, 0x02, 0x00,
    0x00, 0x00, 0x01, 0x00, 0x02, 0x00, 0x00])

SCHEDULING_INFO = bytes([
    0x00, 0x02, 0x00, 0x3a, 0x00, 0x00, 0x02, 0x00, 0x19, 0x00, 0x01, 0x00,
    0x00, 0x0a, 0x00, 0x2e, 0x00, 0x00, 0x04, 0x00, 0x0b, 0x00, 0x12, 0x10,
    0x00, 0x0c, 0x00, 0x0d, 0x00, 0x00, 0x3f, 0x13, 0x00, 0x00, 0x00, 0xf1,
    0x10, 0x00, 0x00, 0x01, 0x08, 0x00, 0x16, 0x00, 0x07, 0x00, 0x00, 0x17,
    0x00, 0x02, 0x00, 0x40, 0x00, 0x18, 0x00, 0x01, 0x80, 0x00, 0x1d, 0x00,
    0x01, 0x01])

SCHEDULING_INFO_RESPONSE = bytes([0x20, 0x02, 0x00, 0x03, 0x00, 0x00, 0x00])

ALL = (M2_SETUP_REQUEST, M2_SETUP_RESPONSE, SESSION_START_REQUEST,
       SESSION_START_RESPONSE, SCHEDULING_INFO, SCHEDULING_INFO_RESPONSE)


def test_all_six_vectors_reencode_byte_exact():
    for wire in ALL:
        pdu = m2ap.decode_pdu(wire)
        assert m2ap.encode_pdu(pdu) == wire, wire.hex()


def test_m2_setup_request_fields():
    pdu = m2ap.decode_pdu(M2_SETUP_REQUEST)
    assert pdu.pdu_type == "initiatingMessage"
    assert pdu.procedure_code == m2ap.PROC_M2SETUP
    ies = {ie.id: ie.value for ie in pdu.ies}
    # srslte_asn1_m2ap_test.cc:64-111 assertions
    genb = ies[m2ap.ID_GLOBAL_ENB_ID]
    assert genb["plmn"] == bytes([0x00, 0xf1, 0x10])
    assert genb["enb_id"] == 0x1A2D0
    assert ies[m2ap.ID_ENB_NAME] == "enb1a2d0"
    conf = ies[m2ap.ID_CONFIG_DATA_LIST]
    assert len(conf) == 1
    item = conf[0]
    assert item["cell_id"] == 27447297
    assert item["mbsfn_sync_area"] == 10000
    assert item["service_areas"] == [bytes([0x00, 0x01]), bytes([0x00, 0x02])]


def test_session_start_request_fields():
    pdu = m2ap.decode_pdu(SESSION_START_REQUEST)
    assert pdu.procedure_code == m2ap.PROC_SESSION_START
    ies = {ie.id: ie.value for ie in pdu.ies}
    assert ies[m2ap.ID_MCE_MBMS_M2AP_ID] == 0
    tmgi = ies[m2ap.ID_TMGI]
    assert tmgi["plmn"] == bytes([0x00, 0xf1, 0x10])
    assert tmgi["service_id"] == bytes([0x00, 0x00, 0x01])
    assert ies[m2ap.ID_MBMS_SERVICE_AREA] == bytes([0x00, 0x01])
    tnl = ies[m2ap.ID_TNL_INFORMATION]
    assert tnl["ipmc"] == bytes([127, 0, 2, 1])
    assert tnl["ipsource"] == bytes([127, 0, 1, 200])
    assert tnl["gtp_teid"] == bytes([0, 0, 0, 1])


def test_session_start_response_fields():
    pdu = m2ap.decode_pdu(SESSION_START_RESPONSE)
    assert pdu.pdu_type == "successfulOutcome"
    ies = {ie.id: ie.value for ie in pdu.ies}
    assert ies[m2ap.ID_MCE_MBMS_M2AP_ID] == 0
    assert ies[m2ap.ID_ENB_MBMS_M2AP_ID] == 0


def test_scheduling_information_fields():
    pdu = m2ap.decode_pdu(SCHEDULING_INFO)
    assert pdu.procedure_code == m2ap.PROC_SCHEDULING_INFORMATION
    ies = {ie.id: ie.value for ie in pdu.ies}
    assert ies[m2ap.ID_MCCH_UPDATE_TIME] == 0
    # the MBSFN area configuration list rides raw but byte-exact
    assert isinstance(ies[10], (bytes, bytearray))


def test_generated_m2_setup_roundtrip():
    from srslte_emane_tpu.stack.asn1.aper import Pdu, ProtocolIE

    pdu = Pdu("initiatingMessage", m2ap.PROC_M2SETUP, "reject", [
        ProtocolIE(m2ap.ID_GLOBAL_ENB_ID, "reject",
                   dict(plmn=bytes([0x00, 0xf1, 0x10]), enb_id=0x19B)),
        ProtocolIE(m2ap.ID_ENB_NAME, "ignore", "emu-enb"),
        ProtocolIE(m2ap.ID_CONFIG_DATA_LIST, "reject", [
            dict(plmn=bytes([0x00, 0xf1, 0x10]), cell_id=0x19B01,
                 mbsfn_sync_area=1,
                 service_areas=[bytes([0x00, 0x01])])])])
    wire = m2ap.encode_pdu(pdu)
    back = m2ap.decode_pdu(wire)
    ies = {ie.id: ie.value for ie in back.ies}
    assert ies[m2ap.ID_ENB_NAME] == "emu-enb"
    assert ies[m2ap.ID_CONFIG_DATA_LIST][0]["cell_id"] == 0x19B01
    assert m2ap.encode_pdu(back) == wire


def test_live_m2_session_start_rides_real_pdus():
    """The MBMS-GW <-> eNB session-start exchange crosses the M2 control
    channel as real 36.443 APER PDUs (same IE set as the capture)."""
    from srslte_emane_tpu.epc import mbms_gw as gw

    req = gw._m2_encode_request(gw.M2SessionStartRequest(
        mbms_service_id=1, area_id=1))
    pdu = m2ap.decode_pdu(req)
    assert pdu.procedure_code == m2ap.PROC_SESSION_START
    assert pdu.pdu_type == "initiatingMessage"
    ies = {ie.id: ie.value for ie in pdu.ies}
    assert ies[m2ap.ID_TMGI]["plmn"] == bytes([0x00, 0xF1, 0x10])
    assert gw._m2_decode_request(req) == gw.M2SessionStartRequest(
        mbms_service_id=1, area_id=1)
    resp = gw._m2_encode_response(gw.M2SessionStartResponse(
        mbms_service_id=1, ok=True))
    assert m2ap.decode_pdu(resp).pdu_type == "successfulOutcome"
    assert gw._m2_decode_response(resp).ok
