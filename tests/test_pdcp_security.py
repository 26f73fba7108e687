"""Security algorithms + PDCP entities."""

import numpy as np

from srslte_emane_tpu.stack import pdcp, security


def test_cmac_rfc4493_vector():
    """Pins AES-CMAC (the EIA2 core): RFC 4493 example 1."""
    from srslte_emane_tpu.stack import aes

    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    assert aes.cmac(key, b"") == bytes.fromhex("bb1d6929e95937287fa37d129b756746")


def test_eea2_roundtrip_and_sensitivity():
    key = bytes(range(16))
    data = b"the quick brown fox" * 3
    enc = security.eea2(key, count=7, bearer=3, direction=0, data=data)
    assert enc != data
    dec = security.eea2(key, count=7, bearer=3, direction=0, data=enc)
    assert dec == data
    # different COUNT -> different keystream
    assert security.eea2(key, 8, 3, 0, data) != enc


def test_eia2_detects_tamper():
    key = bytes(range(16))
    mac = security.eia2(key, 1, 1, 0, b"message")
    assert len(mac) == 4
    assert security.eia2(key, 1, 1, 0, b"messagf") != mac
    assert security.eia2(key, 2, 1, 0, b"message") != mac


def test_milenage_consistency():
    """AK/SQN consistency + deterministic keys (hss.cc:265-342 flow)."""
    k = bytes(range(16))
    op = bytes(range(16, 32))
    opc = security.milenage_opc(k, op)
    rand = bytes(range(32, 48))
    sqn = b"\x00\x00\x00\x00\x00\x01"
    amf = b"\x80\x00"
    res, ck, ik, ak = security.milenage_f2345(k, opc, rand)
    mac_a = security.milenage_f1(k, opc, rand, sqn, amf)
    assert len(res) == 8 and len(ck) == 16 and len(ik) == 16 and len(ak) == 6
    # UE side recomputes the same values
    res2, ck2, ik2, ak2 = security.milenage_f2345(k, opc, rand)
    assert (res, ck, ik, ak) == (res2, ck2, ik2, ak2)
    kasme = security.kdf_kasme(ck, ik, b"\x00\xf1\x10", bytes(a ^ b for a, b in zip(sqn, ak)))
    assert len(kasme) == 32


def test_pdcp_srb_integrity_and_ciphering():
    k_enc, k_int = bytes(range(16)), bytes(range(16, 32))
    rx_out = []
    ue = pdcp.PdcpEntity(lambda s: None, is_srb=True, ciph_algo=security.EEA2,
                         int_algo=security.EIA2, k_enc=k_enc, k_int=k_int, is_ue=True)
    enb = pdcp.PdcpEntity(rx_out.append, is_srb=True, ciph_algo=security.EEA2,
                          int_algo=security.EIA2, k_enc=k_enc, k_int=k_int, is_ue=False)
    for i in range(40):  # crosses the 5-bit SN wrap
        msg = bytes([i]) * 20
        enb.write_pdu(ue.write_sdu(msg))
    assert rx_out == [bytes([i]) * 20 for i in range(40)]
    # tampered PDU is rejected
    pdu = bytearray(ue.write_sdu(b"attack"))
    pdu[3] ^= 0xFF
    n = len(rx_out)
    enb.write_pdu(bytes(pdu))
    assert len(rx_out) == n and enb.integrity_failures == 1


def test_pdcp_drb_ciphered_data():
    k_enc = bytes(range(16))
    out = []
    ue = pdcp.PdcpEntity(lambda s: None, is_srb=False, ciph_algo=security.EEA2,
                         k_enc=k_enc, is_ue=True)
    enb = pdcp.PdcpEntity(out.append, is_srb=False, ciph_algo=security.EEA2,
                          k_enc=k_enc, is_ue=False)
    payloads = [bytes(np.random.default_rng(i).integers(0, 256, 100, dtype=np.uint8))
                for i in range(5000)]  # crosses the 12-bit SN wrap
    for p in payloads[:5000:97]:
        enb.write_pdu(ue.write_sdu(p))
    assert out == payloads[:5000:97]


def test_pdcp_nr_srb_roundtrip_with_integrity():
    k_enc, k_int = bytes(range(16)), bytes(range(16, 32))
    out = []
    ue = pdcp.PdcpEntityNr(lambda s: None, is_srb=True,
                           ciph_algo=security.EEA2, int_algo=security.EIA2,
                           k_enc=k_enc, k_int=k_int, is_ue=True)
    gnb = pdcp.PdcpEntityNr(out.append, is_srb=True,
                            ciph_algo=security.EEA2, int_algo=security.EIA2,
                            k_enc=k_enc, k_int=k_int, is_ue=False)
    msgs = [bytes([i]) * (10 + i) for i in range(5)]
    for m in msgs:
        gnb.write_pdu(ue.write_sdu(m))
    assert out == msgs
    # tampered PDU must fail integrity, not deliver
    bad = bytearray(ue.write_sdu(b"tamperme"))
    bad[-1] ^= 0xFF
    gnb.write_pdu(bytes(bad))
    assert out == msgs and gnb.integrity_failures == 1
    # replayed (duplicate COUNT) PDU is discarded, not re-delivered
    p = ue.write_sdu(b"once")
    gnb.write_pdu(p)
    gnb.write_pdu(p)
    assert out == msgs + [b"once"]


def test_pdcp_nr_drb_18bit_sn_wrap():
    out = []
    ue = pdcp.PdcpEntityNr(lambda s: None, is_srb=False, sn_bits=18,
                           ciph_algo=security.EEA2, k_enc=b"\x11" * 16)
    gnb = pdcp.PdcpEntityNr(out.append, is_srb=False, sn_bits=18,
                            ciph_algo=security.EEA2, k_enc=b"\x11" * 16,
                            is_ue=False)
    # drive COUNT across the 18-bit SN wrap: HFN inference must follow
    ue.tx_next = gnb.rx_next = (1 << 18) - 3
    msgs = [b"pkt%d" % i for i in range(6)]
    for m in msgs:
        gnb.write_pdu(ue.write_sdu(m))
    assert out == msgs
    assert gnb.rx_next == (1 << 18) + 3
