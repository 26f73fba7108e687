"""LTE security algorithms (33.401): EEA0/EEA2 ciphering, EIA2 integrity,
Milenage AKA, key derivation.

Reference behavior: `lib/src/common/{security.cc,liblte_security.cc,
snow_3g.cc,zuc.cc}` — EEA0/1/2/3 + EIA1/2/3 (security.h:35-52,106-126),
Milenage f1-f5, KDFs.  EEA1/EIA1 (SNOW3G, stack/snow3g.py) and EEA3/EIA3
(ZUC, stack/zuc.py) dispatch to the spec-validated stream ciphers.

AES primitives (the block cipher, CTR, CMAC) are stack/aes.py, in NumPy.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import struct

from . import aes

EEA0, EEA1, EEA2, EEA3 = 0, 1, 2, 3
EIA0, EIA1, EIA2, EIA3 = 0, 1, 2, 3


def _aes_ecb(key: bytes, block: bytes) -> bytes:
    return aes.ecb(key, block)


# ---------------- ciphering ----------------

def eea0(key, count, bearer, direction, data: bytes) -> bytes:
    return bytes(data)


def eea2(key: bytes, count: int, bearer: int, direction: int, data: bytes) -> bytes:
    """128-EEA2: AES-CTR with IV = COUNT(32) | BEARER(5) DIR(1) 0*(26) | 0(64)."""
    iv = struct.pack("!I", count & 0xFFFFFFFF)
    iv += bytes([((bearer & 0x1F) << 3) | ((direction & 1) << 2), 0, 0, 0])
    iv += b"\x00" * 8
    return aes.ctr(key, iv, data)


def cipher(algo: int, key, count, bearer, direction, data: bytes) -> bytes:
    if algo == EEA0:
        return eea0(key, count, bearer, direction, data)
    if algo == EEA1:
        from . import snow3g

        return snow3g.eea1(key, count, bearer, direction, data)
    if algo == EEA2:
        return eea2(key, count, bearer, direction, data)
    if algo == EEA3:
        from . import zuc

        return zuc.eea3(key, count, bearer, direction, data)
    raise NotImplementedError(f"EEA{algo} unknown")


decipher = cipher  # stream ciphers are symmetric


# ---------------- integrity ----------------

def eia2(key: bytes, count: int, bearer: int, direction: int, data: bytes) -> bytes:
    """128-EIA2: AES-CMAC over COUNT | BEARER||DIR | message. Returns MAC-I(4B)."""
    m = struct.pack("!I", count & 0xFFFFFFFF)
    m += bytes([((bearer & 0x1F) << 3) | ((direction & 1) << 2), 0, 0, 0])
    return aes.cmac(key, m + bytes(data))[:4]


def integrity(algo: int, key, count, bearer, direction, data: bytes) -> bytes:
    if algo == EIA0:
        return b"\x00\x00\x00\x00"
    if algo == EIA1:
        from . import snow3g

        # 33.401 B.2.2: FRESH = BEARER << 27
        return snow3g.eia1(key, count, (bearer & 0x1F) << 27, direction, data)
    if algo == EIA2:
        return eia2(key, count, bearer, direction, data)
    if algo == EIA3:
        from . import zuc

        return zuc.eia3(key, count, bearer, direction, data)
    raise NotImplementedError(f"EIA{algo} unknown")


# ---------------- Milenage (35.206) ----------------

def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def milenage_opc(k: bytes, op: bytes) -> bytes:
    return _xor(_aes_ecb(k, op), op)


def milenage_f1(k, opc, rand, sqn, amf) -> bytes:
    """f1 -> MAC-A (8 bytes)."""
    temp = _aes_ecb(k, _xor(rand, opc))
    in1 = sqn + amf + sqn + amf
    # rotate by r1=64 bits, c1=0
    x = _xor(temp, _rot(_xor(in1, opc), 8))
    out = _xor(_aes_ecb(k, x), opc)
    return out[:8]


def _rot(b: bytes, n_bytes: int) -> bytes:
    return b[n_bytes:] + b[:n_bytes]


def milenage_f1_star(k, opc, rand, sqn, amf) -> bytes:
    """f1* -> MAC-S (8 bytes): OUT1[8:16] of the same computation as f1
    (TS 35.206 §4.1; used in the AUTS resynchronisation token)."""
    temp = _aes_ecb(k, _xor(rand, opc))
    in1 = sqn + amf + sqn + amf
    x = _xor(temp, _rot(_xor(in1, opc), 8))
    out = _xor(_aes_ecb(k, x), opc)
    return out[8:16]


def milenage_f5_star(k: bytes, opc: bytes, rand: bytes) -> bytes:
    """f5* -> AK* (6 bytes): r5 = 96 bits, c5 = ...0008."""
    temp = _aes_ecb(k, _xor(rand, opc))
    x = _rot(_xor(temp, opc), 12)
    x = bytes(x[:15]) + bytes([x[15] ^ 8])
    out = _xor(_aes_ecb(k, x), opc)
    return out[:6]


def milenage_f2345(k: bytes, opc: bytes, rand: bytes):
    """Returns (RES(8), CK(16), IK(16), AK(6))."""
    temp = _aes_ecb(k, _xor(rand, opc))
    # f2/f5: c2 = ...0001, r2 = 0
    x = _xor(temp, opc)
    x = bytes(x[:15]) + bytes([x[15] ^ 1])
    out2 = _xor(_aes_ecb(k, x), opc)
    res = out2[8:16]
    ak = out2[:6]
    # f3: r3 = 32 bits (4 bytes), c3 = ...0002
    x = _rot(_xor(temp, opc), 4)
    x = bytes(x[:15]) + bytes([x[15] ^ 2])
    ck = _xor(_aes_ecb(k, x), opc)
    # f4: r4 = 64 bits (8 bytes), c4 = ...0004
    x = _rot(_xor(temp, opc), 8)
    x = bytes(x[:15]) + bytes([x[15] ^ 4])
    ik = _xor(_aes_ecb(k, x), opc)
    return res, ck, ik, ak


# ---------------- key derivation (33.401 A.2) ----------------

def kdf(key: bytes, fc: int, *params: bytes) -> bytes:
    s = bytes([fc])
    for p in params:
        s += p + struct.pack("!H", len(p))
    return hmac_mod.new(key, s, hashlib.sha256).digest()


def kdf_kasme(ck: bytes, ik: bytes, plmn: bytes, sqn_xor_ak: bytes) -> bytes:
    return kdf(ck + ik, 0x10, plmn, sqn_xor_ak)


def kdf_kenb(kasme: bytes, ul_nas_count: int) -> bytes:
    return kdf(kasme, 0x11, struct.pack("!I", ul_nas_count))


def kdf_nas_key(kasme: bytes, algo: int, is_enc: bool) -> bytes:
    dist = 0x01 if is_enc else 0x02
    return kdf(kasme, 0x15, bytes([dist]), bytes([algo]))[16:]


def kdf_rrc_up_key(kenb: bytes, algo: int, dist: int) -> bytes:
    """dist: 0x03 RRC-enc, 0x04 RRC-int, 0x05 UP-enc (33.401 A.7)."""
    return kdf(kenb, 0x15, bytes([dist]), bytes([algo]))[16:]
