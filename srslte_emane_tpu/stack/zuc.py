"""ZUC stream cipher + 128-EEA3 / 128-EIA3 (3GPP TS 35.221/35.222).

Reference behavior: `lib/src/common/zuc.cc` + liblte_security.cc
(security_128_eea3 / security_128_eia3).  Implemented fresh from the ZUC
spec structure; only the normative constant tables (S0/S1 S-boxes and the
15-bit key-loading constants D) are loaded as extracted spec data
(zuc_tables.npz, see scripts/extract_zuc_tables.py).

Pure-host NumPy: security runs on the stack (control plane), not the device
compute path, mirroring the reference where ciphering lives in the PDCP
worker threads rather than the PHY.
"""

from __future__ import annotations

import pathlib

import numpy as np

_T = np.load(pathlib.Path(__file__).parent / "zuc_tables.npz")
_S0 = _T["s0"].astype(np.uint32)
_S1 = _T["s1"].astype(np.uint32)
_D = _T["d"].astype(np.uint32)

_M31 = (1 << 31) - 1


def _add31(a: int, b: int) -> int:
    c = a + b
    c = (c & _M31) + (c >> 31)
    return (c & _M31) + (c >> 31)


def _rot32(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF


def _l1(x: int) -> int:
    return x ^ _rot32(x, 2) ^ _rot32(x, 10) ^ _rot32(x, 18) ^ _rot32(x, 24)


def _l2(x: int) -> int:
    return x ^ _rot32(x, 8) ^ _rot32(x, 14) ^ _rot32(x, 22) ^ _rot32(x, 30)


def _sbox(x: int) -> int:
    return (
        (int(_S0[(x >> 24) & 0xFF]) << 24)
        | (int(_S1[(x >> 16) & 0xFF]) << 16)
        | (int(_S0[(x >> 8) & 0xFF]) << 8)
        | int(_S1[x & 0xFF])
    )


class Zuc:
    """ZUC keystream generator (128-bit key, 128-bit IV)."""

    def __init__(self, key: bytes, iv: bytes):
        assert len(key) == 16 and len(iv) == 16
        # key loading: s_i = k_i(8) || D_i(15) || iv_i(8)  (31 bits)
        self.s = [
            (key[i] << 23) | (int(_D[i]) << 8) | iv[i] for i in range(16)
        ]
        self.r1 = 0
        self.r2 = 0
        # 32 initialisation rounds feeding W>>1 into the LFSR
        for _ in range(32):
            w = self._f(*self._bitreorg()[:3])
            self._lfsr_shift(w >> 1)
        # one work-mode round with the F output discarded
        self._f(*self._bitreorg()[:3])
        self._lfsr_shift(None)

    def _bitreorg(self):
        s = self.s
        x0 = ((s[15] >> 15) << 16) | (s[14] & 0xFFFF)
        x1 = ((s[11] & 0xFFFF) << 16) | (s[9] >> 15)
        x2 = ((s[7] & 0xFFFF) << 16) | (s[5] >> 15)
        x3 = ((s[2] & 0xFFFF) << 16) | (s[0] >> 15)
        return x0, x1, x2, x3

    def _f(self, x0: int, x1: int, x2: int) -> int:
        w = ((x0 ^ self.r1) + self.r2) & 0xFFFFFFFF
        w1 = (self.r1 + x1) & 0xFFFFFFFF
        w2 = self.r2 ^ x2
        u = _l1(((w1 & 0xFFFF) << 16) | (w2 >> 16))
        v = _l2(((w2 & 0xFFFF) << 16) | (w1 >> 16))
        self.r1 = _sbox(u)
        self.r2 = _sbox(v)
        return w

    def _lfsr_shift(self, u):
        s = self.s
        # multiplication by 2^k mod (2^31-1) is a 31-bit rotate left by k
        v = _add31(s[0], (s[0] << 8) & _M31 | (s[0] >> 23))  # (1 + 2^8) s0
        v = _add31(v, (s[4] << 20) & _M31 | (s[4] >> 11))
        v = _add31(v, (s[10] << 21) & _M31 | (s[10] >> 10))
        v = _add31(v, (s[13] << 17) & _M31 | (s[13] >> 14))
        v = _add31(v, (s[15] << 15) & _M31 | (s[15] >> 16))
        if u is not None:
            v = _add31(v, u)
        if v == 0:
            v = _M31
        self.s = s[1:] + [v]

    def keystream_words(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.uint32)
        for i in range(n):
            x0, x1, x2, x3 = self._bitreorg()
            out[i] = (self._f(x0, x1, x2) ^ x3) & 0xFFFFFFFF
            self._lfsr_shift(None)
        return out

    def keystream_bytes(self, n: int) -> bytes:
        words = self.keystream_words((n + 3) // 4)
        return words.astype(">u4").tobytes()[:n]


def eea3(key: bytes, count: int, bearer: int, direction: int, data: bytes,
         length_bits: int | None = None) -> bytes:
    """128-EEA3 confidentiality (TS 35.221 annex A): ZUC keystream XOR."""
    iv = bytes(
        [
            (count >> 24) & 0xFF,
            (count >> 16) & 0xFF,
            (count >> 8) & 0xFF,
            count & 0xFF,
            ((bearer & 0x1F) << 3) | ((direction & 1) << 2),
            0,
            0,
            0,
        ]
    )
    iv = iv + iv
    ks = np.frombuffer(Zuc(key, iv).keystream_bytes(len(data)), dtype=np.uint8)
    out = np.frombuffer(data, dtype=np.uint8) ^ ks
    if length_bits is not None and length_bits < 8 * len(data):
        # spec leaves bits past LENGTH zero
        mask = np.packbits(
            (np.arange(8 * len(data)) < length_bits).astype(np.uint8))
        out &= mask
    return out.tobytes()


def eia3(key: bytes, count: int, bearer: int, direction: int, data: bytes,
         length_bits: int | None = None) -> bytes:
    """128-EIA3 integrity (TS 35.222 annex B): 32-bit MAC over LENGTH bits."""
    if length_bits is None:
        length_bits = 8 * len(data)
    iv = bytearray(16)
    iv[0] = (count >> 24) & 0xFF
    iv[1] = (count >> 16) & 0xFF
    iv[2] = (count >> 8) & 0xFF
    iv[3] = count & 0xFF
    iv[4] = (bearer & 0x1F) << 3
    iv[8] = iv[0] ^ ((direction & 1) << 7)
    iv[9], iv[10], iv[11], iv[12], iv[13] = iv[1], iv[2], iv[3], iv[4], iv[5]
    iv[14] = iv[6] ^ ((direction & 1) << 7)
    iv[15] = iv[7]
    n_words = (length_bits + 31) // 32 + 2  # L = ceil(LENGTH/32) + 2
    z = Zuc(key, bytes(iv)).keystream_words(n_words).astype(np.uint64)
    # z as a bitstream: word at bit offset i
    z64 = (z[:-1] << np.uint64(32)) | z[1:]

    def word_at(i: int) -> int:
        j, r = divmod(i, 32)
        return int(z64[j] >> np.uint64(32 - r)) & 0xFFFFFFFF

    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))[:length_bits]
    t = 0
    for i in np.nonzero(bits)[0]:
        t ^= word_at(int(i))
    t ^= word_at(length_bits)
    mac = t ^ int(z[n_words - 1])
    return mac.to_bytes(4, "big")
