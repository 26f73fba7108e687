"""AES-128 in NumPy (FIPS-197), with CTR and CMAC (RFC 4493).

The block cipher runs on an (n, 16) uint8 array of blocks at once, so a
CTR keystream for a whole PDU is one vectorised call.  The state is kept
column-major as in FIPS-197 (byte 4*c + r is row r of column c).
"""

from __future__ import annotations

import functools

import numpy as np


def _xtime(x: np.ndarray) -> np.ndarray:
    """Multiplication by x in GF(2^8) mod x^8 + x^4 + x^3 + x + 1."""
    x = x.astype(np.uint16)
    return (((x << 1) ^ np.where(x & 0x80, 0x1B, 0)) & 0xFF).astype(np.uint8)


def _make_sbox() -> np.ndarray:
    # powers of the generator 3 give log/antilog tables for the inverse
    exp = np.zeros(256, np.uint8)
    log = np.zeros(256, np.int64)
    v = 1
    for i in range(255):
        exp[i] = v
        log[v] = i
        v ^= int(_xtime(np.uint8(v)))  # v *= 3
    inv = np.zeros(256, np.uint8)
    inv[1:] = exp[(255 - log[1:]) % 255]
    s = inv.astype(np.uint16)
    out = s.copy()
    for r in (1, 2, 3, 4):  # affine map: b ^ rotl(b,1..4) ^ 0x63
        out ^= ((s << r) | (s >> (8 - r))) & 0xFF
    return (out ^ 0x63).astype(np.uint8)


SBOX = _make_sbox()
XTIME = _xtime(np.arange(256, dtype=np.uint8))
# ShiftRows: row r of column c takes row r of column (c + r) % 4
SHIFT = np.array([4 * ((c + r) % 4) + r for c in range(4) for r in range(4)])
# row r + 1 of the same column (MixColumns' neighbour)
ROW_UP = np.array([4 * c + (r + 1) % 4 for c in range(4) for r in range(4)])


@functools.lru_cache(maxsize=1024)
def expand_key(key: bytes) -> np.ndarray:
    """AES-128 key schedule: (11, 16) uint8 round keys."""
    if len(key) != 16:
        raise ValueError("AES-128 needs a 16-byte key")
    w = [list(key[4 * i:4 * i + 4]) for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = [int(SBOX[b]) for b in t[1:] + t[:1]]
            t[0] ^= rcon
            rcon = int(XTIME[rcon])
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    rk = np.array(w, np.uint8).reshape(11, 16)
    rk.flags.writeable = False
    return rk


def encrypt_blocks(key: bytes, blocks: np.ndarray) -> np.ndarray:
    """Encrypt (n, 16) uint8 blocks in ECB mode; returns (n, 16) uint8."""
    rk = expand_key(bytes(key))
    s = np.asarray(blocks, np.uint8).reshape(-1, 16) ^ rk[0]
    for rnd in range(1, 11):
        s = SBOX[s[:, SHIFT]]
        if rnd < 10:
            # MixColumns: b_r = 2 a_r ^ 3 a_{r+1} ^ a_{r+2} ^ a_{r+3}
            a1 = s[:, ROW_UP]
            a2 = a1[:, ROW_UP]
            s = XTIME[s ^ a1] ^ a1 ^ a2 ^ a2[:, ROW_UP]
        s ^= rk[rnd]
    return s


def ecb(key: bytes, block: bytes) -> bytes:
    """One 16-byte block."""
    return encrypt_blocks(key, np.frombuffer(block, np.uint8)).tobytes()


def ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    """CTR mode with a 128-bit big-endian counter starting at `iv`."""
    n = -(-len(data) // 16)
    if n == 0:
        return b""
    hi = int.from_bytes(iv[:8], "big")
    lo = int.from_bytes(iv[8:], "big")
    idx = np.arange(n, dtype=np.uint64)
    lo_n = np.uint64(lo) + idx  # wraps mod 2^64 on carry
    hi_n = np.uint64(hi) + (lo_n < np.uint64(lo)).astype(np.uint64)
    ctrs = np.stack([hi_n, lo_n], axis=1).astype(">u8").view(np.uint8)
    stream = encrypt_blocks(key, ctrs.reshape(n, 16)).reshape(-1)
    buf = np.frombuffer(bytes(data), np.uint8)
    return (buf ^ stream[:len(buf)]).tobytes()


def _dbl(b: np.ndarray) -> np.ndarray:
    """Doubling in GF(2^128) (RFC 4493 subkey generation)."""
    v = int.from_bytes(b.tobytes(), "big") << 1
    if v >> 128:
        v = (v ^ 0x87) & ((1 << 128) - 1)
    return np.frombuffer(v.to_bytes(16, "big"), np.uint8)


@functools.lru_cache(maxsize=1024)
def _cmac_subkeys(key: bytes):
    k1 = _dbl(encrypt_blocks(key, np.zeros(16, np.uint8))[0])
    return k1, _dbl(k1)


def cmac(key: bytes, data: bytes) -> bytes:
    """AES-CMAC (RFC 4493): the 16-byte tag."""
    k1, k2 = _cmac_subkeys(bytes(key))
    data = bytes(data)
    n = max(1, -(-len(data) // 16))
    buf = np.zeros(16 * n, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    blocks = buf.reshape(n, 16)
    if data and len(data) % 16 == 0:
        blocks[-1] ^= k1
    else:
        blocks[-1, len(data) - 16 * (n - 1)] = 0x80
        blocks[-1] ^= k2
    x = np.zeros(16, np.uint8)
    for blk in blocks:  # CBC chaining is sequential
        x = encrypt_blocks(key, x ^ blk)[0]
    return x.tobytes()
