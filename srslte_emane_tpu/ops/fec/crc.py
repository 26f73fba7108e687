"""LTE CRC attach/check as batched GF(2) matmuls.

Reference behavior: `lib/src/phy/fec/crc.c` (table-driven LFSR, zero initial
state) with the LTE polynomials pinned by `lib/src/phy/fec/test/CMakeLists.txt:77-80`:
CRC24A 0x1864CFB, CRC24B 0x1800063, CRC16 0x11021, CRC8 0x19B.
Usage: TB-level CRC24A + per-codeblock CRC24B (`lib/src/phy/phch/sch.c:96-101`),
CRC16 for PBCH/DCI (masked), CRC8 for UCI.

Design: with zero initial state the CRC is linear over GF(2):
    crc(m) = XOR_{i : m_i = 1}  (x^(L-1-i+order) mod g)
so a whole batch of length-L messages reduces to one matmul
(B, L) @ (L, order) followed by `& 1` — no bit loop, no tables of bytes.  The (L, order) remainder matrix is host-precomputed per (poly, L) and
cached.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# polynomial bitmasks include the leading x^order term
LTE_CRC24A = (0x1864CFB, 24)
LTE_CRC24B = (0x1800063, 24)
LTE_CRC16 = (0x11021, 16)
LTE_CRC8 = (0x19B, 8)


@functools.lru_cache(maxsize=None)
def _remainder_matrix(poly: int, order: int, length: int) -> np.ndarray:
    """R[i, :] = bits (MSB-first) of x^(length-1-i+order) mod g."""
    # iterate remainders of x^d for d = order .. length-1+order
    rem = np.zeros((length, order), dtype=np.int8)
    # state = x^order mod g  (polynomial bits, index j == coeff of x^j)
    state = poly & ((1 << order) - 1)
    for d in range(length):
        rem[length - 1 - d, :] = [(state >> (order - 1 - b)) & 1 for b in range(order)]
        # multiply by x: shift, reduce
        state <<= 1
        if state >> order & 1:
            state ^= poly
        state &= (1 << order) - 1
    return rem


@functools.partial(jax.jit, static_argnums=(1,))
def crc_bits(bits: jnp.ndarray, crc=LTE_CRC24A) -> jnp.ndarray:
    """CRC of batched bit messages.

    bits: (..., L) 0/1 int array (MSB-first transmission order).
    Returns (..., order) CRC bits, MSB-first, matching the reference's
    `srslte_crc_attach` bit order.
    """
    poly, order = crc
    length = bits.shape[-1]
    r = _remainder_matrix(poly, order, length)  # numpy constant
    # f32 matmul of 0/1 operands: the operands are exact in any float
    # format, and the popcount sum is <= L < 2^24, so the accumulation is
    # exact and mod 2 recovers GF(2)
    acc = jax.lax.dot_general(
        bits.astype(jnp.float32),
        jnp.asarray(r.astype(np.float32)),
        dimension_numbers=(((bits.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return jnp.mod(acc, 2.0).astype(jnp.int8)


def crc_attach(bits: jnp.ndarray, crc=LTE_CRC24A) -> jnp.ndarray:
    """Append CRC bits: (..., L) -> (..., L + order)."""
    return jnp.concatenate([bits, crc_bits(bits, crc)], axis=-1)


def crc_ok(bits_with_crc: jnp.ndarray, crc=LTE_CRC24A) -> jnp.ndarray:
    """Check batched (..., L+order) sequences; True where CRC passes.
    crc(m || crc(m)) == 0 by construction."""
    rem = crc_bits(bits_with_crc, crc)
    return jnp.all(rem == 0, axis=-1)


def crc_host(bits: np.ndarray, crc=LTE_CRC24A) -> np.ndarray:
    """NumPy oracle: bit-serial LFSR CRC (the reference algorithm)."""
    poly, order = crc
    reg = 0
    for b in np.asarray(bits).astype(np.int64):
        reg = (reg << 1) | int(b)
        if (reg >> order) & 1:
            reg ^= poly
    # flush `order` zero bits
    for _ in range(order):
        reg <<= 1
        if (reg >> order) & 1:
            reg ^= poly
    reg &= (1 << order) - 1
    return np.array([(reg >> (order - 1 - i)) & 1 for i in range(order)], dtype=np.int8)
