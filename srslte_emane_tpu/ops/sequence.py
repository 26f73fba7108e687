"""3GPP 36.211 §7.2 Gold / pseudo-random sequence c(n), batched.

Reference behavior: `lib/src/phy/common/sequence.c:44-73` — two length-31
Fibonacci LFSRs x1 (fixed init 0b1) and x2 (init = c_init), both advanced
Nc=1600 steps before output; c(n) = x1(n+Nc) ^ x2(n+Nc).

Design: x1 is the *same* sequence for every user, so it is a precomputed
constant vector.  x2's output is GF(2)-linear in the 31 c_init bits, so a batch
of sequences is a single matmul:

    c[b, n] = x1_seq[n] ^ ( sum_i cinit_bits[b, i] * R[i, n]  mod 2 )

where R = lfsr_output_response(x2_taps, N, skip=Nc) is a host-precomputed
(31, N) matrix.  This replaces the reference's per-RNTI host pregeneration
(`lib/src/phy/phch/pdsch.c:556`) with on-device generation batched over any
number of (rnti, slot, cell) combinations.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import gf2

NC = 1600
_X1_TAPS = np.array([1, 0, 0, 1] + [0] * 27, dtype=np.int64)  # x1(n+31)=x1(n+3)+x1(n)
_X2_TAPS = np.array([1, 1, 1, 1] + [0] * 27, dtype=np.int64)  # +x2(n+2)+x2(n+1)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@functools.lru_cache(maxsize=8)
def _tables(n: int):
    """(x1 constant sequence, x2 response matrix) for n output bits."""
    # x1 init: x1(0)=1, rest 0 -> initial state e_0
    x1_resp = gf2.lfsr_output_response(_X1_TAPS, n, skip=NC)  # (31, n)
    x1_seq = x1_resp[0, :].astype(np.int8)  # init state = e_0 -> row 0
    x2_resp = gf2.lfsr_output_response(_X2_TAPS, n, skip=NC).astype(np.int8)
    return x1_seq, x2_resp


def cinit_bits(c_init) -> jnp.ndarray:
    """Expand integer c_init(s) (shape (...,)) to 31 LSB-first state bits
    (..., 31).  Works on device with traced c_init values."""
    c_init = jnp.asarray(c_init, dtype=jnp.uint32)
    shifts = jnp.arange(31, dtype=jnp.uint32)
    return ((c_init[..., None] >> shifts) & 1).astype(jnp.int8)


@functools.partial(jax.jit, static_argnums=(1,))
def gold_sequence(c_init, n: int) -> jnp.ndarray:
    """Batched c(n) bits.

    c_init: int array of shape (B,) (or scalar), traced or concrete.
    Returns int8 array (B, n) (or (n,) for scalar input) of 0/1 bits.
    """
    scalar = jnp.ndim(c_init) == 0
    bits = cinit_bits(jnp.atleast_1d(c_init))  # (B, 31)
    n_pad = _round_up(max(n, 1), 128)
    x1_seq, x2_resp = _tables(n_pad)  # numpy constants; lifted by jit
    # f32 matmul of 0/1 operands (exact in any float format); the 31-term
    # sum is exact in f32 and mod 2 recovers GF(2)
    x2 = jax.lax.dot_general(
        bits.astype(jnp.float32),
        jnp.asarray(x2_resp.astype(np.float32)),
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    c = jnp.mod(x2, 2.0).astype(jnp.int8) ^ x1_seq[None, :]
    c = c[:, :n]
    return c[0] if scalar else c


def gold_sequence_host(c_init: int, n: int) -> np.ndarray:
    """NumPy oracle: direct LFSR simulation (the reference algorithm,
    `sequence.c:44-73`). Used by tests to validate the matmul path."""
    x1 = np.zeros(NC + n + 31, dtype=np.int64)
    x2 = np.zeros(NC + n + 31, dtype=np.int64)
    x1[0] = 1
    for i in range(31):
        x2[i] = (c_init >> i) & 1
    for i in range(NC + n):
        x1[i + 31] = (x1[i + 3] + x1[i]) & 1
        x2[i + 31] = (x2[i + 3] + x2[i + 2] + x2[i + 1] + x2[i]) & 1
    return ((x1[NC : NC + n] + x2[NC : NC + n]) & 1).astype(np.int8)
