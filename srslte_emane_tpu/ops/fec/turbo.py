"""36.212 §5.1.3.2 rate-1/3 turbo encoder, batched.

Reference behavior: `lib/src/phy/fec/turbocoder.c` (bit-serial RSC recurrence
at turbocoder.c:105-145, trellis termination at :148-186) and the QPP
interleaver `lib/src/phy/fec/tc_interl_lte.c:38-94`.

Design: each 8-state RSC constituent encoder is a GF(2)-linear system
    s_{t+1} = A s_t + b u_t,   z_t = c s_t + u_t
so a whole chunk of C input bits encodes as two matmuls (one for the
parity bits, one for the state carry), batched over code blocks —
the matrix analogue of the reference's byte-wise `tcod_lut[8][256]` LUT
strategy (turbocoder.c:38-46).  A `lax.scan` over K/C chunks carries the
3-bit state; tail bits are a linear function of the final state.

Output: the three 36.212 d-streams, each K+4 bits:
    d0 = systematic + tail, d1 = parity1 + tail, d2 = parity2 + tail.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import cbsegm

# 36.212 Table 5.1.3-3 QPP parameters (f1, f2) per CB size index.
F1_TABLE = np.array([
    3, 7, 19, 7, 7, 11, 5, 11, 7, 41, 103, 15, 9, 17, 9, 21, 101, 21, 57, 23,
    13, 27, 11, 27, 85, 29, 33, 15, 17, 33, 103, 19, 19, 37, 19, 21, 21, 115,
    193, 21, 133, 81, 45, 23, 243, 151, 155, 25, 51, 47, 91, 29, 29, 247, 29,
    89, 91, 157, 55, 31, 17, 35, 227, 65, 19, 37, 41, 39, 185, 43, 21, 155, 79,
    139, 23, 217, 25, 17, 127, 25, 239, 17, 137, 215, 29, 15, 147, 29, 59, 65,
    55, 31, 17, 171, 67, 35, 19, 39, 19, 199, 21, 211, 21, 43, 149, 45, 49, 71,
    13, 17, 25, 183, 55, 127, 27, 29, 29, 57, 45, 31, 59, 185, 113, 31, 17,
    171, 209, 253, 367, 265, 181, 39, 27, 127, 143, 43, 29, 45, 157, 47, 13,
    111, 443, 51, 51, 451, 257, 57, 313, 271, 179, 331, 363, 375, 127, 31, 33,
    43, 33, 477, 35, 233, 357, 337, 37, 71, 71, 37, 39, 127, 39, 39, 31, 113,
    41, 251, 43, 21, 43, 45, 45, 161, 89, 323, 47, 23, 47, 263], dtype=np.int64)
F2_TABLE = np.array([
    10, 12, 42, 16, 18, 20, 22, 24, 26, 84, 90, 32, 34, 108, 38, 120, 84, 44,
    46, 48, 50, 52, 36, 56, 58, 60, 62, 32, 198, 68, 210, 36, 74, 76, 78, 120,
    82, 84, 86, 44, 90, 46, 94, 48, 98, 40, 102, 52, 106, 72, 110, 168, 114,
    58, 118, 180, 122, 62, 84, 64, 66, 68, 420, 96, 74, 76, 234, 80, 82, 252,
    86, 44, 120, 92, 94, 48, 98, 80, 102, 52, 106, 48, 110, 112, 114, 58, 118,
    60, 122, 124, 84, 64, 66, 204, 140, 72, 74, 76, 78, 240, 82, 252, 86, 88,
    60, 92, 846, 48, 28, 80, 102, 104, 954, 96, 110, 112, 114, 116, 354, 120,
    610, 124, 420, 64, 66, 136, 420, 216, 444, 456, 468, 80, 164, 504, 172, 88,
    300, 92, 188, 96, 28, 240, 204, 104, 212, 192, 220, 336, 228, 232, 236,
    120, 244, 248, 168, 64, 130, 264, 134, 408, 138, 280, 142, 480, 146, 444,
    120, 152, 462, 234, 158, 80, 96, 902, 166, 336, 170, 86, 174, 176, 178,
    120, 182, 184, 186, 94, 190, 480], dtype=np.int64)
assert len(F1_TABLE) == 188 and len(F2_TABLE) == 188

# RSC: feedback g0 = 1+D^2+D^3, parity g1 = 1+D+D^3 (state s=(r0,r1,r2)):
#   a   = u + r1 + r2   (feedback-adjusted input entering the register)
#   z   = a + r0 + r2 = u + r0 + r1
#   s'  = (a, r0, r1)
_A = np.array([[0, 1, 1], [1, 0, 0], [0, 1, 0]], dtype=np.int64)  # state update
_B = np.array([1, 0, 0], dtype=np.int64)
_CZ = np.array([1, 1, 0], dtype=np.int64)  # z = cz . s + u
# Tail bits as a linear map of the final state (r0,r1,r2) — derived from the
# termination recurrence (turbocoder.c:150-165): per encoder the 6 outputs
# (x_K, z_K, x_{K+1}, z_{K+1}, x_{K+2}, z_{K+2}) are:
_TAIL = np.array([
    [0, 1, 1],  # x_K     = r1+r2
    [1, 0, 1],  # z_K     = r0+r2
    [1, 1, 0],  # x_{K+1} = r0+r1
    [0, 1, 0],  # z_{K+1} = r1
    [1, 0, 0],  # x_{K+2} = r0
    [1, 0, 0],  # z_{K+2} = r0
], dtype=np.int64)


@functools.lru_cache(maxsize=None)
def qpp_interleaver(k: int) -> np.ndarray:
    """QPP permutation pi(i) = (f1*i + f2*i^2) mod K.  Interleaved input
    c'(i) = c(pi(i)) (36.212 §5.1.3.2.3)."""
    idx = cbsegm.cb_size_index(k)
    f1, f2 = int(F1_TABLE[idx]), int(F2_TABLE[idx])
    i = np.arange(k, dtype=np.int64)
    return (f1 * i + f2 * i * i) % k


@functools.lru_cache(maxsize=None)
def _chunk_tables(c: int):
    """Host-precomputed GF(2) block matrices for a chunk of c input bits:
    P (c,c): parity from inputs; Q (c,3): parity from entry state;
    T (3,3): state from state;    R (c,3): state from inputs (as u @ R)."""
    # impulse responses by direct simulation
    P = np.zeros((c, c), dtype=np.int8)
    R = np.zeros((c, 3), dtype=np.int8)
    Q = np.zeros((c, 3), dtype=np.int8)
    T = np.zeros((3, 3), dtype=np.int8)
    # response to a single input bit at position j with zero state
    for j in range(c):
        s = np.zeros(3, dtype=np.int64)
        for t in range(j, c):
            u = 1 if t == j else 0
            z = (_CZ @ s + u) & 1
            P[t, j] = z
            s = (_A @ s + _B * u) & 1
        R[j, :] = s
    # response to initial state e_i with zero input
    for i in range(3):
        s = np.eye(3, dtype=np.int64)[i]
        for t in range(c):
            Q[t, i] = (_CZ @ s) & 1
            s = (_A @ s) & 1
        T[:, i] = s
    return P, Q, T, R


def _pick_chunk(k: int, target: int) -> int:
    """Largest divisor of k that is <= target (so the scan has no remainder)."""
    if k <= target:
        return k
    best = 1
    for d in range(1, int(k**0.5) + 1):
        if k % d == 0:
            if d <= target:
                best = max(best, d)
            if k // d <= target:
                best = max(best, k // d)
    return best


def _rsc_encode(u: jnp.ndarray, chunk: int):
    """Batched RSC encode: u (B, K) 0/1 -> (parity (B, K), final state (B, 3))."""
    B, K = u.shape
    c = _pick_chunk(K, chunk)
    nchunks = K // c
    # f32 matmuls of 0/1 operands (exact in any float format); chunk sums
    # are <= c+3 << 2^24 so the products are exact and `mod 2` recovers GF(2)
    P, Q, T, R = (m.astype(np.float32) for m in _chunk_tables(c))
    uc = u.astype(jnp.float32).reshape(B, nchunks, c).transpose(1, 0, 2)  # (n,B,c)

    def step(state, u_blk):
        # parity (B, c) = u_blk @ P^T + state @ Q^T   (mod 2)
        z = jnp.mod(u_blk @ P.T + state @ Q.T, 2.0)
        state = jnp.mod(state @ T.T + u_blk @ R, 2.0)
        return state, z

    state0 = jnp.zeros((B, 3), dtype=jnp.float32)
    statef, z = jax.lax.scan(step, state0, uc)
    return (z.transpose(1, 0, 2).reshape(B, K).astype(jnp.int32),
            statef.astype(jnp.int32))


@functools.partial(jax.jit, static_argnums=(1,))
def turbo_encode(u: jnp.ndarray, chunk: int = 512):
    """Encode batched code blocks.

    u: (B, K) 0/1 bits, K a valid CB size (all blocks same K; filler bits must
       already be zeros — the NULL accounting lives in rate matching).
    Returns (d0, d1, d2), each (B, K+4), int8 — the 36.212 d-streams.
    """
    B, K = u.shape
    perm = jnp.asarray(qpp_interleaver(K))
    z1, s1 = _rsc_encode(u, chunk)
    u2 = jnp.take(u, perm, axis=1)
    z2, s2 = _rsc_encode(u2, chunk)

    tail_m = jnp.asarray(_TAIL.astype(np.int32))
    t1 = (s1 @ tail_m.T) & 1  # (B, 6): x_K z_K x_K1 z_K1 x_K2 z_K2
    t2 = (s2 @ tail_m.T) & 1

    # 36.212 §5.1.3.2.2 tail arrangement into the three streams:
    # d0 tail: x_K,  z_{K+1}, x'_K,  z'_{K+1}
    # d1 tail: z_K,  x_{K+2}, z'_K,  x'_{K+2}
    # d2 tail: x_{K+1}, z_{K+2}, x'_{K+1}, z'_{K+2}
    d0 = jnp.concatenate([u.astype(jnp.int32), t1[:, 0:1], t1[:, 3:4], t2[:, 0:1], t2[:, 3:4]], axis=1)
    d1 = jnp.concatenate([z1, t1[:, 1:2], t1[:, 4:5], t2[:, 1:2], t2[:, 4:5]], axis=1)
    d2 = jnp.concatenate([z2, t1[:, 2:3], t1[:, 5:6], t2[:, 2:3], t2[:, 5:6]], axis=1)
    return d0.astype(jnp.int8), d1.astype(jnp.int8), d2.astype(jnp.int8)


def turbo_encode_host(u: np.ndarray) -> tuple:
    """NumPy oracle: bit-serial encoder (reference algorithm,
    turbocoder.c:105-186). u: (K,) bits -> (d0, d1, d2) each (K+4,)."""
    u = np.asarray(u, dtype=np.int64)
    K = len(u)
    perm = qpp_interleaver(K)

    def rsc(bits):
        s = np.zeros(3, dtype=np.int64)
        z = np.zeros(len(bits), dtype=np.int64)
        for t, ub in enumerate(bits):
            z[t] = (ub + s[0] + s[1]) & 1
            a = (ub + s[1] + s[2]) & 1
            s = np.array([a, s[0], s[1]])
        return z, s

    def tail(s):
        out = []
        for _ in range(3):
            u_t = (s[1] + s[2]) & 1
            z_t = (s[0] + s[2]) & 1
            out += [u_t, z_t]
            s = np.array([0, s[0], s[1]])
        return np.array(out)

    z1, s1 = rsc(u)
    z2, s2 = rsc(u[perm])
    t1, t2 = tail(s1), tail(s2)
    d0 = np.concatenate([u, [t1[0], t1[3], t2[0], t2[3]]])
    d1 = np.concatenate([z1, [t1[1], t1[4], t2[1], t2[4]]])
    d2 = np.concatenate([z2, [t1[2], t1[5], t2[2], t2[5]]])
    return d0.astype(np.int8), d1.astype(np.int8), d2.astype(np.int8)
