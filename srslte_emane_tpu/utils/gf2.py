"""GF(2) linear-algebra substrate (host-side, NumPy).

Everything bit-sequential in the reference — LFSRs (gold sequences,
`lib/src/phy/common/sequence.c:44-73`), CRCs (`lib/src/phy/fec/crc.c`),
convolutional and turbo constituent encoders (`lib/src/phy/fec/convcoder.c`,
`turbocoder.c`) — is linear over GF(2).  The batched strategy is therefore:

  * model each bit-serial machine as a linear system  s' = A s + B u  over GF(2),
  * precompute (on the host, once) the dense generator/transition matrices for a
    whole *block* of inputs,
  * on device, replace the bit loop with matmuls of 0/1 operands followed by
    `& 1` (mod-2): one large matrix product instead of a bit-serial loop.

This module holds the host-side helpers used by ops/{sequence,crc}.py and
ops/fec/{turbo,convcoder}.py to build those matrices.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "gf2_matmul",
    "gf2_matpow",
    "lfsr_transition_matrix",
    "lfsr_output_response",
    "poly_to_taps",
]


def gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2). Inputs are 0/1 integer arrays."""
    return (a.astype(np.int64) @ b.astype(np.int64)) & 1


def gf2_matpow(a: np.ndarray, n: int) -> np.ndarray:
    """A**n over GF(2) by square-and-multiply."""
    assert a.shape[0] == a.shape[1]
    result = np.eye(a.shape[0], dtype=np.int64)
    base = a.astype(np.int64) & 1
    while n > 0:
        if n & 1:
            result = gf2_matmul(result, base)
        base = gf2_matmul(base, base)
        n >>= 1
    return result


def poly_to_taps(poly: int, degree: int) -> np.ndarray:
    """Binary coefficient vector [c_0 .. c_degree] of a polynomial given as an
    integer bitmask (bit i == coefficient of x^i)."""
    return np.array([(poly >> i) & 1 for i in range(degree + 1)], dtype=np.int64)


def lfsr_transition_matrix(taps: np.ndarray) -> np.ndarray:
    """One-step transition matrix of a Fibonacci LFSR with the given feedback
    taps over state (s_0 .. s_{n-1}), convention s_{n-1+t} newest:

        new_bit = sum_i taps[i] * s_i   (mod 2);  state shifts left by one.

    `taps` has length n (tap on state position i).  Matches the x1/x2 update in
    the reference gold-sequence generator (`sequence.c:46-57`):
        x1(n+31) = x1(n+3) + x1(n)            -> taps at positions {0,3}
        x2(n+31) = x2(n+3)+x2(n+2)+x2(n+1)+x2(n) -> taps {0,1,2,3}
    """
    n = len(taps)
    m = np.zeros((n, n), dtype=np.int64)
    # state_t = (s_0..s_{n-1}); state_{t+1} = (s_1..s_{n-1}, fb)
    for i in range(n - 1):
        m[i, i + 1] = 1
    m[n - 1, :] = np.asarray(taps, dtype=np.int64) & 1
    return m


def lfsr_output_response(taps: np.ndarray, nsteps: int, skip: int = 0) -> np.ndarray:
    """Response matrix R of shape (n, nsteps): output bit o_t = s_0 at step
    (skip + t), as a linear function of the *initial* state.

    Used for device-side gold-sequence generation: a batch of 31-bit c_init
    vectors (B, 31) matmul'd with R gives (B, nsteps) sequence bits directly,
    skipping the reference's Nc=1600 discard loop (`sequence.c:59-66`) via a
    precomputed matrix power.
    """
    n = len(taps)
    a = lfsr_transition_matrix(taps)
    a_skip = gf2_matpow(a, skip)
    # Row t of V is v_t = e_0^T A^(skip+t); build a seed block by iteration,
    # then extend by log-doubling: v_{t+L} = v_t A^L.
    seed = min(nsteps, 256)
    v = np.zeros((seed, n), dtype=np.int64)
    row = a_skip[0, :].copy()
    a64 = a.astype(np.int64)
    for t in range(seed):
        v[t] = row
        row = (row @ a64) & 1  # v_{t+1}^T = v_t^T A
    a_l = gf2_matpow(a, seed)
    while v.shape[0] < nsteps:
        v = np.concatenate([v, gf2_matmul(v, a_l)], axis=0)
        a_l = gf2_matmul(a_l, a_l)
    return v[:nsteps].T.copy()
