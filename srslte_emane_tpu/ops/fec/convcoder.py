"""36.212 §5.1.3.1 K=7 rate-1/3 tail-biting convolutional code + rate matching.

Reference behavior: `lib/src/phy/fec/convcoder.c` (encoder),
`lib/src/phy/fec/rm_conv.c` (rate matching, RM_PERM_CC at rm_conv.c:32).

Design: the encoder is feed-forward GF(2) — a circular correlation with
the three 7-tap generators, vectorized as roll-and-XOR over the batch (no
state, no scan).  Rate matching is again host-precomputed index tables.
Generators (octal, spec convention): G0=133, G1=171, G2=165.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NCOLS = 32
# 36.212 Table 5.1.4-2 inter-column permutation (== RM_PERM_CC, rm_conv.c:32)
PERM_CC = np.array(
    [1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
     0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30],
    dtype=np.int64,
)

# g[i][j]: tap of generator i on c_{k-j}
GENERATORS = np.array(
    [
        [1, 0, 1, 1, 0, 1, 1],  # 133 octal
        [1, 1, 1, 1, 0, 0, 1],  # 171 octal
        [1, 1, 1, 0, 1, 0, 1],  # 165 octal
    ],
    dtype=np.int64,
)


@jax.jit
def conv_encode(bits: jnp.ndarray) -> jnp.ndarray:
    """Tail-biting encode: (B, K) bits -> (B, 3, K) streams d0/d1/d2.

    Tail-biting: initial register state = last 6 input bits, i.e. the
    correlation is circular (c_{k-j} wraps mod K).
    """
    b = bits.astype(jnp.int32)
    out = []
    for i in range(3):
        acc = jnp.zeros_like(b)
        for j in range(7):
            if GENERATORS[i, j]:
                acc = acc + jnp.roll(b, j, axis=-1)
        out.append(acc & 1)
    return jnp.stack(out, axis=-2).astype(jnp.int8)


@functools.lru_cache(maxsize=None)
def _cc_wmap(d: int) -> np.ndarray:
    """Circular-buffer map for conv rate matching: w (3*Kp,) of source index
    into the flattened (3, D) stream array, or -1 for dummies.
    Layout: w = [v0 | v1 | v2] (concatenated, unlike turbo's interlacing)."""
    R = -(-d // NCOLS)
    Kp = NCOLS * R
    nd = Kp - d
    rows = np.arange(R)
    w = np.empty(3 * Kp, dtype=np.int64)
    for s in range(3):
        y = np.full(Kp, -1, dtype=np.int64)
        y[nd:] = s * d + np.arange(d)
        v = y[(rows[None, :] * NCOLS + PERM_CC[:, None]).reshape(-1)]
        w[s * Kp : (s + 1) * Kp] = v
    return w.astype(np.int32)


@functools.lru_cache(maxsize=None)
def cc_tx_table(d: int, e: int) -> np.ndarray:
    """(e,) gather indices into flattened (3*D) encoder output."""
    w = _cc_wmap(d)
    valid = w[w >= 0]
    return valid[np.arange(e) % len(valid)].astype(np.int32)


@functools.lru_cache(maxsize=None)
def cc_rx_table(d: int, e: int) -> np.ndarray:
    """(e,) scatter targets into the (3*D) LLR buffer (soft combining on
    wraparound, matching srslte_rm_conv_rx)."""
    w = _cc_wmap(d)
    pos = np.flatnonzero(w >= 0)
    src = w[pos]  # d-index for each valid w position, in w order
    return src[np.arange(e) % len(src)].astype(np.int32)


@functools.lru_cache(maxsize=None)
def cc_rx_gather_table(d: int, e: int) -> np.ndarray:
    """Inverse of cc_rx_table as a dense (3*D, n_max) gather into the LLR
    vector padded with a trailing zero (index e = none); no scatter-add."""
    tgt = cc_rx_table(d, e)
    size = 3 * d
    counts = np.bincount(tgt, minlength=size)
    n_max = max(1, int(counts.max()))
    out = np.full((size, n_max), e, dtype=np.int32)
    slot = np.zeros(size, dtype=np.int64)
    for j, t in enumerate(tgt):
        out[t, slot[t]] = j
        slot[t] += 1
    return out


def rate_match_cc(streams: jnp.ndarray, e: int) -> jnp.ndarray:
    """(B, 3, D) encoder bits -> (B, e) rate-matched bits."""
    B, three, d = streams.shape
    tbl = cc_tx_table(d, e)
    return jnp.take(streams.reshape(B, 3 * d), jnp.asarray(tbl), axis=-1)


def rate_unmatch_cc(llrs: jnp.ndarray, d: int) -> jnp.ndarray:
    """(B, e) LLRs -> (B, 3, D) stream LLRs with soft combining of repeats."""
    B, e = llrs.shape
    tbl = cc_rx_gather_table(d, e)
    padded = jnp.concatenate([llrs, jnp.zeros((B, 1), llrs.dtype)], axis=-1)
    buf = jnp.take(padded, jnp.asarray(tbl), axis=-1).sum(-1)
    return buf.reshape(B, 3, d)
