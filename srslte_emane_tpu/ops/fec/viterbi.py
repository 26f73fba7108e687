"""Batched Viterbi decoder for the K=7 rate-1/3 tail-biting code.

Reference behavior: `lib/src/phy/fec/viterbi.c` — "37" decoder with SIMD
butterflies (viterbi.c:274-348); tail-biting handled by repeating the frame
TB_ITER=3 times and keeping the middle copy (viterbi.c:66-72).

Design: the 64-state add-compare-select runs as a `lax.scan` over trellis
steps with the whole batch and all 64 states vectorized; branch
metrics for the 8 output combos come from one (B,T,3)x(3,8) matmul.  The
traceback is a second reverse scan over the stored decision bits.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .convcoder import GENERATORS

TB_ITER = 3


@functools.lru_cache(maxsize=None)
def _tables():
    # combo[s][u] = output bit triple index (d0 + 2 d1 + 4 d2)
    combo = np.zeros((64, 2), dtype=np.int64)
    for s in range(64):
        for u in (0, 1):
            idx = 0
            for i in range(3):
                d = GENERATORS[i, 0] * u
                for j in range(1, 7):
                    d ^= GENERATORS[i, j] * ((s >> (j - 1)) & 1)
                idx |= (int(d) & 1) << i
            combo[s, u] = idx
    # predecessors of state s': u = s'&1; preds = (s'>>1) | top<<5
    sp = np.arange(64)
    preds = np.stack([sp >> 1, (sp >> 1) | 32], axis=-1)  # (64, 2)
    u_of = sp & 1
    pred_combo = combo[preds, u_of[:, None]]  # (64, 2)
    # bipolar signs of the 8 combos for the 3 streams (positive LLR = bit 0)
    signs = np.zeros((3, 8), dtype=np.float32)
    for c in range(8):
        for i in range(3):
            signs[i, c] = 1.0 - 2.0 * ((c >> i) & 1)
    return preds.astype(np.int32), pred_combo.astype(np.int32), signs


@functools.partial(jax.jit, static_argnums=(1,))
def viterbi_decode(llrs: jnp.ndarray, tb_iter: int = TB_ITER):
    """llrs: (B, 3, K) stream LLRs (positive = bit 0). Returns (B, K) int8 bits."""
    preds, pred_combo, signs = _tables()
    B, _, K = llrs.shape
    # branch metrics for all 8 combos: (B, K, 8)
    bm = 0.5 * jnp.einsum("bik,ic->bkc", llrs, jnp.asarray(signs))
    bm3 = jnp.tile(bm, (1, tb_iter, 1))  # tail-biting frame repetition
    T = tb_iter * K

    def acs(metrics, bm_t):
        # metrics: (B, 64); bm_t: (B, 8)
        cand = metrics[:, preds] + bm_t[:, pred_combo]  # (B, 64, 2)
        decision = jnp.argmax(cand, axis=-1).astype(jnp.int8)
        new = jnp.max(cand, axis=-1)
        new = new - jnp.max(new, axis=-1, keepdims=True)
        return new, decision

    m0 = jnp.zeros((B, 64), dtype=llrs.dtype)
    mf, decisions = jax.lax.scan(acs, m0, bm3.transpose(1, 0, 2),
                                 unroll=8)  # (T, B, 64)

    start = jnp.argmax(mf, axis=-1).astype(jnp.int32)  # (B,)

    def traceback(state, dec_t):
        u = (state & 1).astype(jnp.int8)
        top = jnp.take_along_axis(dec_t, state[:, None], axis=1)[:, 0]
        prev = (state >> 1) | (top.astype(jnp.int32) << 5)
        return prev, u

    _, bits_rev = jax.lax.scan(traceback, start, decisions[::-1],
                               unroll=8)
    bits = bits_rev[::-1].transpose(1, 0)  # (B, T)
    mid = (tb_iter // 2) * K
    return bits[:, mid : mid + K]
