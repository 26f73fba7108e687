"""36.211 §7.1 modulation mapper + zone-based soft demodulator.

Reference behavior: `lib/src/phy/modem/{mod.c,lte_tables.c}` (Gray mapping
tables) and `demod_soft.c` (interval/zone approximate max-log LLRs with
SSE paths, demod_soft.c:76-160).

Design: mapping is a (2^Qm,) complex LUT gather over bit-group indices;
demod is closed-form elementwise math (the zone approximations are exactly
srsLTE's, with the sign flipped to this framework's convention:
positive LLR <=> bit 0; srsLTE uses the opposite sign).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

BPSK, QPSK, QAM16, QAM64, QAM256 = "bpsk", "qpsk", "16qam", "64qam", "256qam"
BITS_PER_SYMBOL = {BPSK: 1, QPSK: 2, QAM16: 4, QAM64: 6, QAM256: 8}
# srsLTE srslte_mod_t order: BPSK, QPSK, 16QAM, 64QAM, 256QAM (phy_common.h:246)
MOD_FROM_QM = {1: BPSK, 2: QPSK, 4: QAM16, 6: QAM64, 8: QAM256}


@functools.lru_cache(maxsize=None)
def constellation(mod: str) -> np.ndarray:
    """Complex LUT indexed by the bit-group value (b0 = MSB of the index,
    matching transmission order b(i), b(i+1), ...)."""
    qm = BITS_PER_SYMBOL[mod]
    n = 1 << qm
    pts = np.zeros(n, dtype=np.complex64)
    for v in range(n):
        b = [(v >> (qm - 1 - i)) & 1 for i in range(qm)]
        if mod == BPSK:
            # 36.211 Table 7.1.1-1: b=0 -> (1+j)/sqrt(2), b=1 -> -(1+j)/sqrt(2)
            s = (1 - 2 * b[0]) / np.sqrt(2)
            pts[v] = s + 1j * s
        elif mod == QPSK:
            pts[v] = ((1 - 2 * b[0]) + 1j * (1 - 2 * b[1])) / np.sqrt(2)
        elif mod == QAM16:
            i = (1 - 2 * b[0]) * (1 + 2 * b[2])
            q = (1 - 2 * b[1]) * (1 + 2 * b[3])
            pts[v] = (i + 1j * q) / np.sqrt(10)
        elif mod == QAM64:
            i = (1 - 2 * b[0]) * (4 - (1 - 2 * b[2]) * (2 - (1 - 2 * b[4])))
            q = (1 - 2 * b[1]) * (4 - (1 - 2 * b[3]) * (2 - (1 - 2 * b[5])))
            pts[v] = (i + 1j * q) / np.sqrt(42)
        elif mod == QAM256:
            i = (1 - 2 * b[0]) * (8 - (1 - 2 * b[2]) * (4 - (1 - 2 * b[4]) * (2 - (1 - 2 * b[6]))))
            q = (1 - 2 * b[1]) * (8 - (1 - 2 * b[3]) * (4 - (1 - 2 * b[5]) * (2 - (1 - 2 * b[7]))))
            pts[v] = (i + 1j * q) / np.sqrt(170)
    return pts


@functools.partial(jax.jit, static_argnums=(1,))
def modulate(bits: jnp.ndarray, mod: str) -> jnp.ndarray:
    """(..., E) bits -> (..., E/Qm, 2) split-complex symbols (cf convention).

    Closed-form nested Gray mapping (36.211 Tables 7.1.x-1) evaluated as
    elementwise math: it fuses into its producer, where a LUT gather would
    be a separate memory-bound pass."""
    qm = BITS_PER_SYMBOL[mod]
    shape = bits.shape[:-1] + (bits.shape[-1] // qm, qm)
    s = 1.0 - 2.0 * bits.reshape(shape).astype(jnp.float32)  # (..., n, qm)
    if mod == BPSK:
        v = s[..., 0] * np.float32(1.0 / np.sqrt(2))
        return jnp.stack([v, v], axis=-1)
    if mod == QPSK:
        iq = s * np.float32(1.0 / np.sqrt(2))
    elif mod == QAM16:
        iq = s[..., 0:2] * (2.0 - s[..., 2:4]) * np.float32(1.0 / np.sqrt(10))
    elif mod == QAM64:
        iq = (s[..., 0:2] * (4.0 - s[..., 2:4] * (2.0 - s[..., 4:6]))
              * np.float32(1.0 / np.sqrt(42)))
    elif mod == QAM256:
        iq = (s[..., 0:2] * (8.0 - s[..., 2:4]
                             * (4.0 - s[..., 4:6] * (2.0 - s[..., 6:8])))
              * np.float32(1.0 / np.sqrt(170)))
    else:
        raise ValueError(mod)
    return iq


@functools.partial(jax.jit, static_argnums=(1,))
def demod_soft(symbols: jnp.ndarray, mod: str) -> jnp.ndarray:
    """Zone-approximate max-log LLRs: (..., N, 2) cf symbols -> (..., N*Qm).

    Positive LLR <=> bit 0.  Formulas mirror demod_soft.c:76-160 (sign
    flipped).  LLRs are unnormalized (no 1/sigma^2 factor) — the decoder is
    scale-invariant per codeword and CSI weighting multiplies in later, as in
    pdsch.c:574-686's csi-weighted path.
    """
    re, im = symbols[..., 0], symbols[..., 1]
    if mod == BPSK:
        out = [(re + im) * np.float32(1 / np.sqrt(2))]
    elif mod == QPSK:
        out = [re * np.float32(np.sqrt(2)), im * np.float32(np.sqrt(2))]
    elif mod == QAM16:
        c = np.float32(2 / np.sqrt(10))
        out = [re, im, c - jnp.abs(re), c - jnp.abs(im)]
    elif mod == QAM64:
        c4, c2 = np.float32(4 / np.sqrt(42)), np.float32(2 / np.sqrt(42))
        t_re, t_im = jnp.abs(re) - c4, jnp.abs(im) - c4
        out = [re, im, -t_re, -t_im, c2 - jnp.abs(t_re), c2 - jnp.abs(t_im)]
    elif mod == QAM256:
        c8 = np.float32(8 / np.sqrt(170))
        c4 = np.float32(4 / np.sqrt(170))
        c2 = np.float32(2 / np.sqrt(170))
        t1_re, t1_im = jnp.abs(re) - c8, jnp.abs(im) - c8
        t2_re, t2_im = jnp.abs(t1_re) - c4, jnp.abs(t1_im) - c4
        out = [re, im, -t1_re, -t1_im, -t2_re, -t2_im, c2 - jnp.abs(t2_re), c2 - jnp.abs(t2_im)]
    else:
        raise ValueError(mod)
    # interleave per-symbol: (..., N, Qm) -> (..., N*Qm)
    stacked = jnp.stack(out, axis=-1)
    return stacked.reshape(symbols.shape[:-2] + (-1,))


def demod_hard(symbols: jnp.ndarray, mod: str) -> jnp.ndarray:
    """Hard decisions via the soft path (reference: demod_hard.c)."""
    return (demod_soft(symbols, mod) < 0).astype(jnp.int8)
