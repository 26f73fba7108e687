"""36.212 §5.1.4.1 turbo rate matching, batched.

Reference behavior: `lib/src/phy/fec/rm_turbo.c` — 32-column sub-block
interleaver (RM_PERM_TC at rm_turbo.c:56), circular-buffer bit selection with
precomputed k0 per redundancy version (rm_turbo.c:66), giant TX/RX LUTs
(srslte_rm_turbo_tx_lut at rm_turbo.c:328, SSE/AVX deinterleave :374-428).

Design: the reference's LUT strategy is already the right shape for a batch —
we compute, on the host once per (K, F, E, rv, Ncb) configuration, flat index
tables, and the device op is a single batched gather (TX) or scatter-add (RX
soft-combining into the HARQ w-buffer).  NULL fillers and interleaver dummies
never touch the device: they are simply absent from the index tables; filler
positions re-enter at RX as known-zero LLR clamps.

LLR convention throughout the framework: positive LLR <=> bit 0.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NCOLS = 32
# 36.212 Table 5.1.4-1 inter-column permutation pattern (== RM_PERM_TC).
PERM_TC = np.array(
    [0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
     1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31],
    dtype=np.int64,
)

DUMMY = -1  # sub-block interleaver padding
FILLER = -2  # NULL filler bits (first CB only)

FILLER_LLR = 127.0  # clamp value for known-zero filler bits at RX


@functools.lru_cache(maxsize=None)
def wbuf_map(k: int, f: int) -> np.ndarray:
    """Circular-buffer source map for CB size k with f leading fillers.

    Returns int32 array (3*Kp,) where entry is  stream*D + d_index  into the
    flattened (d0|d1|d2) array (D = k+4), or DUMMY / FILLER.
    """
    D = k + 4
    R = -(-D // NCOLS)
    Kp = NCOLS * R
    nd = Kp - D

    def stream_y(stream):
        y = np.full(Kp, DUMMY, dtype=np.int64)
        idx = np.arange(D)
        src = stream * D + idx
        if stream in (0, 1) and f > 0:
            # d0/d1 positions < f are NULL fillers (turbocoder.c:106-128)
            src = np.where(idx < f, FILLER, src)
        y[nd:] = src
        return y

    # streams 0/1: row-major fill, column permutation, column-major read
    rows = np.arange(R)
    v01 = []
    for s in (0, 1):
        y = stream_y(s)
        # v[col*R + row] = y[row*NCOLS + PERM_TC[col]]
        v = y[(rows[None, :] * NCOLS + PERM_TC[:, None]).reshape(-1)]
        v01.append(v)
    # stream 2: pi(n) = (PERM_TC[n // R] + NCOLS*(n % R) + 1) mod Kp
    n = np.arange(Kp)
    pi = (PERM_TC[n // R] + NCOLS * (n % R) + 1) % Kp
    v2 = stream_y(2)[pi]

    w = np.empty(3 * Kp, dtype=np.int64)
    w[:Kp] = v01[0]
    w[Kp::2] = v01[1]
    w[Kp + 1 :: 2] = v2
    return w.astype(np.int32)


def k0_index(k: int, rv: int, ncb: int) -> int:
    """Bit-selection start k0 = R*(2*ceil(Ncb/(8R))*rv + 2) (36.212 §5.1.4.1.2)."""
    R = -(-(k + 4) // NCOLS)
    return R * (2 * (-(-ncb // (8 * R))) * rv + 2)


@functools.lru_cache(maxsize=None)
def tx_table(k: int, f: int, e: int, rv: int, ncb: int = 0) -> np.ndarray:
    """Gather indices (e,) into the flattened d array (3*(k+4),) producing the
    rate-matched output bits for this configuration."""
    w = wbuf_map(k, f)
    if ncb <= 0 or ncb > len(w):
        ncb = len(w)
    k0 = k0_index(k, rv, ncb)
    region = w[:ncb]
    valid_pos = np.flatnonzero(region >= 0)
    # rotate so selection starts at first valid index >= k0 (circular)
    start = np.searchsorted(valid_pos, k0)
    rot = np.roll(valid_pos, -start)
    sel = rot[np.arange(e) % len(rot)]
    return region[sel].astype(np.int32)


@functools.lru_cache(maxsize=None)
def rx_table(k: int, f: int, e: int, rv: int, ncb: int = 0) -> np.ndarray:
    """Scatter targets (e,) : w-buffer position receiving each incoming LLR."""
    w = wbuf_map(k, f)
    if ncb <= 0 or ncb > len(w):
        ncb = len(w)
    k0 = k0_index(k, rv, ncb)
    valid_pos = np.flatnonzero(w[:ncb] >= 0)
    start = np.searchsorted(valid_pos, k0)
    rot = np.roll(valid_pos, -start)
    return rot[np.arange(e) % len(rot)].astype(np.int32)


@functools.lru_cache(maxsize=None)
def rx_gather_table(k: int, f: int, e: int, rv: int, ncb: int = 0) -> np.ndarray:
    """Inverse of rx_table as a dense gather: (wbuf_size, n_max) indices into
    the incoming LLR vector padded with one trailing zero (index e = "none").

    Soft combining becomes wbuf += padded_llrs[..., table].sum(-1) — pure
    gathers + reduction, with none of the write conflicts a scatter-add
    would have to resolve.
    """
    tgt = rx_table(k, f, e, rv, ncb)
    size = wbuf_size(k)
    counts = np.bincount(tgt, minlength=size)
    n_max = max(1, int(counts.max()))
    out = np.full((size, n_max), e, dtype=np.int32)
    slot = np.zeros(size, dtype=np.int64)
    for j, t in enumerate(tgt):
        out[t, slot[t]] = j
        slot[t] += 1
    return out


@functools.lru_cache(maxsize=None)
def _wbuf_inverse(k: int, f: int):
    """(gather_idx (3D,), filler_mask (3D,)) mapping w-buffer -> d-LLRs.
    gather_idx[j] = w position holding d_flat[j], or 0 for fillers/missing."""
    w = wbuf_map(k, f)
    D = k + 4
    inv = np.zeros(3 * D, dtype=np.int32)
    present = np.zeros(3 * D, dtype=bool)
    pos = np.flatnonzero(w >= 0)
    inv[w[pos]] = pos
    present[w[pos]] = True
    filler = np.zeros(3 * D, dtype=bool)
    if f > 0:
        filler[0:f] = True  # d0 fillers
        filler[D : D + f] = True  # d1 fillers (state stays 0 -> parity known 0)
    return inv, present, filler


def wbuf_size(k: int) -> int:
    return 3 * NCOLS * (-(-(k + 4) // NCOLS))


def rate_match_tx(d_flat: jnp.ndarray, k: int, f: int, e: int, rv: int, ncb: int = 0):
    """TX bit selection: d_flat (B, 3*(k+4)) bits -> (B, e) bits."""
    tbl = tx_table(k, f, e, rv, ncb)
    return jnp.take(d_flat, jnp.asarray(tbl), axis=-1)


def rate_unmatch_rx(
    llrs: jnp.ndarray, wbuf: jnp.ndarray, k: int, f: int, e: int, rv: int, ncb: int = 0
):
    """RX soft-combine: accumulate incoming LLRs (B, e) into the HARQ
    w-buffer (B, 3*Kp) (the `srslte_softbuffer_rx_t` equivalent,
    `fec/softbuffer.c`).  Returns the updated w-buffer.

    Implemented as an inverse gather + sum (see rx_gather_table) because the
    pattern is static per configuration — no scatter needed."""
    tbl = rx_gather_table(k, f, e, rv, ncb)
    padded = jnp.concatenate(
        [llrs, jnp.zeros(llrs.shape[:-1] + (1,), llrs.dtype)], axis=-1
    )
    return jnp.asarray(wbuf) + jnp.take(padded, jnp.asarray(tbl), axis=-1).sum(-1)


@functools.lru_cache(maxsize=None)
def _cyclic_tables(k: int, f: int, ncb: int = 0):
    """Tables for the traced-RV paths.  The ONLY thing the redundancy
    version changes is the circular-buffer start k0 (§5.1.4.1.2), so the
    bit-selection stream z[j] = d[region[valid[j]]] is RV-invariant and
    each RV is a STATIC rotation of it:

      tx_rv[i]  = z[(start_rv + i) mod V]
      rx: w[valid[j]] += sum_i llr[i] over i == j - start_rv (mod V)

    Returns (z_src (V,) gather into d_flat, starts (4,), inv (size,)
    index into the z domain per w-buffer position (V = "none"))."""
    w = wbuf_map(k, f)
    if ncb <= 0 or ncb > len(w):
        ncb = len(w)
    region = w[:ncb]
    valid = np.flatnonzero(region >= 0)
    starts = np.array([np.searchsorted(valid, k0_index(k, rv, ncb))
                       for rv in range(4)], np.int32)
    size = wbuf_size(k)
    inv = np.full(size, len(valid), np.int32)
    inv[valid] = np.arange(len(valid))
    return region[valid].astype(np.int32), starts, inv


def _blend_rolled(z, starts, rv_b, sign):
    """sum_rv (rv_b == rv) * roll(z, sign*starts[rv]): four STATIC rolls
    + a select — the replacement for a per-row dynamic gather of (B, V),
    which reads every row with its own offset."""
    out = 0.0
    for rv in range(4):
        sel = (jnp.asarray(rv_b, jnp.int32) == rv)[:, None]
        out = out + jnp.where(sel, jnp.roll(z, sign * int(starts[rv]),
                                            axis=-1), 0)
    return out


def rate_match_tx_dyn(d_flat: jnp.ndarray, k: int, f: int, e: int, rv_b,
                      ncb: int = 0):
    """rate_match_tx with a TRACED per-row redundancy version rv_b (B,):
    the in-block HARQ path's RV cycling (scheduler_harq.cc get_rv)."""
    z_src, starts, _ = _cyclic_tables(k, f, ncb)
    z = jnp.take(d_flat, jnp.asarray(z_src), axis=-1)  # (B, V) static
    zr = _blend_rolled(z, starts, rv_b, -1)
    V = z_src.shape[0]
    reps = -(-e // V)
    if reps > 1:
        zr = jnp.tile(zr, (1, reps))
    return zr[..., :e].astype(d_flat.dtype)


def rate_unmatch_rx_dyn(llrs: jnp.ndarray, wbuf: jnp.ndarray, k: int, f: int,
                        e: int, rv_b, ncb: int = 0):
    """rate_unmatch_rx with a TRACED per-row rv — HARQ IR soft-combining
    where each batch row may be a different retransmission number."""
    z_src, starts, inv = _cyclic_tables(k, f, ncb)
    V = z_src.shape[0]
    reps = -(-e // V)
    pad = jnp.concatenate(
        [llrs, jnp.zeros(llrs.shape[:-1] + (reps * V - e,), llrs.dtype)],
        axis=-1)
    s = pad.reshape(llrs.shape[:-1] + (reps, V)).sum(-2)  # wrap-combine
    zacc = _blend_rolled(s, starts, rv_b, +1).astype(wbuf.dtype)
    zpad = jnp.concatenate(
        [zacc, jnp.zeros(zacc.shape[:-1] + (1,), zacc.dtype)], axis=-1)
    return jnp.asarray(wbuf) + jnp.take(zpad, jnp.asarray(inv), axis=-1)


def wbuf_to_d_llrs(wbuf: jnp.ndarray, k: int, f: int):
    """De-permute the w-buffer into (sys, par1, par2) LLRs, each (B, k+4).
    Filler positions are clamped to known-zero (+FILLER_LLR); never-transmitted
    positions (punctured) read 0 from the zero-initialised w-buffer."""
    D = k + 4
    inv, present, filler = _wbuf_inverse(k, f)
    d = jnp.take(wbuf, jnp.asarray(inv), axis=-1)
    d = jnp.where(jnp.asarray(present), d, 0.0)
    d = jnp.where(jnp.asarray(filler), FILLER_LLR, d)
    return d[..., :D], d[..., D : 2 * D], d[..., 2 * D :]
