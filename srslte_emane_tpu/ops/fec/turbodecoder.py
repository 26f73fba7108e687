"""36.212 turbo decoder: batched, windowed max-log-MAP.

Reference behavior: `lib/src/phy/fec/turbodecoder.c` + `turbodecoder_win.h` —
max-log-MAP with sub-block windowed decoding (8/16 SIMD windows, 40-sample
halo overlap, metric normalization every 2 trellis steps,
turbodecoder_win.h:36-87) and per-iteration CRC early stop
(`lib/src/phy/phch/sch.c:350-383`).

Design: the reference's "windows in SIMD lanes" is exactly a batch axis.
We fold (code blocks x windows) into one vectorized axis and run the
forward/backward recursions over the window length, with all windows and
all code blocks advancing in lockstep:

  * gammas for the 4 (u, parity) combos are precomputed per trellis step,
  * alpha/beta window boundary metrics come from a separate halo pre-scan
    (H=40, matching the reference), except the exact trellis edges:
    alpha_0 = [0, -inf...] and beta_K from the tail-bit path metrics,
  * the posterior LLR combine is one big vectorized max over the 16
    transitions for every (cb, window, step) at once,
  * CRC early stop: a `lax.while_loop` over HALF-iterations (one MAP pass
    per trip) that exits when every code block in the batch passes CRC;
    per-CB results freeze on first pass.  Checking after every MAP — not
    once per full iteration — halves the minimum decode cost at high SNR.

The MAP pass has one route per platform, chosen in `turbo_decode`:
`_map_decode` below (`lax.scan`s; the plain reference, and the CPU route)
and the fused GPU kernel in turbodecoder_gpu.py (the CUDA route).

LLR convention: positive LLR <=> bit 0 (bipolar sign s_b = 1 - 2b).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import crc as crc_mod
from . import turbo

NEG = -1e30
HALO = 40  # window overlap, matches turbodecoder_win.h:36-87

# extrinsic damping of the max-log-MAP (with it, the exact log-MAP max*
# measured BLER-equal on the 20 MHz link in round 4, so max-log stays)
EXT_SCALE = 0.75


@functools.lru_cache(maxsize=None)
def _trellis():
    """8-state RSC trellis tables (state s = r0*4 + r1*2 + r2).

    Returns dict of int numpy arrays:
      next_state (8,2), parity (8,2): indexed [s][u]
      prev_state (8,2), prev_u (8,2): predecessors of s' (two each)
      tail_signs (8,6): bipolar (x,z) pairs of the 3 forced tail steps per state
    """
    next_state = np.zeros((8, 2), dtype=np.int64)
    parity = np.zeros((8, 2), dtype=np.int64)
    for s in range(8):
        r0, r1, r2 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        for u in (0, 1):
            a = u ^ r1 ^ r2
            z = u ^ r0 ^ r1
            next_state[s, u] = a * 4 + r0 * 2 + r1
            parity[s, u] = z
    prev_state = np.zeros((8, 2), dtype=np.int64)
    prev_u = np.zeros((8, 2), dtype=np.int64)
    fill = np.zeros(8, dtype=np.int64)
    for s in range(8):
        for u in (0, 1):
            ns = next_state[s, u]
            prev_state[ns, fill[ns]] = s
            prev_u[ns, fill[ns]] = u
            fill[ns] += 1
    assert (fill == 2).all()
    tail_signs = np.zeros((8, 6), dtype=np.float32)
    for s0 in range(8):
        s = s0
        for step in range(3):
            r0, r1, r2 = (s >> 2) & 1, (s >> 1) & 1, s & 1
            x = r1 ^ r2  # forced input (feedback bit)
            z = r0 ^ r2
            tail_signs[s0, 2 * step] = 1 - 2 * x
            tail_signs[s0, 2 * step + 1] = 1 - 2 * z
            s = (r0 * 2 + r1)  # a=0: s' = (0, r0, r1)
    return dict(
        next_state=next_state,
        parity=parity,
        prev_state=prev_state,
        prev_u=prev_u,
        tail_signs=tail_signs,
    )


def _pick_windows(k: int) -> int:
    """Number of windows W (dividing k) targeting window length ~128-256."""
    if k <= 256:
        return 1
    for w in (32, 16, 8, 4, 2):
        if k % w == 0 and k // w >= 128:
            return w
    return 1


def _gammas(ls: jnp.ndarray, lp: jnp.ndarray) -> jnp.ndarray:
    """4-combo branch metrics, combo index = u*2 + z.  Shapes (..., T) -> (..., T, 4)."""
    su = jnp.stack([ls, ls, -ls, -ls], axis=-1)
    sz = jnp.stack([lp, -lp, lp, -lp], axis=-1)
    return 0.5 * (su + sz)


def _map_decode(ls_eff: jnp.ndarray, lp: jnp.ndarray, tail_x: jnp.ndarray, tail_z: jnp.ndarray):
    """One max-log-MAP pass.

    ls_eff: (B, K) systematic + apriori LLRs; lp: (B, K) parity LLRs;
    tail_x/tail_z: (B, 3) tail systematic/parity LLRs for this encoder.
    Returns posterior LLRs (B, K).
    """
    T = _trellis()
    B, K = ls_eff.shape
    W = _pick_windows(K)
    L = K // W
    H = min(HALO, L)

    g = _gammas(ls_eff, lp)  # (B, K, 4)
    # windowed views with halos: window w covers [wL, wL+L)
    # alpha halo: [wL-H, wL); beta halo: [wL+L, wL+L+H)
    pos = np.arange(W)[:, None] * L
    a_halo_idx = pos + np.arange(-H, 0)[None, :]  # (W, H) may be negative
    b_halo_idx = pos + np.arange(L, L + H)[None, :]  # may exceed K
    a_halo_valid = a_halo_idx >= 0
    b_halo_valid = b_halo_idx < K
    g_pad = jnp.pad(g, ((0, 0), (H, H), (0, 0)))  # zero gammas outside
    ga_halo = jnp.take(g_pad, jnp.asarray(a_halo_idx + H).reshape(-1), axis=1).reshape(B, W, H, 4)
    gb_halo = jnp.take(g_pad, jnp.asarray(b_halo_idx + H).reshape(-1), axis=1).reshape(B, W, H, 4)
    g_win = g.reshape(B, W, L, 4)

    ns, pz = T["next_state"], T["parity"]
    ps, pu = T["prev_state"], T["prev_u"]
    # static per-transition gamma combo indices
    combo_fwd = (pu * 2 + pz[ps, pu]).astype(np.int32)  # (8,2) for alpha gather
    combo_bwd = (np.arange(2)[None, :] * 2 + pz).astype(np.int32)  # (8,2) for beta

    def alpha_step(alpha, g_t, norm=True):
        # alpha: (B, W, 8); g_t: (B, W, 4)
        cand = alpha[..., ps] + g_t[..., combo_fwd]  # (B, W, 8, 2)
        out = jnp.maximum(cand[..., 0], cand[..., 1])
        if norm:
            out = out - jnp.max(out, axis=-1, keepdims=True)
        return out

    def beta_step(beta, g_t, norm=True):
        cand = beta[..., ns] + g_t[..., combo_bwd]  # (B, W, 8, 2)
        out = jnp.maximum(cand[..., 0], cand[..., 1])
        if norm:
            out = out - jnp.max(out, axis=-1, keepdims=True)
        return out

    # unroll factor: several trellis steps per lax.scan iteration amortizes
    # per-step dispatch; normalization every 2 steps (turbodecoder_win.h)
    U = 4 if L % 4 == 0 and H % 4 == 0 else 1

    def _unrolled(step_fn):
        def body(c, g_u):  # g_u: (U, B, W, 4)
            outs = []
            for u in range(U):
                outs.append(c)
                c = step_fn(c, g_u[u], norm=(u % 2 == 1))
            return c, jnp.stack(outs)
        return body

    uniform = jnp.zeros((B, W, 8), dtype=ls_eff.dtype)
    # ---- beta ----
    gb = gb_halo.transpose(2, 0, 1, 3)[::-1]
    gb = gb.reshape(H // U if U > 1 else H, U, B, W, 4) if U > 1 else gb[:, None]
    b_init = jax.lax.scan(
        lambda c, g_u: (_unrolled(beta_step)(c, g_u)[0], None), uniform, gb
    )[0]
    # exact termination: beta_K from tail path metrics
    beta_tail = 0.5 * jnp.einsum(
        "sj,bj->bs",
        jnp.asarray(T["tail_signs"]),
        jnp.stack([tail_x[:, 0], tail_z[:, 0], tail_x[:, 1], tail_z[:, 1], tail_x[:, 2], tail_z[:, 2]], axis=-1),
    )
    b_init = b_init.at[:, W - 1, :].set(beta_tail - jnp.max(beta_tail, axis=-1, keepdims=True))

    def beta_scan(c, g_u):
        outs = []
        for u in range(U):
            c = beta_step(c, g_u[u], norm=(u % 2 == 1))
            outs.append(c)
        return c, jnp.stack(outs)  # emit beta after consuming each step

    gwr = g_win.transpose(2, 0, 1, 3)[::-1].reshape(L // U, U, B, W, 4)
    _, betas_rev = jax.lax.scan(beta_scan, b_init, gwr)
    betas = betas_rev.reshape(L, B, W, 8)[::-1]
    # beta_scan consumed g in reverse; betas[t] (after flip) = beta *at* position t
    # i.e. the backward metric for states before step t was consumed -> this is
    # beta_{t} meaning metrics at trellis node t ... we need beta at node t+1
    # for the combine.  betas_rev[i] corresponds to node K-1-i; after flip,
    # betas[t] = beta at node t.  Combine needs beta_{t+1}: shift.
    beta_next = jnp.concatenate([betas[1:], b_init[None, :, :, :]], axis=0)
    # careful: for windows, node t+1 within window; at the window end (t=L-1)
    # beta_{t+1} is the window's own init vector b_init -> correct as written
    # only for the *per-window* layout: b_init is (B, W, 8) and betas are
    # (L, B, W, 8) per-window node metrics.

    # ---- alpha scan with FUSED posterior combine ----
    # computing llr_t inside the forward scan avoids materializing the
    # (L,B,W,8) alphas and the (L,B,W,2,8) transition candidates.
    combo_all = (np.arange(2)[:, None] * 2 + pz.T).astype(np.int32)  # (2,8)
    ns_t = ns.T  # (2, 8): next state per (u, s)

    ga = ga_halo.transpose(2, 0, 1, 3).reshape(H // U if U > 1 else H, U, B, W, 4) \
        if U > 1 else ga_halo.transpose(2, 0, 1, 3)[:, None]
    a_init = jax.lax.scan(
        lambda c, g_u: (_unrolled(alpha_step)(c, g_u)[0], None), uniform, ga
    )[0]
    exact0 = jnp.full((8,), NEG, dtype=ls_eff.dtype).at[0].set(0.0)
    a_init = a_init.at[:, 0, :].set(exact0)
    gw = g_win.transpose(2, 0, 1, 3).reshape(L // U, U, B, W, 4)
    bn = beta_next.reshape(L // U, U, B, W, 8)

    def fwd_combine(alpha, xs):
        g_u, b_u = xs  # (U,B,W,4), (U,B,W,8)
        llrs = []
        for u in range(U):
            # cand[u', s] = alpha[s] + g[combo(u', pz[s,u'])] + beta'[ns[s,u']]
            cand = alpha[..., None, :] + g_u[u][..., combo_all] + b_u[u][..., ns_t]
            m = jnp.max(cand, axis=-1)  # (B, W, 2)
            llrs.append(m[..., 0] - m[..., 1])
            alpha = alpha_step(alpha, g_u[u], norm=(u % 2 == 1))
        return alpha, jnp.stack(llrs)

    _, llr = jax.lax.scan(fwd_combine, a_init, (gw, bn))
    llr = llr.reshape(L, B, W)
    return llr.transpose(1, 2, 0).reshape(B, K)


def quantize_llr_int8(llr, scale: float = 8.0):
    """Quantize LLRs to the reference's 8-bit dynamic range
    (`lib/include/srslte/phy/fec/turbodecoder.h:50-66` SRSLTE_TDEC_8BIT):
    round(llr * scale) saturated to [-127, 127], then dequantized — the
    decoder's inputs carry exactly 8 bits of information, as in the
    reference's SIMD mode.  The recursions run in f32, so the 8-bit mode is
    a PRECISION contract, not a speed path (the SIMD-width win the
    reference gets from 8-bit lanes is already taken here by the
    (codeblock x window) batching); BLER parity with the f32 path is
    pinned in tests/test_turbo_bler.py."""
    q = jnp.clip(jnp.round(llr.astype(jnp.float32) * scale), -127, 127)
    return q / scale


def quantize_llr_int16(llr, scale: float = 256.0):
    """16-bit mode (SRSLTE_TDEC_16BIT): same contract, +/-32767 range.
    Forces f32 so a bf16 LLR stream (sch.decode_tb at llr_bits <= 16)
    re-enters the decoder's f32 recursion math."""
    q = jnp.clip(jnp.round(llr.astype(jnp.float32) * scale), -32767, 32767)
    return q / scale


def map_route(ls_eff, lp, tail_x, tail_z):
    """One MAP pass by the route of the platform it is lowered for: the
    fused kernel on CUDA, `_map_decode` everywhere else.  The choice is
    made at lowering time (lax.platform_dependent), so a function jitted
    for the CPU device of a GPU machine still takes the plain route; on
    the GPU a kernel that fails to compile raises."""
    from .turbodecoder_gpu import map_decode_gpu

    return jax.lax.platform_dependent(
        ls_eff, lp, tail_x, tail_z, cuda=map_decode_gpu, default=_map_decode)


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7))
def turbo_decode(
    d0: jnp.ndarray,
    d1: jnp.ndarray,
    d2: jnp.ndarray,
    valid: jnp.ndarray,
    k: int,
    max_iter: int = 8,
    crc: tuple = crc_mod.LTE_CRC24B,
    llr_bits: int = 32,
):
    """Decode a batch of code blocks with CRC-gated early stop.

    d0/d1/d2: (B, K+4) LLRs (systematic/parity1/parity2 + tails), positive=bit 0.
    valid: (B,) bool — CBs actually present (padding rows decode but are ignored
           and treated as done from the start).
    crc: polynomial for per-CB early stop, or None to run all iterations.
    Returns (bits (B, K) int8 hard decisions, crc_pass (B,) bool, n_iter int32).

    n_iter is ceil(half_passes / 2): a decode that converges after the
    first (natural-order) MAP reports 1 full iteration, so avg-iteration
    telemetry derived from it slightly OVERCOUNTS vs the reference's
    whole-iteration counter (sch.c) — half-iteration resolution is lost
    in the rounding, by at most +0.5.
    """
    if llr_bits == 8:
        # reference 8-bit mode (turbodecoder.h SRSLTE_TDEC_8BIT)
        d0, d1, d2 = (quantize_llr_int8(d) for d in (d0, d1, d2))
    elif llr_bits == 16:
        d0, d1, d2 = (quantize_llr_int16(d) for d in (d0, d1, d2))
    B = d0.shape[0]
    perm = jnp.asarray(turbo.qpp_interleaver(k))
    inv_perm = jnp.asarray(np.argsort(turbo.qpp_interleaver(k)))
    ls = d0[:, :k]
    lp1 = d1[:, :k]
    lp2 = d2[:, :k]
    # tail arrangement (36.212 5.1.3.2.2, see turbo.turbo_encode):
    tail_x1 = jnp.stack([d0[:, k], d2[:, k], d1[:, k + 1]], axis=-1)
    tail_z1 = jnp.stack([d1[:, k], d0[:, k + 1], d2[:, k + 1]], axis=-1)
    tail_x2 = jnp.stack([d0[:, k + 2], d2[:, k + 2], d1[:, k + 3]], axis=-1)
    tail_z2 = jnp.stack([d1[:, k + 2], d0[:, k + 3], d2[:, k + 3]], axis=-1)

    def make_phase(ls_p, lp1_p, lp2_p, tx1, tz1, tx2, tz2):
        """while_loop body/cond factory over one (possibly compacted) batch.

        The loop counter is HALF-iterations (one MAP pass each): CRC is
        checked after EVERY MAP, not once per full iteration — a
        sharpening of sch.c:350-383's per-iteration early stop.  A CB whose
        hard decisions already pass CRC after the first (natural-order) MAP
        never pays for the second; at high SNR that halves the decode, and
        at the waterfall it gives the compaction cascade a 2x finer trigger.
        Trade-off vs the reference: twice as many CRC checks per iteration
        doubles the per-CB undetected-false-pass probability (results
        freeze on first pass), but each extra check adds only ~2^-24 of
        collision exposure — negligible vs channel BLER.
        The state carries the latest extrinsic in NATURAL order; parity of
        the half counter selects which constituent decoder runs.
        """
        nB = ls_p.shape[0]

        def check(bits):
            if crc is None:
                return jnp.zeros((nB,), dtype=bool)
            return crc_mod.crc_ok(bits, crc)

        def half_enc1(ext):
            ls_in = ls_p + ext
            post = map_route(ls_in, lp1_p, tx1, tz1)
            new_ext = (post - ls_in) * EXT_SCALE
            bits = (post < 0).astype(jnp.int8)
            return new_ext, bits

        def half_enc2(ext):
            ls2 = jnp.take(ls_p, perm, axis=1)
            ls_in = ls2 + jnp.take(ext, perm, axis=1)
            post = map_route(ls_in, lp2_p, tx2, tz2)
            new_ext = jnp.take((post - ls_in) * EXT_SCALE, inv_perm, axis=1)
            bits = (jnp.take(post, inv_perm, axis=1) < 0).astype(jnp.int8)
            return new_ext, bits

        def body(state):
            h, ext, done, bits_out, pass_out = state
            # NOTE: this cond stays a true branch only under plain jit.
            # Do NOT vmap turbo_decode: vmap converts cond to select and
            # BOTH MAP passes would execute every trip, doubling the cost
            # silently.  Batching is already the leading (B) axis.
            new_ext, bits = jax.lax.cond(h % 2 == 0, half_enc1, half_enc2, ext)
            ok = check(bits)
            # latest hard decisions for unfinished CBs; freeze once passed
            bits_out = jnp.where(done[:, None], bits_out, bits)
            pass_out = pass_out | (ok & ~done)
            done = done | ok
            return h + 1, new_ext, done, bits_out, pass_out

        def cond_until(stop_count):
            def cond(state):
                h, _, done, _, _ = state
                return (h < 2 * max_iter) & (jnp.sum(~done) > stop_count)
            return cond

        return body, cond_until

    apri0 = jnp.zeros_like(ls)
    done0 = ~valid
    bits0 = jnp.zeros((B, k), dtype=jnp.int8)
    pass0 = jnp.zeros((B,), dtype=bool)

    body, cond_until = make_phase(ls, lp1, lp2, tail_x1, tail_z1,
                                  tail_x2, tail_z2)
    if crc is None or B < 8:
        h, _, _, bits_out, pass_out = jax.lax.while_loop(
            cond_until(0), body, (jnp.int32(0), apri0, done0, bits0, pass0))
        return bits_out, pass_out & valid, (h + 1) // 2

    # CRC-gated BATCH COMPACTION cascade (the per-CB iteration scheduling
    # of sch.c:350-383, restructured for static shapes): run the full
    # batch only until <= B/2 code blocks remain unfinished, then gather
    # the stragglers into a half-size batch, then a quarter-size one.
    # Finished CBs stop COSTING, not just stop changing — at the BLER
    # waterfall (where a few never-converging CBs used to drag every row
    # through all 8 iterations) this cuts the MAP work ~2-3x.  The whole
    # compaction rides inside a lax.cond so the converged-early case
    # (high SNR, the 20 dB headline) pays ZERO gather/scatter traffic.
    h, ext, done, bits_out, pass_out = jax.lax.while_loop(
        cond_until(B // 2), body,
        (jnp.int32(0), apri0, done0, bits0, pass0))

    arrs = (ls, lp1, lp2, tail_x1, tail_z1, tail_x2, tail_z2)

    def sub_phase(state, sub_size, stop_count):
        """Gather the unfinished rows into a sub_size batch, run until
        <= stop_count remain, scatter results back full-size."""
        h, ext, done, bits, pas = state
        idx = jnp.argsort(done)[:sub_size]  # unfinished first (stable)
        sub = tuple(a[idx] for a in arrs)
        s_body, s_cond = make_phase(*sub)
        st = (h, ext[idx], done[idx], bits[idx], pas[idx])
        s_h, s_ext, s_done, s_bits, s_pass = jax.lax.while_loop(
            s_cond(stop_count), s_body, st)
        return (s_h, ext.at[idx].set(s_ext), done.at[idx].set(s_done),
                bits.at[idx].set(s_bits), pas.at[idx].set(s_pass))

    # two stages: a B/8 stage adds dispatch and compile cost without
    # beating B/4's MAP width at the straggler tail
    sizes = [s for s in (B // 2, B // 4) if s >= 2]

    def cascade(state, i):
        """Run stage i, then fall through to narrower stages as the
        straggler count keeps shrinking."""
        stop = sizes[i + 1] if i + 1 < len(sizes) else 0
        state = sub_phase(state, sizes[i], stop)
        if i + 1 < len(sizes):
            state = jax.lax.cond(jnp.any(~state[2]),
                                 lambda s: cascade(s, i + 1),
                                 lambda s: s, state)
        return state

    def entry(state, i):
        """Enter at the NARROWEST stage that still fits the stragglers —
        the high-SNR path (1-2 trailing rows) skips straight to the B/8
        batch and pays minimal compaction HBM traffic."""
        if i + 1 >= len(sizes):
            return cascade(state, i)
        return jax.lax.cond(jnp.sum(~state[2]) > sizes[i + 1],
                            lambda s: cascade(s, i),
                            lambda s: entry(s, i + 1), state)

    state = (h, ext, done, bits_out, pass_out)
    h, _, done, bits_out, pass_out = jax.lax.cond(
        jnp.any(~done), lambda s: entry(s, 0), lambda s: s, state)
    return bits_out, pass_out & valid, (h + 1) // 2
