"""Turbo max-log-MAP half-iteration as one GPU kernel (Pallas, Triton route).

Drop-in for `turbodecoder._map_decode`, same windows, same halo and the
same exact trellis edges (reference: `lib/src/phy/fec/turbodecoder_win.h`,
SIMD windows with a 40-step halo).  The plain version is four `lax.scan`s
whose every step is a tiny (B*W, 8) update; on a GPU each step costs a
launch.  Here one program owns a block of independent (window, code block)
columns and walks its whole window in a loop:

  * columns are ordered window-major (n = w * Bp + b), so a block sits in
    one window and every per-step load is one contiguous row of a
    time-major (K + 2H, Bp) array: no halo gather, coalesced loads;
  * the 8 state metrics are 8 block-wide register vectors; the trellis
    permutation is variable renaming;
  * backward: halo warm-up, exact beta_K on the last window, then the
    window walk storing beta at every other node to a device-memory
    buffer (the kernel's second output);
  * forward: halo warm-up, exact alpha_0 on the first window, then the
    window walk with the posterior-LLR combine fused in; the beta of the
    nodes not stored is rebuilt by one backward step from the next node;
  * two trellis steps per loop trip, metrics renormalized after each pair
    (turbodecoder_win.h normalizes every 2 steps); odd lengths finish
    with one single step.

LLR convention as in turbodecoder.py: positive <=> bit 0.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .turbodecoder import HALO, NEG, _pick_windows, _trellis

BLOCK_MAX = 128  # columns per program: one column per thread at 4 warps
BLOCK_MIN = 32


@functools.lru_cache(maxsize=None)
def _tables():
    T = _trellis()
    ns, pz = T["next_state"], T["parity"]
    ps, pu = T["prev_state"], T["prev_u"]
    return dict(
        ns=ns.tolist(), ps=ps.tolist(), pu=pu.tolist(),
        # gamma combo index (u*2 + z) per transition
        cf=(pu * 2 + pz[ps, pu]).tolist(),  # into s from ps[s, j]
        cb=(np.arange(2)[None, :] * 2 + pz).tolist(),  # out of s with input u
    )


def block_size(batch: int) -> int:
    """Columns per program: the batch rounded up to a power of two,
    clamped to [BLOCK_MIN, BLOCK_MAX]."""
    return int(min(BLOCK_MAX, max(BLOCK_MIN, pl.next_power_of_2(batch))))


def _norm(m):
    top = functools.reduce(jnp.maximum, m)
    return tuple(x - top for x in m)


def _walk(n, pair, single, carry):
    """n steps as n // 2 loop trips of `pair`, then one `single` if odd."""
    carry = jax.lax.fori_loop(0, n // 2, pair, carry)
    if n % 2:
        carry = single(n - 1, carry)
    return carry


def _map_kernel(ls_ref, lp_ref, btail_ref, llr_ref, beta_ref, *, W, L, H,
                block):
    S = (L + 1) // 2  # beta slots per window
    t = _tables()
    ns, ps, pu, cf, cb = t["ns"], t["ps"], t["pu"], t["cf"], t["cb"]
    w = pl.program_id(0)
    cols = pl.ds(pl.program_id(1) * block, block)
    row0 = w * L  # extended step e of window w is row row0 + e

    def g4(e):
        # inputs arrive pre-halved: the (u, z) combos are a, b, -b, -a
        ls = ls_ref[row0 + e, cols]
        lp = lp_ref[row0 + e, cols]
        a, b = ls + lp, ls - lp
        return (a, b, -b, -a)

    def bwd(beta, g):
        return tuple(jnp.maximum(beta[ns[s][0]] + g[cb[s][0]],
                                 beta[ns[s][1]] + g[cb[s][1]])
                     for s in range(8))

    def fwd(alpha, g):
        return tuple(jnp.maximum(alpha[ps[s][0]] + g[cf[s][0]],
                                 alpha[ps[s][1]] + g[cf[s][1]])
                     for s in range(8))

    def store(tt, beta):
        for s in range(8):
            beta_ref[w * S + tt // 2, s, cols] = beta[s]

    def load(tt):
        return tuple(beta_ref[w * S + tt // 2, s, cols] for s in range(8))

    zeros = (jnp.zeros((block,), jnp.float32),) * 8

    # ---- backward halo [H+L, 2H+L), walked in reverse from uniform ----
    top = 2 * H + L - 1
    beta = _walk(
        H,
        lambda i, b: _norm(bwd(bwd(b, g4(top - 2 * i)),
                               g4(top - 2 * i - 1))),
        lambda i, b: bwd(b, g4(top - i)),
        zeros)
    last = w == W - 1
    beta = _norm(tuple(jnp.where(last, btail_ref[s, cols], beta[s])
                       for s in range(8)))

    # ---- backward window walk ----
    # The buffer keeps the metrics of node tt + 1 only for odd tt (and
    # tt = L - 1), in slot tt // 2 of the window's S: the forward pass
    # rebuilds node 2i + 1 from node 2i + 2 with one step it has the
    # inputs for, which halves the buffer, the kernel's largest traffic.
    # (For even L the walk stops at node 2: node 1 is rebuilt, node 0 is
    # not needed.)
    store(L - 1, beta)

    def bwd_pair(i, beta):
        tt = L - 1 - 2 * i
        beta = bwd(beta, g4(H + tt))  # node tt
        if L % 2:  # tt is even, tt - 1 odd
            store(tt - 1, beta)
        beta = _norm(bwd(beta, g4(H + tt - 1)))  # node tt - 1
        if L % 2 == 0:  # tt - 2 is odd
            store(tt - 2, beta)
        return beta

    jax.lax.fori_loop(0, L // 2 - (1 - L % 2), bwd_pair, beta)

    # ---- forward halo [0, H) from uniform ----
    alpha = _walk(
        H,
        lambda i, a: _norm(fwd(fwd(a, g4(2 * i)), g4(2 * i + 1))),
        lambda i, a: fwd(a, g4(i)),
        zeros)
    first = w == 0
    alpha = _norm(tuple(jnp.where(first, 0.0 if s == 0 else NEG, alpha[s])
                        for s in range(8)))

    # ---- forward window walk with the posterior combine fused ----
    def emit(tt, alpha, g, bn):
        # t_su = alpha[s] + gamma(s, u) is shared by the combine and the
        # alpha recursion
        tsu = [[alpha[s] + g[cb[s][u]] for u in range(2)] for s in range(8)]
        m = [functools.reduce(jnp.maximum,
                              [tsu[s][u] + bn[ns[s][u]] for s in range(8)])
             for u in range(2)]
        llr_ref[row0 + tt, cols] = m[0] - m[1]
        return tuple(jnp.maximum(tsu[ps[s][0]][pu[s][0]],
                                 tsu[ps[s][1]][pu[s][1]])
                     for s in range(8))

    def fwd_pair(i, alpha):
        tt = 2 * i
        g0, g1 = g4(H + tt), g4(H + tt + 1)
        b2 = load(tt + 1)  # node tt + 2
        alpha = emit(tt, alpha, g0, bwd(b2, g1))  # node tt + 1, rebuilt
        return _norm(emit(tt + 1, alpha, g1, b2))

    alpha = jax.lax.fori_loop(0, L // 2, fwd_pair, alpha)
    if L % 2:
        emit(L - 1, alpha, g4(H + L - 1), load(L - 1))


def map_decode_gpu(ls_eff, lp, tail_x, tail_z, *, interpret: bool = False):
    """One max-log-MAP pass on the GPU; the signature of `_map_decode`.

    ls_eff/lp: (B, K) systematic+apriori and parity LLRs; tail_x/tail_z:
    (B, 3).  Returns posterior LLRs (B, K)."""
    B, K = ls_eff.shape
    W = _pick_windows(K)
    L = K // W
    H = min(HALO, L)
    block = block_size(B)
    Bp = -(-B // block) * block

    def time_major(x):
        # pre-halve (exact: power-of-two scale) so the kernel's branch
        # metrics are plain add/sub; H zero rows on each side are the
        # zero gammas the edge halos see
        return jnp.pad((0.5 * x.astype(jnp.float32)).T,
                       ((H, H), (0, Bp - B)))

    # exact beta_K from the tail-bit path metrics, (8, B); an elementwise
    # +-1 product and sum, so no f32 dot runs at reduced (TF32) precision
    tails = jnp.stack(
        [tail_x[:, 0], tail_z[:, 0], tail_x[:, 1], tail_z[:, 1],
         tail_x[:, 2], tail_z[:, 2]], axis=-1).astype(jnp.float32)
    signs = jnp.asarray(_trellis()["tail_signs"])
    beta_tail = 0.5 * jnp.sum(signs[:, None, :] * tails[None], axis=-1)
    beta_tail = jnp.pad(beta_tail, ((0, 0), (0, Bp - B)))

    llr, _ = pl.pallas_call(
        functools.partial(_map_kernel, W=W, L=L, H=H, block=block),
        out_shape=(jax.ShapeDtypeStruct((K, Bp), jnp.float32),
                   jax.ShapeDtypeStruct((W * ((L + 1) // 2), 8, Bp),
                                        jnp.float32)),
        grid=(W, Bp // block),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, block // 32), num_stages=1),
        interpret=interpret,
        name="turbo_map",
    )(time_major(ls_eff), time_major(lp), beta_tail)
    return llr[:, :B].T
