"""Stage-level profiling of the 2x2 MIMO TM3 decode path.

Times estimate_mimo / effective-channel+ZF / demod+descramble / turbo decode
separately, plus the full decode_tm, at several batch sizes, so the TM3
optimization effort goes where the milliseconds are (VERDICT weak #3).
Usage: python scripts/profile_mimo.py [batch] [iters]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _force(out):
    import jax

    leaf = jax.tree_util.tree_leaves(out)[0]
    np.asarray(leaf.reshape(-1)[:1])


def timeit(name, fn, *args, iters=20):
    out = fn(*args)
    _force(out)
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args)
    _force(out)
    dt = (time.time() - t0) / iters * 1e3
    print(f"{name:40s} {dt:8.2f} ms/iter", flush=True)
    return out, dt


def main():
    import jax
    import jax.numpy as jnp

    from srslte_emane_tpu.utils import compile_cache

    compile_cache.enable()

    from srslte_emane_tpu.ops import channel, cplx, mimo, modem, ofdm, scrambling
    from srslte_emane_tpu.phch import grid as grid_mod, pdsch, sch

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 20

    rng = np.random.default_rng(0)
    cell2 = grid_mod.CellConfig(n_prb=100, cell_id=7, n_ports=2, cfi=1)
    prb_mask = (1,) * 100
    n_re = grid_mod.nof_re(cell2, 1, prb_mask)
    qm = 6
    cfgs = [sch.SchConfig(tbs=(int(n_re * qm * 0.5) - 24) // 8 * 8,
                          G=n_re * qm, Qm=qm, Nl=1) for _ in range(2)]
    s = cfgs[0].segm
    print(f"# batch={batch} tbs={cfgs[0].tbs} G={cfgs[0].G} C={s.C} "
          f"n_re={n_re}")
    tbs_list = [rng.integers(0, 2, (batch, c.tbs), dtype=np.int8) for c in cfgs]
    enc = jax.jit(lambda a, b: ofdm.modulate(
        pdsch.encode_tm([a, b], cfgs, cell2, 1, 0x46, prb_mask, "tm3"), 100))
    tx2 = enc(*tbs_list)
    h = (rng.normal(size=(batch, 2, 2))
         + 1j * rng.normal(size=(batch, 2, 2))).astype(np.complex64)
    h = h + 3.5 * np.eye(2)[None]
    rx2 = channel.mimo_flat(jax.random.PRNGKey(2), tx2, cplx.from_numpy(h), 30.0)
    rg2 = jax.device_put(np.asarray(jax.jit(
        lambda s_: ofdm.demodulate(s_, 100))(rx2)))

    sf_idx, rnti = 1, 0x46
    re_idx = grid_mod.pdsch_re_indices(cell2, sf_idx, prb_mask)

    # ---- stage 1: MIMO channel estimation ----
    est = jax.jit(lambda g: pdsch.estimate_mimo(g, cell2, sf_idx, 2))
    (ce, noise), t_est = timeit("estimate_mimo", est, rg2, iters=iters)

    # ---- stage 2: take + effective channel + ZF + layer demap ----
    def front(rx_grids, ce):
        take = lambda a: jnp.take(
            a.reshape(a.shape[:-3] + (cell2.n_sym * cell2.nre, 2)),
            jnp.asarray(re_idx), axis=-2)
        y = take(rx_grids)
        hh = take(ce)
        m = len(re_idx)
        u = np.array([[1, 1], [1, -1]], dtype=np.complex64) / np.sqrt(2)
        base = (np.eye(2) / np.sqrt(2)).astype(np.complex64)
        w0 = base @ np.diag([1.0, 1.0]).astype(np.complex64) @ u
        w1 = base @ np.diag([1.0, -1.0]).astype(np.complex64) @ u
        w_eff = np.where((np.arange(m) % 2 == 0)[:, None, None],
                         w0[None], w1[None]).astype(np.complex64)
        wr = jnp.asarray(w_eff.real.astype(np.float32))
        wi = jnp.asarray(w_eff.imag.astype(np.float32))
        hr, hi = hh[..., 0], hh[..., 1]
        heff_r = jnp.einsum("brtm,mtl->brlm", hr, wr) - jnp.einsum("brtm,mtl->brlm", hi, wi)
        heff_i = jnp.einsum("brtm,mtl->brlm", hr, wi) + jnp.einsum("brtm,mtl->brlm", hi, wr)
        heff = jnp.stack([heff_r, heff_i], axis=-1)
        x, csi = mimo.decode_zf2(y, heff, noise=None)
        return mimo.layer_demap(x, 2), [csi[..., 0, :], csi[..., 1, :]]

    (streams, csis), t_fr = timeit("take+heff+zf2+demap", jax.jit(front),
                                   rg2, ce, iters=iters)

    # ---- stage 3: demod + descramble (both codewords) ----
    def dem(streams, csis):
        out = []
        for q in range(2):
            llr = modem.demod_soft(streams[q], modem.MOD_FROM_QM[qm])
            llr = llr * jnp.repeat(csis[q], qm, axis=-1)
            c_init = scrambling.pdsch_cinit(rnti, q, sf_idx, cell2.cell_id)
            out.append(scrambling.scramble_llrs(llr, c_init))
        return out

    llrs2, t_dem = timeit("demod+csi+descramble x2", jax.jit(dem),
                          streams, csis, iters=iters)

    # ---- stage 4a: turbo decode, one call per codeword (current) ----
    def dec_sep(llrs2):
        res = []
        for q in range(2):
            p, ok, sb, _ = sch.decode_tb(llrs2[q], cfgs[q], None, 8)
            res.append((p, ok))
        return res

    _, t_sep = timeit("decode_tb x2 (separate)", jax.jit(dec_sep),
                      llrs2, iters=iters)

    # ---- stage 4b: turbo decode, codewords merged into one call ----
    def dec_merged(llrs2):
        stacked = jnp.concatenate(llrs2, axis=0)  # (2B, G)
        p, ok, sb, _ = sch.decode_tb(stacked, cfgs[0], None, 8)
        return p, ok

    _, t_mrg = timeit("decode_tb (merged 2B)", jax.jit(dec_merged),
                      llrs2, iters=iters)

    # ---- full path (current decode_tm) ----
    dec_full = jax.jit(lambda g: pdsch.decode_tm(
        g, cfgs, cell2, sf_idx, rnti, prb_mask, "tm3")[:2])
    out, t_full = timeit("decode_tm full", dec_full, rg2, iters=iters)
    oks = [np.asarray(x) for x in out[1]]
    assert all(o.all() for o in oks), "CRC failed"
    total_bits = sum(c.tbs for c in cfgs)
    print(f"# full: {batch / (t_full / 1e3):.0f} sf/s, "
          f"{batch * total_bits / (t_full / 1e3) / 1e6:.0f} Mb/s")
    print(f"# stage sum: {t_est + t_fr + t_dem + t_sep:.2f} ms "
          f"(vs full {t_full:.2f})")


if __name__ == "__main__":
    main()
