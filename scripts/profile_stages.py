"""Stage-level profiling of the 20 MHz PDSCH bench config.

Times each pipeline stage separately (device-resident inputs, N iters, one
readback) so optimization effort goes where the milliseconds are.
Usage: python scripts/profile_stages.py [batch] [iters]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _force(out):
    import jax

    jax.block_until_ready(out)


def timeit(name, fn, *args, iters=20):
    out = fn(*args)
    _force(out)
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args)
    _force(out)
    dt = (time.time() - t0) / iters * 1e3
    print(f"{name:34s} {dt:8.2f} ms/iter", flush=True)
    return out, dt


def main():
    import jax
    import jax.numpy as jnp

    from srslte_emane_tpu.utils import compile_cache

    compile_cache.enable()

    from srslte_emane_tpu.models import pdsch_link
    from srslte_emane_tpu.ops import channel, modem, ofdm, scrambling
    from srslte_emane_tpu.ops.fec import rm_turbo, turbodecoder
    from srslte_emane_tpu.phch import chest, grid as grid_mod, pdsch, sch

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 20

    cfg = pdsch_link.LinkConfig(
        cell=grid_mod.CellConfig(n_prb=100, cell_id=1, cfi=1),
        qm=6, code_rate=0.55, snr_db=20.0, sf_idx=1)
    scfg = cfg.sch_cfg
    s = scfg.segm
    print(f"# batch={batch} tbs={cfg.tbs} G={cfg.G} C={s.C} "
          f"cb_sizes={sorted(set(s.cb_sizes))} e={sorted(set(scfg.e_sizes))}")

    rng = np.random.default_rng(0)
    payload = jax.device_put(
        rng.integers(0, 2, size=(batch, cfg.tbs), dtype=np.int8))
    key = jax.random.PRNGKey(0)

    # ---- TX stages ----
    enc_tb = jax.jit(lambda p: sch.encode_tb(p, scfg))
    cw, t_enc_tb = timeit("tx: sch.encode_tb", enc_tb, payload, iters=iters)

    re_idx = grid_mod.pdsch_re_indices(cfg.cell, cfg.sf_idx, cfg.prb_mask)
    c_init = scrambling.pdsch_cinit(cfg.rnti, 0, cfg.sf_idx, cfg.cell.cell_id)

    def mod_map(cw):
        scr = scrambling.scramble_bits(cw, c_init)
        syms = modem.modulate(scr, modem.MOD_FROM_QM[scfg.Qm])
        from srslte_emane_tpu.ops import cplx
        grid = cplx.zeros((cw.shape[0], cfg.cell.n_sym, cfg.cell.nre))
        flat = grid.reshape(cw.shape[0], cfg.cell.n_sym * cfg.cell.nre, 2)
        flat = flat.at[:, jnp.asarray(re_idx), :].set(syms)
        grid = flat.reshape(cw.shape[0], cfg.cell.n_sym, cfg.cell.nre, 2)
        return pdsch.put_crs(grid, cfg.cell, cfg.sf_idx)

    g, t_mm = timeit("tx: scramble+mod+REmap+CRS", jax.jit(mod_map), cw,
                     iters=iters)
    tx, t_ofdm = timeit("tx: ofdm.modulate", jax.jit(
        lambda g: ofdm.modulate(g, cfg.cell.n_prb)), g, iters=iters)
    _, t_tx = timeit("tx: full tx_subframe", jax.jit(
        lambda p: pdsch_link.tx_subframe(p, cfg)), payload, iters=iters)

    # ---- channel ----
    rx = jax.device_put(np.asarray(channel.awgn(key, tx, cfg.snr_db)))

    # ---- RX stages ----
    rxg, t_dem = timeit("rx: ofdm.demodulate", jax.jit(
        lambda s_: ofdm.demodulate(s_, cfg.cell.n_prb)), rx, iters=iters)

    def frontend(rx_grid):
        ch = chest.estimate(rx_grid, cfg.cell, cfg.sf_idx)
        flat_rx = rx_grid.reshape(
            rx_grid.shape[:-3] + (cfg.cell.n_sym * cfg.cell.nre, 2))
        flat_ce = ch.ce.reshape(flat_rx.shape)
        y = jnp.take(flat_rx, jnp.asarray(re_idx), axis=-2)
        h = jnp.take(flat_ce, jnp.asarray(re_idx), axis=-2)
        x_eq, csi = chest.equalize_zf(y, h)
        llr = modem.demod_soft(x_eq, modem.MOD_FROM_QM[scfg.Qm])
        llr = llr * jnp.repeat(csi, scfg.Qm, axis=-1)
        return scrambling.scramble_llrs(llr, c_init)

    llrs, t_fe = timeit("rx: chest+eq+demod+descr", jax.jit(frontend), rxg,
                        iters=iters)

    # de-rate-match (all CB groups)
    def derm(llrs):
        offs = np.concatenate([[0], np.cumsum(scfg.e_sizes)])
        out = []
        softbuf = sch.init_softbuffer(batch, scfg)
        for (kr, f, e), rs in sch._groups(scfg).items():
            e_llr = jnp.concatenate(
                [llrs[:, offs[r]: offs[r + 1]] for r in rs], axis=0)
            wbuf = jnp.concatenate([softbuf[r] for r in rs], axis=0)
            wbuf = rm_turbo.rate_unmatch_rx(e_llr, wbuf, kr, f, e, 0, 0)
            out.append(rm_turbo.wbuf_to_d_llrs(wbuf, kr, f))
        return out

    dl, t_derm = timeit("rx: de-rate-match", jax.jit(derm), llrs, iters=iters)

    # turbo decode: fixed 1 iteration (crc=None -> runs max_iter) and early-stop
    (l0, l1, l2) = dl[0]
    kr = sorted(sch._groups(scfg).keys())[0][0]
    nB = l0.shape[0]
    valid = jnp.ones((nB,), bool)
    for n_it in (1, 2, 8):
        _, t = timeit(
            f"rx: turbo fixed {n_it} iter (C={nB//batch}cb)",
            jax.jit(lambda a, b, c_, v, n=n_it: turbodecoder.turbo_decode(
                a, b, c_, v, kr, n, None)),
            l0, l1, l2, valid, iters=max(4, iters // (2 * n_it)))
    _, t_td = timeit(
        "rx: turbo early-stop max8",
        jax.jit(lambda a, b, c_, v: turbodecoder.turbo_decode(
            a, b, c_, v, kr, 8, __import__(
                "srslte_emane_tpu.ops.fec.crc", fromlist=["crc"]).LTE_CRC24B)),
        l0, l1, l2, valid, iters=iters)

    _, t_rx = timeit("rx: full rx_subframe", jax.jit(
        lambda s_: pdsch_link.rx_subframe(s_, cfg)[:2]),
        rx, iters=iters)

    print(f"# decode {batch * 1000.0 / t_rx:.0f} sf/s   "
          f"encode {batch * 1000.0 / t_tx:.0f} sf/s")


if __name__ == "__main__":
    main()
