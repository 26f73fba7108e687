#!/usr/bin/env python3
"""Secondary benchmarks covering the remaining BASELINE.json configs:
  #3  20 MHz PUSCH uplink (SC-FDMA + 8-iteration turbo decode)
  #4  cell-search sweep (PSS correlation bank + SSS)
  #5  2x2 MIMO TM3 eNB encode + UE decode

Run: python scripts/bench_extra.py [batch].  bench.py remains the
benchmark of record.
"""

import json
import sys
import time

import numpy as np


def main():
    import jax

    sys.path.insert(0, ".")
    from srslte_emane_tpu.models import pdsch_link
    from srslte_emane_tpu.ops import channel, cplx, ofdm
    from srslte_emane_tpu.phch import grid as grid_mod, pdsch, pusch, sch, sync

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    iters = 20
    results = {}

    def timed(name, fn, *args, check=None):
        out = fn(*args)
        jax.block_until_ready(out)
        t0 = time.time()
        for _ in range(iters):
            out = fn(*args)
        np.asarray(jax.tree_util.tree_leaves(out)[0])
        dt = (time.time() - t0) / iters
        results[name] = dt
        if check:
            check(out)
        return dt

    rng = np.random.default_rng(0)

    # --- #4: cell search over batched captures ---
    c6 = grid_mod.CellConfig(n_prb=6, cell_id=301)
    gg = cplx.zeros((batch, 14, 72))
    gg = sync.put_pss_sss(gg, c6, 0)
    gg = pdsch.put_crs(gg, c6, 0)
    tt = channel.awgn(jax.random.PRNGKey(1), ofdm.modulate(gg, 6), 5.0)
    # warm the pss_find subgraph first and keep the input resident
    tt = jax.device_put(jax.block_until_ready(tt))
    jax.block_until_ready(jax.jit(lambda s: sync.pss_find(s))(tt))
    cs = jax.jit(lambda s: sync.cell_search(s))
    dt = timed("cell_search", cs, tt,
               check=lambda o: (np.asarray(o["cell_id"]) == 301).all() or (_ for _ in ()).throw(AssertionError("cs")))
    print(f"# cell search: {batch/dt:.0f} captures/s", file=sys.stderr)

    # --- #5: 2x2 MIMO TM3 20 MHz ---
    cell2 = grid_mod.CellConfig(n_prb=100, cell_id=7, n_ports=2, cfi=1)
    prb_mask = (1,) * 100
    n_re = grid_mod.nof_re(cell2, 1, prb_mask)
    qm = 6
    cfgs = [sch.SchConfig(tbs=(int(n_re * qm * 0.5) - 24) // 8 * 8,
                          G=n_re * qm, Qm=qm, Nl=1) for _ in range(2)]
    tbs_list = [rng.integers(0, 2, (batch, c.tbs), dtype=np.int8) for c in cfgs]
    enc = jax.jit(lambda a, b: ofdm.modulate(
        pdsch.encode_tm([a, b], cfgs, cell2, 1, 0x46, prb_mask, "tm3"), 100))
    tx2 = enc(*tbs_list)
    h = (rng.normal(size=(batch, 2, 2)) + 1j * rng.normal(size=(batch, 2, 2))).astype(np.complex64)
    h = h + 3.5 * np.eye(2)[None]
    rx2 = channel.mimo_flat(jax.random.PRNGKey(2), tx2, cplx.from_numpy(h), 30.0)
    rg2 = jax.jit(lambda s: ofdm.demodulate(s, 100))(rx2)
    dec2 = jax.jit(lambda r: pdsch.decode_tm(r, cfgs, cell2, 1, 0x46, prb_mask,
                                             "tm3", llr_bits=16)[:2])
    dt = timed("mimo_tm3_decode", dec2, rg2,
               check=lambda o: all(np.asarray(x).all() for x in o[1]) or (_ for _ in ()).throw(AssertionError("mimo crc")))
    total_bits = sum(c.tbs for c in cfgs)
    print(f"# MIMO 2x2 TM3 64QAM: {batch/dt:.0f} sf/s ({batch/dt*total_bits/1e6:.0f} Mb/s)", file=sys.stderr)

    # --- #3: 20 MHz PUSCH uplink ---
    cell = grid_mod.CellConfig(n_prb=100, cell_id=1)
    l_prb, qm = 96, 4  # 2^5*3 valid transform size
    G = 12 * l_prb * 12 * qm
    tbs = (int(G * 0.5) - 24) // 8 * 8
    cfg = sch.SchConfig(tbs=tbs, G=G, Qm=qm, Nl=1)
    payload = rng.integers(0, 2, (batch, tbs), dtype=np.int8)
    t = jax.jit(lambda p: ofdm.modulate(
        pusch.encode(p, cfg, cell, 2, 0x5A, 0, l_prb), 100))(payload)
    rx = channel.awgn(jax.random.PRNGKey(0), t, 14.0)
    rg = jax.jit(lambda s: ofdm.demodulate(s, 100))(rx)
    dec = jax.jit(lambda r: pusch.decode(r, cfg, cell, 2, 0x5A, 0, l_prb,
                                         llr_bits=16)[:2])
    dt = timed("pusch_decode", dec, rg,
               check=lambda o: np.asarray(o[1]).all() or (_ for _ in ()).throw(AssertionError("UL crc")))
    print(f"# UL 20MHz 16QAM: {batch/dt:.0f} sf/s ({batch/dt*tbs/1e6:.0f} Mb/s)", file=sys.stderr)

    # --- carrier aggregation: 2x 20 MHz CCs in one compiled module ---
    ca_cfg = pdsch_link.LinkConfig(
        cell=grid_mod.CellConfig(n_prb=100, cell_id=1, cfi=1),
        qm=6, code_rate=0.55, snr_db=20.0, sf_idx=1)
    ca_step = pdsch_link.make_ca_link_step(ca_cfg, n_cc=2)
    ca_payloads = jax.device_put(rng.integers(
        0, 2, size=(2, batch, ca_cfg.tbs), dtype=np.int8))
    ca_key = jax.random.PRNGKey(3)
    dt = timed("ca_2cc_link", lambda p: ca_step(p, ca_key), ca_payloads,
               check=lambda o: np.asarray(o[1]).all() or (_ for _ in ()).throw(
                   AssertionError("ca crc")))
    agg = 2 * batch / dt
    print(f"# CA 2CC 20MHz e2e encode+decode: {agg:.0f} carrier-sf/s "
          f"({agg*ca_cfg.tbs/1e6:.0f} Mb/s aggregate)", file=sys.stderr)

    print(json.dumps({k: round(batch / v, 1) for k, v in results.items()}))


if __name__ == "__main__":
    main()
