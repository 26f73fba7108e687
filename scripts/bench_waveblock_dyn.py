"""Benchmark of the DYNAMIC device-resident waveform block.

Measures runtime/waveblock_dyn.py — R rounds x 8 TTIs x n_ues of the
FULL dynamic PHY loop as ONE compiled program: per-TTI PDCCH DCI
(conv-coded, CRC16^RNTI, true search-space CCEs), UE-side blind decode,
PDSCH/PUSCH with live 8-process IR-HARQ soft buffers, PUCCH HARQ-ACK +
PHICH over the air.  This is the semantic superset of
bench_waveblock.py's SPS steady state; the reference's sf_worker
pipeline produces 1000 TTIs/s (real time) on an x86 host.

Prints one JSON line:
  {"metric": "waveform_dyn_block_ttis_per_sec", "value": ..., ...}

With cells > 1 the block is vmapped over that many INDEPENDENT cells
(the emulation's many-eNB scenario) — each with its own payloads,
schedule, channel and HARQ state — and the reported TTIs/s is the
aggregate across cells (cells x T x iters / wall).  The per-cell rate
is aggregate / cells; n_cells=1 is the single-cell number.

Usage: python scripts/bench_waveblock_dyn.py [n_ues] [R] [iters] [runs] [cells]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax

    from srslte_emane_tpu.utils import compile_cache

    compile_cache.enable()

    import jax.numpy as jnp

    from srslte_emane_tpu.phch import grid as grid_mod
    from srslte_emane_tpu.runtime import waveblock_dyn as wbd

    n_ues = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    R = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    iters = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    n_runs = int(sys.argv[4]) if len(sys.argv) > 4 else 3
    cells = int(sys.argv[5]) if len(sys.argv) > 5 else 1

    cell = grid_mod.CellConfig(n_prb=100, cell_id=1, cfi=2)
    rntis = wbd.feasible_rntis(cell, n_ues)
    w = {8: 11, 16: 5}.get(n_ues, 94 // n_ues)
    wu = {8: 10, 16: 5}.get(n_ues, 80 // n_ues)
    cfg = wbd.DynBlockConfig(
        cell=cell, rntis=rntis, dl_l_crbs=w,
        dl_mcs=25,  # 64QAM steady-state link-adaptation point
        ul_l_prb=wu, ul_mcs=20,
        snr_db=(30.0,) * n_ues, R=R,
        llr_bits=16)
    bench = wbd.make_bench_step(cfg, n_cells=cells)

    rng = np.random.default_rng(0)
    T = cfg.T

    def put(a):
        return jax.device_put(a if cells > 1 else a[0])

    dl_q = put(rng.integers(
        0, 2, (cells, T, n_ues, cfg.dl_tbs), dtype=np.int8))
    ul_q = put(rng.integers(
        0, 2, (cells, T, n_ues, cfg.ul_tbs), dtype=np.int8))
    scheds = [wbd.make_schedule(cfg, seed=3 + ci) for ci in range(cells)]
    rb_dl = put(np.stack([s[0] for s in scheds]))
    rb_ul = put(np.stack([s[1] for s in scheds]))
    key = (jax.random.split(jax.random.PRNGKey(0), cells)
           if cells > 1 else jax.random.PRNGKey(0))
    tti0 = jnp.asarray(0, jnp.int32)

    t0 = time.time()
    out = bench(dl_q, ul_q, rb_dl, rb_ul, key, tti0)
    jax.block_until_ready(out)
    compile_s = time.time() - t0
    d_ok, u_ok, a_ok, d_rtx, u_rtx, miss = (int(x) for x in out)
    tot = cells * T * n_ues
    assert d_ok == tot, f"DL CRCs failed: {d_ok}/{tot}"
    assert u_ok == tot, f"UL CRCs failed: {u_ok}/{tot}"
    assert a_ok == tot, f"ACKs missing: {a_ok}/{tot}"
    assert miss == 0, f"DCI misses at 30 dB: {miss}"

    rates = []
    for _ in range(n_runs):
        t0 = time.time()
        for _ in range(iters):
            out = bench(dl_q, ul_q, rb_dl, rb_ul, key, tti0)
        jax.block_until_ready(out)
        rates.append(cells * T * iters / (time.time() - t0))
    ttis_s = float(np.median(rates))
    spread = 100.0 * (max(rates) - min(rates)) / ttis_s
    dl_mbps = ttis_s * n_ues * cfg.dl_tbs / 1e6
    ul_mbps = ttis_s * n_ues * cfg.ul_tbs / 1e6
    agg = f" x {cells} cells AGGREGATE" if cells > 1 else ""
    print(
        f"# dyn-block 100 PRB x {n_ues} UEs, T={T}{agg}: "
        f"compile={compile_s:.1f}s "
        f"{ttis_s:.0f} TTIs/s (spread {spread:.1f}%) = "
        f"{ttis_s/1000.0:.1f}x real time; DL {dl_mbps:.0f} Mb/s + "
        f"UL {ul_mbps:.0f} Mb/s; per-TTI DCI x{2*n_ues} blind-decoded, "
        f"8-process IR-HARQ live; device={jax.devices()[0].device_kind}",
        file=sys.stderr)
    print(json.dumps({
        "metric": "waveform_dyn_block_ttis_per_sec",
        "value": round(ttis_s, 1),
        "unit": "TTIs/s" if cells == 1 else "cell-TTIs/s aggregate",
        "vs_baseline": round(ttis_s / 1000.0, 3),
        "n_prb": 100, "n_ues": n_ues, "block_ttis": T, "n_cells": cells,
        "dl_mbps": round(dl_mbps, 1), "ul_mbps": round(ul_mbps, 1),
        "median_of": n_runs, "spread_pct": round(spread, 2),
        "compile_s": round(compile_s, 1),
        "device": jax.devices()[0].device_kind,
    }))


if __name__ == "__main__":
    main()
