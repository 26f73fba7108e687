"""Benchmark of the device-resident waveform network steady state.

Measures runtime/waveblock.py — T TTIs x n_ues of the FULL PHY both
directions (eNB PDSCH encode -> AWGN -> UE chest/decode -> PUCCH ACK +
SPS PUSCH -> superpose -> eNB chest/decode + ACK matched filter) as ONE
compiled program per block, with the host out of the per-TTI loop.
This is the `netsim --waveform-block` steady state on the chip: the
number the reference's sf_worker pipeline would produce is 1000 TTIs/s
(real time) on an x86 host.

Prints one JSON line:
  {"metric": "waveform_block[_tm3]_ttis_per_sec", "value": ..., ...}

A 6th arg "tm3" switches the downlink to TM3 large-delay-CDD 2x2
spatial multiplexing (two codewords per TTI x UE through per-UE 2x2
channels, per-port CRS chest + closed-form ZF on device): the DL
payload doubles per allocation.

Usage: python scripts/bench_waveblock.py [n_prb] [n_ues] [T] [iters] [runs] [tm3]
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

    from srslte_emane_tpu.phch import grid as grid_mod, pdcch, pusch
    from srslte_emane_tpu.runtime import waveblock

    n_prb = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    n_ues = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    T = int(sys.argv[3]) if len(sys.argv) > 3 else 20
    iters = int(sys.argv[4]) if len(sys.argv) > 4 else 10
    n_runs = int(sys.argv[5]) if len(sys.argv) > 5 else 3
    tm3 = len(sys.argv) > 6 and sys.argv[6] == "tm3"

    cell = grid_mod.CellConfig(n_prb=n_prb, cell_id=1, cfi=1,
                               n_ports=2 if tm3 else 1)
    n_cce = pdcch.n_cce(cell)
    c0, c1 = waveblock.centre_prbs(n_prb)
    dl_starts, dl_w = waveblock._pack_segments(
        n_prb, n_ues, [(0, c0), (c1, n_prb)])
    ul_w = max(1, (n_prb - 2) // n_ues)
    while ul_w > 1 and not pusch.valid_n_prb(ul_w):
        ul_w -= 1
    cfg = waveblock.BlockConfig(
        cell=cell, rntis=tuple(70 + i for i in range(n_ues)),
        dl_rb_start=dl_starts, dl_l_crbs=dl_w,
        dl_mcs=20,  # 64QAM-class steady-state link adaptation point
        ul_rb_start=tuple(1 + ul_w * i for i in range(n_ues)),
        ul_l_prb=ul_w, ul_mcs=20,
        ack_res=tuple(n_cce + i for i in range(n_ues)),
        snr_db=(30.0,) * n_ues, T=T,
        llr_bits=16, tm3=tm3)
    bench = waveblock.make_bench_step(cfg, sfn0=4)

    rng = np.random.default_rng(0)
    n_cw = 2 if tm3 else 1
    dl_shape = ((T, n_ues, 2, cfg.dl_tbs) if tm3
                else (T, n_ues, cfg.dl_tbs))
    dl = jax.device_put(rng.integers(0, 2, dl_shape, dtype=np.int8))
    ul = jax.device_put(rng.integers(
        0, 2, (T, n_ues, cfg.ul_tbs), dtype=np.int8))
    key = jax.random.PRNGKey(0)
    tti0 = jnp.asarray(0, jnp.int32)

    t0 = time.time()
    d_ok, u_ok, a_ok = bench(dl, ul, key, tti0)
    jax.block_until_ready(d_ok)
    compile_s = time.time() - t0
    assert int(d_ok) == T * n_ues * n_cw, \
        f"DL CRCs failed: {int(d_ok)}/{T*n_ues*n_cw}"
    assert int(u_ok) == T * n_ues, f"UL CRCs failed: {int(u_ok)}/{T*n_ues}"
    assert int(a_ok) == T * n_ues, f"ACKs missing: {int(a_ok)}/{T*n_ues}"

    rates = []
    for _ in range(n_runs):
        t0 = time.time()
        for _ in range(iters):
            d_ok, u_ok, a_ok = bench(dl, ul, key, tti0)
        jax.block_until_ready(d_ok)
        dt = time.time() - t0
        rates.append(T * iters / dt)
    ttis_s = float(np.median(rates))
    spread = 100.0 * (max(rates) - min(rates)) / ttis_s
    dl_mbps = ttis_s * n_ues * n_cw * cfg.dl_tbs / 1e6
    ul_mbps = ttis_s * n_ues * cfg.ul_tbs / 1e6
    print(
        f"# waveform-block {n_prb} PRB x {n_ues} UEs, T={T}"
        f"{' TM3 2x2' if tm3 else ''}: "
        f"compile={compile_s:.1f}s {ttis_s:.0f} TTIs/s "
        f"(spread {spread:.1f}%) = {ttis_s/1000.0:.1f}x real time; "
        f"cell DL {dl_mbps:.0f} Mb/s + UL {ul_mbps:.0f} Mb/s "
        f"device={jax.devices()[0].device_kind}",
        file=sys.stderr)
    print(json.dumps({
        "metric": ("waveform_block_tm3_ttis_per_sec" if tm3 else
                   "waveform_block_ttis_per_sec"),
        "value": round(ttis_s, 1),
        "unit": "TTIs/s",
        "vs_baseline": round(ttis_s / 1000.0, 3),
        "n_prb": n_prb, "n_ues": n_ues, "block_ttis": T,
        "dl_mbps": round(dl_mbps, 1), "ul_mbps": round(ul_mbps, 1),
        "median_of": n_runs, "spread_pct": round(spread, 2),
        "compile_s": round(compile_s, 1),
        "device": jax.devices()[0].device_kind,
    }))


if __name__ == "__main__":
    main()
