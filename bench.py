"""Benchmark of record: 20 MHz downlink PDSCH subframes/sec/chip.

Baseline (BASELINE.md): real time = 1000 subframes/s; the reference sustains
exactly real time on an x86 host with 3 PHY worker threads (75 Mbps SISO
20 MHz).  vs_baseline = measured sf/s / 1000 (x real time per chip).

Measures the full UE-side receive chain (OFDM demod -> channel estimation ->
ZF equalize -> soft demod -> descramble -> de-rate-match -> turbo decode with
CRC early stop) on batched subframes, plus reports eNB encode and turbo
throughput as secondary metrics on stderr.
"""

import json
import sys
import time

import numpy as np


def _cache_entries(path):
    import os

    try:
        return len(os.listdir(path))
    except OSError:
        return 0


def main():
    import jax

    from srslte_emane_tpu.utils import compile_cache

    # persistent compile cache: repeat runs skip the full decode graph's
    # compile
    cache_dir = compile_cache.enable()
    cache_before = _cache_entries(cache_dir)

    dev = jax.devices()[0]
    print(json.dumps({"platform": dev.platform, "device_kind": dev.device_kind,
                      "device_count": len(jax.devices())}), flush=True)
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform}")

    from srslte_emane_tpu.models import pdsch_link
    from srslte_emane_tpu.phch import grid as grid_mod

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    llr_bits = int(sys.argv[4]) if len(sys.argv) > 4 else 16  # A/B knob

    # 20 MHz SISO 64QAM, rate ~0.55 -> ~36 Mbps-class TB per subframe
    cfg = pdsch_link.LinkConfig(
        cell=grid_mod.CellConfig(n_prb=100, cell_id=1, cfi=1),
        qm=6,
        code_rate=0.55,
        snr_db=20.0,
        sf_idx=1,
        # the reference's default decoder width (SRSLTE_TDEC_16BIT)
        llr_bits=llr_bits,
    )
    rng = np.random.default_rng(0)
    # device-resident input: a host numpy arg would re-upload ~6 MB per
    # iteration and measure transfer, not compute
    payload = jax.device_put(
        rng.integers(0, 2, size=(batch, cfg.tbs), dtype=np.int8))
    jax.block_until_ready(payload)

    tx_fn = jax.jit(lambda p: pdsch_link.tx_subframe(p, cfg))

    from srslte_emane_tpu.ops import channel

    key = jax.random.PRNGKey(0)
    tx = tx_fn(payload)
    rx_samples = channel.awgn(key, tx, cfg.snr_db)

    rx_fn = jax.jit(lambda s: pdsch_link.rx_subframe(s, cfg)[:2])
    t0 = time.time()
    out, ok = rx_fn(rx_samples)
    jax.block_until_ready(out)
    compile_s = time.time() - t0
    ok_h = np.asarray(ok)
    assert ok_h.all(), f"decode failed at bench SNR: {ok_h}"
    assert (np.asarray(out) == payload).all()

    # cache state of THIS run's compile: a miss writes new entries into the
    # persistent dir.  Recording it makes run-to-run deltas attributable
    # (a cold cache both slows the compile and perturbs the first timings).
    cache_after = _cache_entries(cache_dir)
    assert cache_after > 0, "persistent compile cache dir unused"
    cache_state = "warm" if cache_after == cache_before else "cold"

    # timed decode loop, MEDIAN of n_runs independent runs.  Device
    # execution is sequential, so one forced host readback of the LAST
    # iteration's output proves all N completed — that is steady-state
    # throughput (per-iteration readbacks would measure latency).  The
    # median + spread says whether a delta is signal or noise.
    n_runs = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    rates = []
    for _ in range(n_runs):
        t0 = time.time()
        for _ in range(iters):
            out, ok = rx_fn(rx_samples)
        ok_h = np.asarray(ok)
        dt = time.time() - t0
        assert ok_h.all()
        rates.append(batch * iters / dt)
    sf_per_s = float(np.median(rates))
    spread_pct = 100.0 * (max(rates) - min(rates)) / sf_per_s

    # secondary: encode throughput.  The timing variant reduces the waveform
    # to a scalar ON DEVICE: returning the full (B, 30720, 2) waveform makes
    # the loop measure the ~31 MB/iter readback instead of compute.  The
    # scalar readback of the last iteration still forces the whole in-order
    # queue, same as the decode loop's `ok`.
    import jax.numpy as jnp

    txs_fn = jax.jit(
        lambda p: jnp.sum(jnp.abs(pdsch_link.tx_subframe(p, cfg))))
    s = txs_fn(payload)
    assert np.isfinite(float(s)) and float(s) > 0.0
    t0 = time.time()
    for _ in range(iters):
        s = txs_fn(payload)
    float(s)
    enc_sf_per_s = batch * iters / (time.time() - t0)

    mbps = sf_per_s * cfg.tbs / 1e6
    print(
        f"# compile={compile_s:.1f}s ({cache_state} cache) "
        f"decode={sf_per_s:.1f} sf/s median of {n_runs} "
        f"(spread {spread_pct:.1f}%: {[round(r) for r in rates]}) "
        f"({mbps:.1f} Mb/s payload) encode={enc_sf_per_s:.1f} sf/s "
        f"tbs={cfg.tbs} batch={batch} device={jax.devices()[0].device_kind}",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": "pdsch_20mhz_decode_subframes_per_sec_per_chip",
                "value": round(sf_per_s, 2),
                "unit": "subframes/s",
                "vs_baseline": round(sf_per_s / 1000.0, 3),
                "median_of": n_runs,
                "spread_pct": round(spread_pct, 2),
                "cache_state": cache_state,
                "compile_s": round(compile_s, 1),
            }
        )
    )


if __name__ == "__main__":
    main()
