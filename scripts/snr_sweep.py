"""BLER / throughput vs SNR for the 20 MHz bench link — the honest
companion to the 20 dB headline: at waterfall SNR the decoder runs many
iterations and throughput drops accordingly.

Usage: python scripts/snr_sweep.py [batch] [iters] [snrs...]
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

    from srslte_emane_tpu.models import pdsch_link
    from srslte_emane_tpu.phch import grid as grid_mod

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    snrs = [float(s) for s in sys.argv[3:]] or [8.0, 9.0, 10.0, 11.0, 12.0,
                                                14.0, 20.0]

    rng = np.random.default_rng(0)
    rows = []
    for snr in snrs:
        cfg = pdsch_link.LinkConfig(
            cell=grid_mod.CellConfig(n_prb=100, cell_id=1, cfi=1),
            qm=6, code_rate=0.55, snr_db=snr, sf_idx=1,
            llr_bits=16)  # the shipping bench decoder width
        payload = jax.device_put(
            rng.integers(0, 2, size=(batch, cfg.tbs), dtype=np.int8))
        tx_fn = jax.jit(lambda p, c=cfg: pdsch_link.tx_subframe(p, c))
        from srslte_emane_tpu.ops import channel
        rx_samples = channel.awgn(jax.random.PRNGKey(1), tx_fn(payload), snr)
        rx_fn = jax.jit(lambda s, c=cfg: pdsch_link.rx_subframe(s, c)[:2])
        out, ok = rx_fn(rx_samples)
        np.asarray(ok[:1])  # force compile + first run
        t0 = time.time()
        for _ in range(iters):
            out, ok = rx_fn(rx_samples)
        ok_h = np.asarray(ok)
        dt = (time.time() - t0) / iters
        bler = 1.0 - ok_h.mean()
        sf_s = batch / dt
        rows.append(dict(snr_db=snr, bler=round(float(bler), 4),
                         sf_per_s=round(sf_s, 1),
                         goodput_mbps=round(sf_s * (1 - float(bler))
                                            * cfg.tbs / 1e6, 1)))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"snr_sweep": rows}))


if __name__ == "__main__":
    main()
