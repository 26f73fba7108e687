"""Stage ablation profile of the dynamic waveform block.

Monkeypatches heavy stages with cheap stubs and re-jits, attributing the
per-round latency: full, -viterbi, -turbodec, -turboenc, -chest.
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from srslte_emane_tpu.utils import compile_cache

compile_cache.enable()

from srslte_emane_tpu.ops.fec import viterbi
from srslte_emane_tpu.phch import grid as grid_mod, sch
from srslte_emane_tpu.runtime import waveblock_dyn as wbd


def bench_cfg(R=2):
    cell = grid_mod.CellConfig(n_prb=100, cell_id=1, cfi=2)
    rntis = wbd.feasible_rntis(cell, 8)
    return wbd.DynBlockConfig(
        cell=cell, rntis=rntis, dl_l_crbs=11, dl_mcs=25, ul_l_prb=10,
        ul_mcs=20, snr_db=(30.0,) * 8, R=R,
        llr_bits=16)


def run(cfg, label):
    step = wbd.make_dyn_block_step(cfg)
    rng = np.random.default_rng(0)
    T = cfg.T
    dl_q = jax.device_put(rng.integers(0, 2, (T, 8, cfg.dl_tbs), dtype=np.int8))
    ul_q = jax.device_put(rng.integers(0, 2, (T, 8, cfg.ul_tbs), dtype=np.int8))
    rb_dl, rb_ul = wbd.make_schedule(cfg, seed=3)
    args = (dl_q, ul_q, jax.device_put(rb_dl), jax.device_put(rb_ul),
            jax.random.PRNGKey(0), jnp.asarray(0, jnp.int32))
    out = step(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(3):
        out = step(*args)
    jax.block_until_ready(out)
    dt = (time.time() - t0) / 3 / cfg.R * 1000
    print(f"{label}: {dt:.1f} ms/round", flush=True)
    return dt


def main():
    cfg = bench_cfg()

    def stub_vit(llrs, tb_iter=3):
        # keep the producer chain alive (no DCE of the candidate LLRs)
        keep = (llrs.sum((-2, -1), keepdims=False)[:, None] * 0).astype(jnp.int8)
        return jnp.zeros((llrs.shape[0], llrs.shape[-1]), jnp.int8) + keep
    orig_vit = viterbi.viterbi_decode
    viterbi.viterbi_decode = stub_vit
    run(cfg, "-viterbi")
    viterbi.viterbi_decode = orig_vit

    orig_dec = sch.decode_tb
    def stub_dec(llrs, c, softbuf=None, max_iter=8, llr_bits=32,
                 rv_b=None):
        B = llrs.shape[0]
        if softbuf is None:
            softbuf = sch.init_softbuffer(B, c, llrs.dtype)
        keep = (llrs.sum(-1, keepdims=True) * 0).astype(jnp.int8)
        return (jnp.zeros((B, c.tbs), jnp.int8) + keep,
                jnp.ones((B,), bool) & (llrs.sum(-1) > -1e30),
                softbuf, 0)
    sch.decode_tb = stub_dec
    run(cfg, "-turbodec")
    sch.decode_tb = orig_dec

    orig_enc = sch.encode_tb
    sch.encode_tb = lambda b, c, rv_b=None: jnp.zeros(
        (b.shape[0], c.G), jnp.int8)
    run(cfg, "-turboenc")
    sch.encode_tb = orig_enc

    sch.decode_tb = stub_dec
    viterbi.viterbi_decode = stub_vit
    sch.encode_tb = lambda b, c, rv_b=None: jnp.zeros(
        (b.shape[0], c.G), jnp.int8) + (b.sum(-1, keepdims=True) * 0
                                        ).astype(jnp.int8)
    run(cfg, "-all-fec")


if __name__ == "__main__":
    main()
