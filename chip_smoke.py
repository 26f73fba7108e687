#!/usr/bin/env python3
"""On-card smoke run: the LTE PHY and the device-resident network on a GPU.

    python chip_smoke.py             # one card: device, map, link, net
    python chip_smoke.py --chips 4   # four cards: the sharded paths only

Everything runs in this one process (netsim is called in-process through
its CLI entry).  Each phase prints one JSON line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.  The
script exits non-zero, without that line, when JAX finds no GPU or when
any phase fails.  The phase functions take their sizes as arguments, so
the tests call them at small sizes (on the CPU, the MAP kernel in
interpret mode).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# MAP kernel vs `_map_decode`: the recursions are f32 adds and maxes with
# no matrix product; the two differ only in where the path metrics are
# renormalized, which changes rounding, not the LLR.
MAP_ATOL, MAP_RTOL = 1e-3, 1e-4
# sharded OTA mixing vs one card: the same f32 einsums at the default
# matmul precision (TF32 allowed on the GPU), split over rows
OTA_RTOL = 1e-3

BENCH_LINK = dict(n_prb=100, qm=6, code_rate=0.55, snr_db=20.0, sf_idx=1,
                  llr_bits=16)
NET_RUNS = (
    ("--waveform-dyn", "--prb", "100", "--ues", "8"),
    ("--waveform-block", "--prb", "100", "--ues", "8"),
    ("--ues", "200", "--prb", "100", "--ttis", "4300"),
)
# cross-device collectives in compiled HLO text: the CPU prints them
# synchronous ("all-gather("), the GPU as async pairs ("all-gather-start("
# ... "-done("), counted once per op
COLLECTIVE_RE = re.compile(
    r"\b(?:all-reduce|all-gather|all-to-all|collective-permute|"
    r"reduce-scatter)(?:-start)?\(")


def emit(phase: str, **rec) -> dict:
    print(json.dumps({"phase": phase, **rec}, default=str), flush=True)
    return rec


class CheckFailed(AssertionError):
    """A phase's output is wrong (raised by `require`, which python -O
    keeps, unlike `assert`)."""


def require(ok, what) -> None:
    if not ok:
        raise CheckFailed(what)


def card_name_and_power() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def matmul_precision() -> str:
    import jax

    p = jax.config.jax_default_matmul_precision
    return str(p) if p else "default (TF32 allowed for f32 dots on the GPU)"


def median_seconds(fn, *args, reps: int = 5) -> float:
    """Median wall time of `reps` calls after one warm-up call, each
    ended by block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def link_config(n_prb: int = 100):
    from srslte_emane_tpu.models import pdsch_link
    from srslte_emane_tpu.phch import grid as grid_mod

    kw = dict(BENCH_LINK, n_prb=n_prb)
    return pdsch_link.LinkConfig(
        cell=grid_mod.CellConfig(n_prb=kw.pop("n_prb"), cell_id=1, cfi=1),
        **kw)


# ---------------------------------------------------------------- device

def phase_device(cache_dir: str) -> dict:
    import jax
    import jaxlib

    dev = jax.devices()[0]
    rec = dict(platform=dev.platform, device_kind=dev.device_kind,
               count=len(jax.devices()), jax=jax.__version__,
               jaxlib=jaxlib.__version__,
               xla_flags=os.environ.get("XLA_FLAGS", ""),
               compile_cache=cache_dir)
    if dev.platform == "gpu":
        rec["card"] = card_name_and_power()
    return emit("device", **rec)


# ---------------------------------------------------------------- map

def map_inputs(key, batch: int, k: int):
    """Noisy LLRs of `batch` real turbo codewords of size k, made on the
    default device: (ls, lp, tail_x, tail_z) as `_map_decode` takes them."""
    import jax
    import jax.numpy as jnp

    from srslte_emane_tpu.ops.fec import turbo

    @jax.jit
    def make(key):
        kb, kn = jax.random.split(key)
        bits = jax.random.bernoulli(kb, 0.5, (batch, k)).astype(jnp.int8)
        d0, d1, d2 = (1.0 - 2.0 * d.astype(jnp.float32)
                      for d in turbo.turbo_encode(bits))
        noise = jax.random.normal(kn, (2, batch, k))
        ls = 4.0 * d0[:, :k] + noise[0]
        lp = 4.0 * d1[:, :k] + noise[1]
        tail_x = 4.0 * jnp.stack([d0[:, k], d2[:, k], d1[:, k + 1]], -1)
        tail_z = 4.0 * jnp.stack([d1[:, k], d0[:, k + 1], d2[:, k + 1]], -1)
        return ls, lp, tail_x, tail_z

    return make(key)


def phase_map(n_sub: int = 128, n_ref: int = 64, reps: int = 5,
              n_prb: int = 100, interpret: bool = False) -> list:
    """The turbo MAP kernel at the link's code-block shapes (n_sub
    subframes, one decode per K as sch.decode_tb runs it) against
    `_map_decode` on the CPU device; then one half-iteration timed for
    the kernel and for `_map_decode`, both on the default device."""
    import jax

    from srslte_emane_tpu.ops.fec import turbodecoder, turbodecoder_gpu

    segm = link_config(n_prb).sch_cfg.segm
    cpu = jax.devices("cpu")[0]
    kernel = jax.jit(functools.partial(turbodecoder_gpu.map_decode_gpu,
                                       interpret=interpret))
    scan = jax.jit(turbodecoder._map_decode)
    recs = []
    for i, k in enumerate(sorted(set(segm.cb_sizes))):
        batch = n_sub * segm.cb_sizes.count(k)
        args = map_inputs(jax.random.PRNGKey(i), batch, k)
        got = np.asarray(kernel(*args))
        ref = np.asarray(scan(*(jax.device_put(a[:n_ref], cpu)
                                for a in args)))
        np.testing.assert_allclose(got[:n_ref], ref, atol=MAP_ATOL,
                                   rtol=MAP_RTOL)
        require(np.isfinite(got).all(), f"non-finite MAP output at K={k}")
        t_kernel = median_seconds(kernel, *args, reps=reps)
        t_scan = median_seconds(scan, *args, reps=reps)
        w = turbodecoder._pick_windows(k)
        recs.append(emit(
            "map", K=k, code_blocks=batch, windows=w, columns=batch * w,
            kernel="interpret" if interpret else "compiled",
            device=jax.devices()[0].device_kind,
            ref_device="cpu", ref_code_blocks=min(n_ref, batch),
            max_abs_diff=float(np.abs(got[:n_ref] - ref).max()),
            atol=MAP_ATOL, rtol=MAP_RTOL,
            precision="f32 adds and maxes, no matmul",
            half_iter_ms_kernel=t_kernel * 1e3,
            half_iter_ms_map_decode=t_scan * 1e3,
            speedup=t_scan / t_kernel,
            # least bytes a half-iteration must move: read ls and lp,
            # write the posterior LLRs, all f32
            min_bytes=12 * batch * k))
    return recs


# ---------------------------------------------------------------- link

def phase_link(batch: int = 128, n_cmp: int = 4, n_prb: int = 100,
               reps: int = 5) -> dict:
    """The 20 MHz PDSCH link at the bench configuration: tx_subframe ->
    awgn -> rx_subframe on the default device, every CRC and every
    payload bit checked; the receive front end's soft bits compared with
    the same jitted function on the CPU device."""
    import jax

    from srslte_emane_tpu.models import pdsch_link
    from srslte_emane_tpu.ops import channel, ofdm
    from srslte_emane_tpu.phch import pdsch

    cfg = link_config(n_prb)
    rng = np.random.default_rng(0)
    payload = jax.device_put(
        rng.integers(0, 2, size=(batch, cfg.tbs), dtype=np.int8))
    tx = jax.jit(lambda p: pdsch_link.tx_subframe(p, cfg))(payload)
    rx = jax.block_until_ready(
        channel.awgn(jax.random.PRNGKey(0), tx, cfg.snr_db))

    rx_fn = jax.jit(lambda s: pdsch_link.rx_subframe(s, cfg)[:2])
    t0 = time.perf_counter()
    compiled = rx_fn.lower(rx).compile()
    compile_s = time.perf_counter() - t0
    out, ok = compiled(rx)
    ok = np.asarray(ok)
    require(ok.all(), f"CRC failed on {int((~ok).sum())} of {batch}")
    require((np.asarray(out) == np.asarray(payload)).all(), "payload differs")

    def front(s):
        grid = ofdm.demodulate(s, cfg.cell.n_prb)
        return pdsch.soft_bits(grid, cfg.sch_cfg, cfg.cell, cfg.sf_idx,
                               cfg.rnti, cfg.prb_mask)[0]

    front = jax.jit(front)
    sub = rx[:n_cmp]
    llr_dev = np.asarray(front(sub))
    llr_cpu = np.asarray(front(jax.device_put(sub, jax.devices("cpu")[0])))
    require(np.isfinite(llr_dev).all(), "non-finite soft bits")
    scale = float(np.abs(llr_cpu).max())
    diff = float(np.abs(llr_dev - llr_cpu).max())
    sf_s = batch / median_seconds(compiled, rx, reps=reps)
    mem = compiled.memory_analysis()
    return emit(
        "link", n_prb=n_prb, qm=cfg.qm, code_rate=cfg.code_rate,
        snr_db=cfg.snr_db, llr_bits=cfg.llr_bits, batch=batch, tbs=cfg.tbs,
        crc_pass=int(ok.sum()), payload_bit_exact=True,
        device=jax.devices()[0].device_kind,
        soft_bits_vs_cpu=dict(subframes=n_cmp, max_abs_diff=diff,
                              max_abs_llr=scale, rel=diff / scale),
        matmul_precision=matmul_precision(),
        compile_s=compile_s,
        memory_analysis={a: getattr(mem, a) for a in dir(mem)
                         if a.endswith("_in_bytes")} if mem else None,
        info_sf_per_s_not_a_benchmark=sf_s)


# ---------------------------------------------------------------- net

def check_net_summary(summary: dict, ues: int, waveform: bool) -> None:
    """Every UE attached; for the device-resident engines, IP bytes both
    ways and every block CRC passed."""
    require(summary["attached"] == ues,
            f"{summary['attached']} of {ues} UEs attached")
    if waveform:
        require(summary["dl_ip_bytes"] > 0 and summary["ul_ip_bytes"] > 0,
                "no IP bytes in one direction")
        m = summary["block_metrics"]
        require(m["dl_tb"] > 0 and m["dl_ok"] == m["dl_tb"], f"DL CRCs: {m}")
        require(m["ul_tb"] > 0 and m["ul_ok"] == m["ul_tb"], f"UL CRCs: {m}")


def phase_net(runs=NET_RUNS) -> list:
    """netsim through its CLI entry, in this process, on the default
    device; one line per run with netsim's own summary in it."""
    from srslte_emane_tpu.apps import netsim

    recs = []
    for argv in runs:
        ues = int(argv[argv.index("--ues") + 1])
        waveform = any(a.startswith("--waveform") for a in argv)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            summary = netsim.main(list(argv))
        wall = time.perf_counter() - t0
        check_net_summary(summary, ues, waveform)
        recs.append(emit("net", argv=" ".join(argv), wall_s=wall,
                         summary=summary))
    return recs


# ---------------------------------------------------------------- 4 cards

def count_collectives(hlo: str) -> int:
    return len(COLLECTIVE_RE.findall(hlo))


def _holders(x) -> list:
    return sorted({d.id for s in x.addressable_shards for d in [s.device]})


def compile_all(jobs) -> list:
    """Lower and compile (jitted function, args) pairs in threads: XLA
    compiles without the interpreter lock, so independent programs
    compile at once."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        futures = [ex.submit(lambda f, a: f.lower(*a).compile(), f, a)
                   for f, a in jobs]
        return [f.result() for f in futures]


def phase_multichip(n_dev: int = 4, per_dev: int = 32, n_prb: int = 100,
                    n_ues: int = 8, block_T: int = 10) -> list:
    """The sharded paths on n_dev cards, each against one-card runs:
    the link step (bit for bit, same per-device folded keys), the
    multi-cell SPS block (one cell per card), and the OTA mixing."""
    import jax
    import jax.numpy as jnp

    from srslte_emane_tpu.models import pdsch_link
    from srslte_emane_tpu.parallel import mesh as mesh_mod, ota_collective
    from srslte_emane_tpu.phch import grid as grid_mod, pdcch, pusch
    from srslte_emane_tpu.runtime import waveblock

    require(len(jax.devices()) >= n_dev, f"needs {n_dev} devices")
    mesh = mesh_mod.make_mesh(n_dev)
    n_node, n_sf = mesh.shape["node"], mesh.shape["sf"]
    rng = np.random.default_rng(0)

    # link step: per_dev subframes per card; device d = (i, j) folds its
    # mesh coordinates into the key
    cfg = link_config(n_prb)
    payload_h = rng.integers(0, 2, (n_dev * per_dev, cfg.tbs), dtype=np.int8)
    payload = jax.device_put(payload_h, mesh_mod.batch_sharding(mesh))
    key = jax.random.PRNGKey(0)
    dev_keys = [jax.random.fold_in(jax.random.fold_in(key, d // n_sf),
                                   d % n_sf) for d in range(n_dev)]
    slices = [slice(d * per_dev, (d + 1) * per_dev) for d in range(n_dev)]

    # multi-cell SPS block: one cell per card
    cell = grid_mod.CellConfig(n_prb=n_prb, cell_id=1, cfi=1)
    n_cce = pdcch.n_cce(cell)
    c0, c1 = waveblock.centre_prbs(n_prb)
    dl_starts, dl_w = waveblock._pack_segments(
        n_prb, n_ues, [(0, c0), (c1, n_prb)])
    ul_w = max(1, (n_prb - 2) // n_ues)
    while ul_w > 1 and not pusch.valid_n_prb(ul_w):
        ul_w -= 1
    bcfg = waveblock.BlockConfig(
        cell=cell, rntis=tuple(70 + i for i in range(n_ues)),
        dl_rb_start=dl_starts, dl_l_crbs=dl_w, dl_mcs=20,
        ul_rb_start=tuple(1 + ul_w * i for i in range(n_ues)),
        ul_l_prb=ul_w, ul_mcs=20,
        ack_res=tuple(n_cce + i for i in range(n_ues)),
        snr_db=(30.0,) * n_ues, T=block_T, llr_bits=16)
    cell_ids = tuple(range(1, n_dev + 1))
    bstep, _ = waveblock.make_block_step_sharded(bcfg, mesh, cell_ids)
    dl = rng.integers(0, 2, (n_dev, block_T, n_ues, bcfg.dl_tbs), np.int8)
    ul = rng.integers(0, 2, (n_dev, block_T, n_ues, bcfg.ul_tbs), np.int8)
    keys = jax.vmap(jax.random.PRNGKey)(np.arange(n_dev, dtype=np.uint32))
    tti0 = jnp.asarray(0, jnp.int32)
    bargs = (jnp.asarray(dl), jnp.asarray(ul), keys, tti0)
    cell_args = [(jnp.asarray(dl[c]), jnp.asarray(ul[c]), keys[c], tti0)
                 for c in range(n_dev)]

    # OTA mixing: node-sharded all_gather + per-row mix
    n_nodes = 2 * n_node
    tx = rng.normal(size=(n_nodes, 2, 960, 2)).astype(np.float32)
    g = (rng.normal(size=(n_nodes, n_nodes))
         + 1j * rng.normal(size=(n_nodes, n_nodes))).astype(np.complex64)
    spec = jax.sharding.PartitionSpec("node", None, None, None)
    tx_sh = jax.device_put(tx, jax.sharding.NamedSharding(mesh, spec))
    g0 = g * (1.0 - np.eye(n_nodes, dtype=np.float32))
    ota_args = (jnp.asarray(g0.real), jnp.asarray(g0.imag), jnp.asarray(tx))

    link_c, link1_c, block_c, ota_c, ota1_c, *cell_c = compile_all(
        [(pdsch_link.make_link_step_sharded(cfg, mesh), (payload, key)),
         (pdsch_link.make_link_step(cfg),
          (jnp.asarray(payload_h[slices[0]]), dev_keys[0])),
         (bstep, bargs),
         (jax.jit(lambda t: ota_collective.ota_mix_sharded(mesh, t, g)),
          (tx_sh,)),
         (jax.jit(ota_collective._mix), ota_args)]
        + [(waveblock.make_block_step(bcfg._replace(
            cell=grid_mod.CellConfig(n_prb=n_prb, cell_id=cid,
                                     cfi=cell.cfi))), cell_args[c])
           for c, cid in enumerate(cell_ids)])
    recs = []

    out, ok, snr = link_c(payload, key)
    max_snr_diff = 0.0
    for d, sl in enumerate(slices):
        o1, ok1, snr1 = link1_c(jnp.asarray(payload_h[sl]), dev_keys[d])
        require((np.asarray(out[sl]) == np.asarray(o1)).all() and
                (np.asarray(ok[sl]) == np.asarray(ok1)).all(),
                f"device {d}'s slice differs from one card")
        max_snr_diff = max(max_snr_diff, float(
            np.abs(np.asarray(snr[sl]) - np.asarray(snr1)).max()))
    require(np.asarray(ok).all() and (np.asarray(out) == payload_h).all(),
            "sharded link: CRC or payload")
    recs.append(emit(
        "multichip_link", devices=n_dev, mesh=dict(mesh.shape),
        subframes_per_device=per_dev, crc_pass=int(np.asarray(ok).sum()),
        equal_to_one_card=True, snr_db_max_abs_diff=max_snr_diff,
        cross_device_collectives=count_collectives(link_c.as_text()),
        output_devices=_holders(out)))

    bout = block_c(*bargs)
    for c, cid in enumerate(cell_ids):
        o1 = cell_c[c](*cell_args[c])
        for name in ("dl_out", "ul_out", "dl_ok", "ul_ok"):
            require((np.asarray(bout[name][c]) == np.asarray(o1[name])).all(),
                    f"cell {cid}: {name} differs from one card")
    require(np.asarray(bout["dl_ok"]).all() and np.asarray(bout["ul_ok"]).all()
            and (np.asarray(bout["dl_out"]) == dl).all()
            and (np.asarray(bout["ul_out"]) == ul).all(),
            "sharded block: CRC or payload")
    recs.append(emit(
        "multichip_block", cells=n_dev, n_prb=n_prb, ues_per_cell=n_ues,
        block_ttis=block_T, equal_to_one_card=True, all_crc_ok=True,
        cross_device_collectives=count_collectives(block_c.as_text()),
        output_devices=_holders(bout["dl_out"])))

    rx = ota_c(tx_sh)
    rx1 = np.asarray(ota1_c(*ota_args))
    err = float(np.abs(np.asarray(rx) - rx1).max())
    scale = float(np.abs(rx1).max())
    require(err <= OTA_RTOL * scale, f"OTA mix differs by {err} of {scale}")
    recs.append(emit(
        "multichip_ota", nodes=n_nodes, max_abs_diff=err, max_abs=scale,
        rtol=OTA_RTOL, matmul_precision=matmul_precision(),
        cross_device_collectives=count_collectives(ota_c.as_text()),
        output_devices=_holders(rx)))
    for r in recs:
        require(len(r["output_devices"]) == n_dev,
                f"outputs on {r['output_devices']}")
    return recs


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded paths, on four cards")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "srslte_emane_tpu")):
        print("chip_smoke.py runs from a checkout of the repository",
              file=sys.stderr)
        return 2

    import jax

    from srslte_emane_tpu.utils import compile_cache

    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX's default backend is {jax.default_backend()}",
              file=sys.stderr)
        return 1
    if len(jax.devices()) < args.chips:
        print(f"--chips {args.chips} needs {args.chips} GPUs, JAX sees "
              f"{len(jax.devices())}", file=sys.stderr)
        return 1
    dev = phase_device(compile_cache.enable())
    if args.chips == 4:
        phase_multichip(n_dev=4)
    else:
        phase_map()
        phase_link()
        phase_net()
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["device_kind"],
        "count": args.chips}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
