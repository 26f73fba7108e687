"""Device-resident waveform steady state (runtime/waveblock.py).

The block program runs T TTIs x n_ues of the full PHY both directions in
ONE compiled call (SURVEY §7.7 time-block batch; the batched analogue of the
reference's sf_worker TTI pipelining, srsenb/src/phy/txrx.cc:105-145).

The compiled-scenario tests run in SUBPROCESSES: CPU XLA segfaults
after several hundred cumulative in-process compiles, and these block
programs are the largest compiles in the suite (see
test_wavenet_mimo.py for the pattern's origin).
"""

import os
import subprocess
import sys

import numpy as np
import pytest


def _isolated(name, timeout=1700):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, __file__, name],
                       capture_output=True, text=True, env=env,
                       timeout=timeout)
    assert r.returncode == 0, \
        f"scenario {name} failed:\n{r.stdout[-2000:]}\n{r.stderr[-3000:]}"


def test_block_phy_roundtrip_exact():
    """T x n TTIs of DL PDSCH + UL PUSCH + PUCCH in one device call:
    every TB decodes bit-exact, every ACK is detected positive."""
    _isolated("roundtrip")


def test_block_nack_rides_pucch():
    """A UE that fails its DL CRC signals NACK on its persistent PUCCH
    resource: crush one UE's DL SNR and read the matched filter sign."""
    _isolated("nack")


def test_block_step_sharded_multicell():
    """8 cells on an 8-device ('node','sf') mesh: ONE program runs every
    cell's full-PHY block on its own device with all cell-dependent
    tables as sharded arguments; per-device module collective-free."""
    _isolated("multicell")


@pytest.mark.slow
def test_block_runner_carries_ip_traffic():
    """Attach over the host-paced waveform network, then switch the
    steady state to the device-resident block engine: real DRB IP
    traffic crosses the block PHY in both directions."""
    _isolated("runner", timeout=3000)


# ---------------------------------------------------------------------------
# scenario bodies (subprocess side)
# ---------------------------------------------------------------------------

def _cfg(n_prb=15, n_ues=2, T=10, dl_mcs=10, ul_mcs=10):
    from srslte_emane_tpu.phch import grid as grid_mod, pdcch
    from srslte_emane_tpu.runtime import waveblock

    cell = grid_mod.CellConfig(n_prb=n_prb, cell_id=1, cfi=2)
    n_cce = pdcch.n_cce(cell)
    c0, c1 = waveblock.centre_prbs(n_prb)
    dl_starts, dl_w = waveblock._pack_segments(
        n_prb, n_ues, [(0, c0), (c1, n_prb)])
    return waveblock.BlockConfig(
        cell=cell, rntis=tuple(70 + i for i in range(n_ues)),
        dl_rb_start=dl_starts, dl_l_crbs=dl_w, dl_mcs=dl_mcs,
        ul_rb_start=tuple(1 + 4 * i for i in range(n_ues)), ul_l_prb=4,
        ul_mcs=ul_mcs,
        ack_res=tuple(n_cce + i for i in range(n_ues)),
        snr_db=tuple(30.0 - i for i in range(n_ues)), T=T)


def _roundtrip():
    import jax
    import jax.numpy as jnp

    from srslte_emane_tpu.runtime import waveblock

    cfg = _cfg()
    step = waveblock.make_block_step(cfg, sfn0=12)
    rng = np.random.default_rng(0)
    dl = rng.integers(0, 2, (cfg.T, cfg.n_ues, cfg.dl_tbs), dtype=np.int8)
    ul = rng.integers(0, 2, (cfg.T, cfg.n_ues, cfg.ul_tbs), dtype=np.int8)
    out = step(jnp.asarray(dl), jnp.asarray(ul), jax.random.PRNGKey(1),
               jnp.asarray(120, jnp.int32))
    assert np.asarray(out["dl_ok"]).all()
    assert np.asarray(out["ul_ok"]).all()
    assert (np.asarray(out["dl_out"]) == dl).all()
    assert (np.asarray(out["ul_out"]) == ul).all()
    # PUCCH matched filter: all ACKs present and positive
    assert (np.asarray(out["ack_energy"]) > 0.25).all()
    assert (np.asarray(out["ack_val"]) > 0).all()


def _nack():
    import jax
    import jax.numpy as jnp

    from srslte_emane_tpu.runtime import waveblock

    cfg = _cfg(n_ues=2)._replace(snr_db=(30.0, -10.0))
    step = waveblock.make_block_step(cfg)
    rng = np.random.default_rng(1)
    dl = rng.integers(0, 2, (cfg.T, 2, cfg.dl_tbs), dtype=np.int8)
    ul = rng.integers(0, 2, (cfg.T, 2, cfg.ul_tbs), dtype=np.int8)
    out = step(jnp.asarray(dl), jnp.asarray(ul), jax.random.PRNGKey(2),
               jnp.asarray(40, jnp.int32))
    dl_ok = np.asarray(out["dl_ok"])
    assert dl_ok[:, 0].all() and not dl_ok[:, 1].any()
    val = np.asarray(out["ack_val"])
    assert (val[:, 0] > 0).all()  # ACKs
    assert (val[:, 1] < 0).all()  # NACKs carried over the air


def _multicell():
    import jax
    import jax.numpy as jnp

    from srslte_emane_tpu.parallel import mesh as mesh_mod
    from srslte_emane_tpu.runtime import waveblock

    mesh = mesh_mod.make_mesh(8)
    cfg = _cfg(n_prb=15, n_ues=2, T=4, dl_mcs=8, ul_mcs=8)
    cell_ids = tuple(range(1, 9))
    step, _ = waveblock.make_block_step_sharded(cfg, mesh, cell_ids)
    C = 8
    rng = np.random.default_rng(0)
    dl = rng.integers(0, 2, (C, cfg.T, 2, cfg.dl_tbs), dtype=np.int8)
    ul = rng.integers(0, 2, (C, cfg.T, 2, cfg.ul_tbs), dtype=np.int8)
    keys = jax.vmap(jax.random.PRNGKey)(np.arange(C, dtype=np.uint32))
    lowered = step.lower(jnp.asarray(dl), jnp.asarray(ul), keys,
                         jnp.asarray(20, jnp.int32)).compile()
    hlo = lowered.as_text()
    n_coll = sum(hlo.count(op) for op in
                 ("all-reduce(", "all-gather(", "all-to-all(",
                  "collective-permute(", "reduce-scatter("))
    assert n_coll == 0, f"multi-cell block gained collectives: {n_coll}"
    out = step(jnp.asarray(dl), jnp.asarray(ul), keys,
               jnp.asarray(20, jnp.int32))
    assert np.asarray(out["dl_ok"]).all()
    assert np.asarray(out["ul_ok"]).all()
    assert (np.asarray(out["dl_out"]) == dl).all()
    assert (np.asarray(out["ul_out"]) == ul).all()
    assert (np.asarray(out["ack_energy"]) > 0.25).all()


def _runner():
    import jax
    import jax.numpy as jnp  # noqa: F401

    from srslte_emane_tpu.epc import hss as hss_mod, mme as mme_mod
    from srslte_emane_tpu.epc import spgw as spgw_mod
    from srslte_emane_tpu.runtime import waveblock, wavenet
    from srslte_emane_tpu.stack import enb_stack, security, ue_stack

    n_ues, n_prb = 2, 15
    hss = hss_mod.Hss()
    spgw = spgw_mod.Spgw()
    mme = mme_mod.Mme(hss, spgw)
    enb = enb_stack.EnbStack(mme, enb_id=1, n_prb=n_prb)
    ues = []
    for i in range(n_ues):
        imsi = f"00101000000002{i:02d}"
        key = bytes(range(16))
        hss.add(hss_mod.Subscriber(imsi=imsi, key=key))
        opc = security.milenage_opc(key, b"\x00" * 16)
        ues.append(ue_stack.UeStack(ue_stack.Usim(imsi, key, opc),
                                    preamble=11 + 5 * i))
    net = wavenet.WaveformNetwork(
        enb, ues, pathloss_db=np.full(n_ues, 80.0), n_prb=n_prb, seed=3)
    for _ in range(8):
        net.run(50)
        if all(u.emm_state == "REGISTERED" for u in ues):
            break
    assert all(u.emm_state == "REGISTERED" for u in ues)

    runner = waveblock.SpsBlockRunner(net, T=10)
    # DL: SGi -> GTP -> eNB RLC -> block PDSCH -> UE;  UL: UE gw -> block
    pkts = {}
    for u in ues:
        pkt = spgw_mod.make_ipv4("8.8.8.8", u.ip_addr, b"blk" * 40)
        assert spgw.handle_sgi_pdu(pkt)
        pkts[u.ip_addr] = pkt
        u.gw_send(spgw_mod.make_ipv4(u.ip_addr, "8.8.8.8", b"ul" * 30))
    ul_before = spgw.metrics["ul_bytes"]
    for _ in range(3):
        runner.run_block()
    for u in ues:
        assert any(p == pkts[u.ip_addr] for p in u.gw_rx), \
            (runner.metrics, [len(u.gw_rx) for u in ues])
    assert spgw.metrics["ul_bytes"] > ul_before
    m = runner.metrics
    assert m["blocks"] == 3 and m["dl_ok"] == m["dl_tb"]
    assert m["ul_ok"] == m["ul_tb"] and m["ack_det"] == m["dl_tb"]


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    {"roundtrip": _roundtrip, "nack": _nack,
     "multicell": _multicell, "runner": _runner}[sys.argv[1]]()
