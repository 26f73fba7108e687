"""Dynamic device-resident waveform block: per-TTI PDCCH DCI + 8-process
IR-HARQ (runtime/waveblock_dyn.py).

Reference semantics matched: srsenb/src/phy/sf_worker.cc per-TTI loop,
scheduler_harq.cc RV cycling / max-tx drop, srsue dl_harq.cc NDI-toggle
soft-buffer reset, ul_harq.cc PHICH-driven synchronous retransmission,
lib/src/phy/fec/softbuffer.c IR soft-combining.

Scenarios run in subprocesses (cumulative-compile isolation; see
test_waveblock.py).
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


def test_dyn_block_clean_channel_end_to_end():
    """High SNR: every TB rides a blind-decoded per-TTI DCI and every
    CRC passes first transmission; payload order is intact."""
    _isolated("clean")


@pytest.mark.slow
def test_dyn_block_ir_soft_combining_gain():
    """A crushed-SNR UE recovers TBs via in-block IR retransmission —
    and the gain IS soft combining: with the soft buffer chased
    (combine=False), the identical retransmissions never decode and the
    HARQ entity drops at max_tx (softbuffer.c / sch.c:389-414 role)."""
    _isolated("combining", timeout=3000)


@pytest.mark.slow
def test_dyn_block_dci_miss_is_dtx():
    """At destroyed SNR the UE misses the PDCCH: it neither decodes the
    TB nor sends PUCCH (DTX), and the eNB keeps retransmitting until the
    max-tx drop — no false ACKs."""
    _isolated("dtx")


def test_rnti_pool_keeps_the_static_pdcch_plan_feasible():
    """netsim --waveform-dyn attaches on a feasible C-RNTI pool: the eNB
    hands the pool out first, then continues past it, and any subset of
    a feasible set places (at 100 PRB, sequential RNTIs 70..77 do not)."""
    import types

    from srslte_emane_tpu.epc import hss as hss_mod, mme as mme_mod
    from srslte_emane_tpu.epc import spgw as spgw_mod
    from srslte_emane_tpu.phch import grid as grid_mod
    from srslte_emane_tpu.runtime import waveblock_dyn as wbd
    from srslte_emane_tpu.stack import enb_stack

    cell = grid_mod.CellConfig(n_prb=100, cell_id=1, cfi=2)

    def plan(rntis):
        wbd._alloc_cces(types.SimpleNamespace(
            cell=cell, rntis=tuple(rntis), l_aggr=1, n_ues=len(rntis)))

    with pytest.raises(AssertionError):
        plan(range(70, 78))
    enb = enb_stack.EnbStack(mme_mod.Mme(hss_mod.Hss(), spgw_mod.Spgw()),
                             enb_id=0, n_prb=100)
    pool = wbd.feasible_rntis(cell, 12, start=enb.next_rnti)
    enb.use_rnti_pool(pool)
    got = [enb._new_rnti() for _ in range(13)]
    assert got[:12] == list(pool) and got[12] == max(pool) + 1
    plan(pool[4:])


# ---------------------------------------------------------------------------
# scenario bodies (subprocess side)
# ---------------------------------------------------------------------------

def _cell():
    from srslte_emane_tpu.phch import grid as grid_mod

    return grid_mod.CellConfig(n_prb=15, cell_id=1, cfi=2)


def _run(cfg, seed=0, key=7):
    import jax
    import jax.numpy as jnp

    from srslte_emane_tpu.runtime import waveblock_dyn as wbd

    rb_dl, rb_ul = wbd.make_schedule(cfg, seed=1)
    step = wbd.make_dyn_block_step(cfg)
    rng = np.random.default_rng(seed)
    Q = cfg.T
    dl_q = rng.integers(0, 2, (Q, cfg.n_ues, cfg.dl_tbs), dtype=np.int8)
    ul_q = rng.integers(0, 2, (Q, cfg.n_ues, cfg.ul_tbs), dtype=np.int8)
    out = step(jnp.asarray(dl_q), jnp.asarray(ul_q), jnp.asarray(rb_dl),
               jnp.asarray(rb_ul), jax.random.PRNGKey(key),
               jnp.asarray(0, jnp.int32))
    return jax.tree_util.tree_map(np.asarray, out), dl_q, ul_q, rb_dl


def _clean():
    from srslte_emane_tpu.runtime import waveblock_dyn as wbd

    cfg = wbd.DynBlockConfig(
        cell=_cell(), rntis=(70, 71), dl_l_crbs=3, dl_mcs=8,
        ul_l_prb=2, ul_mcs=8, snr_db=(30.0, 28.0), R=2)
    out, dl_q, ul_q, rb_dl = _run(cfg)
    Tn = cfg.T * cfg.n_ues
    assert out["dl_found"].sum() == Tn  # every DL DCI blind-decoded
    assert out["dci_ul_miss"] == 0
    assert out["dl_ok"].sum() == Tn
    assert out["ul_ok"].sum() == Tn
    assert out["ack_det"].sum() == Tn
    assert out["dl_retx_tx"] == 0 and out["ul_retx_tx"] == 0
    # the UE followed the RIV of the DECODED DCI, not the schedule
    assert (out["rb_ue"] == rb_dl).all()
    # payload stream integrity: delivered TBs match the queue in order
    for u in range(cfg.n_ues):
        ptr = 0
        for r in range(cfg.R):
            for t in range(wbd.N_PID):
                if out["dl_new"][r, t, u]:
                    assert (out["dl_out"][r, t, u] == dl_q[ptr, u]).all()
                    ptr += 1
        assert ptr == out["dl_consumed"][u] == cfg.T
        ptr = 0
        for r in range(cfg.R):
            for t in range(wbd.N_PID):
                if out["ul_new"][r, t, u]:
                    assert (out["ul_out"][r, t, u] == ul_q[ptr, u]).all()
                    ptr += 1
        assert ptr == out["ul_consumed"][u] == cfg.T


def _combining():
    from srslte_emane_tpu.runtime import waveblock_dyn as wbd

    base = dict(cell=_cell(), rntis=(70, 71), dl_l_crbs=3, dl_mcs=16,
                ul_l_prb=2, ul_mcs=8, snr_db=(30.0, 8.0), R=4)
    cfg = wbd.DynBlockConfig(**base, combine=True)
    out, _, _, _ = _run(cfg)
    u = 1
    ok = out["dl_ok"][:, :, u]
    new = out["dl_new"][:, :, u]
    # control channel solid at this SNR: HARQ runs on real feedback
    assert out["dci_dl_miss"] == 0
    # virtually every FIRST transmission fails...
    assert ok[new].sum() <= 2, ok
    # ...and the soft-combined retransmissions recover nearly all of them
    recovered = ok[~new].sum()
    assert recovered >= 10, (recovered, ok, new)
    assert out["dl_drop"] <= 1
    # RV cycling: first retransmissions carry RV 2 (scheduler_harq.cc)
    rv = out["rv_dl"][:, :, u]
    assert (rv[~new] != 0).all()
    assert (rv[1][~new[1]] == 2).all()

    ctrl, _, _, _ = _run(wbd.DynBlockConfig(**base, combine=False))
    okc = ctrl["dl_ok"][:, :, u]
    # identical retransmissions WITHOUT combining: no recovery, drops
    assert okc.sum() <= 2, okc
    assert ctrl["dl_drop"] >= 6
    assert recovered - okc[~ctrl["dl_new"][:, :, u]].sum() >= 8


def _dtx():
    from srslte_emane_tpu.runtime import waveblock_dyn as wbd

    cfg = wbd.DynBlockConfig(
        cell=_cell(), rntis=(70, 71), dl_l_crbs=3, dl_mcs=8,
        ul_l_prb=2, ul_mcs=8, snr_db=(30.0, -6.0), R=2)
    out, _, _, _ = _run(cfg)
    u = 1
    assert not out["dl_found"][:, :, u].any()  # every DCI missed
    assert not out["dl_ok"][:, :, u].any()
    assert not out["ack_det"][:, :, u].any()  # DTX, not ACK
    assert out["dl_retx_tx"] >= 8  # eNB kept retrying
    # the good UE is untouched by its neighbour's outage
    assert out["dl_ok"][:, :, 0].all()
    assert out["ul_ok"][:, :, 0].all()


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import jax

    jax.config.update("jax_platforms", "cpu")
    {"clean": _clean, "combining": _combining, "dtx": _dtx}[sys.argv[1]]()
