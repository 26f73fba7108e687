"""End-to-end PDSCH link: eNB encode -> OFDM -> AWGN -> UE decode.

This is the framework's flagship "model": the batched equivalent of the
reference's pdsch_test / phy_dl_test harnesses (`lib/src/phy/phch/test/
pdsch_test.c:325`, `lib/test/phy/phy_dl_test.c:146-190`) and of one
eNB-TTI-encode + UE-TTI-decode pair of the runtime call stacks
(SURVEY.md §3.1/§3.2).  A batch axis of B subframes replaces the reference's
sf_worker thread pipeline.
"""

from __future__ import annotations

import dataclasses
import functools

import jax

from ..ops import channel, ofdm
from ..phch import grid as grid_mod
from ..phch import pdsch, sch


@dataclasses.dataclass(frozen=True)
class LinkConfig:
    cell: grid_mod.CellConfig = grid_mod.CellConfig()
    sf_idx: int = 1
    rnti: int = 0x46
    qm: int = 2
    prb_mask: tuple = None  # default: all PRBs
    code_rate: float = 0.5  # target rate -> tbs derived from G
    snr_db: float = 10.0
    max_iter: int = 8
    # 32 = f32 LLRs end-to-end; 16 = the reference's default decoder width
    # (SRSLTE_TDEC_16BIT): quantized decoder inputs, bf16 de-rate-match
    llr_bits: int = 32

    def __post_init__(self):
        if self.prb_mask is None:
            object.__setattr__(self, "prb_mask", (1,) * self.cell.n_prb)

    @functools.cached_property
    def n_re(self) -> int:
        return grid_mod.nof_re(self.cell, self.sf_idx, self.prb_mask)

    @functools.cached_property
    def G(self) -> int:
        return self.n_re * self.qm

    @functools.cached_property
    def tbs(self) -> int:
        # largest multiple of 8 with rate <= code_rate (incl. TB CRC)
        return max(8, (int(self.G * self.code_rate) - 24) // 8 * 8)

    @functools.cached_property
    def sch_cfg(self) -> sch.SchConfig:
        return sch.SchConfig(tbs=self.tbs, G=self.G, Qm=self.qm, Nl=1)


def tx_subframe(payload, cfg: LinkConfig):
    """(B, tbs) bits -> (B, SF_LEN, 2) time-domain eNB subframe."""
    g = pdsch.encode(payload, cfg.sch_cfg, cfg.cell, cfg.sf_idx, cfg.rnti, cfg.prb_mask)
    return ofdm.modulate(g, cfg.cell.n_prb)


def rx_subframe(samples, cfg: LinkConfig, softbuf=None):
    """(B, SF_LEN, 2) -> (payload (B, tbs), ok (B,), softbuf, chest)."""
    g = ofdm.demodulate(samples, cfg.cell.n_prb)
    return pdsch.decode(
        g, cfg.sch_cfg, cfg.cell, cfg.sf_idx, cfg.rnti, cfg.prb_mask,
        softbuf=softbuf, max_iter=cfg.max_iter, llr_bits=cfg.llr_bits,
    )


def link_step(payload, key, cfg: LinkConfig):
    """Full eNB->channel->UE step.  jit with static cfg."""
    tx = tx_subframe(payload, cfg)
    rx = channel.awgn(key, tx, cfg.snr_db)
    out, ok, _, ch = rx_subframe(rx, cfg)
    return out, ok, ch.snr_db


def make_link_step(cfg: LinkConfig):
    return jax.jit(functools.partial(link_step, cfg=cfg))


def make_ca_link_step(cfg: LinkConfig, n_cc: int):
    """Carrier-aggregation link step: n_cc component carriers as a leading
    batched axis, each with its own cell identity (distinct scrambling
    c_init + CRS sequences, as the UE's per-SCell cc_worker sees —
    srsue/src/phy/scell/scell_recv.cc role).  Carriers are independent RF
    channels, so the carrier axis is simply more batch: one compiled
    module runs PCell + SCells together and throughput scales with n_cc.

    payloads: (n_cc, B, tbs) -> (out (n_cc, B, tbs), ok (n_cc, B))."""
    import dataclasses as _dc

    cfgs = [
        _dc.replace(cfg, cell=_dc.replace(cfg.cell,
                                          cell_id=cfg.cell.cell_id + 3 * i))
        for i in range(n_cc)
    ]

    def step(payloads, key):
        outs, oks = [], []
        for i, c in enumerate(cfgs):
            out, ok, _ = link_step(payloads[i], jax.random.fold_in(key, i), c)
            outs.append(out)
            oks.append(ok)
        import jax.numpy as jnp
        return jnp.stack(outs), jnp.stack(oks)

    return jax.jit(step)


def make_link_step_sharded(cfg: LinkConfig, mesh):
    """link_step over an n-device mesh via shard_map: each device runs the
    whole pipeline on its local slice of the batch, so the compiled module
    is collective-free BY CONSTRUCTION (subframes are independent).

    Plain in_shardings=jit is not enough here: the turbo decoder's
    (batch x codeblock x window) reshapes merge the sharded batch axis with
    unsharded axes and XLA's SPMD partitioner then inserts >100 resharding
    collectives per step (measured, scripts/scaling_curve.py) — the
    shard_map contract removes them all, which is what makes per-chip
    weak scaling communication-free on real hardware."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def local_step(payload, key):
        # decorrelate noise across devices: fold the device coordinates in
        key = jax.random.fold_in(key, jax.lax.axis_index("node"))
        key = jax.random.fold_in(key, jax.lax.axis_index("sf"))
        return link_step(payload, key, cfg)

    step = shard_map(
        local_step, mesh=mesh, check_vma=False,
        in_specs=(P(("node", "sf")), P()),
        out_specs=(P(("node", "sf")), P(("node", "sf")), P(("node", "sf"))))
    return jax.jit(step)
