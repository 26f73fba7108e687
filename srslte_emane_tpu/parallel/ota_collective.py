"""OTA superposition as a device collective: the multi-chip "air interface".

Reference parallelism being replaced (SURVEY.md §2.8 / §5): one OS process
per network node exchanging OTA frames over the EMANE multicast bus
(`EMANELTE::MHAL::ENB/UE::send_msg/get_messages`).  Here the nodes are
sharded over the 'node' mesh axis and the over-the-air superposition
  rx_i = sum_j  g_ij * tx_j   (j over ALL nodes, both local and remote)
is ONE `all_gather` over the node axis followed by a local mixing matmul —
the per-(tx, rx) complex link-gain matrix is a matrix product, the waveform
exchange is the collective (NCCL over NVLink between GPUs).

Design notes:
- tx waveforms are (n_nodes, B, S, 2) split-complex, sharded on axis 0;
  the gather moves each shard once per step (the OTA "broadcast"), which
  is the minimum traffic any emulated shared medium needs.
- the mix is einsum('ij,jbs->ibs') per re/im part: complex matmul = 4 real
  matmuls; self-interference is excluded by zeroing diag(g).
- HARQ softbuffers / chest state shard WITH their rx node and never move.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P


def _mix(g_re, g_im, x):
    """rx = g @ tx in split-complex: x (n, B, S, 2) -> (m, B, S, 2),
    g (m, n) complex as two real parts."""
    xr, xi = x[..., 0], x[..., 1]
    yr = jnp.einsum("mn,nbs->mbs", g_re, xr) - jnp.einsum("mn,nbs->mbs", g_im, xi)
    yi = jnp.einsum("mn,nbs->mbs", g_re, xi) + jnp.einsum("mn,nbs->mbs", g_im, xr)
    return jnp.stack([yr, yi], axis=-1)


def ota_mix_sharded(mesh, tx, gains, key=None, noise_std: float = 0.0):
    """All-nodes OTA superposition over a sharded node axis.

    tx: (n_nodes, B, S, 2) node-sharded waveforms; gains: (n_nodes, n_nodes)
    complex64 link matrix (row = rx, col = tx; diagonal ignored).
    Returns rx with the SAME sharding as tx.
    """
    n = tx.shape[0]
    g = jnp.asarray(gains) * (1.0 - jnp.eye(n, dtype=jnp.float32))
    g_re, g_im = jnp.real(g).astype(jnp.float32), jnp.imag(g).astype(jnp.float32)
    spec = P("node", None, None, None)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(spec, P("node", None), P("node", None)),
        out_specs=spec)
    def run(tx_local, g_re_rows, g_im_rows):
        # the OTA broadcast: every node's waveform to every chip, once
        tx_all = jax.lax.all_gather(tx_local, "node", axis=0, tiled=True)
        return _mix(g_re_rows, g_im_rows, tx_all)

    rx = run(tx, g_re, g_im)
    if noise_std and key is not None:
        sharding = NamedSharding(mesh, spec)
        noise = noise_std * jax.random.normal(key, rx.shape) / jnp.sqrt(2.0)
        rx = rx + jax.lax.with_sharding_constraint(noise, sharding)
    return rx


def total_rx_power_psum(mesh, tx):
    """Per-node medium occupancy check: sum over the WHOLE medium of each
    node's mean tx power, computed with a psum instead of gathering
    waveforms — the cheap collective for carrier-sense style logic."""
    spec = P("node", None, None, None)

    @functools.partial(shard_map, mesh=mesh, in_specs=(spec,),
                       out_specs=P())
    def run(tx_local):
        # per-node mean over (B, S), then sum nodes: local + psum
        p = jnp.sum(jnp.mean(jnp.sum(tx_local**2, axis=-1), axis=(1, 2)))
        return jax.lax.psum(p, "node")

    return run(tx)
