"""Sharded OTA superposition: all_gather + matmul mixing must equal the dense
single-device computation, with HARQ-style state staying put per shard."""

import numpy as np
import jax
import jax.numpy as jnp

from srslte_emane_tpu.parallel import mesh as mesh_mod, ota_collective


def _dense_mix(g, tx):
    n = g.shape[0]
    g = g * (1.0 - np.eye(n, dtype=np.float32))
    xc = tx[..., 0] + 1j * tx[..., 1]
    yc = np.einsum("mn,nbs->mbs", g, xc)
    return np.stack([yc.real, yc.imag], axis=-1).astype(np.float32)


def test_ota_mix_matches_dense_reference():
    mesh = mesh_mod.make_mesh(8)
    n, B, S = 8, 3, 64
    rng = np.random.default_rng(0)
    tx = rng.normal(size=(n, B, S, 2)).astype(np.float32)
    g = (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))).astype(np.complex64)
    tx_sh = jax.device_put(tx, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("node", None, None, None)))
    rx = ota_collective.ota_mix_sharded(mesh, tx_sh, g)
    np.testing.assert_allclose(np.asarray(rx), _dense_mix(g, tx),
                               rtol=1e-4, atol=1e-4)
    # output keeps the node sharding (state stays with its shard)
    assert "node" in str(rx.sharding.spec)


def test_total_rx_power_psum():
    mesh = mesh_mod.make_mesh(8)
    rng = np.random.default_rng(1)
    tx = rng.normal(size=(8, 2, 32, 2)).astype(np.float32)
    tx_sh = jax.device_put(tx, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("node", None, None, None)))
    p = ota_collective.total_rx_power_psum(mesh, tx_sh)
    ref = sum(np.mean(np.sum(tx[i] ** 2, axis=-1)) for i in range(8))
    np.testing.assert_allclose(float(p), ref, rtol=1e-5)
