"""The GPU MAP kernel (turbodecoder_gpu.py) in interpret mode against the
plain `_map_decode`, and the MAP route chosen inside `turbo_decode`."""

import functools

import jax
import numpy as np
import pytest

from srslte_emane_tpu.ops.fec import crc as crc_mod
from srslte_emane_tpu.ops.fec import turbo, turbodecoder, turbodecoder_gpu

ATOL, RTOL = 1e-3, 1e-4  # as chip_smoke.MAP_ATOL / MAP_RTOL


def _map_inputs(k, B=4):
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, (B, k), dtype=np.int8)
    d0, d1, d2 = (np.asarray(x).astype(np.float32) for x in turbo.turbo_encode(bits))
    scale = 4.0
    ls = ((1 - 2.0 * d0[:, :k]) * scale + rng.normal(0, 1, (B, k))).astype(np.float32)
    lp = ((1 - 2.0 * d1[:, :k]) * scale + rng.normal(0, 1, (B, k))).astype(np.float32)
    tail_x = ((1 - 2.0 * np.stack([d0[:, k], d2[:, k], d1[:, k + 1]], -1)) * scale).astype(np.float32)
    tail_z = ((1 - 2.0 * np.stack([d1[:, k], d0[:, k + 1], d2[:, k + 1]], -1)) * scale).astype(np.float32)
    return ls, lp, tail_x, tail_z


def _random_inputs(k, B, seed=0):
    """Soft inputs of any length k (the MAP pass itself needs no valid
    turbo block size): odd window lengths come from odd k / W."""
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 3, s).astype(np.float32)
            for s in ((B, k), (B, k), (B, 3), (B, 3))]


def _check(args):
    ref = np.asarray(turbodecoder._map_decode(*args))
    got = np.asarray(turbodecoder_gpu.map_decode_gpu(*args, interpret=True))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("k", [512, 2048, 5504])
def test_kernel_matches_map_decode(k):
    # 5504 is a bench-of-record CB size (W=32, L=172)
    _check(_map_inputs(k, B=2 if k > 4096 else 4))


@pytest.mark.parametrize("k", [262, 39])
def test_kernel_odd_window_length(k):
    # 262: W=2 windows of L=131 (odd walk, even halo); 39: one window with
    # L = H = 39 (odd walk and odd halo)
    w = turbodecoder._pick_windows(k)
    assert (k // w) % 2 == 1
    _check(_random_inputs(k, B=3))


@pytest.mark.parametrize("B", [5, 130])
def test_kernel_pads_partial_block(B):
    # 5 columns in a 32-wide block; 130 = one full 128 block + 2 columns
    assert B % turbodecoder_gpu.block_size(B) != 0
    _check(_random_inputs(40, B, seed=B))


def test_block_size():
    bs = turbodecoder_gpu.block_size
    assert [bs(1), bs(32), bs(33), bs(100), bs(128), bs(1152)] == \
        [32, 32, 64, 128, 128, 128]


def _crc_blocks(k, n, snr_scale=2.0, seed=1):
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, (n, k - 24), dtype=np.int8)
    bits = np.asarray(crc_mod.crc_attach(payload, crc_mod.LTE_CRC24B))
    ds = [np.asarray(x).astype(np.float32) for x in turbo.turbo_encode(bits)]
    llr = [((1 - 2.0 * d) * snr_scale + rng.normal(0, 1, d.shape)).astype(np.float32)
           for d in ds]
    return bits, llr


def test_turbo_decode_with_kernel_and_crc_early_stop(monkeypatch):
    """Full turbo_decode (CRC-gated early stop) through the kernel: the
    decode converges, and bits, CRC flags and iteration counts equal the
    plain route's."""
    k, n = 256, 8
    bits, (d0, d1, d2) = _crc_blocks(k, n)
    args = (d0, d1, d2, np.ones(n, bool), k, 8, crc_mod.LTE_CRC24B)
    ref = turbodecoder.turbo_decode(*args)
    turbodecoder.turbo_decode.clear_cache()
    monkeypatch.setattr(turbodecoder, "map_route", functools.partial(
        turbodecoder_gpu.map_decode_gpu, interpret=True))
    try:
        got = turbodecoder.turbo_decode(*args)
    finally:
        turbodecoder.turbo_decode.clear_cache()
    assert np.asarray(got[1]).all()
    assert (np.asarray(got[0]) == bits).all()
    for a, b in zip(got, ref):
        assert (np.asarray(a) == np.asarray(b)).all()
    assert 1 <= int(got[2]) < 8  # stopped early


@pytest.mark.parametrize("platform,kernel", [("cuda", True), ("cpu", False)])
def test_turbo_decode_route(platform, kernel):
    """The MAP route is chosen when turbo_decode is lowered: the kernel
    for CUDA, the plain scan for the CPU."""
    k = 40
    _, (d0, d1, d2) = _crc_blocks(k, 2)
    f = jax.jit(lambda a, b, c, v: turbodecoder.turbo_decode(
        a, b, c, v, k, 4, crc_mod.LTE_CRC24B))
    text = f.trace(d0, d1, d2, np.ones(2, bool)).lower(
        lowering_platforms=(platform,)).as_text()
    assert ("turbo_map" in text) == kernel
