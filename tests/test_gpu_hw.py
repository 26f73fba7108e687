"""GPU lane: the chip_smoke.py phases at reduced sizes, on the card.

Run on a GPU machine: `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`.
The default suite runs on the CPU, where these skip; there the same phase
functions run at tiny sizes in tests/test_chip_smoke.py.
"""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


def test_map_kernel_matches_reference_on_device(gpu):
    """Compiled MAP kernel vs `_map_decode` on the CPU device, at the
    bench link's code-block sizes."""
    recs = chip_smoke.phase_map(n_sub=8, n_ref=16, reps=2)
    assert all(r["kernel"] == "compiled" for r in recs)


def test_e2e_20mhz_link_on_device(gpu):
    """Bench-of-record link, small batch: every CRC, every payload bit."""
    rec = chip_smoke.phase_link(batch=4, n_cmp=2, reps=2)
    assert rec["crc_pass"] == 4


def test_waveform_block_on_device(gpu):
    """netsim's device-resident SPS block end to end on the card."""
    chip_smoke.phase_net(
        runs=(("--waveform-block", "--prb", "25", "--ues", "2"),))
