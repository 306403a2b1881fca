"""The BER/PER sweep (``apps/ber_sweep.py``) against the JAX repo's
``scripts/ber_sweep.py`` with soft-decision v27 payloads (``--fec0 v27
--fec1 none --soft``), OFDM at detect level 0 in both packages.

The same noisy stream (JAX TX, JAX ``channel_apply`` with the script's key;
16 frames at 1.5 dB, between PER 0.73 at 1 dB and 0.115 at 2 dB at 200
frames in ``docs/ber_ofdm_v27_soft.json``) goes through the port's
receiver on the CPU and through the script's receive loop with JAX's
jitted ``make_sync_step``.  Detections and header errors equal; the frames
whose ``payload_valid`` differs at most 1, and the bit-error total within
8 bits a frame whose bit errors differ (the measured gap is printed; on
the CPU it was 0 flips and 0 bits).  Seeded with ``zlib.crc32``.
"""
import pytest
import torch

import torch_ber_ref as ref


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_soft_v27_point_matches_jax_on_the_same_noisy_stream(capsys):
    line = ref.compare_ofdm_point("v27 soft", 16, 1.5, "v27", "none", True,
                                  0)
    with capsys.disabled():
        print("\n" + line)
