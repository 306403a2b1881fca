"""The BER/PER sweep (``apps/ber_sweep.py``) against the JAX repo's
``scripts/ber_sweep.py`` at the OFDM detect levels 1 (kernel B1's metric)
and 2 (kernel B2's fused candidate stage).

The same noisy stream (JAX TX, JAX ``channel_apply`` with the script's key;
20 frames at 7 dB, PER 0.27 at 200 frames in ``docs/ber_ofdm.json``) goes
through the port's receiver on the CPU, where each kernel wrapper runs its
plain version, and through the script's receive loop with JAX's jitted
``make_sync_step`` at the same level (its Pallas kernels in interpret
mode, as the JAX package's own tests run them on the CPU).  Detections and
header errors equal; the frames whose ``payload_valid`` differs at most 1,
and the bit-error total within 8 bits a frame whose bit errors differ (the
measured gap is printed; on the CPU it was 0 flips and 0 bits at both
levels).  Seeded with ``zlib.crc32``.
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


@pytest.mark.parametrize("level", [1, 2])
def test_detect_level_matches_jax_on_the_same_noisy_stream(level, capsys):
    line = ref.compare_ofdm_point("uncoded", 20, 7.0, None, None, False,
                                  level)
    with capsys.disabled():
        print("\n" + line)
