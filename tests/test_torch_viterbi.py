"""The payload codec's Viterbi (``ops/conv.py``) on the CPU: the property
the CUDA kernel's free choice of renormalisation interval rests on, and the
CPU dispatch.

Subtracting a row's least path metric is a shift of every metric of the
row, so the decisions, which compare metrics of one row, and the bits do
not depend on when it happens as long as int32 holds the sums: the plain
version gives the same bits renormalising after every step (as JAX does),
after every 7 or 256 steps, or never (an interval past the trellis:
``big`` leaves room for it), at each state count (64, 256, 16,384), on hard costs with exact
ties and soft costs with erased runs.  The kernel itself runs only on the
card (``tests/test_torch_gpu.py``).  Inputs come from
``numpy.random.default_rng`` seeded with ``zlib.crc32`` of the case name.
"""
import zlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from liquid_usrp_tpu_torch.ops import conv, fec, kernels
from liquid_usrp_tpu_torch.utils import profiling
from liquid_usrp_tpu_torch.utils.bits import pack_bits

CONV = [s for s in range(fec.FEC_CONV_V27, fec.FEC_CONV_V29P78 + 1)
        if s != fec.FEC_RS8]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _costs(scheme: int, soft: bool, n_bytes: int, rng):
    """Branch costs of two encoded rows: row 0 at 2 % bit errors (LLRs at
    SNR 4), row 1 past the code (hard: 30 % flips, many exact ties; soft:
    weak LLRs with an erased run of a third of the word).  Returns the
    costs, ``big`` and the data."""
    data = rng.integers(0, 256, (2, n_bytes), dtype=np.uint8)
    enc = fec.fec_encode(scheme, torch.as_tensor(data)).numpy()
    bits = np.unpackbits(enc, axis=-1)
    if not soft:
        flips = rng.random(bits.shape) < np.array([[0.02], [0.3]])
        coded = torch.as_tensor(np.packbits(bits ^ flips, axis=-1))
        costs = conv._hard_costs(scheme, coded, n_bytes)
        return costs, conv.BIG_HARD, data
    llr = (2.0 * bits - 1.0) * np.array([[4.0], [0.5]]) + \
        rng.normal(size=bits.shape)
    n = llr.shape[-1]
    llr[1, n // 3:2 * n // 3] = 0.0
    llr = torch.as_tensor(llr, dtype=torch.float32)
    costs = conv._soft_costs(scheme, llr, n_bytes)
    return costs, conv.BIG_SOFT, data


# one scheme of each state count, hard and soft; over 256 steps each
CASES = [("v27", False, 40), ("v27", True, 40), ("v39", False, 40),
         ("v29p78", True, 40), ("v615", False, 34), ("v615", True, 34)]


@pytest.mark.parametrize("name,soft,n_bytes", CASES)
def test_plain_bits_do_not_depend_on_the_interval(name, soft, n_bytes,
                                                  monkeypatch):
    s = fec.fec_from_name(name)
    rng = _rng(f"renorm {name} {soft}")
    costs, big, data = _costs(s, soft, n_bytes, rng)
    T = costs.shape[1]
    assert T > 256
    assert conv._RENORM == 256
    want = conv._viterbi_plain(s, costs, big)
    for renorm in (1, 7, T + 1):
        monkeypatch.setattr(conv, "_RENORM", renorm)
        got = conv._viterbi_plain(s, costs, big)
        assert torch.equal(got, want), renorm
    got = pack_bits(want[:, :n_bytes * 8]).numpy()
    np.testing.assert_array_equal(got[0], data[0])
    assert not want[:, -(conv._params(s).K - 1):].any()      # flush zeros


@pytest.mark.parametrize("name", [fec.fec_name(s) for s in CONV])
def test_butterflies_pack_the_trellis(name):
    """Each butterfly word holds the pattern ids of its four branches."""
    s = fec.fec_from_name(name)
    pid, _, _ = conv._trellis(s)
    w = conv._butterflies(s).astype(np.int64)
    S = len(w) * 2
    assert len(pid) == 2 * S
    got = np.stack([(w >> (8 * j)) & 255 for j in range(4)], axis=-1)
    sp = np.arange(S // 2)
    want = np.stack([pid[2 * sp], pid[2 * sp + 1], pid[2 * (sp + S // 2)],
                     pid[2 * (sp + S // 2) + 1]], axis=-1)
    np.testing.assert_array_equal(got, want)
    assert want.max() < 1 << len(conv._params(s).polys)


def test_cpu_runs_the_plain_version_and_launches_nothing():
    s = fec.FEC_CONV_V27
    costs, big, _ = _costs(s, False, 20, _rng("cpu dispatch"))
    kernels.reset_launch_counts()
    profiling.counters.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = conv._viterbi(s, costs, big)
    assert torch.equal(got, conv._viterbi_plain(s, costs, big))
    assert kernels.launches["viterbi"] == 0
    assert profiling.counters == {"viterbi_steps": 20 * 8 + 6}
    profiling.counters.clear()
    with pytest.raises(RuntimeError):
        conv._viterbi(s, costs.to("meta"), big)
