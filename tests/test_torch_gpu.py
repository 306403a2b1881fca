"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.)
Tolerances: B1 max abs difference <= 1e-4; B2 ``detected`` equal, ``vals``
atol 1e-4, the same set of detected offsets per row, and ``c_at`` within
1e-4 of ``|c|`` of the plain lag correlation at the kernel's offsets.  B3
vs :func:`kernels.autocorr_metric` (float64 window sums): metric max abs
difference <= 1e-4, ``c`` within 1e-4 of max ``|c|``.  B4/B5 vs
:func:`kernels.autocorr_metric_prefix` (the same float32 prefix sums):
metric <= 1e-5, ``c`` within 1e-5 of max ``|c|``.
"""
import numpy as np
import pytest
import torch

from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
from liquid_usrp_tpu_torch.ops import kernels


@pytest.fixture(scope="module")
def loaded_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params = ofdm.make_ofdm_params(48, 6, 4)
    sync = ofdm_sync.make_sync(params, block_size=4096, max_payload=128,
                               max_frames=8)
    rng = np.random.default_rng(0)
    ext = np.zeros((3, sync.overlap + sync.block_size), np.complex64)
    for row, pos in ((0, 2000), (1, 700), (2, 3900)):
        frame = ofdm.assemble_frame(
            params, ofdm.default_props(),
            torch.as_tensor(rng.integers(0, 256, 8, dtype=np.uint8)),
            torch.as_tensor(rng.integers(0, 256, 64, dtype=np.uint8)))
        ext[row, pos:pos + len(frame)] = frame.numpy()
    ext += (0.02 * (rng.normal(size=ext.shape) +
                    1j * rng.normal(size=ext.shape))).astype(np.complex64)
    return params, sync, torch.as_tensor(ext).cuda()


@pytest.mark.gpu
def test_b1_kernel_matches_plain(loaded_cuda):
    params, sync, x = loaded_cuda
    tmpl = np.tile(params.s0_time, ofdm.NUM_S0)
    n = sync.block_size + 2 * params.M + 1
    kernels.reset_launch_counts()
    got = kernels.detect_metric_xcorr_onepass(x, tmpl, 24, n)
    torch.cuda.synchronize()
    ref = kernels.detect_metric_xcorr_plain(x, tmpl, 24, n)
    assert float((got - ref).abs().max()) <= 1e-4
    assert kernels.launches["detect_metric_xcorr_onepass"] == 1


@pytest.mark.gpu
def test_b2_kernel_matches_plain(loaded_cuda):
    params, sync, x = loaded_cuda
    M = params.M
    kernels.reset_launch_counts()
    v, loc, c = kernels.detect_candidates_onepass(
        x, M // 4, 2 * M - M // 4, M, sync.block_size, 0.5, 8)
    torch.cuda.synchronize()
    vr, lr, _ = kernels.detect_candidates_plain(
        x, M // 4, 2 * M - M // 4, M, sync.block_size, 0.5, 8)
    _, c_full = kernels.autocorr_metric(x, M // 4, 2 * M - M // 4)
    assert torch.equal(v > 0, vr > 0)
    assert bool((v > 0).any())
    assert float((v - vr).abs().max()) <= 1e-4
    for row in range(x.shape[0]):
        assert sorted(loc[row][v[row] > 0].tolist()) == \
            sorted(lr[row][vr[row] > 0].tolist())
    det = v > 0
    c_ref = torch.gather(c_full, -1, loc.to(torch.int64))[det]
    assert float(((c[det] - c_ref).abs() / c_ref.abs()).max()) <= 1e-4
    assert kernels.launches["detect_candidates_onepass"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("name,plain,limit", [
    ("detect_metric_onepass", "autocorr_metric", 1e-4),
    ("detect_metric_fused_2d", "autocorr_metric_prefix", 1e-5),
    ("detect_metric_fused", "autocorr_metric_prefix", 1e-5)])
def test_autocorr_kernels_match_plain(loaded_cuda, name, plain, limit):
    params, _, x = loaded_cuda
    lag = params.M // 4
    span = ofdm.NUM_S0 * params.M - lag
    kernels.reset_launch_counts()
    m, c = getattr(kernels, name)(x, lag, span)
    torch.cuda.synchronize()
    mr, cr = getattr(kernels, plain)(x, lag, span)
    assert m.shape == c.shape == mr.shape == (x.shape[0], x.shape[1] - span
                                              - lag + 1)
    assert float(mr.max()) > 0.5                  # the frames are there
    assert float((m - mr).abs().max()) <= limit
    assert float((c - cr).abs().max()) <= limit * float(cr.abs().max())
    assert kernels.launches[name] == 1
