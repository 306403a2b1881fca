"""The per-layer readers and the trace arithmetic, on recorded events."""
from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

from rxbench import manifest, profiling, txgen
from rxbench.metrics import (detect_roofline_pct, device_idle_pct,
                             host_syncs_per_dispatch, kernels_per_dispatch)
from rxbench.profiling import Op, Trace

B1 = "void xcorr_metric_kernel<0>(float2 const*, int, int, float*)"


def _trace():
    """A 1,000 us window of two dispatches: device busy 250 us."""
    dev = [Op(B1, 100, 112), Op("void fft_kernel", 110, 200),
           Op("Memcpy HtoD (Pinned -> Device)", 300, 350),
           Op("void argmin_kernel", 600, 700)]
    host = [Op("cudaLaunchKernel", 90, 95), Op("aten::nonzero", 150, 320),
            Op("cudaStreamSynchronize", 200, 300),
            Op("cudaMemcpyAsync", 340, 345), Op("cudaStreamSynchronize",
                                                345, 360),
            Op("cudaDeviceSynchronize", 700, 1000)]
    return Trace(0.0, 1000.0, 2, dev, host)


def test_union_and_idle_share():
    tr = _trace()
    assert profiling.union(tr.device) == [[100, 200], [300, 350],
                                          [600, 700]]
    assert profiling.busy_seconds(tr) == pytest.approx(250e-6)
    assert device_idle_pct.read(tr, None) == pytest.approx(75.0)
    assert device_idle_pct.read(tr._replace(device=[]), None) is None


def test_kernels_and_syncs_per_dispatch():
    tr = _trace()
    assert kernels_per_dispatch.read(tr, None) == 1.5    # copies are not
    assert host_syncs_per_dispatch.read(tr, None) == 1.5
    # no runtime call recorded at all: nothing to read
    bare = tr._replace(host=[Op("aten::nonzero", 0, 10)])
    assert host_syncs_per_dispatch.read(bare, None) is None


def test_detect_roofline_share():
    cell = manifest.cell("mcrx4.loaded")
    least = detect_roofline_pct.least_seconds(cell["config"])
    assert detect_roofline_pct.read(_trace(), cell) == pytest.approx(
        100 * least / 12e-6)
    assert detect_roofline_pct.read(
        _trace()._replace(device=[Op("void fft_kernel", 0, 5)]),
        cell) is None


def test_detect_work_at_the_multichannel_step():
    # B1 on 8 windows of 87,310 samples reaches the first 65,633 + 95 of
    # each: 6.31 MB (not the 7.69 MB of PERF.md's B1 row, which counts the
    # whole window), 72.5 MFLOP, 1.88 us by bytes
    c = manifest.cell("mcrx4.loaded")["config"]
    assert txgen.receiver_overlap(c) + c["block_size"] == 87310
    p = txgen.ofdm_params(48, 6, 4)
    nbytes, flops = profiling.xcorr_work(8, 65536 + 97,
                                         np.tile(p.s0_time, 2), 24)
    assert nbytes == 8 * (65633 + 95) * 8 + 96 * 8 + 8 * 65633 * 4
    assert flops / 1e6 == pytest.approx(72.5, abs=0.05)
    t, what = profiling.bound(nbytes, flops)
    assert (round(t * 1e6, 2), what) == (1.88, "bytes")
    assert profiling.template_period(np.tile(p.s0_time, 2)) == 12
    assert detect_roofline_pct.least_seconds(c) == t
    # the single-channel dispatch: 8 windows of 100,366 samples, of which
    # the metric reaches 16,481 + 95
    s = manifest.cell("ofdm1_conv.v27")["config"]
    assert txgen.receiver_overlap(s) + s["block_size"] == 100366
    t, what = profiling.bound(*profiling.xcorr_work(
        8, 16384 + 97, np.tile(p.s0_time, 2), 24))
    assert (round(t * 1e6, 3), what) == (0.474, "bytes")
    assert detect_roofline_pct.least_seconds(s) == t


def test_breakdown_names_the_host_operation_under_each_gap():
    bd = profiling.breakdown(_trace())
    assert bd["device_ops"][0] == ["void argmin_kernel", pytest.approx(1e-4)]
    gaps = dict(bd["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(100e-6)
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(300e-6)
    assert gaps["(no host operation)"] == pytest.approx(350e-6)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


class _Record:
    """A raw profiler record, as ``kineto_results.events()`` gives it."""

    def __init__(self, name, start, end, device=DeviceType.CPU):
        self._v = (name, device, int(start * 1000), int((end - start) * 1000))

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]


def test_collect_clips_to_the_window():
    events = [_Record("spin_kernel", 0, 50, DeviceType.CUDA),
              _Record(profiling.WINDOW, 60, 160),
              _Record(profiling.WINDOW, 65, 150, DeviceType.CUDA),
              _Record(B1, 55, 70, DeviceType.CUDA),
              _Record("cudaStreamSynchronize", 150, 170),
              _Record("late", 170, 180, DeviceType.CUDA)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    tr = profiling.collect(prof, 1)
    assert (tr.start, tr.end, tr.seconds) == (60, 160, pytest.approx(1e-4))
    assert tr.device == [Op(B1, 60, 70)]
    assert tr.host == [Op("cudaStreamSynchronize", 150, 160)]


def test_breakdown_is_a_sweep():
    """Many gaps and host operations: the sweep labels each gap with the
    shortest operation spanning its middle, as a direct search does."""
    rng = np.random.default_rng(3)
    starts = np.sort(rng.uniform(0, 1e5, 3000))
    dev = [Op("k", a, a + rng.uniform(1, 20)) for a in starts]
    host = [Op(f"h{i % 7}", a, a + rng.uniform(1, 400))
            for i, a in enumerate(rng.uniform(0, 1e5, 3000))]
    tr = Trace(0.0, 1.1e5, 1, dev, host)
    gaps: dict = {}
    edges = [tr.start] + [x for iv in profiling.union(dev) for x in iv] + \
        [tr.end]
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        under = [o for o in host if o.start <= mid < o.end]
        name = (min(under, key=lambda o: (o.end - o.start, o.end)).name
                if under else "(no host operation)")
        gaps[name] = gaps.get(name, 0.0) + (e - s) * 1e-6
    got = dict(profiling.breakdown(tr)["idle_gaps"])
    assert got == pytest.approx(gaps)
