"""The traced window: the profiler, the events it records, the device's
busy time and idle gaps, and the roofline arithmetic.

``open_window``, ``bound``, the detect stage's ``work`` and the published
peaks are copied from ``chip_smoke.py`` (``template_period`` from the
port's ``ops/kernels.py``), so that the yardstick lives with the
benchmark.
"""
from __future__ import annotations

import heapq
from typing import NamedTuple

import numpy as np
import torch

# the H100 SXM's published peaks (NVIDIA's H100 datasheet): HBM bytes/s
# and float32 FLOP/s outside the tensor cores, at a 700 W limit
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
SPIN_CYCLES = 1_000_000        # each spin kernel opening a window
SPIN_OPEN = 16                 # spin kernels opening each profiler window
WINDOW = "rxbench.window"      # the record_function around the window
NAME_CHARS = 160               # of an operation's name in the breakdown
# host calls that block until the device has finished earlier work
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D")


class Op(NamedTuple):
    name: str
    start: float               # microseconds, the profiler's clock
    end: float


class Trace(NamedTuple):
    """What the profiler saw of the window: its span, the device's
    operations (kernels, copies, sets) and the host's operations, each
    clipped to the window, and the dispatches the window ran."""
    start: float
    end: float
    dispatches: int
    device: list
    host: list

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-6


def open_window():
    """Open a profiler window with ``SPIN_OPEN`` spin kernels
    (``torch.cuda._sleep``): the profiler can lose the records of a
    window's first launches, and those losses fall on these kernels."""
    for _ in range(SPIN_OPEN):
        torch.cuda._sleep(SPIN_CYCLES)


def collect(prof, dispatches: int) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile`` whose
    window ran inside ``record_function(WINDOW)``, read from the
    profiler's raw records (a dispatch can launch tens of thousands of
    kernels)."""
    from torch.autograd import DeviceType
    events = [(e.name(), e.device_type(), e.start_ns() * 1e-3,
               (e.start_ns() + e.duration_ns()) * 1e-3)
              for e in prof.profiler.kineto_results.events()]
    # the host's range; the profiler also marks it on the device's timeline
    win = [e for e in events if e[0] == WINDOW and e[1] == DeviceType.CPU]
    if len(win) != 1:
        raise RuntimeError(f"profiler saw {len(win)} windows")
    t0, t1 = win[0][2], win[0][3]
    dev, host = [], []
    for name, kind, s, t in events:
        if name == WINDOW or t <= t0 or s >= t1:
            continue
        op = Op(name, max(s, t0), min(t, t1))
        (dev if kind == DeviceType.CUDA else host).append(op)
    return Trace(t0, t1, dispatches, dev, host)


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def union(ops) -> list:
    """Disjoint ``[start, end)`` intervals covering ``ops``."""
    out = []
    for s, e in sorted((o.start, o.end) for o in ops):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(trace: Trace) -> float:
    return sum(e - s for s, e in union(trace.device)) * 1e-6


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time by the host operation under it: the shortest host operation that
    spans the middle of each gap (one sweep over the gaps in order)."""
    by_name: dict = {}
    for o in trace.device:
        by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start) * 1e-6
    edges = [trace.start] + [x for iv in union(trace.device) for x in iv] + \
        [trace.end]
    host = sorted(trace.host, key=lambda o: o.start)
    active: list = []            # (duration, end, name) of started ops
    gaps: dict = {}
    i = 0
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        while i < len(host) and host[i].start <= mid:
            o = host[i]
            heapq.heappush(active, (o.end - o.start, o.end, o.name))
            i += 1
        while active and active[0][1] <= mid:
            heapq.heappop(active)
        # the top is now the shortest operation that has not ended: an
        # ended one shorter than it would have been popped
        name = active[0][2] if active else "(no host operation)"
        gaps[name] = gaps.get(name, 0.0) + (e - s) * 1e-6
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": [[k[:NAME_CHARS], v] for k, v in order(by_name)],
            "idle_gaps": [[k[:NAME_CHARS], v] for k, v in order(gaps)]}


def profile_window(run, dispatches: int) -> Trace:
    """Trace ``run()``, which runs ``dispatches`` whole dispatches."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        open_window()
        torch.cuda.synchronize()
        with record_function(WINDOW):
            run()
            torch.cuda.synchronize()
    return collect(prof, dispatches)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

def bound(nbytes: float, flops: float):
    """(least seconds, what sets it): the bytes over the HBM rate, or the
    float32 operations over the float32 peak."""
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_F32
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def template_period(tmpl: np.ndarray) -> int:
    """The smallest p < len(tmpl) with ``tmpl[i + p] == tmpl[i]``
    everywhere (exactly), or 0."""
    t = np.asarray(tmpl)
    for p in np.nonzero(t[1:] == t[0])[0] + 1:
        if np.array_equal(t[p:], t[:-p]):
            return int(p)
    return 0


def xcorr_work(rows: int, n_metric: int, tmpl: np.ndarray, span: int):
    """(bytes, float32 operations) of the segmented S0 cross-correlation
    metric at ``n_metric`` offsets of each of ``rows`` windows: the
    ``n_metric + len(tmpl) - 1`` samples of a window that the metric
    reaches and the template read once, the metric written once.  With a
    template of period p, the
    product of tap k and sample i depends on (i, (i - k) mod p) only, so
    each of the p residue classes of outputs takes one product sequence
    (6 a product) and its running span-window sums (4 a sample), over the
    samples its outputs reach; where the span divides p, the span-window
    sums are sums of non-overlapping blocks of those products (8 a
    product); where p divides the span, one p-tap correlation per sample
    (8 per complex tap) serves every segment; the least of these and 8
    per tap of every segment (the direct form); then per segment |u|^2,
    the energy scale, the divide, the floor gate and the sum, and per
    sample |x|^2, a running span-window power sum and the mean."""
    n = n_metric
    n_tap, p = len(tmpl), template_period(tmpl)
    n_seg = n_tap // span
    corr = 8 * n_tap * n
    if p:
        prods = p * n + min(p, n) * (n_tap - p)
        corr = min(corr, (8 if p % span == 0 else 10) * prods)
    if p and span % p == 0:
        corr = min(corr, n * (8 * p + n_seg * 2 * (span // p - 1)))
    return (rows * (n + n_tap - 1) * 8 + n_tap * 8 + rows * n * 4,
            rows * (corr + n * (7 * n_seg + 6)))
