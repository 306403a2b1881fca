"""One run of one cell: set-up, the measured (or traced) window, and the
comparison with the reference that decides ``correct``."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from . import manifest, profiling, reference, txgen

CHECKED_FRAMES = 512           # frames whose estimates the reference redoes


class Clock:
    """When each dispatch was handed to the program, and when its frames
    were on the host."""

    def __init__(self):
        self.calls: list = []
        self.dones: list = []

    def called(self):
        self.calls.append(time.perf_counter())

    def done(self):
        self.dones.append(time.perf_counter())

    def latencies_ms(self) -> np.ndarray:
        n = len(self.dones)
        return (np.array(self.dones) - np.array(self.calls[:n])) * 1e3


def _buffers(inputs: list, count=None, deadline=None):
    """The loop's buffers in order, from its first, until ``count`` were
    handed over or the clock passed ``deadline``."""
    k = 0
    while (count is None or k < count) and \
            (deadline is None or time.perf_counter() < deadline):
        yield inputs[k % len(inputs)]
        k += 1


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, ingest: str = "c64", log=print,
             count: int | None = None, world=None) -> dict | None:
    """Run ``cell`` (from :func:`manifest.cell`) once: the result object,
    with the numbers compared, each beside its limit, under ``checks``.
    ``count`` replaces the clock by a number of dispatches (the CPU
    rehearsals).  ``world`` (:class:`ranks.World`) makes this one rank of
    a cell on several cards; a rank other than 0 returns ``None``."""
    config, traffic = cell["config"], cell["traffic"]
    stream = txgen.make_stream(config, traffic, seed, device)
    if world is not None:
        world.check_stream(stream)
    entry = manifest.entry_class(config)(config, device, ingest)
    inputs = [entry.host_input(c) for c in stream.chunks]
    entry.run(iter(inputs[:config["warm_dispatches"]]), Clock())
    entry.reset()
    _sync(device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if world is not None:
        world.end_setup()
    setup_s = time.perf_counter() - t_start

    clock = Clock()
    tr = None
    host = ""
    if trace:
        K = int(traffic["traced_dispatches"])
        tr = profiling.profile_window(
            lambda: entry.run(_buffers(inputs, count=K), clock), K)
        window_s = tr.seconds
        if world is not None:
            world.end_window()
    else:
        t0, cpu0 = time.perf_counter(), time.thread_time()
        buffers = _buffers if world is None else world.buffers
        entry.run(buffers(inputs, count=count,
                          deadline=None if count else t0 + seconds), clock)
        _sync(device)
        if world is not None:
            world.end_window()
        window_s = time.perf_counter() - t0
        host = (f" (the loop's thread on a host core "
                f"{time.thread_time() - cpu0:.6f} s)")
    dispatches = len(clock.dones)
    blocks = dispatches * entry.blocks_per_dispatch
    samples = dispatches * entry.dispatch_samples
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    rows = entry.rows()
    del entry, inputs
    if world is not None:
        world.dispatches, world.peak = dispatches, int(peak)
        if world.rank:
            log(f"window: {dispatches} dispatches")
            return None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    attempted, missed, wrong, extra, ok_rows = reference.match(
        rows, stream, config, traffic, blocks)
    rng = np.random.default_rng([seed % (1 << 64), 1])
    sample = np.sort(rng.choice(np.asarray(ok_rows, np.int64),
                                min(CHECKED_FRAMES, len(ok_rows)),
                                replace=False)) if ok_rows else \
        np.zeros(0, np.int64)
    rssi_gap, cfo_gap, clamped = reference.estimate_gaps(
        rows, sample, np.concatenate(stream.chunks), config)
    lim = config["limits"]
    checks = {"frames_missed": (missed, 0), "frames_wrong": (wrong, 0),
              "reports_extra": (extra, lim["reports_extra"]),
              "rssi_gap_db": (rssi_gap, lim["rssi_gap_db"]),
              "cfo_gap": (cfo_gap, lim["cfo_gap"])}
    correct = attempted > 0 and all(
        np.isfinite(v) and v <= limit for v, limit in checks.values())

    lat = clock.latencies_ms()
    log(f"window: {dispatches} dispatches in {window_s:.6f} s{host}; "
        f"latency ms p50 {np.percentile(lat, 50):.3f} "
        f"p95 {np.percentile(lat, 95):.3f} max {lat.max():.3f}; "
        f"frames due {attempted}, reported {len(rows['t'])}, "
        f"checked {len(sample)} ({clamped} from a clamped window)")
    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            v = cell["readers"][m["name"]].read(tr, cell)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"rx_msps": samples / window_s / 1e6,
                  "result_ms_p95": float(np.percentile(lat, 95)),
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(missed + wrong), "metrics": metrics,
           "device": device_info}
    if trace:
        device_info.update(busy_s=profiling.busy_seconds(tr),
                           window_s=tr.seconds)
        out["breakdown"] = profiling.breakdown(tr)
    out["checks"] = {k: {"value": float(v), "limit": float(limit)}
                     for k, (v, limit) in checks.items()}
    return out

