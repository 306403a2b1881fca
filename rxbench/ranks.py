"""A cell with ``chips`` = k > 1: k spawned processes, rank r on ``cuda:r``.

:func:`launch` starts the ranks, forms their world through a ``file://``
rendezvous in a fresh temporary directory (NCCL, each rank's card as its
``device_id``, and a gloo group beside it for the host's own agreements),
runs :func:`harness.run_cell` in every rank with a :class:`World`, and
puts the ranks' readings together into one result.  The benchmark keeps
its own launcher so that no change to the program changes how a cell is
launched or counted.

What a rank adds to a one-card run (``harness.run_cell`` with ``world``):

- set-up: every rank makes the stream from the seed on its own card, and
  the sha256 of its host chunks is gathered and held to rank 0's; a
  barrier on the host ends set-up after the warm-up;
- the window: rank 0's clock alone decides, before each buffer, whether
  another is handed over, and the decision reaches the other ranks over
  the gloo group (rank 0 does not wait for it to arrive), so every rank
  hands over the same number of buffers and no card is synchronised for
  it; the window ends when every rank has synchronised its card and met
  the others at a barrier.  A traced run profiles the same fixed number
  of dispatches on every rank;
- the result: rank 0 judges its entry's rows, and its clock and trace give
  the metrics; ``device.count`` counts the cards that ran every dispatch
  of rank 0's window and allocated memory, ``memory_peak_bytes`` is the
  fullest card's peak and ``memory_peak_bytes_each`` every rank's.

A rank that fails ends the run: its traceback is printed, every rank is
killed and no result is printed.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import queue
import shutil
import signal
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SETUP_LIMIT_S = 1200           # a first run in a checkout builds kernels
WINDOW_MARGIN_S = 120          # past the window's seconds, for any rank
RESULT_LIMIT_S = 240           # rank 0's comparison with the reference
JOIN_S = 30
PR_SET_PDEATHSIG = 1           # prctl(2)


class RankFailure(Exception):
    """The run ended without a result; ``code`` is the exit code."""

    def __init__(self, message: str, code: int = 1):
        super().__init__(message)
        self.code = code


class World:
    """One rank's view of the world: its rank, the world's size, the gloo
    group the host agreements use, and what it posts to the parent."""

    def __init__(self, rank: int, size: int, group, post):
        self.rank, self.size, self.group, self.post = rank, size, group, post
        self._pending: list = []    # rank 0's broadcasts in flight
        self.dispatches = 0         # this rank's window, set by run_cell
        self.peak = 0

    def check_stream(self, stream):
        """Raise unless every rank made rank 0's host chunks, bit for bit."""
        h = hashlib.sha256()
        for c in stream.chunks:
            h.update(memoryview(c).cast("B"))
        digests = [None] * self.size
        dist.all_gather_object(digests, h.hexdigest(), group=self.group)
        differ = [r for r, d in enumerate(digests) if d != digests[0]]
        if differ:
            raise RuntimeError(
                f"rank(s) {differ} made another stream than rank 0 from the "
                f"seed: sha256 {digests}")

    def end_setup(self):
        dist.barrier(group=self.group)
        self.post(("ready", self.rank, None))

    def buffers(self, inputs: list, count=None, deadline=None):
        """``harness._buffers`` with rank 0's decision on every rank."""
        k = 0
        while True:
            flag = torch.zeros(1, dtype=torch.int32)
            if self.rank == 0:
                flag[0] = (count is None or k < count) and \
                    (deadline is None or time.perf_counter() < deadline)
                self._pending.append(
                    dist.broadcast(flag, 0, group=self.group, async_op=True))
            else:
                dist.broadcast(flag, 0, group=self.group)
            if not flag[0]:
                return
            yield inputs[k % len(inputs)]
            k += 1

    def end_window(self):
        for w in self._pending:
            w.wait()
        self._pending = []
        dist.barrier(group=self.group)
        self.post(("window", self.rank, None))


def _kill(procs):
    for p in procs:
        if p.is_alive():
            try:                      # the rank and what it started
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                p.kill()


def rank_main(rank: int, cell: dict, seed: int, seconds: float, trace: bool,
              t_start: float, cuda: bool, count, init_method: str, posts):
    """One rank: its world, then :func:`harness.run_cell` with it.  The
    rank leads a process group of its own, so that a kill takes what it
    started with it, and dies with the parent."""
    os.setpgid(0, 0)
    ctypes.CDLL(None).prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    from rxbench import harness
    from rxbench.run import FORBIDDEN

    def log(*a):                  # one write a line: ranks share stderr
        sys.stderr.write(" ".join([f"[rank {rank}]", *map(str, a)]) + "\n")
        sys.stderr.flush()

    k = int(cell["workload"]["chips"])
    # each rank takes its share of the host's cores, as one card's run has
    # the cores of a one-card host
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // k))
    try:
        device = torch.device("cuda", rank) if cuda else torch.device("cpu")
        if cuda:
            torch.cuda.set_device(device)
            dist.init_process_group("nccl", init_method=init_method,
                                    world_size=k, rank=rank,
                                    device_id=device)
        else:
            dist.init_process_group("gloo", init_method=init_method,
                                    world_size=k, rank=rank)
        world = World(rank, k, dist.new_group(backend="gloo"), posts.put)
        cell = dict(cell, readers={m["name"]: importlib.import_module(
            f"rxbench.metrics.{m['name']}") for m in cell["per_layer"]})
        out = harness.run_cell(cell, seed, seconds, trace, device, t_start,
                               log=log, count=count, world=world)
        posts.put(("result", rank, {
            "out": out, "dispatches": world.dispatches,
            "peak": world.peak,
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "forbidden": sorted({m.split(".")[0] for m in sys.modules}
                                & FORBIDDEN)}))
    except Exception:  # noqa: BLE001 — the parent prints it and ends the run
        posts.put(("error", rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(cell: dict, seed: int, seconds: float, trace: bool,
           t_start: float, log=print, cuda: bool = True, count=None,
           target=rank_main) -> dict:
    """Run ``cell`` on ``cell["workload"]["chips"]`` ranks and return the
    result object; raise :class:`RankFailure` if a rank fails, a phase
    overruns its limit or the ranks' cards differ.  ``cuda=False`` runs a
    gloo world on the CPU and ``count`` a number of dispatches in place of
    the clock (the CPU tests, which also pass their own ``target``)."""
    k = int(cell["workload"]["chips"])
    ctx = mp.get_context("spawn")
    rdzv = tempfile.mkdtemp(prefix="rxbench_rdzv_")
    posts = ctx.Queue()
    bare = {key: v for key, v in cell.items() if key != "readers"}
    procs = [ctx.Process(target=target, daemon=True, args=(
        r, bare, seed, seconds, trace, t_start, cuda, count,
        "file://" + os.path.join(rdzv, "store"), posts)) for r in range(k)]
    seen: dict = {"ready": set(), "window": set(), "result": {}}
    limits = {"ready": SETUP_LIMIT_S,
              "window": (seconds if not trace else 0) + WINDOW_MARGIN_S,
              "result": RESULT_LIMIT_S}
    try:
        for p in procs:
            p.start()
        for phase in ("ready", "window", "result"):
            deadline = time.monotonic() + limits[phase]
            while len(seen[phase]) < k:
                if time.monotonic() > deadline:
                    missing = sorted(set(range(k)) - set(seen[phase]))
                    raise RankFailure(f"rank(s) {missing} did not reach "
                                      f"{phase} within {limits[phase]:g} s")
                try:
                    what, rank, body = posts.get(timeout=0.5)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode is not None
                            and r not in seen["result"]]
                    if dead and posts.empty():
                        raise RankFailure(
                            f"rank(s) {dead} exited (codes "
                            f"{[procs[r].exitcode for r in dead]}) before "
                            f"reporting a result") from None
                    continue
                if what == "error":
                    raise RankFailure(f"rank {rank} failed:\n{body}")
                if what == "result":
                    seen["result"][rank] = body
                else:
                    seen[what].add(rank)
        for p in procs:
            p.join(JOIN_S)
    finally:
        _kill(procs)
        for p in procs:
            p.join()
        posts.close()
        shutil.rmtree(rdzv, ignore_errors=True)
    return _merge([seen["result"][r] for r in range(k)], log)


def _merge(results: list, log) -> dict:
    """Rank 0's result object, with the cards every rank used."""
    found = {r: x["forbidden"] for r, x in enumerate(results)
             if x["forbidden"]}
    if found:
        raise RankFailure(f"imported in the ranks: {found}", code=3)
    kinds = [x["kind"] for x in results]
    if len(set(kinds)) > 1:
        raise RankFailure(f"the ranks' cards differ: {kinds}")
    runs = [x["dispatches"] for x in results]
    peaks = [x["peak"] for x in results]
    cpu = kinds[0] == "cpu"
    log(f"ranks: dispatches {runs}, memory peaks {peaks} B")
    out = results[0]["out"]
    dev = out["device"]
    out["device"] = {
        "platform": dev["platform"], "kind": kinds[0],
        "count": sum(n == runs[0] and (cpu or peak > 0)
                     for n, peak in zip(runs, peaks)),
        "memory_peak_bytes": max(peaks), "memory_peak_bytes_each": peaks,
        **{key: dev[key] for key in ("busy_s", "window_s") if key in dev}}
    return out
