"""Multi-process launch helpers over ``torch.distributed``.

Port of ``liquid_usrp_tpu/parallel/distributed.py``.  One process (rank)
drives one device.  :func:`init` forms the process group from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``: the counterparts of ``JAX_PROCESS_ID``,
``JAX_NUM_PROCESSES`` and ``JAX_COORDINATOR_ADDRESS``) or from its
arguments, then the ``(time, channel)`` mesh is built over the ranks:

    from liquid_usrp_tpu_torch.parallel import distributed, mesh, stream
    distributed.init()                       # torchrun's environment
    m = mesh.make_sdr_mesh()                 # every rank of the world
    run = stream.sharded_mcrx(m, num_channels, sync, blocks)
    res = run(stream.shard_for(m, mixture, run.in_spec))

The backend follows the hardware, chosen up front: NCCL when each rank has
a card of its own, gloo for ranks on the CPU or ranks that share a card
(their collectives go through pinned host copies).  Nothing falls back:
a backend that fails to form raises.

:func:`spawn` runs a world on this host in spawned processes that meet
through a ``file://`` rendezvous: the counterpart of the JAX package's
virtual CPU devices and of its two-process test.

JAX's TPU pod auto-discovery branch has no counterpart: a torch world
always learns its size and rank from its launcher.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ..utils.device import DEVICE_ENV

__all__ = ["init", "is_distributed", "local_info", "local_device",
           "spawn", "RankTraceback"]

DEFAULT_TIMEOUT_S = 600.0


def _placement(rank=None, world_size=None) -> tuple[int, int]:
    """(local rank, ranks on this host): torchrun's ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE``, else the global rank and world (one host)."""
    if rank is None:
        rank = (dist.get_rank() if dist.is_initialized()
                else int(os.environ.get("RANK", 0)))
    if world_size is None:
        world_size = (dist.get_world_size() if dist.is_initialized()
                      else int(os.environ.get("WORLD_SIZE", 1)))
    return (int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", world_size)))


def local_device(device=None, *, rank=None, world_size=None
                 ) -> torch.device:
    """This rank's device: ``device`` when given, else
    ``$LIQUID_USRP_TORCH_DEVICE`` when set, else ``cuda:{LOCAL_RANK}`` when
    the host has a card per rank and ``cuda:{LOCAL_RANK % cards}`` when its
    ranks share cards (``cuda:0`` on a one-card host).  Without a card it
    raises: the CPU is used only when asked for."""
    if device is None:
        device = os.environ.get(DEVICE_ENV) or None
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            f"device='cpu' or set {DEVICE_ENV}=cpu to run on the CPU")
    local_rank, local_world = _placement(rank, world_size)
    cards = torch.cuda.device_count()
    return torch.device("cuda", local_rank if local_world <= cards
                        else local_rank % cards)


def _backend_for(device: torch.device, local_world: int) -> str:
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init(backend: str | None = None, init_method: str | None = None,
         world_size: int | None = None, rank: int | None = None,
         device=None) -> None:
    """Form the default process group (idempotent; torchrun's environment
    fills what the arguments leave out).

    Without a world size (argument or ``WORLD_SIZE``) and without
    ``init_method`` this is a plain single process and nothing forms; a
    later call with arguments still can, as in JAX, which latches only once
    a group formed.  ``backend=None`` takes NCCL when each rank on this host
    has a card, else gloo; asking for NCCL on ranks that share a card
    raises.  ``device`` is this rank's device as :func:`local_device`
    resolves it (the CPU only when asked); a CUDA device becomes the
    process's current device."""
    if dist.is_initialized():
        return
    if world_size is None and os.environ.get("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    if world_size is None and init_method is None:
        return
    dev = local_device(device, rank=rank, world_size=world_size)
    chosen = _backend_for(dev, _placement(rank, world_size)[1])
    if backend is None:
        backend = chosen
    elif backend == "nccl" and chosen != "nccl":
        raise ValueError(f"NCCL needs a card per rank; rank device {dev} "
                         f"is shared or not a card: use gloo")
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev    # communicators formed eagerly
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, **kwargs)


def is_distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def local_info() -> dict:
    """JAX's keys; one device per process."""
    on = dist.is_initialized()
    world = dist.get_world_size() if on else 1
    return {
        "process_index": dist.get_rank() if on else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
    }


# ---------------------------------------------------------------------------
# local launcher
# ---------------------------------------------------------------------------

class RankTraceback(Exception):
    """The traceback of a rank's error, raised as its ``__cause__``."""


def _error_payload(exc: BaseException) -> bytes:
    tb = traceback.format_exc()
    try:
        return pickle.dumps((exc, tb))
    except (pickle.PicklingError, TypeError, AttributeError):
        # an exception that does not pickle travels as its text
        return pickle.dumps((RuntimeError(repr(exc)), tb))


def _rank_main(fn, rank, world_size, init_method, backend, device, args,
               results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world_size))
    torch.set_num_threads(1)
    try:
        init(backend=backend, init_method=init_method,
             world_size=world_size, rank=rank, device=device)
        out = pickle.dumps(fn(rank, *args))
    except Exception as exc:  # noqa: BLE001 — the parent raises it
        results.put((rank, False, _error_payload(exc)))
    else:
        results.put((rank, True, out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, *args, backend: str | None = None,
          device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes that form
    one world through a ``file://`` rendezvous under a fresh temporary
    directory (parallel test workers never share a port), with torchrun's
    environment variables set and one intra-op thread each, as torchrun
    sets ``OMP_NUM_THREADS=1``.  ``backend`` and ``device`` go to
    :func:`init`.

    Returns the ranks' return values in rank order (they must pickle).  The
    first rank error to arrive is raised here, its traceback as the cause;
    a rank that dies without reporting raises ``RuntimeError``.  Every rank
    is killed once one fails or ``timeout_s`` passes (``TimeoutError``).
    ``fn`` must be importable by name: a spawned child imports its
    module."""
    ctx = mp.get_context("spawn")
    rdzv = tempfile.mkdtemp(prefix="liquid_usrp_rdzv_")
    init_method = "file://" + os.path.join(rdzv, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, rank, world_size, init_method, backend, device, args, results))
        for rank in range(world_size)]
    done: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(done) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = [r for r in range(world_size) if r not in done]
                raise TimeoutError(f"spawn: ranks {missing} did not finish "
                                   f"within {timeout_s} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in done and p.exitcode not in (None, 0):
                        raise RuntimeError(f"rank {r} exited with code "
                                           f"{p.exitcode} before it reported")
                continue
            if not ok:
                exc, tb = pickle.loads(out)
                raise exc from RankTraceback(f"rank {rank}:\n{tb}")
            done[rank] = pickle.loads(out)
        return [done[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive() and len(done) < world_size:
                p.kill()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(rdzv, ignore_errors=True)
