"""The all-to-all sharded receiver as a streaming step
(``parallel/stream.py::make_sharded_mcrx_a2a_step``) on a 2x2 ``('time',
'channel')`` gloo world of four spawned CPU processes, and the benchmark's
four-card cell ``mcrx16.shard4`` at a tiny size through its own launcher.

The step is held to the one-shot ``make_sharded_mcrx_a2a(..., n_steps=4)``
over the same stream, exactly, and to the one-card
``make_mcrx_batched_step``: every integer and bool field of the detected
rows exact, ``rssi`` and ``cfo`` within the benchmark's 2e-4 dB and 1e-6
rad/sample, which the step fed bfloat16 planes does not meet.  Its trace
holds one ``rx.exchange`` span a collective and ``exchange_bytes`` the
bytes each rank sends.  The tiny cell is correct against
``rxbench/reference.py``, and not with either of two planted faults.
"""
import multiprocessing
import time

import numpy as np
import pytest
import torch

from liquid_usrp_tpu_torch.framing import ofdm as tofdm
from liquid_usrp_tpu_torch.framing import ofdm_sync
from liquid_usrp_tpu_torch.models.multichannel import (make_mcrx_batched_step,
                                                       make_mctx_step)
from liquid_usrp_tpu_torch.parallel import distributed
from rxbench import manifest, ranks
from rxbench.metrics import exchange_roofline_pct

import torch_parallel_ranks as rank_fns

N = 4
BS = 2048                     # block_size: a fine chunk of one block
SYNC = dict(block_size=BS, max_payload=64, max_frames=4, use_pallas=1)
CFG = {"N": N, "sync": SYNC}
K = 4                         # dispatches
DISPATCH = 2 * N * BS * 4     # mixture samples a dispatch: 4 ranks
PER_CH = 4 * BS               # channel samples a dispatch
N_LOC, ROWS = N // 2, 2 * SYNC["max_frames"]
RSSI_DB, CFO = 2e-4, 1e-6     # the benchmark's limits (mcrx4_m48.json)
SPAWN_TIMEOUT_S = 300


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs, as in each rank:
    the suite runs in several processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _mixture(seed=11):
    """K dispatches of the 4-channel mixture, a 64-byte frame on every
    channel across each dispatch edge and between them: ``([K,
    DISPATCH] complex64, {(ch, position): payload})``."""
    params = tofdm.make_ofdm_params(48, 6, 4)
    flen = tofdm.frame_length(params, tofdm.default_props(), 48)
    rng = np.random.default_rng(seed)
    total = K * PER_CH
    streams = np.zeros((N, total), np.complex64)
    sent = {}
    for ch in range(N):
        edges = [e * PER_CH - flen // 2 for e in range(1, K)]
        for pos in [300 + 37 * ch, 11000 + 50 * ch, 19000, 28000] + edges:
            h = rng.integers(0, 256, 8, dtype=np.uint8)
            p = rng.integers(0, 256, 48, dtype=np.uint8)
            w = tofdm.assemble_frame(params, tofdm.default_props(),
                                     torch.as_tensor(h),
                                     torch.as_tensor(p)).numpy()
            streams[ch, pos:pos + len(w)] = w
            sent[(ch, pos)] = p
    init, step = make_mctx_step(N, "cpu")
    st, out = init(), []
    for lo in range(0, total, 4096):
        Y = np.zeros((4096, 2 * N), np.complex64)
        Y[:, :N] = streams[:, lo:lo + 4096].T
        st, y = step(st, torch.as_tensor(Y))
        out.append(y.numpy())
    mix = np.concatenate(out)
    mix = (mix + 0.002 * (rng.normal(size=mix.shape) + 1j *
                          rng.normal(size=mix.shape))).astype(np.complex64)
    return mix.reshape(K, DISPATCH), sent


@pytest.fixture(scope="module")
def inputs():
    return _mixture()


@pytest.fixture(scope="module")
def world(inputs):
    """Every rank's outputs of the 2x2 world."""
    return distributed.spawn(rank_fns.sharded_step, 4, CFG, list(inputs[0]),
                             device="cpu", timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def one_card(inputs):
    """The one-card ``make_mcrx_batched_step(N, sync, 4)`` over the same
    dispatches, rows ``[N, 4 * max_frames]`` a dispatch."""
    sync = ofdm_sync.make_sync(tofdm.make_ofdm_params(48, 6, 4), **SYNC)
    init, step = make_mcrx_batched_step(N, sync, 4, device="cpu")
    state, out = init(), []
    for d in inputs[0]:
        state, res = step(state, torch.as_tensor(d))
        out.append({f: v.reshape((N, -1) + v.shape[3:]).numpy()
                    for f, v in res._asdict().items()})
    return out


def _cat(dispatches):
    return {f: np.concatenate([d[f] for d in dispatches], axis=1)
            for f in dispatches[0]}


def _keyed(res):
    return {(int(ch), int(res["t_start"][ch, r])):
            {f: v[ch, r] for f, v in res.items()}
            for ch, r in zip(*np.nonzero(res["detected"]))}


EXACT = ("header_valid", "payload_valid", "payload_len", "mod", "fec0",
         "fec1", "check", "t_start", "header")


def _gaps(got, want):
    """Every integer and bool field of the detected rows exact; the
    largest |rssi| and |cfo| differences."""
    np.testing.assert_array_equal(got["detected"], want["detected"])
    g, w = _keyed(got), _keyed(want)
    rssi = cfo = 0.0
    for key in g:
        for f in EXACT:
            np.testing.assert_array_equal(g[key][f], w[key][f], err_msg=f)
        n = int(g[key]["payload_len"])
        np.testing.assert_array_equal(g[key]["payload"][:n],
                                      w[key]["payload"][:n])
        rssi = max(rssi, abs(float(g[key]["rssi"]) - float(w[key]["rssi"])))
        cfo = max(cfo, abs(float(g[key]["cfo"]) - float(w[key]["cfo"])))
    return rssi, cfo


def test_step_over_four_dispatches_equals_the_one_shot(world, inputs):
    """Frames across every dispatch edge: the carried filter memory, sync
    tails and super-step index make four calls give the one-shot
    ``n_steps=4`` rows, every field, bit for bit."""
    got, want = _cat(world[0]["step"]), world[0]["one_shot"]
    assert got.keys() == want.keys()
    for f in got:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    ok = got["detected"] & got["payload_valid"]
    decoded = {(int(c), bytes(got["payload"][c, r][:48]))
               for c, r in zip(*np.nonzero(ok))}
    assert decoded == {(c, p.tobytes()) for (c, _), p in inputs[1].items()}
    assert world[0]["state_step"] == K


def test_step_equals_the_one_card_step(world, one_card):
    rssi, cfo = _gaps(_cat(world[0]["step"]), _cat(one_card))
    assert rssi <= RSSI_DB and cfo <= CFO, (rssi, cfo)


def test_bf16_planes_miss_the_limits(world, one_card):
    """The tolerances tell a bfloat16 front end apart: the step fed
    bfloat16 planes (two dispatches) still decodes every frame, off in its
    estimates."""
    rssi, cfo = _gaps(_cat(world[0]["step_bf16"]), _cat(one_card[:2]))
    assert rssi > RSSI_DB or cfo > CFO, (rssi, cfo)


def test_results_on_rank_0_global_elsewhere_local(world):
    """Rank 0 gets ``[N, rows]`` leaves, the others their own channels'
    ``[N_loc, rows]``, all tensors on the rank's device; a chunk of the
    wrong size raises."""
    for r, out in enumerate(world):
        lead = (N, 2 * ROWS) if r == 0 else (N_LOC, ROWS)
        assert out["shapes"] == [lead + (SYNC["max_payload"],)] * K
        assert out["on_device"]
        assert out["in_spec"] == (("time", "channel"),)
        assert "the step expects" in out["bad_chunk"]


def _sent_by(rank, sync_overlap):
    """Bytes rank ``rank`` of the 2x2 world sends a step, by hand: the
    analysis-filter memory to the next fine chunk (2N x 4P complex64,
    P = 14), the other channel shard's half of its channelized samples,
    its sync tails to the next time row, and its results to the gather
    (rank 1 its own, rank 2 the two of its time row, rank 0 none)."""
    per_row = 3 + 8 + SYNC["max_payload"] + 9 * 4   # FrameResults' bytes
    results = N_LOC * ROWS * per_row
    gather = {0: 0, 1: results, 2: 2 * results, 3: results}[rank]
    return (2 * N * 4 * 14 * 8 + BS * N_LOC * 8 + N_LOC * sync_overlap * 8
            + gather)


def test_trace_spans_and_bytes(world):
    """The last step traced on each rank: one ``rx.exchange`` span a
    collective (the two halos, the all-to-all's launch and its wait, the
    gather), one ``rx.dispatch`` and one ``rx.front_end``; the counter
    holds the bytes sent, and the readers read them."""
    overlap = ofdm_sync.make_sync(tofdm.make_ofdm_params(48, 6, 4),
                                  **SYNC).overlap
    for r, out in enumerate(world):
        assert out["spans"] == {"rx.exchange": 5, "rx.dispatch": 1,
                                "rx.front_end": 1}
        if r:
            assert out["local_bytes"] == N_LOC * ROWS * (
                3 + 8 + SYNC["max_payload"] + 9 * 4)
        assert out["exchange_bytes"] == _sent_by(r, overlap)
        rd = out["readers"]
        assert rd["exchange_mbytes"] == _sent_by(r, overlap) / 1e6
        assert rd["exchange_host_ms"] > 0
        assert rd["exchange_roofline_pct"] is None     # no NCCL kernel


def test_roofline_bytes_at_the_cells_shapes():
    """What rank 0 must move a dispatch of ``mcrx16.shard4``: its 65,536
    channelized samples of the other shard's 8 channels, one sync overlap
    (21,774) of its 8 channels, one analysis-filter memory (32 x 56)."""
    config = manifest.cell("mcrx16.shard4")["config"]
    assert exchange_roofline_pct.least_bytes(config) == \
        65536 * 8 * 8 + 8 * 21774 * 8 + 32 * 56 * 8 == 5_602_176


def test_roofline_reads_nccl_kernels_only():
    """The device time of NCCL's kernels, not of the ``nccl:*`` ranges
    the profiler mirrors onto the card's timeline around them."""
    from rxbench.profiling import Op, Trace
    cell = manifest.cell("mcrx16.shard4")
    dev = [Op("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
              0, 40), Op("nccl:coalesced", 0, 45), Op("nccl:gather", 50, 70),
           Op("ncclKernel_Gather_RING_LL_Sum_int8_t", 50, 60),
           Op("void at::native::reduce_kernel", 70, 90)]
    least = exchange_roofline_pct.least_bytes(cell["config"]) / 450e9
    tr = Trace(0.0, 1000.0, 2, dev, [])
    assert exchange_roofline_pct.read(tr, cell) == \
        pytest.approx(100 * 2 * least / 50e-6)
    assert exchange_roofline_pct.read(tr._replace(device=dev[1:3]),
                                      cell) is None


def test_each_rank_takes_its_own_cores():
    """The entry's ranks split the host's cores into equal runs in order,
    none shared; a host with fewer cores than ranks pins nothing."""
    from rxbench.entries.mcrx_sharded import own_cores
    shares = [own_cores(r, 4, range(32)) for r in range(4)]
    assert shares == [list(range(8 * r, 8 * r + 8)) for r in range(4)]
    assert own_cores(1, 4, {30, 2, 6, 10, 14, 18, 22, 26, 34}) == [10, 14]
    assert own_cores(3, 4, {0, 1, 2}) == []


# ---------------------------------------------------------------------------
# the cell through the benchmark's launcher
# ---------------------------------------------------------------------------

def tiny_cell() -> dict:
    """``mcrx16.shard4`` with 2,048-sample blocks, 24-byte payloads and a
    3-chunk loop: 16 channels on the 2x2 mesh, as on the cards."""
    cell = manifest.cell("mcrx16.shard4")
    c, t = cell["config"], cell["traffic"]
    c.update(block_size=BS, max_payload=48, max_frames=6,
             chunk_samples=2 * 16 * BS * 4, warm_dispatches=1)
    t.update(payload_len=24, loop_chunks=3)
    return cell


@pytest.fixture
def limits(monkeypatch):
    monkeypatch.setattr(ranks, "SETUP_LIMIT_S", 120)
    monkeypatch.setattr(ranks, "WINDOW_MARGIN_S", 60)
    monkeypatch.setattr(ranks, "RESULT_LIMIT_S", 60)


def launch(count, **kw):
    try:
        return ranks.launch(tiny_cell(), 2**31 + 12345, 0.0, False,
                            time.perf_counter(), log=lambda *a: None,
                            cuda=False, count=count, **kw)
    finally:
        assert not multiprocessing.active_children()


def test_tiny_cell_is_correct(limits):
    out = launch(4)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["device"]["count"] == 4
    assert set(out["metrics"]) == {"rx_msps", "setup_s"}


@pytest.mark.parametrize("target", [rank_fns.reinits_state,
                                    rank_fns.reports_own_rows],
                         ids=["state_reinit", "own_rows_only"])
def test_planted_fault_is_not_correct(limits, target):
    out = launch(2, target=target)
    assert not out["correct"], out["checks"]
    assert out["failed"] > 0
