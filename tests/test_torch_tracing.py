"""The receive path's spans and counters (``utils/profiling.py``) and the
benchmark's readers of them (``rxbench/spans.py``, ``rxbench/metrics/``).

On the CPU, under a CPU ``torch.profiler``: a small ``Mcrx.step`` loop
through ``run_pipelined`` and an ``OfdmTxRx.run_rx`` emit the ``rx.*``
spans as host ``cpu_op`` events (not ``record_function``'s
``user_annotation``, which kineto mirrors onto the card's timeline), nested
as the layers are, one ``rx.dispatch`` a dispatch; the counters equal hand
counts from the shapes.  With no profiler the counters do not move, and
with one the program dispatches the same torch operations and gives the
same bits.  Each reader gives known values on a synthetic
``rxbench.profiling.Trace`` and ``None`` where its span or counter is
absent.  Seeds are ``zlib.crc32`` of the case's name.
"""
import ast
import json
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
from liquid_usrp_tpu_torch.framing import payload as payload_codec
from liquid_usrp_tpu_torch.io.pipeline import run_pipelined
from liquid_usrp_tpu_torch.models import multichannel as mc
from liquid_usrp_tpu_torch.models.ofdmtxrx import OfdmTxRx
from liquid_usrp_tpu_torch.ops import conv, fec
from liquid_usrp_tpu_torch.utils import profiling
from rxbench import spans
from rxbench.profiling import Op, Trace
from rxbench.metrics import (codec_host_ms, codec_syncs_per_dispatch,
                             decode_host_ms, decode_rows_useful_pct,
                             detect_host_ms, front_end_host_ms,
                             ingest_host_ms, nearest_scan_mentries,
                             result_wait_ms)

PKG = Path(__file__).resolve().parents[1] / "liquid_usrp_tpu_torch"
N, BS, NB, K = 2, 2048, 2, 6
DISPATCHES = 3
PARAMS = ofdm.make_ofdm_params(48, 6, 4)
SYNC = ofdm_sync.make_sync(PARAMS, block_size=BS, max_payload=48,
                           max_frames=K, use_pallas=1)
SC = dict(block_size=1024, max_payload=48, batch_blocks=2,
          enable_conv=True, device="cpu")
SC_BLOCKS = 9


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.counters.clear()
    yield
    profiling.counters.clear()


def _rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


@pytest.fixture(scope="module")
def mixture():
    """``DISPATCHES`` chunks of the N-channel mixture, frames on both
    channels in the first two, noise only in the last."""
    rng = _rng("mixture")
    step = BS * NB
    Y = np.zeros((DISPATCHES * step, 2 * N), np.complex64)
    for ch, pos in ((0, 300), (1, 1500), (0, step + 900)):
        f = ofdm.assemble_frame(
            PARAMS, ofdm.default_props(),
            torch.as_tensor(rng.integers(0, 256, 8, dtype=np.uint8)),
            torch.as_tensor(rng.integers(0, 256, 24, dtype=np.uint8)))
        Y[pos:pos + len(f), ch] = f.numpy()
    init, tx = mc.make_mctx_step(N, "cpu")
    _, y = tx(init(), torch.as_tensor(Y))
    y = y.numpy()
    y = y + 0.002 * (rng.normal(size=y.shape) + 1j * rng.normal(size=y.shape))
    return np.split(y.astype(np.complex64), DISPATCHES)


def _mcrx_run(chunks):
    """``run_pipelined`` over ``chunks``: the step's results and the
    delivered ones, each as NumPy."""
    init, step = mc.make_mcrx_batched_step(N, SYNC, NB, "cpu")
    out, delivered = [], []

    def keep(state, x):
        state, res = step(state, x)
        out.append(res)
        return state, res

    run_pipelined(iter(chunks), keep, init(),
                  on_results=lambda r: delivered.append(r))
    assert len(delivered) == len(out) == len(chunks)
    return [[v.numpy() for v in r] for r in out]


@pytest.fixture(scope="module")
def sc_stream():
    """Three single-channel frames (v27 inner code) in noise, ``SC_BLOCKS``
    of the receiver's blocks: batched chunks of 2 and a single block."""
    rng = _rng("sc_stream")
    tx = OfdmTxRx(**SC)
    pieces = []
    for n in (20, 30, 24):
        pieces += [np.zeros(700, np.complex64),
                   tx.transmit_packet(rng.integers(0, 256, 8, np.uint8),
                                      rng.integers(0, 256, n, np.uint8),
                                      fec0=fec.FEC_CONV_V27,
                                      fec1=fec.FEC_NONE)]
    air = np.concatenate(pieces)
    air = np.concatenate([air, np.zeros(SC_BLOCKS * 1024 - len(air),
                                        np.complex64)])
    air += (0.003 * (rng.normal(size=air.shape) +
                     1j * rng.normal(size=air.shape))).astype(np.complex64)
    return air


def _sc_run(air):
    rx = OfdmTxRx(**SC)
    rx.start_rx()
    return rx, rx.run_rx(air)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.name(), e.activity_type(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("rx.")]
    return out, sorted(events, key=lambda e: (e[2], -e[3]))


def _parent(events, i):
    """The name of the innermost span that contains span ``i``."""
    _, _, s, t = events[i]
    best = None
    for j, (name, _, s2, t2) in enumerate(events):
        if j != i and s2 <= s and t <= t2 and (best is None or
                                               t2 - s2 < best[1]):
            best = (name, t2 - s2)
    return best and best[0]


def _named(events, name):
    return [e for e in events if e[0] == name]


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def _gated(out):
    det = ofdm_sync.FrameResults._fields.index("detected")
    return [r for r in out if r[det].any()]


def test_mcrx_spans_are_cpu_ops_nested_by_layer(mixture):
    out, ev = _profiled(lambda: _mcrx_run(mixture))
    assert {k for _, k, _, _ in ev} == {"cpu_op"}
    assert len(_named(ev, "rx.dispatch")) == DISPATCHES
    assert len(_named(ev, "rx.ingest")) == DISPATCHES
    assert len(_named(ev, "rx.deliver")) == DISPATCHES
    parents = {}
    for i, e in enumerate(ev):
        parents.setdefault(e[0], set()).add(_parent(ev, i))
    assert parents == {
        "rx.dispatch": {None}, "rx.ingest": {None}, "rx.deliver": {None},
        "rx.front_end": {"rx.dispatch"}, "rx.detect": {"rx.dispatch"},
        "rx.decode": {"rx.dispatch"}, "rx.results": {"rx.dispatch"},
        "rx.codec": {"rx.decode"}}
    # the payload codec runs in the dispatches that detect a frame
    assert len(_named(ev, "rx.codec")) == len(_gated(out)) == 2
    for name in ("rx.front_end", "rx.detect", "rx.decode", "rx.results"):
        assert len(_named(ev, name)) == DISPATCHES


def test_deliver_k_follows_dispatch_k_and_the_next_one(mixture):
    _, ev = _profiled(lambda: _mcrx_run(mixture))
    disp, deliv = _named(ev, "rx.dispatch"), _named(ev, "rx.deliver")
    ingest = _named(ev, "rx.ingest")
    for k, (d, r) in enumerate(zip(disp, deliv)):
        assert d[3] <= r[2]
        assert ingest[k][3] <= d[2]          # staged before its step
        if k + 1 < len(disp):
            # held while the next chunk is staged and its step launched
            assert disp[k + 1][3] <= r[2]
            assert r[3] <= deliv[k + 1][2]


def test_run_rx_spans_nest_one_dispatch_a_dispatch(sc_stream):
    (rx, frames), ev = _profiled(lambda: _sc_run(sc_stream))
    assert frames and {k for _, k, _, _ in ev} == {"cpu_op"}
    # four batched chunks of 2 blocks and one single block
    assert len(_named(ev, "rx.dispatch")) == 5
    parents = {}
    for i, e in enumerate(ev):
        parents.setdefault(e[0], set()).add(_parent(ev, i))
    assert parents == {
        "rx.dispatch": {None}, "rx.ingest": {"rx.dispatch"},
        "rx.detect": {"rx.dispatch"}, "rx.decode": {"rx.dispatch"},
        "rx.results": {"rx.dispatch"}, "rx.codec": {"rx.decode"}}
    # the synchronizer's results and the host copy with the rows
    assert len(_named(ev, "rx.results")) == 10


def test_span_records_what_record_function_would_mirror():
    """``record_function`` gives a ``user_annotation`` (which kineto also
    mirrors onto the card's timeline); ``span`` a ``cpu_op``."""
    def both():
        with torch.profiler.record_function("rx.annotation"):
            with profiling.span("rx.span"):
                torch.ones(2).add_(1)
    _, ev = _profiled(both)
    assert {n: k for n, k, _, _ in ev} == {"rx.annotation": "user_annotation",
                                           "rx.span": "cpu_op"}


# ---------------------------------------------------------------------------
# off: no state, no work; on: the same work and bits
# ---------------------------------------------------------------------------

class _OpLog(TorchDispatchMode):
    """Every torch operation dispatched, by name, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_off_counts_nothing_and_shares_one_no_op(mixture, sc_stream):
    assert profiling.span("rx.a") is profiling.span("rx.b")
    _mcrx_run(mixture)
    _sc_run(sc_stream)
    profiling.count("rows_decoded", 5)
    assert profiling.counters == {}


def test_on_dispatches_the_same_ops_and_bits(mixture):
    with _OpLog() as off_log:
        off = _mcrx_run(mixture)
    with profile(activities=[ProfilerActivity.CPU]):
        with _OpLog() as on_log:
            on = _mcrx_run(mixture)
    assert profiling.counters["rows_decoded"] > 0
    assert on_log.ops == off_log.ops
    for a, b in zip(off, on):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_run_rx_rows_are_the_same_on_and_off(sc_stream):
    _, off = _sc_run(sc_stream)
    with profile(activities=[ProfilerActivity.CPU]):
        _, on = _sc_run(sc_stream)
    assert len(on) == len(off) == 3
    for a, b in zip(off, on):
        assert a["t"] == b["t"] and a["payload_valid"] == b["payload_valid"]
        np.testing.assert_array_equal(a["payload"], b["payload"])
        assert a["stats"] == b["stats"]


LOOPS = (ast.For, ast.While, ast.ListComp, ast.SetComp, ast.DictComp,
         ast.GeneratorExp)


def _calls_in_loops(tree):
    """(function, name) of each call of ``utils.profiling``'s ``span`` or
    ``count``, as the module imports them, that sits inside a loop of the
    function that holds it."""
    names = {a.asname or a.name for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) and
             (node.module or "").endswith("utils.profiling")
             for a in node.names} & {"span", "count"}
    out = []

    def visit(node, fn, looped):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                visit(child, getattr(child, "name", fn), False)
                continue
            if isinstance(child, ast.Call) and looped and \
                    getattr(child.func, "id", None) in names:
                out.append((fn, child.func.id))
            visit(child, fn, looped or isinstance(child, LOOPS))
    visit(tree, None, False)
    return out


def test_no_span_or_count_inside_a_step_or_chunk_loop():
    """The only loops that hold a span are the dispatch loops."""
    found = []
    for path in sorted(PKG.rglob("*.py")):
        found += [(path.name, fn, name) for fn, name in
                  _calls_in_loops(ast.parse(path.read_text()))]
    assert found == [("ofdmtxrx.py", "run_rx", "span")] * 4


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

def _entries(res_np, R):
    """The nearest-point pairs of one gated dispatch, from its shapes: the
    decision-directed pass and the payload EVM scan the whole table, the
    demap 64 entries where every row's mode has at most 6 bits."""
    n_data = len(PARAMS.data_idx)
    mod = res_np[ofdm_sync.FrameResults._fields.index("mod")].reshape(-1)
    n_tab = 64 if (payload_codec._BPS[mod] <= 6).all() else 256
    dd = min(ofdm_sync._DD_SYMS, SYNC.max_psym)
    pts = SYNC.max_psym * n_data
    return R * (dd * n_data * 256 + pts * n_tab + pts * 256)


def test_counters_equal_hand_counts(mixture):
    with profile(activities=[ProfilerActivity.CPU]):
        out = _mcrx_run(mixture)
    R = N * NB * K
    det = ofdm_sync.FrameResults._fields.index("detected")
    gated = _gated(out)
    assert len(gated) == 2
    assert profiling.counters == {
        "rows_decoded": R * len(gated),
        "rows_detected": sum(int(r[det].sum()) for r in out),
        "nearest_entries": sum(_entries(r, R) for r in gated)}


def test_scan_and_viterbi_counters_from_shapes():
    rng = _rng("scans")
    x = torch.as_tensor((rng.normal(size=(3, 40)) +
                         1j * rng.normal(size=(3, 40))).astype(np.complex64))
    mod = torch.tensor([3, 5, 7], dtype=torch.int32)
    table = torch.as_tensor(payload_codec._stacked_tables())[mod.long()]
    with profile(activities=[ProfilerActivity.CPU]):
        payload_codec._nearest_sym(x, table)
        payload_codec.generic_demod_soft(x, mod, 64, n_table=64)
        coded = torch.as_tensor(rng.integers(0, 256, (2, 44), np.uint8))
        conv.conv_decode(fec.FEC_CONV_V27, coded, 20)
    assert profiling.counters == {"nearest_entries": 120 * 256 + 120 * 64,
                                  "viterbi_steps": 20 * 8 + 6}


def test_run_rx_counts_rows_and_viterbi_steps(sc_stream):
    with profile(activities=[ProfilerActivity.CPU]):
        rx, frames = _sc_run(sc_stream)
    s = rx._sync
    c = profiling.counters
    assert c["rows_detected"] == len(frames) == 3
    assert c["rows_decoded"] % s.max_frames == 0 and \
        c["rows_decoded"] >= s.max_frames
    # one v27 stage a gated dispatch, over the receiver's whole budget
    n = payload_codec._fit_bytes(fec.FEC_CONV_V27, s.dec_max, s.enc_max)
    assert c["viterbi_steps"] % (n * 8 + 6) == 0 and c["viterbi_steps"] > 0


def test_trace_writes_the_counts_made_inside_it(tmp_path):
    profiling.counters["nearest_entries"] = 7
    with profiling.trace(str(tmp_path)):
        profiling.count("nearest_entries", 5)
        profiling.count("rows_decoded", 3)
        with profiling.span("rx.dispatch"):
            pass
    assert json.loads((tmp_path / "counters.json").read_text()) == {
        "nearest_entries": 5, "rows_decoded": 3}
    names = {e["name"]: e.get("cat") for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert names["rx.dispatch"] == "cpu_op"


# ---------------------------------------------------------------------------
# the benchmark's readers, on a synthetic trace (microseconds)
# ---------------------------------------------------------------------------

def _trace(host, dispatches=2):
    return Trace(0.0, 1000.0, dispatches, [Op("kernel", 0.0, 10.0)],
                 [Op(*h) for h in host])


SYNTH = _trace([
    ("rx.ingest", 0, 5), ("rx.dispatch", 10, 110),
    ("rx.front_end", 12, 20), ("rx.detect", 20, 30),
    ("cudaStreamSynchronize", 25, 29),
    ("rx.decode", 30, 90), ("rx.codec", 50, 80),
    ("cudaStreamSynchronize", 55, 60), ("cudaMemcpy", 70, 71),
    ("cudaLaunchKernel", 72, 73), ("rx.results", 95, 100),
    ("rx.ingest", 120, 127), ("rx.dispatch", 130, 200),
    ("rx.front_end", 131, 135), ("rx.detect", 135, 140),
    ("rx.decode", 140, 150), ("rx.results", 150, 160),
    ("rx.deliver", 210, 230), ("cudaStreamSynchronize", 215, 220),
    ("rx.deliver", 240, 250)])


@pytest.mark.parametrize("reader, want", [
    (ingest_host_ms, (5 + 7) / 2e3),
    (front_end_host_ms, (8 + 4) / 2e3),
    (detect_host_ms, (10 + 5) / 2e3),
    (decode_host_ms, (60 - 30 + 10) / 2e3),
    (codec_host_ms, 30 / 2e3),
    (codec_syncs_per_dispatch, 2 / 2),
    (result_wait_ms, ((210 - 110) + (240 - 200)) / 2e3)],
    ids=lambda v: getattr(v, "__name__", "").rsplit(".", 1)[-1] or None)
def test_span_readers_on_a_synthetic_trace(reader, want):
    assert reader.read(SYNTH, None) == pytest.approx(want)
    assert reader.read(_trace([("aten::add", 0, 5)]), None) is None


def test_self_time_subtracts_the_union_of_nested_spans():
    t = _trace([("rx.dispatch", 0, 100), ("rx.decode", 10, 60),
                ("rx.codec", 20, 40), ("rx.results", 50, 70),
                ("aten::add", 0, 100)])
    assert spans.self_us(t, "rx.dispatch") == 100 - 60
    assert spans.self_us(t, "rx.decode") == 50 - 20
    assert spans.self_us(t, "rx.ingest") is None


def test_counter_readers(monkeypatch):
    t = _trace([], dispatches=4)
    assert decode_rows_useful_pct.read(t, None) is None
    assert nearest_scan_mentries.read(t, None) is None
    monkeypatch.setitem(profiling.counters, "rows_decoded", 192 * 4)
    monkeypatch.setitem(profiling.counters, "rows_detected", 432)
    monkeypatch.setitem(profiling.counters, "nearest_entries", 8_000_000)
    assert decode_rows_useful_pct.read(t, None) == pytest.approx(56.25)
    assert nearest_scan_mentries.read(t, None) == pytest.approx(2.0)
    # a program without the counters (no attribute at all)
    monkeypatch.delattr(profiling, "counters")
    assert decode_rows_useful_pct.read(t, None) is None
    assert nearest_scan_mentries.read(t, None) is None
