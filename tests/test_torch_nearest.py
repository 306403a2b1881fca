"""The nearest-point scan (``framing/payload.py::_nearest_sym``): its CUDA
kernel ``csrc/nearest.cu`` against the plain chunked loop, and the CPU
dispatch.

On the CPU: a NumPy float32 model of the kernel's walk (every entry in
ascending order, strict ``<`` from ``(0, 1e30)``) equals
:func:`payload._nearest_sym_plain` (argmin within chunks of 16, strict ``<``
across them) bit for bit on every kind of point below, at every table size;
``_nearest_sym`` on a CPU tensor runs the plain loop and counts its pairs
but no launch; the build declares ``nearest_launch``.

On the card (``gpu``, skipped without CUDA): the kernel equals the plain
loop run on the card, ``arg`` exactly and ``best`` bit for bit, over the
tables of every modem scheme mixed across rows, at C = 4, 16, 37, 64 and
256 entries, with points exactly on constellation points, at the origin
and at midpoints (exact ties: the first entry wins), in Gaussian clouds at
0, 10 and 30 dB, near ``1e6`` (where a padding entry wins, tied with the
other padding entries), NaN and infinite, at point counts that end
mid-tile, and with K = 0 or n = 0 (no launch).  The demap, the payload EVM
and the decision-directed pass of a window batch's decode give on the card
with the kernel what they give with the plain loop there, and the demap
what the CPU gives.

Inputs come from ``numpy.random.default_rng`` seeded with ``zlib.crc32`` of
the case name; one intra-op thread.  This file imports no JAX, so its card
tests run with ``--noconftest``.
"""
import ctypes
import zlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from liquid_usrp_tpu_torch.framing import payload
from liquid_usrp_tpu_torch.ops import _build, kernels, modem
from liquid_usrp_tpu_torch.utils import profiling

SIZES = (4, 16, 37, 64, 256)
KINDS = ("on", "ties", "snr0", "snr10", "snr30", "far", "nonfinite")
ROWS = len(payload.PAYLOAD_MODS)     # a row of each scheme's table
POINTS = 1001                        # a kernel tile is 512 points


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def scan_case(kind: str, C: int, rows: int = ROWS, n: int = POINTS):
    """``(x [rows, n], table [rows, C])`` complex64 NumPy arrays: each row
    the first C entries of a padded scheme table, rows of distinct schemes
    in a random order (every scheme's at ``ROWS``), and points of
    ``kind``."""
    rng = _rng(f"nearest {kind} {C} {rows} {n}")
    stacked = payload._stacked_tables()
    mods = rng.permutation(len(payload.PAYLOAD_MODS))[:rows]
    table = stacked[mods][:, :C]
    valid = np.minimum(C, [1 << modem.bits_per_symbol(int(m)) for m in mods])
    pick = (rng.random((rows, n)) * valid[:, None]).astype(np.int64)
    on = np.take_along_axis(table, pick, axis=-1)
    if kind == "on":
        x = on
    elif kind == "ties":
        # the origin (equidistant from a symmetric constellation's points)
        # and the midpoints of entries c and c + 1
        nxt = np.take_along_axis(table, np.minimum(pick + 1, C - 1), axis=-1)
        x = ((on.astype(np.complex128) + nxt) / 2).astype(np.complex64)
        x[:, ::5] = 0
    elif kind.startswith("snr"):
        sigma = 10 ** (-int(kind[3:]) / 20) / np.sqrt(2)
        x = on + sigma * (rng.normal(size=on.shape) +
                          1j * rng.normal(size=on.shape))
    elif kind == "far":
        x = 1e6 * (1 + 1e-3 * rng.normal(size=on.shape)) + \
            3e2 * rng.normal(size=on.shape) * 1j
        x[:, ::3] = on[:, ::3] * 1e5
    else:
        x = on.copy()
        bad = np.array([np.nan, np.inf, -np.inf], np.float32)
        sel = rng.random(on.shape) < 0.5
        x.real[sel] = bad[rng.integers(0, 3, on.shape)][sel]
        sel = rng.random(on.shape) < 0.5
        x.imag[sel] = bad[rng.integers(0, 3, on.shape)][sel]
    return x.astype(np.complex64), np.ascontiguousarray(table, np.complex64)


def scan_model(x: np.ndarray, table: np.ndarray):
    """The kernel's walk in NumPy float32: entries in ascending order, each
    distance's products and sum rounded on their own, strict ``<`` from
    ``(arg, best) = (0, 1e30)``."""
    xr, xi = x.real, x.imag
    best = np.full(x.shape, 1e30, np.float32)
    arg = np.zeros(x.shape, np.int64)
    with np.errstate(all="ignore"):
        for c in range(table.shape[-1]):
            dr = xr - table.real[:, c:c + 1]
            di = xi - table.imag[:, c:c + 1]
            d = dr * dr + di * di
            upd = d < best
            best = np.where(upd, d, best)
            arg = np.where(upd, c, arg)
    return arg, best


@pytest.mark.parametrize("C", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_walk_matches_the_plain_loop(kind, C):
    x, table = scan_case(kind, C)
    arg, best = payload._nearest_sym_plain(torch.as_tensor(x),
                                           torch.as_tensor(table))
    want_arg, want_best = scan_model(x, table)
    np.testing.assert_array_equal(arg.numpy(), want_arg)
    assert np.array_equal(best.numpy().view(np.int32),
                          want_best.view(np.int32))
    if kind == "far" and (table == np.complex64(1e6)).any():
        won = np.take_along_axis(table, arg.numpy(), axis=-1)
        assert (won == np.complex64(1e6)).any()     # a padding entry won
    if kind == "nonfinite":
        nan = ~np.isfinite(x)
        assert (arg.numpy()[nan] == 0).all() and \
            (best.numpy()[nan] == np.float32(1e30)).all()


def test_cpu_runs_the_plain_loop_and_counts_no_launch():
    x, table = scan_case("snr10", 64)
    x, table = torch.as_tensor(x), torch.as_tensor(table)
    kernels.reset_launch_counts()
    profiling.counters.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        arg, best = payload._nearest_sym(x, table)
    want = payload._nearest_sym_plain(x, table)
    assert torch.equal(arg, want[0]) and torch.equal(best, want[1])
    assert kernels.launches["nearest"] == 0
    assert profiling.counters == {"nearest_entries": ROWS * POINTS * 64}
    profiling.counters.clear()
    with pytest.raises(RuntimeError):
        payload._nearest_sym(x.to("meta"), table.to("meta"))


def test_the_build_declares_nearest_launch():
    argtypes, restype = _build._SIGNATURES["nearest_launch"]
    vp, i = ctypes.c_void_p, ctypes.c_int
    # x, K, n, table, C, arg, best, stream
    assert argtypes == [vp, i, i, vp, i, vp, vp, vp]
    assert restype is i


@pytest.mark.gpu
@pytest.mark.parametrize("C", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_nearest_kernel_matches_plain(cuda, kind, C):
    """One launch a call; ``arg`` equal and ``best`` bit-equal to the plain
    loop on the card, also at point counts around the 512-point tile."""
    for rows, n in ((ROWS, POINTS), (3, 512), (2, 513), (5, 1)):
        x, table = scan_case(kind, C, rows, n)
        x, table = torch.as_tensor(x, device=cuda), \
            torch.as_tensor(table, device=cuda)
        kernels.reset_launch_counts()
        arg, best = payload._nearest_sym(x, table)
        assert kernels.launches["nearest"] == 1
        want_arg, want_best = payload._nearest_sym_plain(x, table)
        assert torch.equal(arg, want_arg), (rows, n)
        assert torch.equal(best.view(torch.int32),
                           want_best.view(torch.int32)), (rows, n)


@pytest.mark.gpu
def test_nearest_kernel_empty_strided_and_refused(cuda):
    """K = 0 and n = 0 give empty results with no launch; a sliced table
    and points out of a wider buffer give the plain loop's results; a
    complex128 input, a table of 0 or 257 entries and rows that do not
    match raise."""
    table = torch.as_tensor(payload._stacked_tables()[:3], device=cuda)
    kernels.reset_launch_counts()
    for K, n in ((0, 100), (3, 0)):
        x = torch.zeros((K, n), dtype=torch.complex64, device=cuda)
        arg, best = payload._nearest_sym(x, table[:K])
        assert arg.shape == (K, n) and arg.dtype == torch.int64
        assert best.shape == (K, n) and best.dtype == torch.float32
    assert kernels.launches["nearest"] == 0
    x, _ = scan_case("snr10", 256, 3, 700)
    wide = torch.as_tensor(x, device=cuda)[:, 50:650]
    sliced = table[..., :64]
    got = payload._nearest_sym(wide, sliced)
    want = payload._nearest_sym_plain(wide, sliced)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernels.launches["nearest"] == 1
    with pytest.raises(TypeError):
        payload._nearest_sym(wide.to(torch.complex128), sliced)
    for bad in (table[..., :0], torch.cat([table, table[..., :1]], -1),
                table[:2]):
        with pytest.raises(ValueError):
            payload._nearest_sym(wide, bad)


def _window_batch(device):
    """One multichannel window batch at M = 48: 4 rows of a 4,096-sample
    block behind its overlap, each holding 2 frames (QPSK, 16-QAM,
    64-QAM and 256-QAM payloads) in 0.02-rms noise, and the sync's
    candidates: ``(sync, tables, windows [R, W], c_at [R])``."""
    from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
    params = ofdm.make_ofdm_params(48, 6, 4)
    sync = ofdm_sync.make_sync(params, block_size=4096, max_payload=128,
                               max_frames=8)
    rng = _rng("nearest window batch")
    ext = np.zeros((4, sync.overlap + sync.block_size), np.complex64)
    mods = (modem.MOD_QPSK, modem.MOD_QAM16, modem.MOD_QAM64,
            modem.MOD_QAM256)
    for row in range(4):
        props = ofdm.default_props()._replace(mod=mods[row])
        for pos in (300 + 200 * row, 2500):
            frame = ofdm.assemble_frame(
                params, props,
                torch.as_tensor(rng.integers(0, 256, 8, dtype=np.uint8)),
                torch.as_tensor(rng.integers(0, 256, 64, dtype=np.uint8)))
            ext[row, pos:pos + len(frame)] += frame.numpy()
    ext += (0.02 * (rng.normal(size=ext.shape) +
                    1j * rng.normal(size=ext.shape))).astype(np.complex64)
    ext = torch.as_tensor(ext, device=device)
    tables = ofdm_sync.sync_tables(sync, device)
    detected, locs, c_at = ofdm_sync._detect_candidates(sync, ext, tables)
    row_of = torch.arange(4, device=device).repeat_interleave(
        sync.max_frames)
    win = ofdm_sync._window_gather(ext, row_of, locs.reshape(-1),
                                   sync.overlap)
    return sync, tables, win, c_at.reshape(-1), detected.reshape(-1)


def _decode_scans(sync, tables, win, c_at):
    """The DD-corrected points, the schemes, the codec's hard demap and
    the payload EVM of a window batch."""
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    out = ofdm_sync._decode_window(sync, tables, win, c_at)
    points, plen, mod, f0, f1, check = out[1:7]
    bits, _ = payload.generic_demod_bits(points, mod, sync.enc_max * 8)
    used = payload.payload_points_used(sync.fecs, sync.dec_max, sync.enc_max,
                                       plen, mod, f0, f1, check)
    return points, mod, bits, payload.payload_evm_mse(points, mod, used)


@pytest.mark.gpu
def test_nearest_kernel_in_a_window_batch_decode(cuda, monkeypatch):
    """The DD pass, the demap and the EVM of a window batch's decode run
    three launches and equal the plain loop's run on the card exactly; the
    demap of the card's points equals the CPU's."""
    sync, tables, win, c_at, detected = _window_batch(cuda)
    assert int(detected.sum()) == 8
    kernels.reset_launch_counts()
    got = _decode_scans(sync, tables, win, c_at)
    assert kernels.launches["nearest"] == 3

    def loop(*args, **kw):
        raise AssertionError("the plain loop ran on the card")
    monkeypatch.setattr(payload, "_nearest_sym_plain", loop)
    _decode_scans(sync, tables, win, c_at)
    monkeypatch.undo()
    monkeypatch.setattr(payload, "_nearest_sym", payload._nearest_sym_plain)
    want = _decode_scans(sync, tables, win, c_at)
    monkeypatch.undo()
    for name, g, w in zip(("points", "mod", "bits", "evm"), got, want):
        assert torch.equal(g, w), name
    points, mod, bits, _ = got
    cpu_bits, _ = payload.generic_demod_bits(points.cpu(), mod.cpu(),
                                             sync.enc_max * 8)
    assert torch.equal(bits.cpu(), cpu_bits)
