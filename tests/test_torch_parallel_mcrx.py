"""The port's parallel layer against the JAX package's, part 2: the sharded
multichannel receivers and transmitter on a 2x2 ``('time', 'channel')``
mesh.

One world of four spawned CPU processes over gloo runs, for the module:
``make_sharded_mcrx`` (duplicate channelizer), ``make_sharded_mcrx_a2a`` on
complex64 and on bfloat16 I/Q planes, the a2a's ``n_steps=3`` pipelined
form and its one-shot form over the same stream, ``make_sharded_mctx``,
and the sharded TX feeding the sharded RX across the processes (the
counterpart of ``scripts/multihost_worker.py``).  JAX runs the same
builders under ``shard_map`` on four virtual CPU devices.

Tolerances: the mixture within 1e-5 of its peak of JAX's; RX rows exact in
the detected/valid-masked fields (``rssi`` atol 1e-3 dB, ``evm`` 0.05 dB,
``cfo`` 1e-5 rad/sample); every injected payload decodes byte for byte.
JAX's pipelined test is marked slow for its compile time, so the port's
pipelined run is held to the port's one-shot run, exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquid_usrp_tpu.framing import ofdm as jofdm
from liquid_usrp_tpu.framing import ofdm_sync as jsync
from liquid_usrp_tpu.parallel import stream as jstream
from liquid_usrp_tpu_torch.framing import ofdm as tofdm
from liquid_usrp_tpu_torch.models.multichannel import make_mctx_step
from liquid_usrp_tpu_torch.ops import iqfmt
from liquid_usrp_tpu_torch.parallel import distributed

import torch_parallel_ranks as ranks

N = 4
SYNC = dict(block_size=2048, max_payload=64, max_frames=4)
CFG = {"N": N, "sync": {**SYNC, "use_pallas": 0}, "n_steps": 3,
       "chunk_samples": 2048, "tx_rx_chunk_blocks": 1}
T = 4 * 2048                  # channel samples: 2 time rows x 2 x 2048
STEP = 4 * 2 * 2048           # channel samples per pipelined super-step
SPAWN_TIMEOUT_S = 300


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs, as in each rank:
    the suite runs in several processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _baseband(positions, total, seed):
    """Per-channel baseband ``[N, total]`` with a 48-byte frame at each
    ``positions[ch]`` entry; returns (streams, {(ch, pos): payload})."""
    params = tofdm.make_ofdm_params(48, 6, 4)
    rng = np.random.default_rng(seed)
    streams = np.zeros((N, total), np.complex64)
    sent = {}
    for ch in range(N):
        for pos in positions[ch]:
            h = rng.integers(0, 256, 8, dtype=np.uint8)
            p = rng.integers(0, 256, 48, dtype=np.uint8)
            w = tofdm.assemble_frame(params, tofdm.default_props(),
                                     torch.as_tensor(h),
                                     torch.as_tensor(p)).numpy()
            streams[ch, pos:pos + len(w)] = w
            sent[(ch, pos)] = p
    return streams, sent


def _synthesize(streams):
    """The port's sequential ``make_mctx_step`` loop: ``[N, T]`` ->
    ``[2N * T]``."""
    init, step = make_mctx_step(N, "cpu")
    st, out = init(), []
    for lo in range(0, streams.shape[1], 4096):
        Y = np.zeros((4096, 2 * N), np.complex64)
        Y[:, :N] = streams[:, lo:lo + 4096].T
        st, y = step(st, torch.as_tensor(Y))
        out.append(y.numpy())
    return np.concatenate(out)


@pytest.fixture(scope="module")
def inputs():
    # frames across the fine-chunk (2048) and time-row (4096) edges, all
    # starting before T - overlap, where the last block's detect region
    # ends
    one, sent = _baseband({0: [300, 3300], 1: [1500, 3900], 2: [2500],
                           3: [900, 4200]}, T, seed=5)
    rng = np.random.default_rng(6)
    mix = _synthesize(one)
    mixture = (mix + 0.002 * (rng.normal(size=mix.shape) + 1j *
                              rng.normal(size=mix.shape))
               ).astype(np.complex64)
    planes = iqfmt.iq_to_planes(torch.as_tensor(mixture)).float().numpy()
    # the pipelined stream: a frame mid-stream and one across each
    # super-step edge (test_parallel.py's layout on this mesh)
    flen = tofdm.frame_length(tofdm.make_ofdm_params(48, 6, 4),
                              tofdm.default_props(), 48)
    pos = [1200, STEP - flen // 2, int(1.5 * STEP), 2 * STEP - flen // 2,
           int(2.45 * STEP)]
    long, piped_sent = _baseband({ch: pos for ch in range(N)},
                                 3 * STEP, seed=9)
    piped = _synthesize(long)
    tx_streams, tx_sent = _baseband({ch: [100 + 37 * ch, 2600 + 50 * ch]
                                     for ch in range(N)}, T, seed=7)
    return dict(mixture=mixture, sent=sent, planes=planes, piped=piped,
                piped_sent=piped_sent, tx_streams=tx_streams,
                tx_sent=tx_sent)


@pytest.fixture(scope="module")
def world(inputs):
    """Rank 0's outputs of the 2x2 world (every rank holds the same)."""
    outs = distributed.spawn(
        ranks.receivers, 4, CFG, inputs["mixture"], inputs["planes"],
        inputs["piped"], inputs["tx_streams"], device="cpu",
        timeout_s=SPAWN_TIMEOUT_S)
    return outs[0]


@pytest.fixture(scope="module")
def jax_ref():
    mesh = jax.make_mesh((2, 2), ("time", "channel"),
                         devices=jax.devices()[:4])
    sync = jsync.make_sync(jofdm.make_ofdm_params(48, 6, 4), **SYNC)
    assert sync.use_pallas == CFG["sync"]["use_pallas"]
    return mesh, sync


def _np(res):
    return {f: np.asarray(v) for f, v in res._asdict().items()}


def _keyed(res):
    det = np.asarray(res["detected"])
    return {(int(ch), int(res["t_start"][ch, r])):
            {f: np.asarray(v[ch, r]) for f, v in res.items()}
            for ch, r in zip(*np.nonzero(det))}


def _rows_equal(got, want):
    """Masked fields exact, the float statistics within the tolerances."""
    assert got["detected"].shape == want["detected"].shape
    g, w = _keyed(got), _keyed(want)
    assert g.keys() == w.keys()
    for key in g:
        for f in ("header_valid", "payload_valid", "payload_len", "mod",
                  "fec0", "fec1", "check", "t_start"):
            np.testing.assert_array_equal(g[key][f], w[key][f], err_msg=f)
        if g[key]["header_valid"]:
            np.testing.assert_array_equal(g[key]["header"], w[key]["header"])
        n = int(g[key]["payload_len"])
        np.testing.assert_array_equal(g[key]["payload"][:n],
                                      w[key]["payload"][:n])
        for f, tol in (("rssi", 1e-3), ("evm", 0.05), ("cfo", 1e-5)):
            np.testing.assert_allclose(g[key][f], w[key][f], atol=tol,
                                       err_msg=f)


def _decoded(res):
    """{(channel, t_start): payload bytes} of the payload-valid rows."""
    ok = res["detected"] & res["payload_valid"]
    return {(int(ch), int(res["t_start"][ch, r])):
            bytes(res["payload"][ch, r][:int(res["payload_len"][ch, r])])
            for ch, r in zip(*np.nonzero(ok))}


def _all_delivered(res, sent):
    """Every injected payload decodes once, at a constant lag behind its
    injected position (the PFB cascade's group delay)."""
    got = _decoded(res)
    assert len(got) == len(sent)
    lags = set()
    for (ch, t), p in got.items():
        match = [pos for (c, pos), q in sent.items()
                 if c == ch and q.tobytes() == p]
        assert len(match) == 1, (ch, t)
        lags.add(t - match[0])
    assert len(lags) == 1 and 0 <= lags.pop() <= 64


def test_sharded_mcrx_matches_jax(world, inputs, jax_ref):
    mesh, sync = jax_ref
    want = jstream.make_sharded_mcrx(mesh, N, sync, 2)(
        jnp.asarray(inputs["mixture"]))
    _rows_equal(world["mcrx"], _np(want))
    _all_delivered(world["mcrx"], inputs["sent"])


def test_a2a_mcrx_matches_jax(world, inputs, jax_ref):
    mesh, sync = jax_ref
    want = jstream.make_sharded_mcrx_a2a(mesh, N, sync, 1)(
        jnp.asarray(inputs["mixture"]))
    _rows_equal(world["a2a"], _np(want))
    _all_delivered(world["a2a"], inputs["sent"])


def test_a2a_mcrx_bf16_planes_match_jax(world, inputs, jax_ref):
    mesh, sync = jax_ref
    planes = jnp.asarray(inputs["planes"]).astype(jnp.bfloat16)
    want = jstream.make_sharded_mcrx_a2a(mesh, N, sync, 1,
                                         ingest="bf16")(planes)
    _rows_equal(world["a2a_bf16"], _np(want))
    _all_delivered(world["a2a_bf16"], inputs["sent"])


def test_a2a_pipelined_matches_one_shot(world, inputs):
    """Three super-steps with frames across both super-step edges: the
    carried analysis, NCO and sync tails make the pipelined run equal to
    the one-shot run over the same stream, row for row in JAX's (step,
    time, row) order, and every injected payload decodes."""
    piped, one = world["piped"], world["one_shot"]
    assert piped["detected"].shape == one["detected"].shape
    assert _keyed(piped).keys() == _keyed(one).keys()
    _rows_equal(piped, one)
    # both orders are global block order, so the rows sit at the same
    # positions, not only under the same (channel, t_start) keys
    np.testing.assert_array_equal(piped["detected"], one["detected"])
    det = one["detected"]
    np.testing.assert_array_equal(piped["t_start"][det], one["t_start"][det])
    np.testing.assert_array_equal(piped["payload_valid"][det],
                                  one["payload_valid"][det])
    _all_delivered(piped, inputs["piped_sent"])


@pytest.mark.parametrize("name", ["mcrx", "piped"])
def test_regroup_matches_jax(world, jax_ref, name):
    """``run.regroup`` (kept to mirror JAX's public names: the port's
    ``run`` applies it itself) moves every gathered element to the place
    JAX's puts it: ``[N, (step,) time, row]`` for both receivers."""
    mesh, sync = jax_ref
    n_steps = CFG["n_steps"] if name == "piped" else None
    probe = ranks._regroup_probe(n_steps)
    if n_steps:
        want = jstream.make_sharded_mcrx_a2a(mesh, N, sync, 2,
                                             n_steps=n_steps).regroup(probe)
    else:
        want = jstream.make_sharded_mcrx(mesh, N, sync, 2).regroup(probe)
    np.testing.assert_array_equal(world[f"regroup_{name}"], want)


def test_sharded_mctx_matches_jax(world, inputs, jax_ref):
    mesh, _ = jax_ref
    want = np.asarray(jstream.make_sharded_mctx(mesh, N, 2048)(
        jnp.asarray(inputs["tx_streams"])))
    got = world["mctx"]
    assert got.shape == want.shape == (2 * N * T,)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # and the port's own sequential synthesizer
    seq = _synthesize(inputs["tx_streams"])
    assert np.abs(got - seq).max() <= 1e-5 * np.abs(seq).max()


def test_sharded_tx_to_sharded_rx_across_processes(world, inputs):
    _all_delivered(world["tx_rx"], inputs["tx_sent"])
