"""The port's parallel layer (``liquid_usrp_tpu_torch/parallel``) against the
JAX package's, part 1: the mesh, the launcher, the collectives and time
sharding.

The port runs a real world of spawned CPU processes over gloo
(``parallel.distributed.spawn``, one world for the whole module: a 2x2
``('time', 'channel')`` mesh and a 1-D ``'time'`` mesh of the same four
ranks); JAX runs ``shard_map`` on four of ``tests/conftest.py``'s virtual
CPU devices.  Both see the same NumPy inputs.  Tolerances: collectives,
shards, NCO phases and mesh layout exact; time-sharded OFDM rows exact in
the detected/valid-masked fields against JAX's (``rssi`` atol 1e-3 dB,
``evm`` 0.05 dB, ``cfo`` 1e-5); flexframe, GMSK and 802.11a time sharding
against the port's own sequential ``block_fn`` loop (earlier slices hold
that loop to JAX), with the same tolerances, and every injected payload.
The rank functions live in ``tests/torch_parallel_ranks.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from liquid_usrp_tpu.framing import ofdm as jofdm
from liquid_usrp_tpu.framing import ofdm_sync as jsync
from liquid_usrp_tpu.ops import nco as jnco
from liquid_usrp_tpu.parallel import mesh as jmesh
from liquid_usrp_tpu.parallel import stream as jstream
from liquid_usrp_tpu_torch.framing import flexframe as tff
from liquid_usrp_tpu_torch.framing import flexframe_sync as tffs
from liquid_usrp_tpu_torch.framing import gmskframe as tgf
from liquid_usrp_tpu_torch.framing import ofdm as tofdm
from liquid_usrp_tpu_torch.framing import ofdm_sync as tsync
from liquid_usrp_tpu_torch.framing import wlan as twlan
from liquid_usrp_tpu_torch.ops import nco as tnco
from liquid_usrp_tpu_torch.parallel import distributed
from liquid_usrp_tpu_torch.parallel.mesh import factor_devices
from liquid_usrp_tpu_torch.utils.device import DEVICE_ENV

import torch_parallel_ranks as ranks

TC = ("time", "channel")
L = 8                                   # collective test row length
OFDM_CFG = dict(block_size=4096, max_payload=128, max_frames=4,
                use_pallas=0)
CHUNK_BLOCKS = {"ofdm": 3, "flex": 3, "gmsk": 3, "wlan": 2}
SPAWN_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs, as in each rank:
    the suite runs in several processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jmesh4(shape, names):
    return jax.make_mesh(shape, names, devices=jax.devices()[:4])


def _impair(x, seed, cfo, snr_amp=0.02):
    rng = np.random.default_rng(seed)
    n = np.arange(len(x))
    y = 0.8 * np.exp(1j * (0.4 + cfo * n)) * x
    y += snr_amp * (rng.normal(size=len(x)) + 1j * rng.normal(size=len(x)))
    return y.astype(np.complex64)


def _burst_stream(make_burst, total, overlap, gap, seed, header_len=8,
                  payload_len=90):
    """Frames from ``pos = 1500`` every ``gap`` samples past the last, up
    to ``total - overlap``; returns (stream, [(pos, payload)])."""
    rng = np.random.default_rng(seed)
    s = np.zeros(total, np.complex64)
    sent, pos = [], 1500
    while True:
        header = rng.integers(0, 256, header_len, dtype=np.uint8)
        payload = rng.integers(0, 256, payload_len, dtype=np.uint8)
        frame = make_burst(header, payload)
        if pos + len(frame) >= total - overlap:
            return s, sent
        s[pos:pos + len(frame)] = frame
        sent.append((pos, payload))
        pos += len(frame) + gap


def _family_streams():
    """The time-sharded streams (4 ranks x chunk_blocks x 4096 samples)
    with frames across the rank boundaries, impaired by a phase, a CFO and
    noise; returns ({family: stream}, {family: sent}, {family: sync})."""
    op = tofdm.make_ofdm_params(48, 6, 4)
    fp = tff.make_flex_params(k=2, m=7, beta=0.3)
    gp = tgf.make_gmsk_params(k=2, m=3, bt=0.5)
    syncs = {
        "ofdm": tsync.make_sync(op, **OFDM_CFG),
        "flex": tffs.make_flex_sync(fp, block_size=4096, max_payload=128,
                                    max_frames=4),
        "gmsk": tgf.make_gmsk_sync(gp, block_size=4096, max_payload=128,
                                   max_frames=4),
        "wlan": twlan.make_wlan_sync(block_size=4096, max_psdu=64,
                                     max_frames=2),
    }
    t = torch.as_tensor
    burst = {
        "ofdm": lambda h, p: tofdm.assemble_frame(
            op, tofdm.FrameProps(), t(h), t(p)).numpy(),
        "flex": lambda h, p: tff.flex_assemble(
            fp, tff.default_props(), t(h), t(p)).numpy(),
        "gmsk": lambda h, p: tgf.gmsk_assemble(
            gp, tgf.gmsk_default_props(), t(h), t(p)).numpy(),
        "wlan": lambda h, p: twlan.wlan_assemble(
            (6, 24, 54)[int(p[0]) % 3], p, device="cpu").numpy(),
    }
    gaps = {"ofdm": 5000, "flex": 5000, "gmsk": 5200, "wlan": 4000}
    streams, sent = {}, {}
    for i, (name, sy) in enumerate(syncs.items()):
        total = 4 * CHUNK_BLOCKS[name] * sy.block_size
        s, sent[name] = _burst_stream(
            burst[name], total, sy.overlap, gaps[name], seed=3 + i,
            header_len=getattr(sy, "header_user", 8),
            payload_len=40 if name == "wlan" else 90)
        streams[name] = _impair(s, 10 + i, cfo=0.0005)
    return streams, sent, syncs


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    X = (rng.normal(size=(4, L)) + 1j * rng.normal(size=(4, L))
         ).astype(np.complex64)
    Y = rng.normal(size=(4 * 3, 2, 5)).astype(np.float32)
    streams, sent, syncs = _family_streams()
    return X, Y, streams, sent, syncs


@pytest.fixture(scope="module")
def world(inputs):
    """The 4-rank gloo world's outputs, one dict per rank."""
    X, Y, streams, _, syncs = inputs
    family = {"streams": streams, "syncs": syncs,
              "chunk_blocks": CHUNK_BLOCKS}
    return distributed.spawn(ranks.mesh_and_collectives, 4, X, Y, family,
                             device="cpu", timeout_s=SPAWN_TIMEOUT_S)


# ---------------------------------------------------------------------------
# without a world
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
def test_factor_devices_matches_jax(n):
    assert factor_devices(n) == jmesh.factor_devices(n)


@pytest.mark.parametrize("index", [0, 2 ** 24 + 1, 2 ** 31 + 5, 2 ** 32 - 1])
@pytest.mark.parametrize("freq", [-0.5 * 3 / 4 * np.pi, 0.3])
def test_nco_init_at_matches_jax_exactly(index, freq):
    want = jnco.nco_init_at(freq, index)
    got = tnco.nco_init_at(freq, index, "cpu")
    assert int(got.phase) == int(want.phase)
    assert int(got.freq) == int(want.freq)
    # and the ramp from there, as the sharded builders mix with it
    x = np.ones(64, np.complex64)
    _, jy = jnco.nco_mix_block(want, jnp.asarray(x))
    _, ty = tnco.nco_mix_block(tnco.nco_init_at(freq, index, "cpu"),
                               torch.as_tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6)


def test_local_device_takes_the_cpu_only_when_asked(monkeypatch):
    monkeypatch.delenv(DEVICE_ENV, raising=False)
    assert distributed.local_device("cpu") == torch.device("cpu")
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    assert distributed.local_device() == torch.device("cpu")
    monkeypatch.delenv(DEVICE_ENV)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.local_device()


def test_init_without_a_launch_forms_no_group(monkeypatch):
    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    distributed.init()
    assert not distributed.is_distributed()
    assert distributed.local_info() == {
        "process_index": 0, "process_count": 1, "local_devices": 1,
        "global_devices": 1}


def test_spawn_raises_the_failing_ranks_error():
    with pytest.raises(ValueError, match="rank 1 fails on purpose") as info:
        distributed.spawn(ranks.fails_on_rank_one, 2, device="cpu",
                          timeout_s=120)
    assert isinstance(info.value.__cause__, distributed.RankTraceback)
    assert "rank 1:" in str(info.value.__cause__)


def test_spawn_kills_the_world_at_its_timeout():
    with pytest.raises(TimeoutError, match="did not finish"):
        distributed.spawn(ranks.hangs, 2, device="cpu", timeout_s=6)


# ---------------------------------------------------------------------------
# the world: mesh and launcher
# ---------------------------------------------------------------------------

def test_mesh_layout_matches_jax(world):
    jm = jmesh.make_sdr_mesh(4)
    assert jm.axis_names == TC
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for out in world:
        r = out["rank"]
        assert out["coord"] == tuple(int(v) for v in np.argwhere(ids == r)[0])
        t, c = out["coord"]
        assert out["time_group"] == [int(v) for v in ids[:, c]]
        assert out["channel_group"] == [int(v) for v in ids[t, :]]
        assert out["info"] == {"process_index": r, "process_count": 4,
                               "local_devices": 1, "global_devices": 4}
        assert out["is_distributed"]
    # a mesh over the first ranks only, laid out as JAX's over the first
    # devices; the others are outside it
    sub = np.vectorize(lambda d: d.id)(jmesh.make_sdr_mesh(2).devices)
    for out in world:
        where = np.argwhere(sub == out["rank"])
        want = tuple(int(v) for v in where[0]) if len(where) else None
        assert out["sub_coord"] == want


def test_mesh_raises_where_jax_raises(world):
    with pytest.raises(ValueError, match="available"):
        jmesh.make_sdr_mesh(len(jax.devices()) + 1)
    with pytest.raises(ValueError, match="!="):
        jmesh.make_sdr_mesh(4, axis_shapes=(3, 1))
    for out in world:
        assert out["too_many"].startswith("ValueError") and \
            "available" in out["too_many"]
        assert out["bad_shape"].startswith("ValueError") and \
            "!=" in out["bad_shape"]


def test_builders_raise_where_jax_raises(world):
    jm = _jmesh4((2, 2), TC)
    js = jsync.make_sync(jofdm.make_ofdm_params(48, 6, 4), block_size=2048,
                         max_payload=64, max_frames=4)
    with pytest.raises(ValueError, match="not divisible"):
        jstream.make_sharded_mcrx(jm, 3, js, 2)
    with pytest.raises(ValueError, match="halo"):
        jstream.make_sharded_mcrx(jm, 4, js, 1)
    with pytest.raises(ValueError, match="not divisible"):
        jstream.make_sharded_mcrx_a2a(jm, 3, js, 1)
    with pytest.raises(ValueError, match="halo"):
        jstream.make_time_sharded_sync(_jmesh4((4,), ("time",)), js, 1)
    for out in world:
        assert "ValueError" in out["err_channels"]
        assert "not divisible" in out["err_channels"]
        assert "ValueError" in out["err_halo"] and "halo" in out["err_halo"]
        assert "not divisible" in out["err_a2a_channels"]
        assert "halo" in out["err_time_halo"]


def test_builder_without_a_device_raises_without_a_card(world):
    """The no-card rule in a rank: no ``device="cpu"`` and no
    ``LIQUID_USRP_TORCH_DEVICE`` means the card, and there is none here."""
    for out in world:
        assert out["no_card"].startswith("RuntimeError")
        assert "no CUDA device" in out["no_card"]


def test_spawn_without_a_device_raises_without_a_card(monkeypatch):
    monkeypatch.delenv(DEVICE_ENV, raising=False)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.spawn(ranks.fails_on_rank_one, 2, timeout_s=120)


# ---------------------------------------------------------------------------
# the world: collectives against lax's
# ---------------------------------------------------------------------------

def test_shard_for_matches_jax_shardings(world, inputs):
    X = inputs[0]
    jm = _jmesh4((2, 2), TC)
    specs = {("time",): P("time"), (TC,): P(TC),
             ("channel", "time"): P("channel", "time"), (None, TC): P(None, TC)}
    for spec, pspec in specs.items():
        idx = NamedSharding(jm, pspec).devices_indices_map(X.shape)
        for out in world:
            dev = jm.devices.reshape(-1)[out["rank"]]
            np.testing.assert_array_equal(out["shards"][str(spec)],
                                          X[idx[dev]])


def test_ppermute_matches_lax(world, inputs):
    X = inputs[0]
    jm = _jmesh4((2, 2), TC)
    chain = [(i, i + 1) for i in range(3)]

    def body(x):
        return (jax.lax.ppermute(x, "time", [(0, 1)]),
                jax.lax.ppermute(x, "channel", [(1, 0)]),
                jax.lax.ppermute(x, TC, chain),
                jax.lax.ppermute(x, TC, [(3, 0)]))

    f = jax.shard_map(body, mesh=jm, in_specs=P(TC), out_specs=P(TC),
                      check_vma=False)
    want = [np.asarray(v) for v in f(jnp.asarray(X))]
    for out in world:
        r = out["rank"]
        for k, name in enumerate(("pp_time", "pp_channel", "pp_chain",
                                  "pp_wrap")):
            np.testing.assert_array_equal(out[name], want[k][r], err_msg=name)
    # ranks that no pair sends to got zeros
    assert not world[0]["pp_chain"].any() and not world[1]["pp_wrap"].any()


@pytest.mark.parametrize("concat_axis", [0, 2])
def test_all_to_all_matches_lax(world, inputs, concat_axis):
    Y = inputs[1]
    jm = _jmesh4((2, 2), TC)
    f = jax.shard_map(
        lambda y: jax.lax.all_to_all(y, "channel", 1, concat_axis,
                                     tiled=False),
        mesh=jm, in_specs=P(TC), out_specs=P(TC), check_vma=False)
    want = np.asarray(f(jnp.asarray(Y)))
    want = want.reshape((4, -1) + want.shape[1:])
    if concat_axis == 2:
        want = want.reshape(4, 3, 5, 2)
    for out in world:
        got = out[f"a2a_{concat_axis}"]
        np.testing.assert_array_equal(got, want[out["rank"]])


def test_gather_tree_assembles_every_dtype(world, inputs):
    X = inputs[0]
    want = [np.array([[r, -r] for r in range(4)], np.int32),
            np.array([[r % 2 == 0, True] for r in range(4)]),
            np.array([[r, 255 - r] for r in range(4)], np.uint8),
            np.array([[[0.5 * r]] for r in range(4)], np.float32),
            X]
    for out in world:
        for got, w in zip(out["gathered"], want):
            assert got.dtype == w.dtype
            np.testing.assert_array_equal(got, w.reshape((2, 2) + w.shape[1:]))
        t, c = out["coord"]
        np.testing.assert_array_equal(out["gathered_time"][0],
                                      want[0][[c, 2 + c]])


# ---------------------------------------------------------------------------
# the world: time sharding
# ---------------------------------------------------------------------------

def _keyed(res):
    """Detected rows by ``t_start``: {t_start: {field: value}}."""
    det = np.nonzero(np.asarray(res["detected"]))[0]
    return {int(res["t_start"][r]): {f: np.asarray(v[r])
                                    for f, v in res.items()} for r in det}


def _rows_equal(got, want):
    """Masked fields exact, float statistics within the tolerances."""
    g, w = _keyed(got), _keyed(want)
    assert g.keys() == w.keys()
    for t in g:
        for f in g[t]:
            if f in ("rssi", "evm", "cfo"):
                tol = {"rssi": 1e-3, "evm": 0.05, "cfo": 1e-5}[f]
                np.testing.assert_allclose(g[t][f], w[t][f], atol=tol,
                                           err_msg=f)
            elif f not in ("payload", "psdu", "header"):
                np.testing.assert_array_equal(g[t][f], w[t][f], err_msg=f)
        valid = g[t].get("payload_valid", g[t].get("psdu_valid"))
        if valid:
            body = "payload" if "payload" in g[t] else "psdu"
            n = int(g[t].get("payload_len", g[t].get("length")))
            np.testing.assert_array_equal(g[t][body][:n], w[t][body][:n])
        if g[t].get("header_valid"):
            np.testing.assert_array_equal(g[t]["header"], w[t]["header"])


def _delivered(res, sent, slack=2):
    valid = res.get("payload_valid", res.get("psdu_valid"))
    body = "payload" if "payload" in res else "psdu"
    size = "payload_len" if "payload_len" in res else "length"
    rows = np.nonzero(res["detected"] & valid)[0]
    got = sorted((int(res["t_start"][r]), res[body][r][:int(res[size][r])])
                 for r in rows)
    assert len(got) == len(sent) > 2, (len(got), len(sent))
    for (t_got, p_got), (t_want, p_want) in zip(got, sent):
        assert abs(t_got - t_want) <= slack
        np.testing.assert_array_equal(p_got, p_want)


def test_time_sharded_ofdm_matches_jax(world, inputs):
    streams, sent = inputs[2], inputs[3]
    jm = _jmesh4((4,), ("time",))
    js = jsync.make_sync(jofdm.make_ofdm_params(48, 6, 4),
                         **{k: v for k, v in OFDM_CFG.items()
                            if k != "use_pallas"})
    assert js.use_pallas == OFDM_CFG["use_pallas"]
    run = jstream.make_time_sharded_sync(jm, js, CHUNK_BLOCKS["ofdm"])
    want = jax.device_get(run(jnp.asarray(streams["ofdm"])))
    got = world[0]["time_ofdm"]
    assert got["detected"].shape == want.detected.shape
    _rows_equal(got, {f: np.asarray(v) for f, v in want._asdict().items()})
    _delivered(got, sent["ofdm"])


def _sequential(sync, stream):
    """The port's own block loop over the stream (zero-padded by one
    overlap and one block), results stacked like the sharded rows."""
    from liquid_usrp_tpu_torch.parallel.stream import _sync_ops
    block_fn, _ = _sync_ops(sync)
    init = {"flex": tffs.flex_sync_init, "gmsk": tgf.gmsk_sync_init,
            "wlan": twlan.wlan_sync_init}
    kind = {tffs.FlexSync: "flex", tgf.GmskSync: "gmsk",
            twlan.WlanSync: "wlan"}[type(sync)]
    state = init[kind](sync, "cpu")
    bs = sync.block_size
    padded = np.concatenate([stream,
                             np.zeros(sync.overlap + bs, np.complex64)])
    rows = []
    for b in range(len(padded) // bs):
        state, r = block_fn(sync, state,
                            torch.as_tensor(padded[b * bs:(b + 1) * bs]))
        rows.append(r)
    return {f: torch.cat([getattr(r, f) for r in rows]).numpy()
            for f in rows[0]._fields}


@pytest.mark.parametrize("family", ["flex", "gmsk", "wlan"])
def test_time_sharded_family_matches_sequential(world, inputs, family):
    streams, sent, syncs = inputs[2], inputs[3], inputs[4]
    got = world[0][f"time_{family}"]
    want = _sequential(syncs[family], streams[family])
    n = len(got["detected"])
    # the same blocks, so the same rows, slot for slot
    np.testing.assert_array_equal(got["detected"], want["detected"][:n])
    assert not want["detected"][n:].any()
    _rows_equal(got, want)
    _delivered(got, sent[family], slack=0 if family == "wlan" else 2)
