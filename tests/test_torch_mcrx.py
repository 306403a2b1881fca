"""The whole slice: the port's multichannel TX/RX against the JAX package.

Tolerances: the synthesized mixture max abs error <= 1e-5 of its peak; RX
results exact in the detected/valid-masked fields (``rssi`` atol 1e-3 dB,
``evm`` atol 0.05 dB, ``cfo`` atol 1e-5 rad/sample); NCO phase and sync
``base`` state exact; carried sample state atol 1e-5 of the peak.  The
port's RX resumes from a converted mid-stream JAX state, and every
injected payload must decode byte-exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquid_usrp_tpu.apps import common as jcommon
from liquid_usrp_tpu.framing import ofdm as jofdm
from liquid_usrp_tpu.framing import ofdm_sync as jsync
from liquid_usrp_tpu.models import multichannel as jmc
from liquid_usrp_tpu_torch.apps import common as tcommon
from liquid_usrp_tpu_torch.apps import multichannel_rx, multichannel_tx
from liquid_usrp_tpu_torch.framing import ofdm as tofdm
from liquid_usrp_tpu_torch.framing import ofdm_sync as tsync
from liquid_usrp_tpu_torch.models import multichannel as tmc
from liquid_usrp_tpu_torch.utils.convert import from_jax_tree, to_numpy_tree
from liquid_usrp_tpu_torch.utils.device import DEVICE_ENV

N = 2
BS = 4096
NB = 2
STEP = BS * NB                  # channel samples per RX step


@pytest.fixture
def cpu_env(monkeypatch):
    """The CLIs take no device flag: ask for the CPU through the
    environment, as the JAX apps run under ``JAX_PLATFORMS=cpu``."""
    monkeypatch.setenv(DEVICE_ENV, "cpu")


@pytest.fixture(scope="module")
def mixture():
    """2 channels x 2 frames (one straddling the first step edge), through
    the JAX synthesizer and the port's; returns (JAX mixture, port mixture,
    injected (channel, header, payload) list)."""
    rng = np.random.default_rng(7)
    params = tofdm.make_ofdm_params(48, 6, 4)
    total = 3 * STEP
    Y = np.zeros((total, 2 * N), np.complex64)
    sent = []
    for ch, pos in ((0, 1000), (0, 5000), (1, 3000), (1, 7500)):
        hdr = rng.integers(0, 256, 8, dtype=np.uint8)
        pay = rng.integers(0, 256, 90, dtype=np.uint8)
        f = tofdm.assemble_frame(params, tofdm.default_props(),
                                 torch.as_tensor(hdr),
                                 torch.as_tensor(pay)).numpy()
        Y[pos:pos + len(f), ch] = f
        sent.append((ch, hdr, pay))
    jinit, jstep = jmc.make_mctx_step(N)
    _, jy = jstep(jinit(), jnp.asarray(Y))
    tinit, tstep = tmc.make_mctx_step(N, "cpu")
    ts, ty = tstep(tinit(), torch.as_tensor(Y))
    jy = np.asarray(jy)
    noise = 0.002 * (rng.normal(size=jy.shape) + 1j * rng.normal(size=jy.shape))
    return ((jy + noise).astype(np.complex64),
            (ty.numpy() + noise).astype(np.complex64), sent)


def test_mctx_matches_jax(mixture):
    jy, ty, _ = mixture
    assert jy.shape == ty.shape == (2 * N * 3 * STEP,)
    assert np.abs(ty - jy).max() <= 1e-5 * np.abs(jy).max()


def _rows(res):
    out = {}
    for idx in zip(*np.nonzero(np.asarray(res.detected))):
        key = (int(idx[0]), int(res.t_start[idx]))
        out[key] = {f: np.asarray(getattr(res, f)[idx]) for f in res._fields}
    return out


def _compare(tres, jres):
    tres = to_numpy_tree(tres)
    jres = jax.device_get(jres)
    for f in ("detected", "header_valid", "payload_valid"):
        np.testing.assert_array_equal(np.sort(getattr(tres, f), axis=-1),
                                      np.sort(getattr(jres, f), axis=-1))
    tr, jr = _rows(tres), _rows(jres)
    assert tr.keys() == jr.keys()
    for key in tr:
        for f in ("header_valid", "payload_valid", "header", "payload",
                  "payload_len", "mod", "fec0", "fec1", "check", "t_start"):
            np.testing.assert_array_equal(tr[key][f], jr[key][f])
        np.testing.assert_allclose(tr[key]["rssi"], jr[key]["rssi"],
                                   atol=1e-3)
        np.testing.assert_allclose(tr[key]["evm"], jr[key]["evm"],
                                   atol=0.05)
        np.testing.assert_allclose(tr[key]["cfo"], jr[key]["cfo"],
                                   atol=1e-5)
    return tr


def _state_close(tstate, jstate):
    t, j = to_numpy_tree(tstate), jax.device_get(jstate)
    assert int(t.nco.phase) == int(j.nco.phase)
    assert int(t.nco.freq) == int(j.nco.freq)
    np.testing.assert_array_equal(t.syncs.base, j.syncs.base)
    for a, b in ((t.chz.frames, j.chz.frames), (t.syncs.tail, j.syncs.tail)):
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max())


def test_mcrx_batched_matches_jax_and_resumes(mixture):
    jy, _, sent = mixture
    params = jofdm.make_ofdm_params(48, 6, 4)
    kw = dict(block_size=BS, max_payload=128, max_frames=8, use_pallas=1)
    jsy = jsync.make_sync(params, **kw)
    tsy = tsync.make_sync(tofdm.make_ofdm_params(48, 6, 4), **kw)
    jinit, jstep = jmc.make_mcrx_batched_step(N, jsy, NB)
    tinit, tstep = tmc.make_mcrx_batched_step(N, tsy, NB, "cpu")
    g = 2 * N * STEP
    chunks = [jy[i * g:(i + 1) * g] for i in range(3)] + \
        [np.zeros(g, np.complex64)]
    js, ts = jinit(), tinit()
    found = {}
    for i, x in enumerate(chunks):
        if i == 1:
            # resume the port from the converted mid-stream JAX state
            ts = from_jax_tree(jax.device_get(js), "cpu")
        js, jr = jstep(js, jnp.asarray(x))
        ts, tr = tstep(ts, torch.as_tensor(x))
        assert tr.detected.shape == (N, NB, 8)
        found.update(_compare(tr, jr))
        _state_close(ts, js)
    got = {(k[0], bytes(r["header"])): r for k, r in found.items()
           if r["payload_valid"]}
    assert len(got) == len(sent) == 4
    for ch, hdr, pay in sent:
        r = got[(ch, bytes(hdr))]
        np.testing.assert_array_equal(r["payload"][:90], pay)
        assert int(r["payload_len"]) == 90


def test_state_conversion_roundtrip():
    params = jofdm.make_ofdm_params(48, 6, 4)
    jsy = jsync.make_sync(params, block_size=BS, max_payload=64)
    jinit, _ = jmc.make_mcrx_step(N, jsy)
    js = jax.device_get(jinit())
    back = to_numpy_tree(from_jax_tree(js, "cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_multichannel_rx_class_and_apps(cpu_env, tmp_path, capsys):
    """MultichannelRx (execute + flush) loopback, and the CLI pair, also
    with ``--snr/--cfo`` impairments and the ``-d`` debug dump."""
    tx = tmc.MultichannelTx(N, device="cpu")
    rx = tmc.MultichannelRx(N, block_size=2048, max_payload=128,
                             device="cpu")
    assert rx.sync.use_pallas == 1          # "auto" -> kernel B1
    rng = np.random.default_rng(8)
    sent = {}
    for ch in range(N):
        hdr = rng.integers(0, 256, 8, dtype=np.uint8)
        pay = rng.integers(0, 256, 64, dtype=np.uint8)
        tx.update_data(ch, hdr, pay)
        sent[ch] = pay
    mix = tx.generate_samples(max(len(q) for q in tx._queues) + 64)
    frames = rx.execute(mix) + rx.flush()
    got = {f["channel"]: f for f in frames if f["payload_valid"]}
    assert set(got) == set(range(N))
    for ch, pay in sent.items():
        np.testing.assert_array_equal(got[ch]["payload"], pay)
    path = str(tmp_path / "mc.iq")
    assert multichannel_tx.main(["-o", path, "-n", "2", "-N", "2",
                                 "-P", "60"]) == 0
    assert multichannel_rx.main(["-i", path, "-n", "2", "-q"]) == 0
    assert "valid packets       :      4 (100.00%)" in capsys.readouterr().out
    # virtual-channel impairments and the per-channel debug dump
    dbg = str(tmp_path / "dbg")
    assert multichannel_rx.main(["-i", path, "-n", "2", "-q", "--snr", "30",
                                 "--cfo", "0.001", "--seed", "2",
                                 "-d", dbg]) == 0
    assert "valid packets       :      4 (100.00%)" in capsys.readouterr().out
    for ch in range(2):
        text = open(f"{dbg}_framesync_channel{ch}.m").read()
        assert "detected=1 hdr_valid=1" in text and "H = [" in text
    with pytest.raises(SystemExit):
        multichannel_rx.main(["-i", path, "--bogus"])
    x = (rng.normal(size=300) + 1j * rng.normal(size=300)).astype(
        np.complex64)
    x[:100] = 0
    assert tcommon.occupied_power(x) == jcommon.occupied_power(x)
