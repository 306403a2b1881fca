"""The BER/PER sweep (``apps/ber_sweep.py``) against the JAX repo's
``scripts/ber_sweep.py``, uncoded, one case per frame family.

- ``theory_per`` equal to the script's within 1e-12 over -6..26 dB, and
  ``implementation_loss_db`` equal on the stored uncoded curves
  (``docs/ber_{ofdm,flex,gmsk}.json``);
- ``build_stream``: payloads, headers and frame positions equal to the
  script's for the same seed; the port's TX waveform within 1e-5 of JAX's
  peak (OFDM, flexframe) or 1e-4 (GMSK: the phase is a float32 cumsum
  that each backend rounds in its own order), the frame power within a
  relative 1e-5;
- one near-threshold point per family (20 frames): JAX's noisy stream
  (JAX TX, JAX ``channel_apply`` with the script's key) through the port's
  ``sweep_point`` on the CPU and through the script's receive loop (JAX's
  jitted ``make_sync_step``): detections and header errors equal; the
  frames whose ``payload_valid`` differs at most 1, and the bit-error
  total within 8 bits a frame whose bit errors differ (the measured gap
  is printed; on the CPU it was 0 flips and 0 bits at every point);
- the port's rows at 8 blocks a batched dispatch (``BLOCKS``, what the
  sweep runs) exactly equal to those of a loop of one ``make_sync_step`` a
  block, as JAX's loop runs;
- GMSK's silence gate, which tests one raw sample, drops a frame whose
  first sample is nulled at 0 dB in both packages (ROADMAP Queue C, found
  in the reference and mirrored).

The detect levels and the soft v27 point are in
``test_torch_ber_levels.py``.  Cases are seeded with ``zlib.crc32``.
"""
import functools
import json
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_ber_ref as ref
from liquid_usrp_tpu_torch.apps import ber_sweep as bs
from liquid_usrp_tpu_torch.utils.device import DEVICE_ENV

DOCS = Path(__file__).resolve().parent.parent / "docs"
PAYLOAD, FRAMES = 200, 20
# a point on each family's waterfall (PER 0.27-0.39 at 200 frames, docs/)
SNR = {"ofdm": 7.0, "flex": 5.0, "gmsk": 2.0}
TX_ATOL = {"ofdm": 1e-5, "flex": 1e-5, "gmsk": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@functools.lru_cache(maxsize=None)
def _script():
    return ref.script()


@functools.lru_cache(maxsize=None)
def _case(family):
    """The JAX stream and point of one family, and the port's config."""
    sync, step, init, assemble = ref.config(family, PAYLOAD)
    x, positions, payloads, headers, sig_pwr = ref.stream(
        sync, assemble, FRAMES, PAYLOAD, zlib.crc32(family.encode()))
    y = ref.noisy(x, sig_pwr, SNR[family])
    want = ref.point(sync, step, init, y, positions, payloads, PAYLOAD,
                     SNR[family])
    return dict(x=x, positions=positions, payloads=payloads,
                headers=headers, sig_pwr=sig_pwr, y=y, want=want,
                jax=(sync, step, init), cfg=bs.make_config(family, PAYLOAD))


@functools.lru_cache(maxsize=None)
def _port_score(family):
    c = _case(family)
    return bs.score(bs.receive(c["cfg"], torch.as_tensor(c["y"])),
                    c["positions"], c["payloads"], PAYLOAD)


@pytest.mark.parametrize("family", bs.FAMILIES)
def test_theory_per_matches_the_script(family):
    for snr in np.arange(-6.0, 26.01, 0.5):
        got = bs.theory_per(family, float(snr), PAYLOAD)
        want = _script().theory_per(family, float(snr), PAYLOAD)
        assert abs(got - want) <= 1e-12, (snr, got, want)


@pytest.mark.parametrize("family", bs.FAMILIES)
def test_implementation_loss_matches_the_script_on_the_stored_curves(family):
    stored = json.loads((DOCS / f"ber_{family}.json").read_text())
    rows = stored["rows"]
    got = bs.implementation_loss_db(rows, family, PAYLOAD)
    assert got == _script().implementation_loss_db(rows, family, PAYLOAD)
    assert got == stored["impl_loss_db_at_1pct_per"]
    # and at a level the sweep does not reach
    assert bs.implementation_loss_db(rows[:2], family, PAYLOAD) is None


@pytest.mark.parametrize("family", bs.FAMILIES)
def test_stream_matches_the_script(family):
    c = _case(family)
    got = bs.build_stream(c["cfg"], FRAMES, zlib.crc32(family.encode()),
                          "cpu")
    assert got.positions == c["positions"]
    for a, b in zip(got.payloads + got.headers,
                    c["payloads"] + c["headers"]):
        np.testing.assert_array_equal(a, b)
    x = got.samples.numpy()
    assert x.shape == c["x"].shape
    peak = float(np.abs(c["x"]).max())
    assert float(np.abs(x - c["x"]).max()) <= TX_ATOL[family] * peak
    assert abs(got.sig_pwr / c["sig_pwr"] - 1.0) <= 1e-5


@pytest.mark.parametrize("family", bs.FAMILIES)
def test_sweep_point_matches_jax_on_its_noisy_stream(family, capsys):
    c = _case(family)
    row_j, ok_j, errs_j = c["want"]
    got = bs.sweep_point(c["cfg"], torch.as_tensor(c["y"]), c["positions"],
                         c["payloads"], SNR[family])
    assert set(got) == set(row_j)
    assert got["snr_db"] == row_j["snr_db"]
    assert got["frames_sent"] == row_j["frames_sent"] == FRAMES
    assert got["frames_detected"] == row_j["frames_detected"]
    assert got["header_errors"] == row_j["header_errors"]
    sc = _port_score(family)
    assert bs.row(sc, SNR[family]) == got
    flips = int((sc.frame_ok != ok_j).sum())
    differ = int((sc.frame_errs != errs_j).sum())
    gap = abs(sc.bit_errs - int(errs_j[errs_j >= 0].sum()))
    with capsys.disabled():
        print(f"\n{family} at {SNR[family]} dB: PER {got['packet_error_rate']}"
              f" (JAX {row_j['packet_error_rate']}), {flips} payload_valid "
              f"flips, {differ} frames with other bit errors, bit-error gap "
              f"{gap}")
    assert flips <= 1
    assert gap <= 8 * differ
    # the point lies on the waterfall: some frames fail, some decode
    assert 0.0 < row_j["packet_error_rate"] < 1.0


def _step_loop(cfg, noisy):
    """The detections of one ``make_sync_step`` a block over ``noisy``
    (zero-padded and flushed as ``dispatches`` does), JAX's loop."""
    from liquid_usrp_tpu_torch.framing import flexframe_sync, gmskframe
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    from liquid_usrp_tpu_torch.models.ofdmtxrx import _to_host
    make_step = {"ofdm": ofdm_sync.make_sync_step,
                 "flex": flexframe_sync.make_flex_sync_step,
                 "gmsk": gmskframe.make_gmsk_sync_step}[cfg.family]
    init = {"ofdm": ofdm_sync.sync_init,
            "flex": flexframe_sync.flex_sync_init,
            "gmsk": gmskframe.gmsk_sync_init}[cfg.family]
    sync = cfg.sync
    bs_ = sync.block_size
    n_blocks = -(-len(noisy) // bs_) + -(-sync.overlap // bs_) + 1
    x = torch.zeros(n_blocks * bs_, dtype=torch.complex64)
    x[:len(noisy)] = noisy
    step, state, out = make_step(sync), init(sync, "cpu"), []
    for blk in x.reshape(n_blocks, bs_):
        state, res = step(state, blk)
        out.append(_to_host(type(res)(*(v[None] for v in res))))
    return bs.collect(out)


@pytest.mark.parametrize("family", bs.FAMILIES)
def test_blocks_a_dispatch_give_the_same_rows(family):
    c = _case(family)
    steps = bs.score(_step_loop(c["cfg"], torch.as_tensor(c["y"])),
                     c["positions"], c["payloads"], PAYLOAD)
    for a, b in zip(steps, _port_score(family)):
        np.testing.assert_array_equal(a, b)
    sync = c["cfg"].sync
    n_blocks = -(-len(c["y"]) // sync.block_size) + \
        -(-sync.overlap // sync.block_size) + 1
    assert bs.receive(c["cfg"], torch.as_tensor(c["y"])).dispatches == \
        -(-n_blocks // bs.BLOCKS)


def test_cli_writes_rows_and_manifest(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    out = tmp_path / "gmsk.json"
    assert bs.main(["gmsk", "--snrs", "2,12", "--frames", "4", "--json",
                    str(out)]) == 0
    text = capsys.readouterr().out
    assert "implementation loss at 1% PER" in text
    got = json.loads(out.read_text())
    assert [r["snr_db"] for r in got["rows"]] == [2.0, 12.0]
    hi = got["rows"][1]
    assert hi["frames_detected"] == 4 and hi["packet_error_rate"] == 0.0
    assert hi["theory_per"] == round(bs.theory_per("gmsk", 12.0, PAYLOAD), 6)
    m = got["manifest"]
    assert (m["family"], m["frames"], m["device"]) == ("gmsk", 4, "cpu")
    for key in ("git_sha", "utc", "card", "seconds", "cmd"):
        assert key in m


def test_soft_with_an_outer_code_warns(capsys):
    cfg = bs.make_config("flex", PAYLOAD, fec0="v27", fec1="h74", soft=True)
    assert "warning: --soft with a conv fec0" in capsys.readouterr().err
    assert cfg.sync.soft and len(cfg.sync.fecs) > 10
    bs.make_config("flex", PAYLOAD, fec0="v27", fec1="none", soft=True)
    assert capsys.readouterr().err == ""


def test_gmsk_silence_gate_on_one_null_sample_mirrors_jax():
    """The GMSK detector gates its metric to 0 where the raw sample at the
    candidate offset has less than 1e-3 of the window's mean power
    (``gmskframe._front_end``, as JAX's).  At 0 dB the metric's
    neighbours lie below the threshold, so a frame whose first sample
    fades into that floor is not detected: both packages miss frame 3 of
    this stream once its first sample is 0, and detect it otherwise (on
    the card the sweep met two such fades in 16 GMSK v27 points)."""
    c = _case("gmsk")
    sync, step, init = c["jax"]
    k = 3
    clean = ref.noisy(c["x"], c["sig_pwr"], 0.0)
    nulled = clean.copy()
    nulled[c["positions"][k]] = 0
    for y, want_missed in ((clean, False), (nulled, True)):
        _, _, errs_j = ref.point(sync, step, init, y, c["positions"],
                                 c["payloads"], PAYLOAD, 0.0)
        sc = bs.score(bs.receive(c["cfg"], torch.as_tensor(y)),
                      c["positions"], c["payloads"], PAYLOAD)
        missed = set(np.nonzero(sc.frame_errs < 0)[0].tolist())
        assert missed == set(np.nonzero(errs_j < 0)[0].tolist())
        assert (k in missed) == want_missed
