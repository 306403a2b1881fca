"""A run of each cell at a tiny size on the CPU, through the port's plain
path: every cell decodes every frame and its estimates match the
reference's; the control (the program's bfloat16 ingest) and each fault
that the timed path can have come out not correct."""
import pytest
import torch

from liquid_usrp_tpu_torch.framing import ofdm_sync
from liquid_usrp_tpu_torch.models import multichannel
from rxbench.tests.conftest import tiny_cell, tiny_run

CELLS = ["mcrx4.loaded", "mcrx4.burst", "ofdm1_conv.v27",
         "ofdm1_conv.golay"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct(name):
    out = tiny_run(tiny_cell(name))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) >= {"rx_msps", "setup_s"}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", ["mcrx4.loaded", "ofdm1_conv.golay"])
def test_control_is_not_correct(name):
    out = tiny_run(tiny_cell(name), ingest="bf16")
    assert not out["correct"]
    c = out["checks"]
    # every frame still decodes: the estimates tell the control apart
    assert c["frames_missed"]["value"] == c["frames_wrong"]["value"] == 0
    assert c["rssi_gap_db"]["value"] > c["rssi_gap_db"]["limit"] or \
        c["cfo_gap"]["value"] > c["cfo_gap"]["limit"]


def _state_unchanged(monkeypatch):
    """Every step hands back the state it was given."""
    step = multichannel.Mcrx.step
    monkeypatch.setattr(multichannel.Mcrx, "step",
                        lambda self, state, x: (state, step(self, state,
                                                            x)[1]))
    batched = ofdm_sync.sync_blocks_batched
    monkeypatch.setattr(ofdm_sync, "sync_blocks_batched",
                        lambda sync, state, blocks: (
                            state, batched(sync, state, blocks)[1]))


def _half_batch(monkeypatch):
    """The second half of each dispatch's windows is left out."""
    results = ofdm_sync._results

    def drop(detected, locs, base_t, decoded, shape):
        d = detected.reshape(-1, detected.shape[-1]).clone()
        d[d.shape[0] // 2:] = False
        return results(d.reshape(detected.shape), locs, base_t, decoded,
                       shape)
    monkeypatch.setattr(ofdm_sync, "_results", drop)


def _answer_altered(monkeypatch):
    """One payload byte of every dispatch flipped where it is produced."""
    results = ofdm_sync._results

    def alter(*args):
        res = results(*args)
        payload = res.payload.clone()
        payload.reshape(-1, payload.shape[-1])[
            torch.nonzero(res.detected.reshape(-1))[:1, 0], 3] ^= 0x10
        return res._replace(payload=payload)
    monkeypatch.setattr(ofdm_sync, "_results", alter)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("name", ["mcrx4.loaded", "ofdm1_conv.golay"])
def test_fault_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    fault(monkeypatch)
    out = tiny_run(cell)
    assert not out["correct"], out["checks"]
    assert out["failed"] > 0
