"""A cell on several cards, rehearsed as a gloo world of 2 CPU ranks: the
tiny ``mcrx4.loaded`` cell with ``chips`` 2, every rank running the whole
one-card receiver (replicated).  And the one-card path, which forms no
world and reports what it always has."""
import multiprocessing
import re
import time

import pytest
import torch
import torch.distributed as dist

from rxbench import harness, manifest, ranks, run
from rxbench.tests import rank_faults
from rxbench.tests.conftest import tiny_cell, tiny_run

ONE_CARD_KEYS = ["correct", "attempted", "failed", "metrics", "device",
                 "checks"]
ONE_CARD_DEVICE = ["platform", "kind", "count", "memory_peak_bytes"]


@pytest.fixture
def limits(monkeypatch):
    """Each spawning test's own time limit: the launcher's phase limits,
    past which it kills every rank."""
    monkeypatch.setattr(ranks, "SETUP_LIMIT_S", 90)
    monkeypatch.setattr(ranks, "WINDOW_MARGIN_S", 30)
    monkeypatch.setattr(ranks, "RESULT_LIMIT_S", 60)


def two_ranks(**kw):
    cell = tiny_cell("mcrx4.loaded")
    cell["workload"]["chips"] = 2
    lines: list = []
    t = time.perf_counter()
    kw.setdefault("count", 4)
    try:
        out = ranks.launch(cell, 5, kw.pop("seconds", 0.0), False, t,
                           log=lambda *a: lines.append(" ".join(map(str, a))),
                           cuda=False, **kw)
    finally:
        assert not multiprocessing.active_children()
    return out, lines


def test_two_ranks_run_the_same_window_and_report_both_cards(limits):
    # rank 0's clock closes the window; the other rank follows it
    out, lines = two_ranks(seconds=2.0, count=None)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    dev = out["device"]
    assert dev["count"] == 2
    assert list(dev) == ONE_CARD_DEVICE + ["memory_peak_bytes_each"]
    assert len(dev["memory_peak_bytes_each"]) == 2
    assert list(out) == ONE_CARD_KEYS
    assert set(out["metrics"]) >= {"rx_msps", "setup_s"}
    runs = [re.search(r"dispatches \[(\d+), (\d+)\]", line)
            for line in lines]
    n = [m.groups() for m in runs if m]
    assert len(n) == 1 and n[0][0] == n[0][1] != "0"


@pytest.mark.parametrize("target, says, margin, code", [
    (rank_faults.fails_in_window,
     "rank 1 failed:\nTraceback (most recent call last):", 30, 1),
    (rank_faults.makes_another_stream, "made another stream than rank 0",
     30, 1),
    (rank_faults.hangs_in_window, "did not reach window within 5 s", 5, 1),
    (rank_faults.loads_jax, "imported in the ranks: {1: ['jax']}", 30, 3),
], ids=["raises", "stream_differs", "hangs", "loads_jax"])
def test_a_failing_rank_ends_the_run(limits, monkeypatch, target, says,
                                     margin, code):
    """With its traceback (or what it failed to reach, or what it
    imported), within its phase's limit, and with every rank ended."""
    monkeypatch.setattr(ranks, "WINDOW_MARGIN_S", margin)
    t = time.perf_counter()
    with pytest.raises(ranks.RankFailure) as e:
        two_ranks(target=target)
    assert says in str(e.value)
    assert e.value.code == code
    assert time.perf_counter() - t < 60


def test_one_card_result_keys_are_unchanged():
    out = tiny_run(tiny_cell("mcrx4.loaded"))
    assert list(out) == ONE_CARD_KEYS
    assert list(out["device"]) == ONE_CARD_DEVICE
    assert out["device"]["count"] == 1


def _fake_cards(monkeypatch, n, chips):
    cell = manifest.cell("mcrx4.loaded")
    cell["workload"]["chips"] = chips
    monkeypatch.setattr(manifest, "cell", lambda name: cell)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    monkeypatch.setattr(run, "card", lambda: "a card")
    calls = []
    monkeypatch.setattr(harness, "run_cell",
                        lambda *a, **k: calls.append(a) or {"checks": {}})
    monkeypatch.setattr(ranks, "launch", lambda *a, **k: pytest.fail(
        "a one-card cell was launched as ranks"))
    return calls


def test_one_card_cell_runs_in_this_process_on_cuda_0(monkeypatch, capsys):
    calls = _fake_cards(monkeypatch, 4, 1)
    assert run.main(["--workload", "mcrx4.loaded", "--seed", "1",
                     "--seconds", "1"]) == 0
    assert len(calls) == 1 and calls[0][4] == "cuda:0"
    assert not dist.is_initialized()
    assert capsys.readouterr().out.strip() == '{"checks": {}}'


def test_too_few_cards_exit_2_with_no_result(monkeypatch, capsys):
    calls = _fake_cards(monkeypatch, 1, 2)
    assert run.main(["--workload", "mcrx4.loaded", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert not calls
    cap = capsys.readouterr()
    assert cap.out == "" and "needs 2 CUDA device(s)" in cap.err
