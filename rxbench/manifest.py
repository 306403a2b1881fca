"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads``) names a configuration and a traffic mix; the
configuration's file (``configs``, ``file``) names its entry module
(``rxbench/entries/<entry>.py``) and its limits; the traffic is
``rxbench/traffic/<traffic>.json``; each per-layer metric is read by
``rxbench/metrics/<name>.py``.  Adding a cell, a configuration, a traffic
mix or a metric adds files and entries and edits none.

The entry contract on k > 1 cards (``chips``; ``rxbench/ranks.py``): rank
r is a process of its own and builds ``Entry(config, "cuda:r", ingest)``
with the signature a one-card entry has, after the harness has formed the
default process group (NCCL, ``device_id`` = ``cuda:r``); the entry reads
its rank and the world's size from ``torch.distributed`` and builds its
mesh with the port's ``parallel.mesh.make_sdr_mesh``.  Every rank makes
the stream from the seed on its own card (``txgen.make_stream``), and
set-up fails unless the hashes of every rank's host chunks, gathered at
set-up, equal rank 0's.  ``dispatch_samples`` counts the input samples of
a dispatch over all ranks.  Every rank is handed the same buffers in the
same number; ``rows()`` is called on every rank after the window, and rank
0's are the global rows, the only ones ``reference.match`` and
``estimate_gaps`` judge.
"""
from __future__ import annotations

import importlib
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def load(path: Path | None = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def cell(name: str, bench: dict | None = None) -> dict:
    """Everything one cell needs: its entry of ``workloads``, its
    configuration and traffic as dicts, the end-to-end and per-layer
    metrics it reports, and the reader module of each per-layer metric."""
    bench = bench or load()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())

    def reports(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if reports(m)]
    per_layer = [m for m in bench["per_layer"] if reports(m)]
    readers = {m["name"]: importlib.import_module(
        f"rxbench.metrics.{m['name']}") for m in per_layer}
    return {"name": name, "workload": w, "config": config,
            "traffic": traffic, "end_to_end": e2e, "per_layer": per_layer,
            "readers": readers}


def entry_class(config: dict):
    return importlib.import_module(
        f"rxbench.entries.{config['entry']}").Entry
