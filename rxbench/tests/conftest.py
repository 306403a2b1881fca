"""Tiny cells for the CPU: the cells of ``BENCHMARK.json`` with short
blocks, short payloads and short loops, run through the same harness."""
import time

from rxbench import harness, manifest


def tiny_cell(name: str) -> dict:
    cell = manifest.cell(name)
    c, t = cell["config"], cell["traffic"]
    if c["entry"] == "mcrx_pipelined":
        c.update(block_size=2048, max_payload=48, max_frames=6,
                 chunk_samples=2 * c["num_channels"] * 2048 * c["n_blocks"],
                 warm_dispatches=1)
        t.update(payload_len=24,
                 loop_chunks=9 if t["burst_every"] > 1 else 6)
        if t["burst_every"] > 1:
            t["burst_every"] = 3
    else:
        c.update(block_size=1024, max_payload=48,
                 chunk_samples=1024 * c["batch_blocks"], warm_dispatches=1)
        t.update(payload_len=24, loop_chunks=4)
    return cell


def tiny_run(cell: dict, seed: int = 5, dispatches: int = 6,
             ingest: str = "c64") -> dict:
    """A run of ``dispatches`` dispatches on the CPU."""
    return harness.run_cell(cell, seed, 0.0, False, "cpu",
                            time.perf_counter(), ingest=ingest,
                            log=lambda *a: None, count=dispatches)
