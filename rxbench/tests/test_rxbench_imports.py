"""Nothing the benchmark runs imports JAX or the JAX package: top-level
module names are compared whole, since the port's name begins with the
JAX package's."""
import ast
import os
import subprocess
import sys
from pathlib import Path

from rxbench import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "liquid_usrp_tpu"}
HERE = manifest.HERE


def top_levels(names):
    return {n.split(".")[0] for n in names}


def test_names_are_compared_whole():
    found = top_levels(["liquid_usrp_tpu_torch.framing.ofdm",
                        "jax_like", "numpy"]) & FORBIDDEN
    assert found == set()
    assert top_levels(["liquid_usrp_tpu.ops", "jax.numpy"]) & FORBIDDEN \
        == {"liquid_usrp_tpu", "jax"}


def test_no_source_file_imports_them():
    for path in HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not top_levels(names) & FORBIDDEN, (path, names)


def test_the_harness_process_loads_none_of_them():
    """Import everything a run imports, then look at ``sys.modules``."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from rxbench import harness, manifest, control, run\n"
        "for w in manifest.load()['workloads']:\n"
        "    c = manifest.cell(w['name']); manifest.entry_class(c['config'])\n"
        "bad = {m.split('.')[0] for m in sys.modules} & %r\n"
        "print(sorted(bad))\n" % (str(manifest.ROOT), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(manifest.ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(Path(HERE, "run.py")), "--workload",
         "mcrx4.loaded", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(manifest.ROOT),
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2
    assert "needs 1 CUDA device" in out.stderr
    assert out.stdout == ""
