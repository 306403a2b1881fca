"""The port's public surface against the JAX package's, and its device
defaults.

Every name in the ``__all__`` of a JAX module must be defined by the
port's module of the same path (read by AST: neither package is imported
for it).  The JAX Pallas kernels' module maps to ``ops/kernels.py``, which
wraps their CUDA counterparts.  Left out, exactly, is the list of what the
port does not take over (ROADMAP, Queue A, "Do not port"): ``ops/planar.py``
and ``utils/tpu_session.py`` (tunnel workarounds), and
``iqfmt.device_put_c64`` / ``device_get_c64``.

The state constructors of the OFDM synchronizer, the NCO and the
channelizer, and the public tensor builders ``iqfmt.czeros``,
``modem.constellation`` and ``convert.from_jax_tree``, run on the card
unless asked for the CPU, as every other constructor of the port does
(ROADMAP Queue C, C4).
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
from liquid_usrp_tpu_torch.ops import iqfmt, modem, nco, pfb
from liquid_usrp_tpu_torch.utils import convert
from liquid_usrp_tpu_torch.utils.device import DEVICE_ENV

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "liquid_usrp_tpu", ROOT / "liquid_usrp_tpu_torch"
NOT_PORTED_MODULES = {"ops/planar.py", "utils/tpu_session.py"}
NOT_PORTED_NAMES = {("ops/iqfmt.py", "device_put_c64"),
                    ("ops/iqfmt.py", "device_get_c64")}
RENAMED_MODULES = {"ops/pallas_kernels.py": "ops/kernels.py"}


def _exported(path: Path):
    """The literal ``__all__`` of a module, or None."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    return None


def _defined(path: Path) -> set:
    """Names bound at a module's top level: defs, classes, assignments and
    imports."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                names.update(n.id for n in ast.walk(t)
                             if isinstance(n, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return names


def _jax_modules():
    return sorted(str(p.relative_to(JAX_PKG))
                  for p in JAX_PKG.rglob("*.py")
                  if _exported(p) is not None)


@pytest.mark.parametrize("rel", _jax_modules())
def test_port_defines_every_public_name_of_the_jax_module(rel):
    if rel in NOT_PORTED_MODULES:
        assert not (PORT_PKG / rel).exists()
        return
    port = PORT_PKG / RENAMED_MODULES.get(rel, rel)
    assert port.exists(), f"no port of {rel}"
    defined = _defined(port)
    missing = [n for n in _exported(JAX_PKG / rel)
               if n not in defined and (rel, n) not in NOT_PORTED_NAMES]
    assert not missing, f"{rel}: the port lacks {missing}"


def test_the_three_names_added_match_jax():
    from liquid_usrp_tpu.framing import ofdm_sync as jos
    from liquid_usrp_tpu.ops import crc as jcrc
    from liquid_usrp_tpu.ops import filter_design as jfd
    from liquid_usrp_tpu_torch.ops import crc, filter_design
    for n, beta in ((1, 0.0), (17, 5.65), (64, 8.6)):
        np.testing.assert_array_equal(filter_design.kaiser_window(n, beta),
                                      jfd.kaiser_window(n, beta))
    assert crc.CrcScheme is jcrc.CrcScheme is int
    assert ofdm_sync.PAYLOAD_MODS == tuple(jos.PAYLOAD_MODS)
    assert "PAYLOAD_MODS" in ofdm_sync.__all__


def _constructors():
    sync = ofdm_sync.make_sync(ofdm.make_ofdm_params(48, 6, 4),
                               block_size=2048, max_payload=64)
    ch = pfb.pfbch_create(8)
    return {
        "sync_init": lambda *d: ofdm_sync.sync_init(sync, *d).tail,
        "nco_init": lambda *d: nco.nco_init(0.1, 0.0, *d).phase,
        "nco_init_at": lambda *d: nco.nco_init_at(0.1, 12345, *d).phase,
        "pfbch_state": lambda *d: pfb.pfbch_state(ch, *d).frames,
        "czeros": lambda *d: iqfmt.czeros((2, 3), *d),
        "constellation": lambda *d: modem.constellation(modem.MOD_QPSK, *d),
        "from_jax_tree": lambda *d: convert.from_jax_tree(
            (np.zeros(3, np.uint32),), *d)[0],
    }


@pytest.mark.parametrize("name", ["sync_init", "nco_init", "nco_init_at",
                                  "pfbch_state", "czeros", "constellation",
                                  "from_jax_tree"])
def test_no_card_raises_instead_of_running_on_the_cpu(name, monkeypatch):
    """Without a CUDA device and without the CPU asked for, the constructor
    raises (it built CPU state before: C4); asked for by argument or by
    ``LIQUID_USRP_TORCH_DEVICE=cpu``, it returns CPU tensors."""
    build = _constructors()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(DEVICE_ENV, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    assert build("cpu").device.type == "cpu"
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    assert build().device.type == "cpu"
