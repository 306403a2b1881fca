"""Pathological-input robustness of the port's four synchronizer families.

The port of ``tests/test_robustness.py``'s three promises, with its blocks
(``BS = 8192``, ``max_payload=64``, ``max_frames=4``): any finite block
gives finite carried state and no ``payload_valid``/``psdu_valid`` without
a real frame (zeros, DC, a tone, the S0 alias tone, impulses, a 1e6
amplitude step, denormals); a NaN/Inf block does not poison the state, so
the frame after it decodes payload-exact; and on a stream carrying one
frame of each family each synchronizer decodes exactly its own.  OFDM runs
at detect levels 0, 1 and 2 (on the CPU levels 1 and 2 run the plain
versions of kernels B1 and B2).  The promises are absolute, so no JAX runs
here: the port is held to what JAX's file holds JAX to.  The ``gpu`` case
runs the same blocks through OFDM levels 1 and 2 on the card, where B1-B3
take the NaN block and the 1e6 step through their own float32 window
sums.  Seeds come from ``zlib.crc32`` of a name.
"""
import zlib

import numpy as np
import pytest
import torch

from liquid_usrp_tpu_torch.framing import flexframe as ff
from liquid_usrp_tpu_torch.framing import flexframe_sync as ffs
from liquid_usrp_tpu_torch.framing import gmskframe as gf
from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync, wlan

BS = 8192
FAMILIES = ["ofdm0", "ofdm1", "ofdm2", "flex", "gmsk", "wlan"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _family(name: str):
    """(sync, init, block function) of a family; ``ofdmL``: OFDM at detect
    level L."""
    if name.startswith("ofdm"):
        params = ofdm.make_ofdm_params(M=48, cp_len=6, taper_len=4)
        return (ofdm_sync.make_sync(params, block_size=BS, max_payload=64,
                                    max_frames=4, use_pallas=int(name[4])),
                ofdm_sync.sync_init, ofdm_sync.sync_block)
    if name == "flex":
        return (ffs.make_flex_sync(ff.make_flex_params(), block_size=BS,
                                   max_payload=64, max_frames=4),
                ffs.flex_sync_init, ffs.flex_sync_block)
    if name == "gmsk":
        return (gf.make_gmsk_sync(gf.make_gmsk_params(), block_size=BS,
                                  max_payload=64, max_frames=4),
                gf.gmsk_sync_init, gf.gmsk_sync_block)
    return (wlan.make_wlan_sync(block_size=BS, max_psdu=64, max_frames=4),
            wlan.wlan_sync_init, wlan.wlan_sync_block)


def _adversarial_blocks(rng):
    t = np.arange(BS)
    return {
        "zeros": np.zeros(BS, np.complex64),
        "dc": np.full(BS, 0.7 + 0.3j, np.complex64),
        "tone": np.exp(2j * np.pi * 0.1251 * t).astype(np.complex64),
        # a period-(M/4) tone is the S0 detector's worst structured alias
        "alias_tone": np.exp(2j * np.pi * t / 12).astype(np.complex64),
        "impulses": (np.where(t % 257 == 0, 1000.0, 0.0) + 0j
                     ).astype(np.complex64),
        "amp_step": np.where(t < BS // 2, 1e-6, 1e6).astype(
            np.complex64) * np.exp(1j * 0.3),
        "denormal": (1e-38 * (rng.normal(size=BS) +
                              1j * rng.normal(size=BS))
                     ).astype(np.complex64),
    }


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)


def _valid(res):
    """(valid flags, payloads, lengths) of a family's results."""
    if hasattr(res, "psdu_valid"):
        return res.psdu_valid, res.psdu, res.length
    return res.payload_valid, res.payload, res.payload_len


def _burst(family: str, header, payload) -> np.ndarray:
    if family.startswith("ofdm"):
        return ofdm.assemble_frame(
            ofdm.make_ofdm_params(M=48, cp_len=6, taper_len=4),
            ofdm.default_props(), torch.as_tensor(header),
            torch.as_tensor(payload)).numpy()
    if family == "flex":
        return ff.flex_assemble(ff.make_flex_params(), ff.default_props(),
                                torch.as_tensor(header),
                                torch.as_tensor(payload)).numpy()
    if family == "gmsk":
        return gf.gmsk_assemble(gf.make_gmsk_params(),
                                gf.gmsk_default_props(),
                                torch.as_tensor(header),
                                torch.as_tensor(payload)).numpy()
    return wlan.wlan_assemble(24, payload, device="cpu").numpy()


def check_no_false_frames(family: str, device) -> None:
    """Two blocks of each adversarial kind from a fresh state: nothing
    valid, and every float or complex leaf of the state finite."""
    sync, init, block_fn = _family(family)
    for tag, blk in _adversarial_blocks(_rng("adversarial")).items():
        st = init(sync, device)
        for _ in range(2):
            st, res = block_fn(sync, st, torch.as_tensor(blk, device=device))
        assert not bool(_valid(res)[0].any()), (family, tag)
        for leaf in _leaves(st):
            if leaf.is_floating_point() or leaf.is_complex():
                assert bool(torch.isfinite(leaf).all()), (family, tag)


def check_recovers_after_nan_block(family: str, device) -> None:
    """A NaN/Inf block, a flush block that drains the carried tail, then a
    clean frame: exactly that frame decodes, payload-exact."""
    sync, init, block_fn = _family(family)
    rng = _rng("nan-recovery")
    header = rng.integers(0, 256, 14 if family == "flex" else 8,
                          dtype=np.uint8)
    payload = rng.integers(0, 256, 48, dtype=np.uint8)
    burst = _burst(family, header, payload)
    clean = np.zeros(BS, np.complex64)
    clean[500:500 + len(burst)] = burst
    clean += (0.005 * (rng.normal(size=BS) + 1j * rng.normal(size=BS))
              ).astype(np.complex64)
    st = init(sync, device)
    st, _ = block_fn(sync, st, torch.as_tensor(
        np.full(BS, np.nan + 1j * np.inf, np.complex64), device=device))
    got = 0
    for blk in (np.zeros(BS, np.complex64), clean,
                np.zeros(BS, np.complex64), np.zeros(BS, np.complex64)):
        st, res = block_fn(sync, st, torch.as_tensor(blk, device=device))
        ok, pay, plen = (v.cpu() for v in _valid(res))
        for k in np.nonzero(ok.numpy())[0]:
            got += 1
            np.testing.assert_array_equal(pay[k][:int(plen[k])].numpy(),
                                          payload)
    assert got == 1, (family, got)


@pytest.mark.parametrize("family", FAMILIES)
def test_no_false_frames_and_finite_state(family):
    check_no_false_frames(family, "cpu")


@pytest.mark.parametrize("family", FAMILIES)
def test_recovers_after_nan_block(family):
    check_recovers_after_nan_block(family, "cpu")


def test_cross_family_isolation():
    """A stream carrying one frame of each family in 0.01-rms noise: each
    synchronizer (OFDM at levels 0, 1 and 2) decodes exactly its own frame,
    payload-exact, and validates nothing of the others."""
    rng = _rng("cross-family")
    h8 = rng.integers(0, 256, 8, dtype=np.uint8)
    h14 = rng.integers(0, 256, 14, dtype=np.uint8)
    payloads, bursts = {}, {}
    for fam in ("ofdm", "flex", "gmsk", "wlan"):
        payloads[fam] = rng.integers(0, 256, 60, dtype=np.uint8)
        if fam == "wlan":
            bursts[fam] = wlan.wlan_assemble(12, payloads[fam],
                                             device="cpu").numpy()
        else:
            bursts[fam] = _burst(fam, h14 if fam == "flex" else h8,
                                 payloads[fam])
    stream = np.zeros(4 * BS, np.complex64)
    pos = 700
    for fam in ("ofdm", "flex", "gmsk", "wlan"):
        stream[pos:pos + len(bursts[fam])] = bursts[fam]
        pos += len(bursts[fam]) + 900
    stream += (0.01 * (rng.normal(size=len(stream)) +
                       1j * rng.normal(size=len(stream)))
               ).astype(np.complex64)
    for family in FAMILIES:
        sync, init, block_fn = _family(family)
        st = init(sync, "cpu")
        n_blocks = 4 + sync.overlap // BS + 1
        padded = np.concatenate(
            [stream, np.zeros(n_blocks * BS - len(stream), np.complex64)])
        got = []
        for b in range(n_blocks):
            st, res = block_fn(sync, st, torch.as_tensor(
                padded[b * BS:(b + 1) * BS]))
            ok, pay, plen = _valid(res)
            for k in np.nonzero(ok.numpy())[0]:
                got.append(pay[k][:int(plen[k])].numpy())
        assert len(got) == 1, (family, len(got))
        np.testing.assert_array_equal(got[0], payloads[family[:4]])


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["ofdm1", "ofdm2"])
def test_ofdm_levels_on_the_card(family):
    """The adversarial blocks and the NaN/Inf block through OFDM levels 1
    (B1) and 2 (B2) on the card: no false valid flag, finite state, the
    frame after the NaN block payload-exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liquid_usrp_tpu_torch.ops import kernels
    dev = torch.device("cuda", 0)
    kernels.reset_launch_counts()
    check_no_false_frames(family, dev)
    check_recovers_after_nan_block(family, dev)
    name = {"ofdm1": "detect_metric_xcorr_onepass",
            "ofdm2": "detect_candidates_onepass"}[family]
    assert kernels.launches[name] > 0
