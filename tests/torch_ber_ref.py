"""Helpers of the BER-sweep parity tests.  The JAX side: the reference
script's (``scripts/ber_sweep.py``) family set-up, stream, channel and
receive loop, written out as functions so a test can hold each step of the
port (``liquid_usrp_tpu_torch.apps.ber_sweep``) against it; the receive
loop is the script's, with each sent frame's outcome recorded besides the
row.  And :func:`compare_ofdm_point`, one OFDM point of both packages on
the same noisy stream.  Not collected by pytest (no ``test_`` prefix)."""
import functools
import zlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from liquid_usrp_tpu.framing import flexframe as jff
from liquid_usrp_tpu.framing import flexframe_sync as jffs
from liquid_usrp_tpu.framing import gmskframe as jgf
from liquid_usrp_tpu.framing import ofdm as jofdm
from liquid_usrp_tpu.framing import ofdm_sync as jos
from liquid_usrp_tpu.framing import payload as jpc
from liquid_usrp_tpu.io import channel_model as jchan
from liquid_usrp_tpu.ops import fec as jfec
from liquid_usrp_tpu_torch.apps import ber_sweep as bs

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "ber_sweep.py"


def script():
    """``scripts/ber_sweep.py`` as a module (for ``theory_per`` and
    ``implementation_loss_db``)."""
    spec = importlib.util.spec_from_file_location("jax_ber_sweep", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config(family, payload_len, fec0=None, fec1=None, soft=False,
           use_pallas="auto"):
    """``(sync, step, init, assemble)`` as the script builds them
    (``:37-99``), with JAX's detect level ``use_pallas`` for OFDM."""
    def with_fec(props):
        if fec0 is not None:
            props = props._replace(fec0=jfec.fec_from_name(fec0))
        if fec1 is not None:
            props = props._replace(fec1=jfec.fec_from_name(fec1))
        return props

    def sync_opts(props):
        return dict(
            enable_conv=any(s not in jpc.PAYLOAD_FECS
                            for s in (props.fec0, props.fec1)),
            soft=soft, expansion=jpc.required_expansion(props, payload_len))

    common = dict(block_size=8192, max_payload=max(payload_len, 64),
                  max_frames=4)
    if family == "ofdm":
        params = jofdm.make_ofdm_params(48, 6, 4)
        props = with_fec(jofdm.default_props())
        opts = sync_opts(props)
        sync = jos.make_sync(params, use_pallas=use_pallas, **common, **opts)
        step, init = jos.make_sync_step(sync), lambda: jos.sync_init(sync)
        tx = jofdm.assemble_frame
    elif family == "flex":
        params = jff.make_flex_params()
        props = with_fec(jff.default_props())
        opts = sync_opts(props)
        sync = jffs.make_flex_sync(params, **common, **opts)
        step = jffs.make_flex_sync_step(sync)
        init = lambda: jffs.flex_sync_init(sync)  # noqa: E731
        tx = jff.flex_assemble
    else:
        params = jgf.make_gmsk_params()
        props = with_fec(jgf.gmsk_default_props())
        opts = sync_opts(props)
        sync = jgf.make_gmsk_sync(params, **common, **opts)
        step = jgf.make_gmsk_sync_step(sync)
        init = lambda: jgf.gmsk_sync_init(sync)  # noqa: E731
        tx = jgf.gmsk_assemble

    # jitted where the script runs it eagerly (one compile for the
    # stream's frames, all of one shape); both receivers get its samples
    tx_jit = jax.jit(lambda h, p: tx(params, props, h, p,
                                     expansion=opts["expansion"]))

    def assemble(h, p):
        return tx_jit(jnp.asarray(h), jnp.asarray(p))
    return sync, step, init, assemble


def stream(sync, assemble, n_frames, payload_len, seed):
    """``(stream, positions, payloads, headers, sig_pwr)`` (``:112-137``)."""
    rng = np.random.default_rng(seed)
    payloads = [rng.integers(0, 256, payload_len, dtype=np.uint8)
                for _ in range(n_frames)]
    headers = [rng.integers(0, 256, getattr(sync, "header_user", 8),
                            dtype=np.uint8)
               for _ in range(n_frames)]
    frames = [np.asarray(assemble(h, p)) for h, p in zip(headers, payloads)]
    gap = 600
    x = np.zeros(sum(len(f) + gap for f in frames) + gap, np.complex64)
    positions, pos = [], gap
    for f in frames:
        x[pos:pos + len(f)] = f
        positions.append(pos)
        pos += len(f) + gap
    sig_pwr = float(np.mean(np.concatenate([np.abs(f) ** 2
                                            for f in frames])))
    return x, positions, payloads, headers, sig_pwr


def noisy(x, sig_pwr, snr, cfo=0.001):
    """The channel with JAX's key (``:145-148``), before the padding."""
    ch = jchan.Channel(snr_db=float(snr), cfo=cfo)
    return np.array(jchan.channel_apply(
        ch, jax.random.PRNGKey(int(snr * 10) + 1), jnp.asarray(x),
        signal_power=sig_pwr))


def point(sync, step, init, y, positions, payloads, payload_len, snr):
    """``(row, frame_ok, frame_errs)``: the script's receive loop
    (``:139-182``) over the noisy stream ``y``, and per sent frame whether
    it decoded and its bit errors (-1 when no detection matched it)."""
    n_frames = len(positions)
    bs = sync.block_size
    flush = int(np.ceil(sync.overlap / bs)) + 1
    total = (-(-len(y) // bs) + flush) * bs
    y = np.concatenate([y, np.zeros(total - len(y), np.complex64)])
    state = init()
    det, hok, pok, bit_errs, bits_tot = 0, 0, 0, 0, 0
    got = {}
    frame_ok = np.zeros(n_frames, bool)
    frame_errs = np.full(n_frames, -1)
    for b in range(total // bs):
        state, res = step(state, jnp.asarray(y[b * bs:(b + 1) * bs]))
        d = np.asarray(res.detected)
        for i in np.nonzero(d)[0]:
            det += 1
            if bool(res.header_valid[i]):
                hok += 1
            t = int(res.t_start[i])
            j = int(np.argmin([abs(t - p) for p in positions]))
            if abs(t - positions[j]) < 50 and j not in got:
                got[j] = True
                if bool(res.payload_valid[i]):
                    pok += 1
                    frame_ok[j] = True
                dec = np.asarray(res.payload[i])[:payload_len]
                if len(dec) == payload_len:
                    e = int(np.unpackbits(dec ^ payloads[j]).sum())
                    frame_errs[j] = e
                    bit_errs += e
                    bits_tot += payload_len * 8
    row = {
        "snr_db": float(snr),
        "frames_sent": n_frames,
        "frames_detected": det,
        "header_errors": det - hok,
        "packet_error_rate": 1.0 - pok / n_frames,
        "payload_ber": (bit_errs / bits_tot) if bits_tot else 1.0,
    }
    return row, frame_ok, frame_errs


@functools.lru_cache(maxsize=None)
def _ofdm_noisy(frames, snr, fec0, fec1, soft, payload_len, name):
    sync, _, _, assemble = config("ofdm", payload_len, fec0, fec1, soft)
    x, positions, payloads, _, sig_pwr = stream(
        sync, assemble, frames, payload_len,
        zlib.crc32(f"ofdm {name}".encode()))
    return noisy(x, sig_pwr, snr), positions, payloads


def compare_ofdm_point(name, frames, snr, fec0, fec1, soft, level,
                       payload_len=200):
    """One OFDM point at detect level ``level`` on JAX's noisy stream (its
    frames seeded by ``name``) through the script's loop and the port's
    receiver on the CPU, held to the sweep tests' rule: detections and
    header errors equal, at most one frame whose ``payload_valid``
    differs, the bit-error total within 8 bits a frame whose bit errors
    differ.  Returns the line that states the measured gap."""
    y, positions, payloads = _ofdm_noisy(frames, snr, fec0, fec1, soft,
                                         payload_len, name)
    sync, step, init, _ = config("ofdm", payload_len, fec0, fec1, soft,
                                 use_pallas=level)
    assert sync.use_pallas == level
    row_j, ok_j, errs_j = point(sync, step, init, y, positions, payloads,
                                payload_len, snr)
    cfg = bs.make_config("ofdm", payload_len, fec0, fec1, soft,
                         use_pallas=level)
    assert cfg.sync.use_pallas == level and cfg.sync.soft == soft
    sc = bs.score(bs.receive(cfg, torch.as_tensor(y)), positions, payloads,
                  payload_len)
    got = bs.row(sc, snr)
    assert got["frames_detected"] == row_j["frames_detected"]
    assert got["header_errors"] == row_j["header_errors"]
    flips = int((sc.frame_ok != ok_j).sum())
    differ = int((sc.frame_errs != errs_j).sum())
    gap = abs(sc.bit_errs - int(errs_j[errs_j >= 0].sum()))
    assert flips <= 1
    assert gap <= 8 * differ
    # the point lies on the waterfall: some frames fail, some decode
    assert 0.0 < row_j["packet_error_rate"] < 1.0
    return (f"ofdm {name} at {snr} dB, level {level}: PER "
            f"{got['packet_error_rate']} (JAX {row_j['packet_error_rate']}), "
            f"{flips} payload_valid flips, {differ} frames with other bit "
            f"errors, bit-error gap {gap}")
