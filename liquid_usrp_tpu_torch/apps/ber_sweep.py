"""ber_sweep — BER/PER-vs-SNR sweep of a frame family's receiver.

Port of the JAX repo's ``scripts/ber_sweep.py``: TX chain -> AWGN/CFO
channel -> RX chain at each SNR, reporting per point the frames detected,
the header errors, the packet error rate and the residual payload BER,
beside an analytic coded-PER curve (:func:`theory_per`) and the
implementation loss at 1 % PER (:func:`implementation_loss_db`).  For any
of the three frame families (OFDM at M=48, flexframe, GMSK), each at its
default props or with ``--fec0/--fec1`` overridden (liquid names); ``--soft``
routes channel LLRs into the conv Viterbi.

The family set-up, the stream (one ``np.random.default_rng(seed)`` draw
order, 600-sample gaps, the SNR defined on the frame samples only) and the
matching rule (nearest transmitted frame within 50 samples, each frame
counted once, payload BER on matched frames only) are JAX's.  The OFDM
receiver detects at the port's ``make_sync`` default (``use_pallas="auto"``
= level 1, kernel B1; :func:`make_config` takes the level).  Where JAX's
loop steps one block at a time, the receiver here takes ``BLOCKS`` blocks
a dispatch through the family's batched dispatch: by the block-size
invariance contract the rows are the same, with fewer launches of the
eager Viterbi.  The noise comes from a ``torch.Generator`` on the run's device,
seeded ``int(snr * 10) + 1`` as JAX's ``PRNGKey``: the same distribution,
not JAX's samples.  Runs on the first CUDA device
(``LIQUID_USRP_TORCH_DEVICE=cpu`` asks for the CPU).

    python -m liquid_usrp_tpu_torch.apps.ber_sweep ofdm --snrs 7,8 \\
        --frames 200 --json out.json
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ..framing import flexframe as ff
from ..framing import flexframe_sync as ffs
from ..framing import gmskframe as gf
from ..framing import ofdm, ofdm_sync
from ..framing import payload as payload_codec
from ..io import channel_model as chan
from ..models.ofdmtxrx import _to_host
from ..ops import fec as fec_mod
from ..utils.device import default_device

__all__ = ["FAMILIES", "BLOCKS", "SweepConfig", "Stream", "make_config",
           "build_stream", "add_noise", "Detections", "dispatches", "collect",
           "receive", "Score",
           "score", "row", "sweep_point",
           "run_sweep", "theory_per", "implementation_loss_db", "main"]

FAMILIES = ("ofdm", "flex", "gmsk")
BLOCK_SIZE = 8192
MAX_FRAMES = 4
GAP = 600                  # zero samples between frames, and at both ends
MATCH_RADIUS = 50          # samples: a detection's reach to its frame
BLOCKS = 8                 # blocks a dispatch

# per family: TX, state constructor, batched dispatch
_OPS = {
    "ofdm": (ofdm.assemble_frame, ofdm_sync.sync_init,
             ofdm_sync.sync_blocks_batched),
    "flex": (ff.flex_assemble, ffs.flex_sync_init,
             ffs.flex_sync_blocks_batched),
    "gmsk": (gf.gmsk_assemble, gf.gmsk_sync_init,
             gf.gmsk_sync_blocks_batched),
}


class SweepConfig(NamedTuple):
    family: str
    params: object             # OfdmParams / FlexParams / GmskParams
    props: object              # FrameProps
    sync: object               # OfdmSync / FlexSync / GmskSync
    expansion: int             # decode budget the TX checks against
    payload_len: int


class Stream(NamedTuple):
    samples: torch.Tensor      # complex64 [n], frames between gaps
    positions: list            # first sample of each frame
    payloads: list             # uint8 [payload_len] arrays, in stream order
    headers: list              # uint8 [header_user] arrays
    sig_pwr: float             # mean |x|^2 over the frame samples


def make_config(family: str, payload_len: int = 200, fec0: str = None,
                fec1: str = None, soft: bool = False,
                use_pallas="auto") -> SweepConfig:
    """The sweep's receiver for ``family``: ``block_size=8192``,
    ``max_frames=4``, ``max_payload=max(payload_len, 64)``, the conv/RS
    decode set when either FEC needs it and the decode budget sized to the
    pair.  ``use_pallas`` is the OFDM detect level (the other families
    have none)."""
    if family not in FAMILIES:
        raise ValueError(family)
    if family == "ofdm":
        params, props = ofdm.make_ofdm_params(48, 6, 4), ofdm.default_props()
    elif family == "flex":
        params, props = ff.make_flex_params(), ff.default_props()
    else:
        params, props = gf.make_gmsk_params(), gf.gmsk_default_props()
    if fec0 is not None:
        props = props._replace(fec0=fec_mod.fec_from_name(fec0))
    if fec1 is not None:
        props = props._replace(fec1=fec_mod.fec_from_name(fec1))
    expansion = payload_codec.required_expansion(props, payload_len)
    opts = dict(block_size=BLOCK_SIZE, max_payload=max(payload_len, 64),
                max_frames=MAX_FRAMES, soft=soft, expansion=expansion,
                enable_conv=any(s not in payload_codec.PAYLOAD_FECS
                                for s in (props.fec0, props.fec1)))
    if family == "ofdm":
        sync = ofdm_sync.make_sync(params, use_pallas=use_pallas, **opts)
    elif family == "flex":
        sync = ffs.make_flex_sync(params, **opts)
    else:
        sync = gf.make_gmsk_sync(params, **opts)
    if soft and fec_mod._is_conv(props.fec0) \
            and props.fec1 != fec_mod.FEC_NONE:
        # channel LLRs are a valid view of the inner code's input only when
        # the outer stage is the identity
        print("warning: --soft with a conv fec0 needs --fec1 none to "
              "engage soft Viterbi (outer decode invalidates channel "
              "LLRs); this sweep will decode hard-equivalently",
              file=sys.stderr)
    return SweepConfig(family, params, props, sync, expansion, payload_len)


def build_stream(cfg: SweepConfig, n_frames: int, seed: int = 0,
                 device=None) -> Stream:
    """``n_frames`` frames of random payloads and headers (all payloads
    drawn first, then all headers, from ``default_rng(seed)``), each
    followed by a ``GAP``-sample gap after a leading gap, assembled on
    ``device``."""
    dev = default_device(device)
    rng = np.random.default_rng(seed)
    payloads = [rng.integers(0, 256, cfg.payload_len, dtype=np.uint8)
                for _ in range(n_frames)]
    headers = [rng.integers(0, 256, getattr(cfg.sync, "header_user", 8),
                            dtype=np.uint8)
               for _ in range(n_frames)]
    assemble = _OPS[cfg.family][0]
    frames = [assemble(cfg.params, cfg.props, torch.as_tensor(h, device=dev),
                       torch.as_tensor(p, device=dev),
                       expansion=cfg.expansion)
              for h, p in zip(headers, payloads)]
    samples = torch.zeros(sum(len(f) + GAP for f in frames) + GAP,
                          dtype=torch.complex64, device=dev)
    positions, pos = [], GAP
    for f in frames:
        samples[pos:pos + len(f)] = f
        positions.append(pos)
        pos += len(f) + GAP
    # the SNR is defined on the occupied (frame) samples, not the gaps
    sig_pwr = float(torch.cat([f.abs() ** 2 for f in frames]).mean())
    return Stream(samples, positions, payloads, headers, sig_pwr)


def add_noise(stream: Stream, snr_db: float, cfo: float = 0.001):
    """The stream through the channel at ``snr_db`` (relative to the frame
    power) with carrier offset ``cfo`` rad/sample; the noise generator
    lives on the stream's device, seeded ``int(snr_db * 10) + 1``."""
    gen = torch.Generator(device=stream.samples.device)
    gen.manual_seed(int(snr_db * 10) + 1)
    return chan.channel_apply(chan.Channel(snr_db=float(snr_db), cfo=cfo),
                              gen, stream.samples,
                              signal_power=stream.sig_pwr)


class Detections(NamedTuple):
    t_start: list              # stream sample of each detection, in order
    header_valid: list
    payload_valid: list
    payload: list              # uint8 arrays [max_payload]
    dispatches: int


def dispatches(cfg: SweepConfig, noisy):
    """Run the receiver over ``noisy`` (a complex tensor or array; the
    run's device is its device), zero-padded to whole blocks plus the flush
    that drains the carried overlap, ``BLOCKS`` blocks a batched dispatch;
    yield each dispatch's results as NumPy arrays ``[BLOCKS, max_frames]``
    (fewer in the last), the only copy to the host."""
    noisy = torch.as_tensor(noisy)
    sync = cfg.sync
    bs = sync.block_size
    flush = int(np.ceil(sync.overlap / bs)) + 1
    n_blocks = -(-noisy.shape[-1] // bs) + flush
    x = torch.zeros(n_blocks * bs, dtype=torch.complex64,
                    device=noisy.device)
    x[:noisy.shape[-1]] = noisy
    x = x.reshape(n_blocks, bs)
    _, init, batched = _OPS[cfg.family]
    state = init(sync, noisy.device)
    for b in range(0, n_blocks, BLOCKS):
        state, res = batched(sync, state, x[b:b + BLOCKS])
        yield _to_host(res)


def collect(results) -> Detections:
    """The detections of a sequence of dispatch results, in stream order."""
    out = Detections([], [], [], [], 0)
    n = 0
    for res in results:
        n += 1
        for j in range(res.detected.shape[0]):
            for i in np.nonzero(res.detected[j])[0]:
                out.t_start.append(int(res.t_start[j, i]))
                out.header_valid.append(bool(res.header_valid[j, i]))
                out.payload_valid.append(bool(res.payload_valid[j, i]))
                out.payload.append(res.payload[j, i])
    return out._replace(dispatches=n)


def receive(cfg: SweepConfig, noisy) -> Detections:
    """Every detection of the receiver over ``noisy``
    (:func:`dispatches`)."""
    return collect(dispatches(cfg, noisy))


class Score(NamedTuple):
    detected: int              # detections, duplicates and strays included
    header_ok: int
    packets_ok: int            # matched frames with a valid payload
    bit_errs: int              # over the matched frames
    bits: int
    frame_ok: np.ndarray       # bool [n_frames]: matched, payload valid
    frame_errs: np.ndarray     # int [n_frames]: bit errors, -1 unmatched


def score(dets: Detections, positions, payloads, payload_len: int) -> Score:
    """JAX's tallies of the detections against the sent frames, and per
    sent frame its outcome.  A detection matches the nearest frame start
    within ``MATCH_RADIUS`` samples that no earlier detection matched;
    payload bits are counted on matched frames only."""
    pos = np.asarray(positions)
    frame_ok = np.zeros(len(positions), bool)
    frame_errs = np.full(len(positions), -1)
    got = set()
    hok = 0
    for t, hv, pv, pay in zip(*dets[:4]):
        hok += hv
        j = int(np.argmin(np.abs(t - pos)))
        if abs(t - pos[j]) < MATCH_RADIUS and j not in got:
            # a duplicate detection of a matched frame counts nothing more
            got.add(j)
            frame_ok[j] = pv
            dec = pay[:payload_len]
            if len(dec) == payload_len:
                frame_errs[j] = int(np.unpackbits(dec ^ payloads[j]).sum())
    counted = frame_errs >= 0
    return Score(len(dets.t_start), hok, int(frame_ok.sum()),
                 int(frame_errs[counted].sum()),
                 int(counted.sum()) * payload_len * 8, frame_ok, frame_errs)


def sweep_point(cfg: SweepConfig, noisy, positions, payloads,
                snr_db: float) -> dict:
    """One row of the sweep: the receiver over the noisy stream, scored as
    JAX's ``run_sweep`` scores it."""
    sc = score(receive(cfg, noisy), positions, payloads, cfg.payload_len)
    return row(sc, snr_db)


def row(sc: Score, snr_db: float) -> dict:
    """The sweep's row of one point's :class:`Score`, JAX's keys."""
    n = len(sc.frame_ok)
    return {
        "snr_db": float(snr_db),
        "frames_sent": n,
        "frames_detected": sc.detected,
        "header_errors": sc.detected - sc.header_ok,
        "packet_error_rate": 1.0 - sc.packets_ok / n,
        "payload_ber": sc.bit_errs / sc.bits if sc.bits else 1.0,
    }


def run_sweep(family: str, snrs, n_frames: int, payload_len: int,
              cfo: float = 0.001, seed: int = 0, fec0: str = None,
              fec1: str = None, soft: bool = False, device=None):
    """The sweep's rows, one per SNR, printed as they come."""
    cfg = make_config(family, payload_len, fec0, fec1, soft)
    stream = build_stream(cfg, n_frames, seed, device)
    results = []
    for snr in snrs:
        row = sweep_point(cfg, add_noise(stream, snr, cfo), stream.positions,
                          stream.payloads, snr)
        results.append(row)
        print("snr %5.1f dB: det %3d/%3d  hdr_ok %3d  PER %.3f  BER %.2e" %
              (snr, row["frames_detected"], n_frames,
               row["frames_detected"] - row["header_errors"],
               row["packet_error_rate"], row["payload_ber"]), flush=True)
    return results


def _qfunc(x):
    from scipy.special import erfc
    return 0.5 * erfc(np.asarray(x) / np.sqrt(2.0))


def _block_code_ok(p, n, t):
    """P(codeword decodes) for an (n, .) code correcting t errors, raw
    bit-error prob p."""
    from scipy.special import comb
    return float(sum(comb(n, i) * p ** i * (1 - p) ** (n - i)
                     for i in range(t + 1)))


def theory_per(family: str, snr_db: float, payload_len: int) -> float:
    """Analytic coded PER for the sweep's default configs: the curve the
    measured waterfall is compared against (implementation loss = measured
    SNR at a PER level minus this curve's SNR at the same level).

    Raw BER uses the coherent matched-filter bound for the payload
    modulation; FEC/CRC structure matches the family defaults (gmsk: CRC16
    + Hamming(7,4); ofdm/flex: CRC32 + Hamming(12,8) on QPSK).  Header:
    Golay(24,12) BPSK.  Frame-detection loss is not modeled (about 0 above
    the waterfall)."""
    g = 10.0 ** (snr_db / 10.0)          # SNR per complex sample
    if family == "gmsk":
        # k=2 samples/symbol, 1 bit/symbol => Eb/N0 = 2 * per-sample SNR;
        # coherent MSK bound
        p_raw = _qfunc(np.sqrt(2 * 2 * g))
        p_hdr = p_raw
        n_pay_blocks = 2 * (payload_len + 2)         # (7,4): 2 blocks/byte
        pay_ok = _block_code_ok(p_raw, 7, 1) ** n_pay_blocks
    elif family in ("ofdm", "flex"):
        if family == "flex":
            # k=2 samples/symbol QPSK: 1 sample/bit at the matched filter
            gb = g
        else:
            params = ofdm.make_ofdm_params(48, 6, 4)
            M = params.M
            n_act = len(params.data_idx) + len(params.pilot_idx)
            # per-subcarrier symbol energy: only the M FFT-window samples
            # are usable (CP energy is discarded), spread over n_act active
            # carriers; QPSK: /2 per bit
            gb = g * M / n_act / 2.0
        p_raw = _qfunc(np.sqrt(2 * gb))
        p_hdr = _qfunc(np.sqrt(2 * gb * 2.0))        # header is BPSK
        n_pay_blocks = payload_len + 4               # (12,8): 1 block/byte
        pay_ok = _block_code_ok(p_raw, 12, 1) ** n_pay_blocks
    else:
        raise ValueError(family)
    # flex carries the reference's 14-byte user header; ofdm/gmsk use 8
    user_b = ff.FLEX_HEADER_USER if family == "flex" \
        else payload_codec.HEADER_USER_BYTES
    n_hdr_blocks = payload_codec.header_enc_bytes(user_b) * 8 // 24
    hdr_ok = _block_code_ok(p_hdr, 24, 3) ** n_hdr_blocks
    return float(1.0 - hdr_ok * pay_ok)


def implementation_loss_db(results, family, payload_len, per_level=0.01):
    """SNR gap (dB) between the measured and theory waterfalls at a PER
    level, or None when the sweep does not reach it."""
    snrs = np.array([r["snr_db"] for r in results])
    per = np.array([r["packet_error_rate"] for r in results])
    fine = np.arange(snrs.min(), snrs.max() + 0.01, 0.05)
    th = np.array([theory_per(family, s, payload_len) for s in fine])

    def cross(x, y):
        order = np.argsort(x)                 # the sweep may be unsorted
        x, y = np.asarray(x)[order], np.asarray(y)[order]
        # tolerance: 1 - ok/n accumulates float error (199/200 missed the
        # 1e-2 level by 9e-18)
        idx = np.where(y <= per_level * (1 + 1e-9))[0]
        if not len(idx):
            return None
        i = idx[0]
        if i == 0 or y[i] <= 0:
            return float(x[i])
        # log-linear interpolation between the bracketing points
        y0, y1 = np.log(y[i - 1]), np.log(y[i])
        t = (np.log(per_level) - y0) / (y1 - y0)
        return float(x[i - 1] + t * (x[i] - x[i - 1]))

    m = cross(snrs, per)
    t = cross(fine, th)
    if m is None or t is None:
        return None
    return round(m - t, 2)


def _command_out(argv) -> str | None:
    """First line of a command's output, or None when it cannot run."""
    try:
        out = subprocess.run(argv, capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ber_sweep")
    ap.add_argument("family", choices=FAMILIES)
    ap.add_argument("--snrs", default="4,8,12,16,20,25")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--payload", type=int, default=200)
    ap.add_argument("--cfo", type=float, default=0.001)
    ap.add_argument("--json", default=None)
    ap.add_argument("--fec0", default=None,
                    help="override inner payload FEC (liquid name, e.g. "
                         "v27); conv names enable the runtime conv set")
    ap.add_argument("--fec1", default=None,
                    help="override outer payload FEC (liquid name)")
    ap.add_argument("--soft", action="store_true",
                    help="soft-decision LLRs into conv payload decode")
    args = ap.parse_args(argv)
    snrs = [float(s) for s in args.snrs.split(",")]
    dev = default_device()
    t0 = time.perf_counter()
    res = run_sweep(args.family, snrs, args.frames, args.payload, args.cfo,
                    fec0=args.fec0, fec1=args.fec1, soft=args.soft,
                    device=dev)
    seconds = time.perf_counter() - t0
    for r in res:
        r["theory_per"] = round(
            theory_per(args.family, r["snr_db"], args.payload), 6)
    loss = implementation_loss_db(res, args.family, args.payload)
    print("implementation loss at 1% PER: "
          f"{loss} dB" if loss is not None else
          "implementation loss at 1% PER: not bracketed by sweep range")
    print(f"sweep: {seconds:.1f} s on {dev}")
    if args.json:
        # manifest: every curve traces to the commit, the receiver config
        # and the card that produced it
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        out = {"rows": res, "impl_loss_db_at_1pct_per": loss,
               "manifest": {
                   "git_sha": _command_out(["git", "-C", root, "rev-parse",
                                            "--short", "HEAD"]) or "unknown",
                   "utc": datetime.datetime.now(
                       datetime.timezone.utc).isoformat(timespec="seconds"),
                   "family": args.family, "frames": args.frames,
                   "payload": args.payload, "cfo": args.cfo,
                   "fec0": args.fec0, "fec1": args.fec1, "soft": args.soft,
                   "device": str(dev),
                   "card": _command_out(["nvidia-smi",
                                         "--query-gpu=name,power.limit",
                                         "--format=csv,noheader"]),
                   "seconds": round(seconds, 3),
                   "cmd": " ".join(["ber_sweep"] + list(
                       sys.argv[1:] if argv is None else argv))}}
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print("wrote", args.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
