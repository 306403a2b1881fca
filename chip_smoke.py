"""On-card smoke run of the PyTorch/CUDA port (``liquid_usrp_tpu_torch``).

Drives the port's four paths once on one CUDA device and checks them: the
multichannel OFDM receiver (NCO mix-down -> 2N-bin PFB analyzer -> batched
N-channel detect + decode) at the full bench configuration, the
single-channel OFDM transceiver (``OfdmTxRx``, the ``ofdmflexframe_tx/rx``
apps), the single-carrier flexframe path (``flexframe_tx/rx``,
``packet_tx/rx``: FIR, resamplers, flexframe sync) and the GMSK path
(``gmskframe_tx/rx``) at the app defaults, the convolutional and
Reed-Solomon FEC layer (``--conv``), the soft-decision decode path
(``--soft``), and the measurement ops and small CLIs (``rssi``,
``asgram_rx``, ``narrowband_tx``, ``halfduplex_txrx``,
``fullduplex_txrx``), the streaming plumbing (``NativeWriter``,
``run_pipelined``, the TX worker, ``AsyncTxProducer``,
``multichannel_txrx``), the 802.11a path (``wlanframe_tx/rx``) and the
parallel layer (``parallel/``: worlds of ranks that share the card):

1. the card's name and power limit (``nvidia-smi``);
2. the build of the CUDA kernels from ``liquid_usrp_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it, with times: the wrapper's and the plain
   version's (CUDA events), and the kernel's own device time
   (``torch.profiler`` over 100 launches) beside its bound (bytes over the
   HBM rate or float32 operations over the float32 peak) and its share.
   B1 and B2 on the multichannel
   windows (B1 max abs difference <= 1e-4; B2 ``detected`` identical,
   ``vals`` atol 1e-4, detected offsets equal or within 3 samples, and
   ``c_at`` within 1e-4 of ``|c|`` of the plain lag correlation at the
   kernel's offsets); B3, B4 and B5 on the 8 extended windows of the
   single-channel path's first dispatch (B3 vs ``autocorr_metric``: metric
   <= 1e-4, ``c`` within 1e-4 of max ``|c|``; B4/B5 vs
   ``autocorr_metric_prefix``: metric <= 1e-5, ``c`` within 1e-5 of max
   ``|c|``); and the payload codec's Viterbi kernel (``csrc/viterbi.cu``)
   at the ``ofdm1_conv.v27`` cell's shape (10 rows of v27 hard costs over
   the 2,052-byte budget, 16,422 steps, at 2 % bit errors, the last row a
   third erased): every bit equal to the plain version's, the 9 unerased
   rows decoded, its device time beside the bytes' bound and the time a
   step of its chain takes; the nearest-point scan's kernel
   (``csrc/nearest.cu``) at the ``mcrx4.loaded`` dispatch's call shapes
   (192 candidate rows: the decision-directed pass's 64 symbols against
   256 entries, the codec's demap and the payload EVM over the whole
   payload against 64 and 256): ``arg`` and ``best`` equal to the plain
   loop's bit for bit, its device time beside its bound (float32
   operations, 5 a pair);
4. the multichannel path at N=4, M=48, cp=6, taper=4, 400-byte payloads,
   ``block_size=65536``, ``n_blocks=2``, ``max_frames=24``,
   ``max_payload=512`` for detect levels ``use_pallas`` 0, 1 and 2, on a
   mixture built by the port's own TX exactly as ``bench.py`` builds its
   mixture: every injected frame must decode (88/88) with each channel's
   count and uint32 payload fingerprint as ``bench.py`` expects; the same
   frames with a carrier frequency offset of 0.035-0.05 rad/sample per
   channel must decode too, each with its offset estimated within 1.5e-3
   (this fails if B2's ``c_at``, which seeds the coarse estimate, is
   wrong); and the kernels of levels 1 and 2 must have launched during
   that run;
5. the class entry point, ``MultichannelRx.execute + flush``, on a short
   mixture;
6. decode-verified samples/s per level, timed with CUDA events over
   ``TIMED_STEPS`` steps (a smoke window, not a benchmark): each timed
   step decodes the loaded chunk from the initial state, and each must
   give the count and fingerprint of the checked first step;
7. the single-channel path: ``ofdmflexframe_tx.main`` writes 40 frames
   (M=48, cp=6, taper=4, 1200-byte QPSK payloads, FEC none + Golay(24,12),
   CRC32, -12 dB, seed 42); ``OfdmTxRx`` (``block_size=16384``,
   ``batch_blocks=8``, ``max_payload=2048``) and ``ofdmflexframe_rx.main``
   must decode 40/40 with the regenerated payloads; then ``run_rx`` at each
   detect config (xcorr at levels 0 and 1, the legacy detector at levels 0,
   1 (B3) and 2 (B2)), and at the legacy level 1 again on the stream
   through ``--snr 20 --cfo 0.045`` (every offset within 1.5e-3); each
   config's kernel must have launched;
8. ``OfdmTxRx.debug_print`` on the card, which must launch B3;
9. the multichannel receiver at M=16 (cp=4, taper=2, ``use_pallas=2``):
   every injected frame decodes with ``bench.py``'s fingerprints, B3 is
   launched and B2 is not (its 64-sample segments need M >= 32); then B3's
   generic instance against its plain version on that path's extended
   windows (limits as in 3), with its times;
10. decode-verified samples/s of the single-channel path per detect
   config, and the time of one 8-block dispatch, over a smoke window;
11. B4 and B5 lie on no path: their launch counts, summed over the path
   runs of 4, 7, 8, 9, 12, 14, 16 and 18, must be 0;
12. the single-carrier flexframe path at the app defaults:
   ``flexframe_tx.main`` writes 40 frames (1024-byte QPSK payloads, FEC
   none + Hamming(12,8), CRC32, -12 dB, ``-r 2.0``, seed 42);
   ``flexframe_rx.main`` (``-r 0.5``, ``block_size=8192``,
   ``max_payload=2048``, ``max_frames=4``, 8-block dispatches through
   ``iter_sync_results``) must report 40/40 valid; the same sync driven
   directly must return the 40 regenerated headers and payloads byte for
   byte in stream order; then the stream through ``--snr 20 --cfo 0.01``
   (rad/sample at the file rate, 0.02 after the RX resampler): every frame
   decodes with its offset within 2e-3 of 0.02, by the app and directly;
13. the flexframe front end on the card against the port on the CPU: on
   every 8-block dispatch of the stream (the first one detects nothing:
   its detect regions lie in the zeros the sync starts from),
   ``_mf_and_detect`` gives the same ``detected`` and detected offsets, ``mf``
   within 1e-5 of max |mf|, and the metric within 1e-4 where the window
   energy is at least 100x the silence floor (the float32 cumsum of the
   energy sums in another order on each device, which near the floor
   moves the metric and can move the gate; the largest difference
   anywhere is printed); ``msresamp_block`` at rates 0.5 (the file) and
   2.0 (the resampled stream) gives the CPU's count, with ``y`` within
   1e-5 of max |y|;
14. the packet (frame64) path: ``packet_tx.main`` writes 40 bursts and
   ``packet_rx.main`` reports 40/40 valid and no foreign burst; the sync
   driven directly returns the regenerated payloads;
15. the flexframe path's own times (CUDA events, after a warm-up):
   decode-verified input samples/s of the receiver over the whole
   resampled stream (every run checked), ms per 8-block dispatch, and ms
   of the RX ``msresamp`` over the stream.  B1-B5 launch on neither the
   flexframe nor the packet path: their counts there must be 0;
16. the GMSK path at the app defaults: ``gmskframe_tx.main`` writes 40
   frames (200-byte payloads, CRC16, FEC none + Hamming(7,4), -12 dB,
   300-sample gaps, seed 42); ``gmskframe_rx.main`` (``-p 1024``,
   ``block_size=8192``, ``max_frames=4``, 8-block dispatches) must report
   40/40 valid, and the sync driven directly must return the 40
   regenerated headers and payloads byte for byte in stream order; then
   the stream through ``--snr 20 --cfo 0.01``: 40/40 by the app and
   directly, every offset within ``GM_CFO_ATOL`` of 0.01;
17. the GMSK front end on the card against the port on the CPU, on every
   8-block dispatch of that stream: the same detected offsets in every
   window (their top-k slot order may differ: the stream's frames peak
   within 4e-5 of each other), ``z`` within 1e-5 of max |z|, the metric within 1e-4 where
   the template span's energy is at least 100x its silence floor (the
   energy's float32 cumsum rounds in another order on each device; the
   largest difference anywhere and the gate flips are printed);
18. the conv/RS layer on the card: ``conv_decode`` (v27, v29, v27p34) and
   ``rs_decode`` equal the port on the CPU bit for bit on the same noisy
   words; ``gmskframe_tx -N 40 -c v27 -k none`` -> ``gmskframe_rx
   --conv``: 40/40, and the sync directly byte for byte;
   ``ofdmflexframe_tx -k rs8`` (10 frames of 442 bytes: whole RS blocks,
   the sizes the reference's static-size RS decode aligns with) ->
   ``ofdmflexframe_rx --conv -p 512`` and ``flexframe_tx -c v27 -k none``
   (10 frames of 100 bytes) -> ``flexframe_rx --conv -p 256``: every frame
   valid; the Viterbi's ms per dispatch (the ``fec0`` stage of the timed
   GMSK ``--conv`` dispatch, v27 over its header-valid rows); the
   ``ofdm1_conv.v27`` cell's receiver (``OfdmTxRx(enable_conv=True)`` at
   its defaults) over ``ofdmflexframe_tx -c v27 -k none`` (20 frames of
   1200 bytes), one 8-block dispatch a ``run_rx`` call, from a reset of
   the launch counts and with the counters on: every frame valid, the
   Viterbi kernel launched once in each dispatch that decodes a frame
   (``kernels.launches`` and ``viterbi_launches``), each launch over the
   2,052-byte budget's 16,422 steps (``viterbi_steps``), and no B1-B5
   kernel but B1 (that run's count is the kernels line's ``launches``);
19. GMSK times (CUDA events, after a warm-up): decode-verified samples/s
   over the whole stream and ms per 8-block dispatch, without and with
   ``--conv``.  B1-B5 launch on none of the runs of 16-18 but the OFDM
   app's (whose detector is B1 at its default level, as on every OFDM
   run): their counts there must be 0;
20. the soft decode ops on the card against the port on the CPU:
   ``generic_demod_soft`` on the payload points of a real flexframe
   ``soft`` dispatch (32 candidates of the app-default stream) at tables of
   64 (QPSK) and 256 (qam256) entries, LLRs within 1e-6 of max |LLR| with
   equal signs beyond (the 256-entry table on 8 rows on the CPU), with
   the demapper's ms and peak memory; ``decode_payload_batch_soft`` on
   that dispatch equal on the header-valid rows; ``golay_decode_soft`` on
   8,192 noisy blocks equal except near-ties (the two best scores within
   1e-5 of the best; counted), and unchanged with TF32 on and
   ``set_float32_matmul_precision("medium")``;
21. the soft loopbacks: ``ofdmflexframe``, ``flexframe`` and ``gmskframe``
   TX with 10 v27 frames -> RX ``--conv --soft``: every frame valid, and
   ``OfdmTxRx`` and the flexframe and GMSK syncs with ``soft=True`` byte
   for byte; the GMSK v27 file through ``--snr -1.5``, near the header
   waterfall: the card's soft decode gives the CPU's payload-valid frames
   and bytes, and at least as many as the hard decode, whose count is
   printed;
22. the measurement ops and small CLIs: AGC (relative 1e-5), the
   spectrogram (1e-3 dB, equal peak bins) and the ring log (equal) on the
   card against the CPU; ``narrowband_tx -> asgram_rx / rssi`` on the card
   against the same apps on the CPU (equal peak frequencies, levels within
   0.01 dB); ``halfduplex_txrx -N 2`` delivers 2/2 and ``fullduplex_txrx``
   every frame both ways;
23. soft times (CUDA events, after a warm-up, decode-verified): the GMSK
   ``--conv --soft`` dispatch on blocks 8-15 beside the ``--conv`` one, in
   turns (hard, soft, soft, hard), and the soft dispatch's payload decode
   against the CPU's; the Golay ML stage on one
   dispatch's header blocks.  The soft GMSK and flexframe runs and the
   A13 ops launch none of B1-B5; the soft OFDM run and the duplex CLIs
   launch B1 only, the OFDM detector;
24. the streaming plumbing at the bench configuration: the mixture of 4
   written with ``NativeWriter`` (its bytes equal ``write_file``'s) and
   read back through ``NativeReader`` -> ``BlockPrefetcher`` ->
   ``run_pipelined`` over ``make_mcrx_step``: 88/88 with ``bench.py``'s
   fingerprints, the same results as the direct step loop, B1 launched;
   the TX worker at N=4 (``chunk=256``, ``max_ahead=65536``) with 400-byte
   packets queued on every channel mid-stream while this thread runs
   ``MultichannelRx`` on the card: every frame payload-exact, at most
   ``max_ahead + 2N * chunk`` samples ahead; ``AsyncTxProducer`` frames
   payload-exact; ``multichannel_txrx`` at its defaults and at ``-n 4 -P
   400 -R 4`` payload-exact.  A worker thread that dies fails the phase;
25. 802.11a on the card: ``wlanframe_tx -r R -N 5`` -> ``wlanframe_rx``
   5/5 valid PSDUs at each of the 8 rates, and the sync driven directly
   returns the regenerated PSDUs byte for byte with the CPU port's rows
   (t_start, rate, length, flags exact; cfo within 1e-5, rssi within
   1e-4 dB); ``-P 1500`` frames at 6 and 54 Mb/s through ``wlanframe_rx
   -p 1500``, byte for byte; one stream impaired once (``--snr 15 --cfo
   0.002``, rate 24) decoded on the card and the CPU, equal, 3/3; the
   soft Viterbi's bits equal the CPU's on the pairs of a real dispatch and
   on random pairs with erasures and exact ties, the soft demap within
   1e-6 of max |LLR|, the detection metric within 1e-5 where both gates
   are open; B1-B5 launched 0 times;
26. times (CUDA-synchronised, after a warm-up, every run decode-checked):
   ``run_pipelined`` against the direct step loop (both reading the file
   with ``NativeReader``) in turns (direct, pipelined, pipelined, direct)
   in samples/s, the TX worker's output samples/s, WLAN input samples/s over the default stream, and WLAN ms
   per detecting block with the DATA Viterbi's ms, at ``-p 256`` and
   ``-p 1500``;
27. the parallel layer, after the parent built the kernels, in spawned
   worlds whose ranks each set the card as their device and hold one
   intra-op thread: a 2x2 ``(time, channel)`` world of 4 ranks that share
   ``cuda:0`` over gloo (their collectives through pinned host copies;
   on a host with a card per rank, NCCL on ``cuda:{rank}``, as
   ``distributed.spawn`` chooses) runs ``sharded_mcrx`` (the all-to-all receiver, ``use_pallas=1``, 1
   block of 65,536 a fine chunk) and ``make_sharded_mcrx``
   (``use_pallas=2``, 2 blocks a time chunk) over the bench mixture and
   its flush chunk (2,097,152 samples): 88/88 with ``bench.py``'s
   fingerprints, every rank launching B1 (B2 at level 2) and no other
   kernel; ``n_steps=2`` over the mixture and three flush chunks: 88/88
   and the one-shot run's rows; ``make_sharded_mctx`` on the bench
   baseband within 1e-5 of its peak of ``make_mctx_step``'s mixture, then
   88/88 through the single-process receiver; on a 1-D ``time`` mesh of
   the same 4 ranks, ``make_time_sharded_sync`` over the app-default
   streams of phases 7 (the legacy detector at level 1: B3 in every
   rank), 12, 16 and 25, each zero-padded to 4 equal chunks with one
   overlap after the stream: every frame decoded (40/40, 40/40, 40/40,
   5/5) and the detected rows equal to the port's sequential block loop
   on the card (rows exact, ``rssi`` within 1e-3 dB, ``evm`` 0.05 dB,
   ``cfo`` 1e-5); a 1-rank NCCL world on ``cuda:0``: ``sharded_mcrx``
   88/88 (B1), rows equal to the gloo world's; then decode-verified
   samples/s of both worlds beside the single-process ``make_mcrx_step``
   loop in turns (single, gloo, NCCL, single), each world's share of a
   rank's run spent in collectives, and the transport.  These are ranks
   sharing one card, not a scaling measurement.  A rank that fails fails
   the phase; its launches count toward B4/B5's zero check;
28. (run after 23) the receiver-fidelity sweep (``apps/ber_sweep.py``)
   at its own configs (M=48, ``block_size=8192``, ``max_frames=4``, 200-byte
   payloads, CFO 0.001 rad/sample, 8 blocks a dispatch, the noise from a
   generator on the card), held to the JAX repo's curves
   (``docs/ber_*.json``, 200 frames a point): (a) uncoded OFDM (level 1,
   B1), flexframe and GMSK at 200 frames at each point of the JAX
   waterfall (PER 0.02-0.95) and the first point below 1 % after it: the
   port's PER at s must lie between the JAX curve's (log-interpolated) at
   s + 0.5 dB and at s - 0.5 dB, and its detections between the curve's at
   s - 0.5 and s + 0.5 dB, each bound widened by 3 binomial standard
   deviations of the port's frame count; (b) OFDM at levels 0, 1 (B1) and
   2 (B2) on the same noisy streams at 7 and 8 dB (around 10 % PER): level
   1 within one detection of level 0 and its ``payload_valid`` differing
   from level 0's in at most 2 frames (level 2's flips printed), B1 and
   B2 launched once in every dispatch (the wrappers' counts), each held to
   its plain version at the sweep's shapes (the first dispatch's windows,
   8 x 17,330) under the limits of the main path's check, and traced by
   ``torch.profiler`` there (one CUDA kernel a call, 100 calls, with its
   device time); the kernel records the profiler sees over a whole point
   are printed beside its dispatches; (c) v27 with
   soft decisions at 2 dB (OFDM), 0 dB (flexframe) and -3 dB (GMSK), soft
   and hard on one stream, each under rule (a) against its JAX curve, the
   soft PER below the hard.  Its B1 and B2 launches add to the kernels
   line; B3-B5 launch 0 times;
29. (run after 28) every OFDM size the JAX package takes: at M = 512
   (B2, level 2), 1,028 (B1, level 1) and 1,152 (B3, the legacy detector),
   where each kernel leaves its M=48 tiling, B1, B2 and B3 against their
   plain versions (the limits of 3) on the 8 extended windows of
   ``ofdmflexframe_rx``'s first dispatch (``ofdmflexframe_tx -M m -C m/8
   -N 4 -P 200`` in 0.01-rms noise), and that M's kernel timed (device
   time over all the CUDA kernels its wrapper launches, beside its
   bound); a launch-only sweep over every M that is a multiple of 4 from
   8 to 4,096, and 6,144 and 8,192 (B1 and B3 at each, B2 from 32:
   finite outputs of their shapes); ``sync_block`` on the card at each of
   the three sizes and its detect config decoding 4/4 payload-exact, with
   the rows of the port's CPU path on the same samples;
   ``tests/test_robustness.py``'s adversarial blocks and NaN/Inf block
   through OFDM levels 1 and 2 (no false frame, finite state, the frame
   after the NaN block payload-exact); ``ofdmflexframe_rx -M 1028`` 4/4
   and ``multichannel_rx -M 1028`` 6/6 valid on their TX's files.  Its
   launches count toward B4/B5's zero check, not the kernels line.

Launch checks about B1-B5 read those five counts; the Viterbi kernel
launches on every conv decode (phases 18-21, 23, 28) and its launches over
the runs are summed on the kernels line.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failure raises and the
script exits non-zero without that line; so does a machine without CUDA.

    python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

N = 4
M, CP, TAPER = 48, 6, 4
PAYLOAD = 400
BLOCK = 65536
N_BLOCKS = 2
MAX_FRAMES = 24
MAX_PAYLOAD = 512
TIMED_STEPS = 10
CFOS = (0.045, -0.04, 0.035, -0.05)    # rad/sample, per channel
CFO_ATOL = 1.5e-3
CAND_SEG = 64                  # outputs per segment of kernel B2
# per wrapper: its detect level on the multichannel path, its source, the
# TPU kernel it replaces and the name of its CUDA kernel (for the profiler)
KERNELS = {
    "detect_metric_xcorr_onepass": dict(
        level=1, source="liquid_usrp_tpu_torch/csrc/xcorr_metric.cu",
        replaces="liquid_usrp_tpu/ops/pallas_kernels.py:616",
        kernel="xcorr_metric_kernel"),
    "detect_candidates_onepass": dict(
        level=2, source="liquid_usrp_tpu_torch/csrc/detect_candidates.cu",
        replaces="liquid_usrp_tpu/ops/pallas_kernels.py:491",
        kernel="detect_candidates_kernel"),
    "detect_metric_onepass": dict(
        level=None, source="liquid_usrp_tpu_torch/csrc/autocorr_metric.cu",
        replaces="liquid_usrp_tpu/ops/pallas_kernels.py:161",
        kernel="autocorr_metric_kernel"),
    "detect_metric_fused_2d": dict(
        level=None, source="liquid_usrp_tpu_torch/csrc/autocorr_prefix.cu",
        replaces="liquid_usrp_tpu/ops/pallas_kernels.py:246",
        kernel="autocorr_prefix_kernel"),
    "detect_metric_fused": dict(
        level=None, source="liquid_usrp_tpu_torch/csrc/autocorr_prefix.cu",
        replaces="liquid_usrp_tpu/ops/pallas_kernels.py:332",
        kernel="autocorr_prefix_kernel"),
}
# the payload codec's Viterbi: its source note, and the ofdm1_conv.v27
# cell's shape (v27 rows a dispatch, bytes of the budget)
VITERBI = dict(
    source="liquid_usrp_tpu_torch/csrc/viterbi.cu", replaces=None,
    note="replaces no Pallas kernel: the JAX package's lax.scan "
         "(liquid_usrp_tpu/ops/conv.py:187-205), whose eager form launched "
         "about 66,000 kernels a --conv dispatch; bound by the chain of T "
         "dependent trellis steps, not by bytes or operations",
    kernel="viterbi_warp_kernel")
VIT_ROWS, VIT_BYTES = 10, 2052
# the nearest-point scan's kernel: its source note and CUDA kernel
NEAREST = dict(
    source="liquid_usrp_tpu_torch/csrc/nearest.cu", replaces=None,
    note="replaces no Pallas kernel: the JAX package's lax.scan over table "
         "chunks (liquid_usrp_tpu/framing/payload.py::_nearest_sym), whose "
         "eager form launched 130-180 kernels a call; bound by float32 "
         "operations, 5 a (point, entry) pair",
    kernel="nearest_kernel")
V27_FRAMES = 20                # frames of the cell's receiver run
# the H100 SXM's published peaks (NVIDIA's H100 datasheet): HBM bytes/s
# and float32 FLOP/s outside the tensor cores, at a 700 W limit
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
DEVICE_ITERS = 100             # launches per kernel-only device time
DEVICE_TRACES = 5              # profiler windows tried per device time
SPIN_CYCLES = 1_000_000        # each spin kernel opening a window
SPIN_OPEN = 16                 # spin kernels opening each profiler window
# the single-channel path at the ofdmflexframe_tx/rx defaults
SC_FRAMES, SC_PAYLOAD, SC_SEED = 40, 1200, 42
SC_BLOCK, SC_BATCH, SC_MAX_PAYLOAD = 16384, 8, 2048
SC_CFO = 0.045                 # rad/sample, above pi / (2 M)
# detect configs of the single-channel path: (xcorr_detect, use_pallas),
# and the kernel each must launch
SC_CONFIGS = {(True, 0): None, (True, 1): "detect_metric_xcorr_onepass",
              (False, 0): None, (False, 1): "detect_metric_onepass",
              (False, 2): "detect_candidates_onepass"}
SC_TIMED_RUNS = 2
# the flexframe path at the flexframe_tx/rx defaults
FF_FRAMES, FF_PAYLOAD, FF_SEED = 40, 1024, 42
FF_BLOCK, FF_BATCH, FF_MAX_PAYLOAD, FF_MAX_FRAMES = 8192, 8, 2048, 4
FF_RX_RATE = 0.5               # flexframe_rx/packet_rx -r default
FF_CFO = 0.01                  # rad/sample at the file rate (k = 4)
FF_CFO_ATOL = 2e-3
FF_METRIC_LOUD = 100.0         # metric held where energy >= this x floor
FF_TIMED_RUNS = 2
FF_DISPATCH = 2                # the timed dispatch: blocks 16..23
# the multichannel receiver below the fused kernel's M >= 32
M16, CP16, TAPER16 = 16, 4, 2
# the GMSK path at the gmskframe_tx/rx defaults
GM_FRAMES, GM_PAYLOAD, GM_SEED = 40, 200, 42
GM_BLOCK, GM_BATCH, GM_MAX_PAYLOAD, GM_MAX_FRAMES = 8192, 8, 1024, 4
GM_CFO = 0.01                  # rad/sample (the RX takes the file rate)
GM_CFO_ATOL = 1e-3             # a CPU dry run at 8 frames: within 2e-4
GM_TIMED_RUNS = 2
GM_DISPATCH = 1                # the timed dispatch: blocks 8..15
# the --conv loopbacks of the OFDM and flexframe apps
CV_FRAMES = 10
# the soft decode path (phases 20, 21 and 23)
SOFT_LLR_RTOL = 1e-6           # LLRs: of the largest |LLR| of the call
NEAR_TIE = 1e-5                # Golay: best-two score gap over the best
SOFT_GOLAY_BLOCKS = 8192
SOFT_CPU_ROWS = 8              # rows of the 256-entry demap held on the CPU
SOFT_FRAMES, SOFT_SEED = 10, 42
SOFT_SNR = "-1.5"              # the low-SNR GMSK v27 file: soft above hard
# the streaming plumbing (phases 24 and 26): the TX worker's step and bound
TXW_CHUNK, TXW_AHEAD, TXW_PACKETS = 256, 65536, 3
STREAM_TIMED_RUNS = 2          # per side, in turns
# the 802.11a path (phases 25 and 26) at the wlanframe_tx/rx defaults
WLAN_FRAMES, WLAN_PSDU, WLAN_SEED = 5, 200, 42
WLAN_MTU, WLAN_MTU_FRAMES = 1500, 3
WLAN_CFO_ATOL, WLAN_RSSI_ATOL = 1e-5, 1e-4
WLAN_METRIC_ATOL = 1e-5
WLAN_TIMED_RUNS = 2
# the parallel layer (phase 27): a 2x2 world of ranks that share the card
# over gloo, and a 1-rank NCCL world
PAR_RANKS = 4
PAR_TIMED_RUNS = 2             # per world, after its checks
PAR_TIMEOUT_S = 600            # per spawned world
# the receiver-fidelity sweep (phase 28) at apps/ber_sweep.py's configs
# (M=48, block_size=8192, max_frames=4, 200-byte payloads, cfo 0.001),
# held to the JAX repo's curves in docs/ber_*.json (200 frames a point;
# the current JAX package reproduces their uncoded rows and the v27 soft
# OFDM rows at 1-2 dB within their binomial bounds: JAX_PLATFORMS=cpu
# python scripts/ber_sweep.py {ofdm,flex,gmsk} ... --frames 200)
FID_PAYLOAD, FID_FRAMES, FID_SOFT_FRAMES = 200, 200, 200
FID_WATERFALL = (0.02, 0.95)   # the JAX PERs whose points are checked
FID_SHIFT_DB = 0.5             # rule (a): PER_J(s + 0.5) <= PER <= ...
FID_SIGMAS = 3.0               # ... PER_J(s - 0.5), each widened so
FID_LEVEL_SNRS = (7.0, 8.0)    # OFDM: bracket 10 % PER, levels 0, 1, 2
FID_LEVEL_FLIPS = 2            # level 1's payload_valid flips vs level 0
FID_SOFT_SNR = {"ofdm": 2.0, "flex": 0.0, "gmsk": -3.0}
FID_INVALID_SNRS = (-2.0, -1.0)  # GMSK v27 hard: headers fail (fault C6)
# every OFDM size the JAX package takes (phase 29): per M, the detect
# config (xcorr_detect, use_pallas) whose kernel leaves its M=48 tiling
# there, and the CUDA kernels a call of its wrapper launches at that M
# (B2's window-sum path runs its chunk totals only past M = 512:
# kernels.candidates_kernels names those of a geometry)
LM_CONFIGS = {512: (True, 2, "detect_candidates_onepass"),
              1028: (True, 1, "detect_metric_xcorr_onepass"),
              1152: (False, 1, "detect_metric_onepass")}
LM_KERNELS = {"detect_metric_xcorr_onepass": ("xcorr_fold_kernel",
                                              "xcorr_fold_sum_kernel"),
              "detect_candidates_onepass": ("w3_totals_kernel",
                                            "cand_sums_kernel",
                                            "cand_pick_kernel"),
              "detect_metric_onepass": ("w3_totals_kernel",
                                        "w3_metric_kernel")}
# the sizes of phase 29's redesigned paths, timed on windows of the shape
# of the single-channel path's first dispatch at each M: B1's period
# fold, B2's and B3's window sums (and B3 at a span of at most 9, at
# M=48's shape)
LM_FOLD_SIZES = (64, 256, 1024, 1028, 4096)
LM_B2_SIZES = (512, 1024, 2048, 4096)
LM_W3_SIZES = (1152, 2048, 4096)
LM_W3_SHORT = (2, 9)           # (lag, span)
LM_PLAIN_ITERS = 2             # plain-version calls timed at these sizes
LM_FRAMES, LM_PAYLOAD, LM_MAX_PAYLOAD, LM_BLOCK = 4, 200, 256, 8192
LM_SWEEP = tuple(range(8, 4097, 4)) + (6144, 8192)
LM_SWEEP_BLOCK = 1024          # the sweep's rows: 4 M + this many samples
ROB_BLOCK = 8192               # tests/test_robustness.py's blocks


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` calls (CUDA events,
    after two warm-up calls)."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def open_window():
    """Open a profiler window with ``SPIN_OPEN`` spin kernels
    (``torch.cuda._sleep``, about 8 ms of device time in all), so that the
    launches under test queue behind them.  The profiler can lose the
    records of a window's first launches (on an H100 once phases 24-27
    had run: one spin kernel's and the first call's in every window of the
    process; with eight spin kernels, 121 of 176 spin records over 22
    windows); those losses fall on these sacrificial kernels, whose
    records are counted in ``PROFILER_SPINS`` and checked nowhere."""
    for _ in range(SPIN_OPEN):
        torch.cuda._sleep(SPIN_CYCLES)


PROFILER_SPINS = {"windows": 0, "launched": 0, "seen": 0, "least": SPIN_OPEN,
                  "retraced": 0}


def kernel_device_us(fn, kernel, iters: int = DEVICE_ITERS) -> float:
    """Mean device microseconds a call of ``fn`` spends in the CUDA kernel
    named ``kernel`` (or, for a tuple of names, in those kernels, each
    launched once a call) over ``iters`` back-to-back calls
    (``torch.profiler``: the kernels' own time on the card, without the
    wrapper's other work or the host's launch gaps).  Two calls warm every
    kernel up first, and each window opens with ``open_window``'s spin
    kernels.  Every launch of every kernel must be in the window; one that
    is not is traced again, at most ``DEVICE_TRACES`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    fn()
    fn()
    torch.cuda.synchronize()
    for _ in range(DEVICE_TRACES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            open_window()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        n = {k: sum(e.count for e in ev if k in e.key) for k in names}
        total = {k: sum(getattr(e, "self_device_time_total", None) or
                        e.self_cuda_time_total for e in ev if k in e.key)
                 for k in names}
        spin = sum(e.count for e in ev if "spin" in e.key)
        PROFILER_SPINS["windows"] += 1
        PROFILER_SPINS["launched"] += SPIN_OPEN
        PROFILER_SPINS["seen"] += spin
        PROFILER_SPINS["least"] = min(PROFILER_SPINS["least"], spin)
        if all(c == iters for c in n.values()):
            return sum(total.values()) / iters
        PROFILER_SPINS["retraced"] += 1
        print(f"profiler saw {n} launches of {iters} each and {spin} of "
              f"{SPIN_OPEN} spin kernels: traced again", flush=True)
    raise AssertionError(f"profiler saw {n} launches, expected {iters} "
                         f"of each")


def bound(nbytes: float, flops: float):
    """(least ms, what sets it): the bytes the function must move over
    the HBM rate, or its float32 operations over the float32 peak."""
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_F32
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def work(name, rows, length, **shape):
    """(bytes, float32 operations) of one call at these shapes: each input
    read once and each output written once; operations as the function
    needs them on this run's data.  B1: with a template of period p, the
    product of tap k and sample i depends on (i, (i - k) mod p) only, so
    each of the p residue classes of outputs takes one product sequence
    (6 a product) and its running span-window sums (4 a sample), over the
    samples its outputs reach; where the span divides p, the span-window
    sums are sums of non-overlapping blocks of those products (2 a
    product in place of 4 a sample, so 8 a product); where p divides the
    span, one p-tap correlation z per sample (8 per complex tap) serves
    every segment, which adds span/p values of z; the least of these and
    8 per tap of every segment (the direct form); then per segment |u|^2,
    the energy scale, the divide, the floor gate and the sum, and per
    sample |x|^2, a running span-window power sum and the mean.  B2/B3:
    the lag product,
    power and three window sums as running sums, the metric and, for B2,
    the NMS max; B4/B5: four window differences and the metric."""
    from liquid_usrp_tpu_torch.ops.kernels import template_period
    x = rows * length * 8
    if name == "detect_metric_xcorr_onepass":
        n, tmpl, span = shape["n_metric"], shape["tmpl"], shape["span"]
        n_tap, p = len(tmpl), template_period(tmpl)
        n_seg = n_tap // span
        corr = 8 * n_tap * n
        if p:
            prods = p * n + min(p, n) * (n_tap - p)
            corr = min(corr, (8 if p % span == 0 else 10) * prods)
        if p and span % p == 0:
            corr = min(corr, n * (8 * p + n_seg * 2 * (span // p - 1)))
        return x + rows * n * 4, rows * (corr + n * (7 * n_seg + 6))
    n_out = length - shape["span"] - shape["lag"] + 1
    if name == "detect_candidates_onepass":
        n_seg = -(-n_out // CAND_SEG)
        return x + rows * n_seg * 16, rows * n_out * 25
    if name == "detect_metric_onepass":
        return x + rows * n_out * 12, rows * n_out * 21
    prefix = rows * (2 * (length - shape["lag"] + 1) + length + 1) * 4
    return prefix + rows * n_out * 12, rows * n_out * 10


def bench_streams(params, props, total, margin, dev, cfos=None):
    """The per-channel baseband of ``bench.py::_build_loaded_mixture``:
    back-to-back frames (random headers/payloads from ``default_rng(0)``)
    -> (streams [total, N], payloads).  ``cfos``: a frequency offset
    (rad/sample) per channel stream."""
    from liquid_usrp_tpu_torch.framing import ofdm
    rng = np.random.default_rng(0)
    flen = ofdm.frame_length(params, props, PAYLOAD)
    gap = 128
    n_frames = max(1, (total - margin) // (flen + gap))
    streams = np.zeros((total, N), np.complex64)
    payloads = []
    for ch in range(N):
        per_ch, pos = [], 0
        for _ in range(n_frames):
            h = rng.integers(0, 256, 8, dtype=np.uint8)
            p = rng.integers(0, 256, PAYLOAD, dtype=np.uint8)
            per_ch.append(p)
            w = ofdm.assemble_frame(params, props,
                                    torch.as_tensor(h, device=dev),
                                    torch.as_tensor(p, device=dev))
            streams[pos:pos + flen, ch] = w.cpu().numpy()
            pos += flen + gap
        payloads.append(per_ch)
    if cfos is not None:
        n = np.arange(total)
        for ch, cfo in enumerate(cfos):
            streams[:, ch] *= np.exp(1j * cfo * n).astype(np.complex64)
    return streams, payloads


def build_mixture(params, props, total, margin, dev, cfos=None):
    """``bench.py::_build_loaded_mixture`` with the port's TX:
    :func:`bench_streams` through the m=13 synthesizer -> (mixture
    [2N*total], payloads)."""
    from liquid_usrp_tpu_torch.models.multichannel import make_mctx_step
    streams, payloads = bench_streams(params, props, total, margin, dev,
                                      cfos)
    init, step = make_mctx_step(N, dev)
    Y = np.zeros((total, 2 * N), np.complex64)
    Y[:, :N] = streams
    st, out = init(), []
    for lo in range(0, total, 1 << 15):
        st, y = step(st, torch.as_tensor(Y[lo:lo + (1 << 15)], device=dev))
        out.append(y.cpu().numpy())
    return np.concatenate(out), payloads


def expected_fingerprints(payloads, weights):
    """``bench.py::_expected_fingerprints``: per-channel frame counts and
    order-independent uint32 payload fingerprints."""
    fps, counts = [], []
    for per_ch in payloads:
        acc = 0
        for p in per_ch:
            pad = np.zeros(MAX_PAYLOAD, np.uint64)
            pad[:len(p)] = p
            acc = (acc + int((pad * weights.astype(np.uint64)).sum())) \
                & 0xFFFFFFFF
        fps.append(acc)
        counts.append(len(per_ch))
    return counts, fps


def fingerprint(res, w64):
    """Per-channel (count, uint32 fingerprint) of the payload-valid rows, as
    device tensors ``[N]`` (the fingerprint not yet reduced mod 2^32)."""
    ok = res.payload_valid
    row_fp = (res.payload.to(torch.int64) * w64).sum(-1) & 0xFFFFFFFF
    red = tuple(range(1, ok.dim()))
    fp = torch.where(ok, row_fp, torch.zeros_like(row_fp)).sum(red)
    return ok.sum(red), fp


def check_decoded(what, cnt, fp, expected):
    """Raise unless every channel's count and fingerprint are expected."""
    cnt = cnt.cpu().numpy()
    fp = fp.cpu().numpy() & 0xFFFFFFFF
    exp_cnt, exp_fp = expected
    for ch in range(N):
        if int(cnt[ch]) != exp_cnt[ch]:
            raise AssertionError(f"{what} channel {ch}: decoded "
                                 f"{int(cnt[ch])} frames, injected "
                                 f"{exp_cnt[ch]}")
        if int(fp[ch]) != exp_fp[ch]:
            raise AssertionError(f"{what} channel {ch}: payload "
                                 f"fingerprint mismatch")
    return fp


def decode_stream(step, init, blocks, flush, n_flush, w64):
    """One loaded chunk then ``n_flush`` flush chunks from the initial
    state: (count, fingerprint) per channel of the whole run, the first
    step's (count, fingerprint), and the results of every step."""
    st, res = step(init(), blocks)
    first = fingerprint(res, w64)
    cnt, fp = first
    out = [res]
    for _ in range(n_flush):
        st, res = step(st, flush)
        c2, f2 = fingerprint(res, w64)
        cnt, fp = cnt + c2, fp + f2
        out.append(res)
    return (cnt, fp), first, out


def b1_vs_plain(args, what):
    """B1's wrapper against its plain version on ``args``: the largest
    absolute difference, which must be at most 1e-4."""
    from liquid_usrp_tpu_torch.ops import kernels
    got = kernels.detect_metric_xcorr_onepass(*args)
    torch.cuda.synchronize()
    ref = kernels.detect_metric_xcorr_plain(*args)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    print(f"{what} kernel vs plain: max abs diff {err:.3e} (limit 1e-4), "
          f"metric peak {float(ref.max()):.4f}", flush=True)
    if not err <= 1e-4:
        raise AssertionError(f"{what} disagrees with its plain version: "
                             f"{err}")
    return err


def b2_vs_plain(args, what):
    """B2's wrapper against its plain version on ``args``: the detected
    mask identical (and not empty), the values within 1e-4, the offsets
    within 3 samples and ``c_at`` within a relative 1e-4 of the plain lag
    correlation at the kernel's offsets.  Returns the values' largest
    absolute difference."""
    from liquid_usrp_tpu_torch.ops import kernels
    exts, d, L = args[:3]
    v, loc, c = kernels.detect_candidates_onepass(*args)
    torch.cuda.synchronize()
    vr, lr, _ = kernels.detect_candidates_plain(*args)
    _, c_full = kernels.autocorr_metric(exts, d, L)
    torch.cuda.synchronize()
    det, detr = v > 0, vr > 0
    if not torch.equal(det, detr):
        raise AssertionError(f"{what} detected mask differs from its plain "
                             f"version")
    err = float((v - vr).abs().max())
    loc_err = 0
    for row in range(exts.shape[0]):
        a = np.sort(loc[row][det[row]].cpu().numpy())
        b = np.sort(lr[row][detr[row]].cpu().numpy())
        if len(a):
            loc_err = max(loc_err, int(np.abs(a.astype(np.int64) - b).max()))
    # c_at against the plain lag correlation at the kernel's own offsets
    c_ref = torch.gather(c_full, -1, loc.to(torch.int64))[det]
    c_rel = float(((c[det] - c_ref).abs() / c_ref.abs()).max()) \
        if bool(det.any()) else 0.0
    print(f"{what} kernel vs plain: {int(det.sum())} detected (identical), "
          f"vals max abs diff {err:.3e} (limit 1e-4), locs max diff "
          f"{loc_err} (limit 3), c_at max rel diff {c_rel:.3e} (limit "
          f"1e-4)", flush=True)
    if not (err <= 1e-4 and loc_err <= 3 and bool(det.any())):
        raise AssertionError(f"{what} disagrees with its plain version")
    if not c_rel <= 1e-4:
        raise AssertionError(f"{what} c_at disagrees with the plain lag "
                             f"correlation: {c_rel}")
    return err


def check_kernels(sync, rx, blocks):
    """Each kernel vs its plain version at the main path's shapes (the
    extended windows of the first chunk).  Returns per-kernel stats."""
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    from liquid_usrp_tpu_torch.ops import kernels
    st = rx.init_state()
    _, _, chans = rx.front_end(st, blocks)
    _, exts = ofdm_sync.extended_windows(sync, st.syncs.tail, chans)
    print(f"kernel inputs: {tuple(exts.shape)} {exts.dtype}", flush=True)
    tmpl = rx.tables.xc_tmpl
    span = ofdm_sync._xc_span(len(tmpl))
    n_metric = sync.block_size + 2 * M + 1
    d, L = M // 4, 2 * M - M // 4
    b1_args = (exts, tmpl, span, n_metric)
    b2_args = (exts, d, L, M, sync.block_size, sync.threshold,
               sync.max_frames)

    b1_err = b1_vs_plain(b1_args, "B1")
    b2_err = b2_vs_plain(b2_args, "B2")

    rows, length = exts.shape
    return {
        "detect_metric_xcorr_onepass": timed(
            "detect_metric_xcorr_onepass",
            kernels.detect_metric_xcorr_onepass,
            kernels.detect_metric_xcorr_plain, b1_args, b1_err,
            work("detect_metric_xcorr_onepass", rows, length,
                 n_metric=n_metric, tmpl=tmpl, span=span),
            exts.shape),
        "detect_candidates_onepass": timed(
            "detect_candidates_onepass", kernels.detect_candidates_onepass,
            kernels.detect_candidates_plain, b2_args, b2_err,
            work("detect_candidates_onepass", rows, length, span=L, lag=d),
            exts.shape)}


def check_viterbi_kernel(dev):
    """The Viterbi kernel against its plain version on the card at the
    ``ofdm1_conv.v27`` cell's shape: ``VIT_ROWS`` words of v27 over
    ``VIT_BYTES`` at 2 % bit errors, the last with a third of its steps
    erased; every bit of every step equal.  Bound: the costs read and the
    bits written once over the HBM rate; the chain of T steps is the real
    limit, so the line also gives the device ns a step."""
    from liquid_usrp_tpu_torch.ops import conv, fec
    from liquid_usrp_tpu_torch.utils.bits import pack_bits
    s = fec.FEC_CONV_V27
    rng = np.random.default_rng(0x7E5B)
    data = rng.integers(0, 256, (VIT_ROWS, VIT_BYTES), dtype=np.uint8)
    bits = np.unpackbits(fec.fec_encode(s, torch.as_tensor(data)).numpy(),
                         axis=-1)
    noisy = np.packbits(bits ^ (rng.random(bits.shape) < 0.02), axis=-1)
    costs = conv._hard_costs(s, torch.as_tensor(noisy, device=dev),
                             VIT_BYTES)
    B, T, P = costs.shape
    costs[-1, T // 3:2 * T // 3] = 0
    args = (s, costs, conv.BIG_HARD)
    got = conv._viterbi(*args)
    if not torch.equal(got, conv._viterbi_plain(*args)):
        raise AssertionError("the Viterbi kernel differs from its plain "
                             "version")
    ok = (pack_bits(got[:, :VIT_BYTES * 8]).cpu().numpy() == data).all(-1)
    if not ok[:-1].all():
        raise AssertionError(f"the Viterbi left unerased rows at 2 % bit "
                             f"errors undecoded: {ok.tolist()}")
    print(f"viterbi: {tuple(costs.shape)} costs, every bit equal to the "
          f"plain version's; rows decoded {ok.tolist()} (the last, a third "
          f"erased, need not)", flush=True)
    t = timed("viterbi", conv._viterbi, conv._viterbi_plain, args, 0,
              (costs.numel() * 4 + B * T, 0), costs.shape,
              kernel=VITERBI["kernel"], plain_iters=2)
    print(f"viterbi: {t['kernel_ms'] * 1e6 / T:.1f} ns of device time a "
          f"trellis step ({T} steps, {B} rows in parallel): the chain, not "
          f"the bytes, bounds it", flush=True)
    return t


def check_nearest_kernel(dev):
    """The nearest-point kernel against the plain loop on the card at the
    ``mcrx4.loaded`` dispatch's call shapes: points at 20 dB around a
    random scheme's constellation a row, tables the first C entries of
    each row's padded table; ``arg`` equal and ``best`` bit-equal.  Bytes:
    the points and tables read and ``arg`` and ``best`` written once;
    operations 5 a (point, entry) pair.  Returns the timings of the
    payload EVM's shape (the whole payload against 256 entries), for the
    kernels line."""
    from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync, payload
    from liquid_usrp_tpu_torch.ops import modem
    params = ofdm.make_ofdm_params(M, CP, TAPER)
    sync = ofdm_sync.make_sync(params, block_size=BLOCK,
                               max_payload=MAX_PAYLOAD, max_frames=MAX_FRAMES)
    R = N * N_BLOCKS * MAX_FRAMES
    n_data = len(params.data_idx)
    dd = min(ofdm_sync._DD_SYMS, sync.max_psym)
    rng = np.random.default_rng(0x5CA7)
    stacked = payload._stacked_tables()
    times = {}
    for label, n_sym, C in (("dd", dd, 256), ("demap", sync.max_psym, 64),
                            ("evm", sync.max_psym, 256)):
        n = n_sym * n_data
        mods = rng.integers(0, len(payload.PAYLOAD_MODS), R)
        tab = stacked[mods][:, :C]
        size = [min(C, 1 << modem.bits_per_symbol(int(m))) for m in mods]
        pick = (rng.random((R, n)) * np.array(size)[:, None]).astype(np.int64)
        x = np.take_along_axis(tab, pick, axis=-1) + 0.07 * (
            rng.normal(size=(R, n)) + 1j * rng.normal(size=(R, n)))
        args = (torch.as_tensor(x.astype(np.complex64), device=dev),
                torch.as_tensor(np.ascontiguousarray(tab), device=dev))
        got = payload._nearest_sym(*args)
        want = payload._nearest_sym_plain(*args)
        if not (torch.equal(got[0], want[0]) and
                torch.equal(got[1].view(torch.int32),
                            want[1].view(torch.int32))):
            raise AssertionError(f"nearest ({label}): the kernel differs "
                                 f"from the plain loop at {R} x {n} x {C}")
        times[label] = timed(
            "nearest", payload._nearest_sym, payload._nearest_sym_plain,
            args, 0, (R * n * 20 + R * C * 8, 5 * R * n * C), (R, n, C),
            label=f"nearest ({label}: {R} x {n} points, {C} entries, equal "
            f"to the plain loop)", kernel=NEAREST["kernel"], plain_iters=3)
    return times["evm"]


def timed(name, fn, plain, args, err, nbytes_flops, shape, label=None,
          kernel=None, plain_iters=10):
    """The wrapper ``fn(*args)``'s and the plain version's times (CUDA
    events; the plain version over ``plain_iters`` calls), the kernel's
    device time alone (profiler) and its bound: one entry of the kernels
    line.  ``label`` names the printed line (default ``name``);
    ``kernel``: the CUDA kernel name(s) a call launches (default the
    wrapper's one-pass kernel)."""
    ms = cuda_ms(lambda: fn(*args), 50)
    plain_ms = cuda_ms(lambda: plain(*args), plain_iters)
    dev_us = kernel_device_us(lambda: fn(*args),
                              kernel or KERNELS[name]["kernel"])
    bound_ms, bound_by = bound(*nbytes_flops)
    print(f"{label or name}: wrapper {ms:.4f} ms, plain {plain_ms:.4f} ms; "
          f"kernel "
          f"alone {dev_us:.2f} us on the device, bound {bound_ms * 1e3:.2f} "
          f"us by {bound_by} ({nbytes_flops[0] / 1e6:.2f} MB, "
          f"{nbytes_flops[1] / 1e6:.1f} MFLOP): it reaches "
          f"{bound_ms * 1e3 / dev_us:.1%} of the bound ({tuple(shape)} rows)",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                kernel_ms=dev_us * 1e-3, bound_ms=bound_ms, bound_by=bound_by)


def run_level(level, params, mixes, flush, weights, expected, dev, label):
    """The main path at one detect level: decode each loaded chunk of
    ``mixes`` (the bench mixture, then the same frames with ``CFOS``) and
    the flush chunks, check counts, fingerprints and the estimated
    offsets, then time steps of the bench chunk and check each."""
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    from liquid_usrp_tpu_torch.models.multichannel import \
        make_mcrx_batched_step
    from liquid_usrp_tpu_torch.ops import kernels
    sync = ofdm_sync.make_sync(params, block_size=BLOCK,
                               max_payload=MAX_PAYLOAD,
                               max_frames=MAX_FRAMES, use_pallas=level)
    init, step = make_mcrx_batched_step(N, sync, N_BLOCKS, dev)
    w64 = torch.as_tensor(weights.astype(np.int64), device=dev)
    n_flush = -(-(sync.overlap // sync.block_size + 1) // N_BLOCKS)
    blocks, cfo_blocks = mixes
    kernels.reset_launch_counts()
    total, first, _ = decode_stream(step, init, blocks, flush, n_flush, w64)
    cfo_total, _, cfo_res = decode_stream(step, init, cfo_blocks, flush,
                                          n_flush, w64)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    fp = check_decoded(f"level {level}", *total, expected)
    check_decoded(f"level {level} with CFO", *cfo_total, expected)
    want = torch.tensor(CFOS, device=dev)[:, None, None]
    cfo_err = max(float(torch.where(r.payload_valid, (r.cfo - want).abs(),
                                    torch.zeros_like(r.cfo)).max())
                  for r in cfo_res)
    if not cfo_err <= CFO_ATOL:
        raise AssertionError(f"level {level}: CFO estimate off by {cfo_err}")
    for name, k in KERNELS.items():
        if k["level"] == level and launches[name] <= 0:
            raise AssertionError(f"level {level}: kernel {name} was not "
                                 f"launched on the main path")
    n_dec, n_exp = int(total[0].sum()), sum(expected[0])
    print(f"main path use_pallas={level}: {n_dec}/{n_exp} frames decoded, "
          f"fingerprints match ({[hex(int(f)) for f in fp]}); with CFO "
          f"{int(cfo_total[0].sum())}/{n_exp}, offsets within "
          f"{cfo_err:.2e} (limit {CFO_ATOL}); kernel launches {launches}",
          flush=True)

    # every timed step decodes the loaded chunk from the initial state and
    # must reproduce the checked first step
    st0, timed = init(), []

    def one():
        _, res = step(st0, blocks)
        timed.append(fingerprint(res, w64))

    ms = cuda_ms(one, TIMED_STEPS)
    for cnt, fpr in timed:
        if not (torch.equal(cnt, first[0]) and torch.equal(fpr, first[1])):
            raise AssertionError(f"level {level}: a timed step decoded "
                                 f"other frames than the checked first step")
    sps = blocks.shape[-1] / (ms * 1e-3)
    print(f"main path use_pallas={level}: {ms:.3f} ms/step, "
          f"{sps / 1e6:.3f} MS/s decode-verified over {TIMED_STEPS} steps "
          f"({blocks.shape[-1]} samples/step, {int(first[0].sum())} frames "
          f"each) on {label}", flush=True)
    return launches, ms


def check_class_entry(dev):
    """MultichannelRx.execute + flush on a short two-frames-per-channel
    mixture from MultichannelTx."""
    from liquid_usrp_tpu_torch.models.multichannel import (MultichannelRx,
                                                           MultichannelTx)
    rng = np.random.default_rng(5)
    tx = MultichannelTx(N, M=M, cp_len=CP, taper_len=TAPER, device=dev)
    rx = MultichannelRx(N, M=M, cp_len=CP, taper_len=TAPER, device=dev)
    sent, chunks = {}, []
    for _ in range(2):
        for ch in range(N):
            h = rng.integers(0, 256, 8, dtype=np.uint8)
            h[2] = ch
            p = rng.integers(0, 256, 100, dtype=np.uint8)
            tx.update_data(ch, h, p)
            sent[bytes(h)] = p
        chunks.append(tx.generate_samples(
            max(len(q) for q in tx._queues) + 64))
    frames = rx.execute(np.concatenate(chunks)) + rx.flush()
    valid = {bytes(f["header"]): f for f in frames if f["payload_valid"]}
    if set(valid) != set(sent):
        raise AssertionError(f"MultichannelRx decoded {len(valid)} of "
                             f"{len(sent)} frames")
    for h, p in sent.items():
        if not np.array_equal(valid[h]["payload"], p):
            raise AssertionError("MultichannelRx payload mismatch")
    print(f"MultichannelRx.execute + flush: {len(valid)}/{len(sent)} frames "
          f"payload-exact", flush=True)


def metric_vs_plain(name, plain, limit, exts, m_sub, label=None, lag=None,
                    span=None):
    """Kernel ``name`` (B3, B4 or B5) vs its ``plain`` version on the
    extended windows ``exts`` of M = ``m_sub`` (or at ``lag`` and
    ``span``): metric max abs difference and ``c`` relative to max ``|c|``
    within ``limit``.  Returns the metric's difference."""
    from liquid_usrp_tpu_torch.ops import kernels
    lag = m_sub // 4 if lag is None else lag
    span = 2 * m_sub - lag if span is None else span
    m, c = getattr(kernels, name)(exts, lag, span)
    torch.cuda.synchronize()
    mr, cr = plain(exts, lag, span)
    torch.cuda.synchronize()
    err = float((m - mr).abs().max())
    c_rel = float((c - cr).abs().max() / cr.abs().max())
    print(f"{label or name} kernel vs plain: metric max abs diff {err:.3e} "
          f"(limit {limit}), c max diff {c_rel:.3e} of max |c| (limit "
          f"{limit}), metric peak {float(mr.max()):.4f}", flush=True)
    if not (err <= limit and c_rel <= limit and m.shape == mr.shape):
        raise AssertionError(f"{label or name} disagrees with its plain "
                             f"version")
    return err


def check_metric_kernel(name, plain, limit, exts, m_sub, label=None,
                        kernel=None):
    """:func:`metric_vs_plain`, then the kernel's times (``kernel``: the
    CUDA kernels a call launches, as :func:`timed` takes them)."""
    from liquid_usrp_tpu_torch.ops import kernels
    err = metric_vs_plain(name, plain, limit, exts, m_sub, label)
    lag = m_sub // 4
    span = 2 * m_sub - lag
    return timed(name, getattr(kernels, name), plain, (exts, lag, span), err,
                 work(name, *exts.shape, span=span, lag=lag), exts.shape,
                 label, kernel)


def check_autocorr_kernels(exts):
    """B3, B4 and B5 vs their plain versions on the single-channel path's
    first 8 extended windows, with times.  Returns per-kernel stats."""
    from liquid_usrp_tpu_torch.ops import kernels
    print(f"kernel inputs: {tuple(exts.shape)} {exts.dtype}", flush=True)
    return {name: check_metric_kernel(name, plain, limit, exts, M)
            for name, plain, limit in (
                ("detect_metric_onepass", kernels.autocorr_metric, 1e-4),
                ("detect_metric_fused_2d", kernels.autocorr_metric_prefix,
                 1e-5),
                ("detect_metric_fused", kernels.autocorr_metric_prefix,
                 1e-5))}


def sc_windows(params, stream, dev):
    """The extended windows of the single-channel path's first dispatch
    (``[SC_BATCH, overlap + SC_BLOCK]``), as the detect front end sees
    them."""
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    sync = ofdm_sync.make_sync(params, block_size=SC_BLOCK,
                               max_payload=SC_MAX_PAYLOAD)
    blocks = torch.as_tensor(stream[:SC_BATCH * SC_BLOCK].reshape(
        1, SC_BATCH, SC_BLOCK), device=dev)
    _, exts = ofdm_sync.extended_windows(
        sync, ofdm_sync.sync_init(sync, dev).tail[None], blocks)
    return exts


def sc_transmit(path, m=M, cp=CP, frames=SC_FRAMES, payload=SC_PAYLOAD):
    """``ofdmflexframe_tx.main`` at its defaults (40 frames of 1200 bytes,
    seed 42; or ``frames`` of ``payload`` bytes at M = ``m``, cyclic prefix
    ``cp``) into ``path``: (stream, {packet id: payload}) with the payloads
    regenerated from the seed as the app draws them."""
    from liquid_usrp_tpu_torch.apps import ofdmflexframe_tx
    from liquid_usrp_tpu_torch.io.streams import read_iq
    with contextlib.redirect_stdout(io.StringIO()):
        rc = ofdmflexframe_tx.main([
            "-o", path, "-N", str(frames), "-P", str(payload),
            "-s", str(SC_SEED), "-g", "-12", "-M", str(m), "-C", str(cp),
            "-T", str(TAPER), "-m", "qpsk", "-c", "none", "-k", "g2412"])
    if rc != 0:
        raise AssertionError(f"ofdmflexframe_tx exited {rc}")
    rng = np.random.default_rng(SC_SEED)
    sent = {}
    for pid in range(frames):
        rng.integers(0, 256, 6, dtype=np.uint8)      # header bytes 2..7
        sent[pid] = rng.integers(0, 256, payload, dtype=np.uint8)
    return read_iq(path), sent


def check_sc_frames(what, frames, sent, cfo=None):
    """Raise unless ``frames`` hold exactly the sent packets, payload-exact
    (and each offset within ``CFO_ATOL`` of ``cfo``).  Returns the largest
    offset error (0 without ``cfo``)."""
    ok = {}
    for f in frames:
        if f["payload_valid"]:
            ok[(int(f["header"][0]) << 8) | int(f["header"][1])] = f
    n_valid = sum(f["payload_valid"] for f in frames)
    if n_valid != len(sent) or set(ok) != set(sent):
        raise AssertionError(f"{what}: {n_valid} payload-valid frames for "
                             f"{len(sent)} sent")
    for pid, p in sent.items():
        if not np.array_equal(ok[pid]["payload"], p):
            raise AssertionError(f"{what}: packet {pid} payload mismatch")
    if cfo is None:
        return 0.0
    err = max(abs(f["stats"]["cfo"] - cfo) for f in ok.values())
    if not err <= CFO_ATOL:
        raise AssertionError(f"{what}: CFO estimate off by {err}")
    return err


def sc_receiver(dev, config=None):
    """``OfdmTxRx`` at the app defaults; ``config = (xcorr_detect,
    use_pallas)`` replaces its synchronizer with that detect config, so
    that ``run_rx`` dispatches as it always does, through another
    detector."""
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    from liquid_usrp_tpu_torch.models.ofdmtxrx import OfdmTxRx
    rx = OfdmTxRx(M=M, cp_len=CP, taper_len=TAPER, block_size=SC_BLOCK,
                  batch_blocks=SC_BATCH, max_payload=SC_MAX_PAYLOAD,
                  device=dev)
    if config is not None:
        xcorr, level = config
        rx._sync = ofdm_sync.make_sync(
            rx.params, block_size=SC_BLOCK, max_payload=SC_MAX_PAYLOAD,
            use_pallas=level, xcorr_detect=xcorr)
        rx._step = ofdm_sync.make_sync_step(rx._sync)
        rx.reset_rx()
    rx.start_rx()
    return rx


def sc_decode(rx, stream):
    """One whole-stream ``run_rx`` with a flush, from the initial state."""
    rx.reset_rx()
    frames = rx.run_rx(stream, flush=True)
    torch.cuda.synchronize()
    return frames


def run_single_channel(stream, sent, path, dev, label):
    """The single-channel path: the class and the RX app at their
    defaults, then each detect config (with its kernel launched), the
    legacy B3 config through ``--snr 20 --cfo 0.045``, and decode-verified
    timings.  Returns (launches per config, and of the impaired run under
    "impaired"; timing lines)."""
    from liquid_usrp_tpu_torch.apps import ofdmflexframe_rx
    from liquid_usrp_tpu_torch.apps.common import (apply_channel,
                                                   occupied_power)
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    from liquid_usrp_tpu_torch.models.ofdmtxrx import _to_host
    from liquid_usrp_tpu_torch.ops import kernels
    rx = sc_receiver(dev)
    check_sc_frames("OfdmTxRx", sc_decode(rx, stream), sent)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ofdmflexframe_rx.main(["-i", path, "-q"])
    got = re.search(r"valid packets\s+:\s+(\d+)", out.getvalue())
    if rc != 0 or got is None or int(got.group(1)) != SC_FRAMES:
        raise AssertionError(f"ofdmflexframe_rx: rc {rc}, "
                             f"{out.getvalue()[-400:]}")
    print(f"single channel: OfdmTxRx and ofdmflexframe_rx decode "
          f"{SC_FRAMES}/{SC_FRAMES} payload-exact ({len(stream)} samples, "
          f"{len(stream) // SC_BLOCK} blocks of {SC_BLOCK})", flush=True)

    impaired = apply_channel(stream, {"snr": "20", "cfo": str(SC_CFO)},
                             signal_power=occupied_power(stream))
    launches, timing = {}, {}
    for config, kernel in SC_CONFIGS.items():
        rx = sc_receiver(dev, config)
        kernels.reset_launch_counts()
        frames = sc_decode(rx, stream)
        launches[config] = dict(kernels.launches)
        check_sc_frames(f"config {config}", frames, sent)
        if kernel is not None and launches[config][kernel] <= 0:
            raise AssertionError(f"config {config}: {kernel} was not "
                                 f"launched")
        cfo_err = None
        if config == (False, 1):
            kernels.reset_launch_counts()
            cfo_err = check_sc_frames("legacy B3 with --snr 20 --cfo "
                                      f"{SC_CFO}", sc_decode(rx, impaired),
                                      sent, SC_CFO)
            launches["impaired"] = dict(kernels.launches)
            if launches["impaired"][kernel] <= 0:
                raise AssertionError("B3 was not launched on the impaired "
                                     "stream")
        # decode-verified timings: whole-stream runs, each checked, and
        # one 8-block dispatch from the initial state, each giving the
        # checked first dispatch's valid count
        secs = []
        for _ in range(SC_TIMED_RUNS):
            t0 = time.perf_counter()
            frames = sc_decode(rx, stream)
            secs.append(time.perf_counter() - t0)
            check_sc_frames(f"config {config}, timed run", frames, sent)
        blocks = torch.as_tensor(stream[:SC_BATCH * SC_BLOCK].reshape(
            SC_BATCH, SC_BLOCK), device=dev)
        st0 = ofdm_sync.sync_init(rx._sync, dev)
        counts = []

        def dispatch():
            _, res = ofdm_sync.sync_blocks_batched(rx._sync, st0, blocks)
            counts.append(int(_to_host(res).payload_valid.sum()))
        disp_ms = cuda_ms(dispatch, 5)
        if len(set(counts)) != 1 or counts[0] <= 0:
            raise AssertionError(f"config {config}: timed dispatches "
                                 f"decoded {counts}")
        sps = len(stream) / min(secs)
        timing[config] = (disp_ms, sps)
        print(f"single channel xcorr_detect={config[0]} use_pallas="
              f"{config[1]}: {SC_FRAMES}/{SC_FRAMES} payload-exact"
              + (f", with --snr 20 --cfo {SC_CFO} {SC_FRAMES}/{SC_FRAMES}, "
                 f"offsets within {cfo_err:.2e}" if cfo_err is not None
                 else "")
              + f"; {disp_ms:.3f} ms per {SC_BATCH}-block dispatch "
              f"({counts[0]} frames), {sps / 1e6:.3f} MS/s decode-verified "
              f"(best of {SC_TIMED_RUNS} whole-stream runs); launches "
              f"{ {k: v for k, v in launches[config].items() if v} } on "
              f"{label}", flush=True)
    return launches, timing


def check_debug_print(stream, dev, tmpdir):
    """``OfdmTxRx.debug_enable -> run_rx -> debug_print`` on the card: the
    metric of the dump comes from B3.  Returns the launch counts."""
    from liquid_usrp_tpu_torch.ops import kernels
    rx = sc_receiver(dev)
    rx.debug_enable()
    rx.run_rx(stream[:3 * SC_BLOCK])
    kernels.reset_launch_counts()
    path = rx.debug_print(str(Path(tmpdir) / "sc"))
    torch.cuda.synchronize()
    n = kernels.launches["detect_metric_onepass"]
    text = Path(path).read_text()
    if n <= 0 or "metric = [" not in text:
        raise AssertionError(f"debug_print: B3 launched {n} times")
    print(f"OfdmTxRx.debug_print: B3 launched {n} time(s), wrote "
          f"{len(text)} bytes", flush=True)
    return dict(kernels.launches)


def run_mcrx_m16(noise, flush, weights, dev):
    """The multichannel receiver at M=16, ``use_pallas=2``: every injected
    frame decodes with ``bench.py``'s fingerprints, through B3 and not B2.
    Then B3's generic instance vs its plain version, with times, on the
    extended windows of that path's first chunk.  Returns the path's
    launch counts."""
    from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
    from liquid_usrp_tpu_torch.models.multichannel import (
        Mcrx, make_mcrx_batched_step)
    from liquid_usrp_tpu_torch.ops import kernels
    params = ofdm.make_ofdm_params(M16, CP16, TAPER16)
    sync = ofdm_sync.make_sync(params, block_size=BLOCK,
                               max_payload=MAX_PAYLOAD,
                               max_frames=MAX_FRAMES, use_pallas=2)
    mixture, payloads = build_mixture(params, ofdm.default_props(),
                                      BLOCK * N_BLOCKS,
                                      sync.overlap + 8 * M16, dev)
    blocks = torch.as_tensor((mixture + 0.01 * noise).reshape(-1),
                             device=dev)
    expected = expected_fingerprints(payloads, weights)
    init, step = make_mcrx_batched_step(N, sync, N_BLOCKS, dev)
    w64 = torch.as_tensor(weights.astype(np.int64), device=dev)
    n_flush = -(-(sync.overlap // sync.block_size + 1) // N_BLOCKS)
    kernels.reset_launch_counts()
    total, _, _ = decode_stream(step, init, blocks, flush, n_flush, w64)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    check_decoded("M=16", *total, expected)
    if launches["detect_metric_onepass"] <= 0 or \
            launches["detect_candidates_onepass"] != 0:
        raise AssertionError(f"M=16: launches {launches}")
    print(f"multichannel M=16 use_pallas=2: {int(total[0].sum())}/"
          f"{sum(expected[0])} frames decoded, fingerprints match; B3 "
          f"launched {launches['detect_metric_onepass']} times, B2 0",
          flush=True)
    rx = Mcrx(N, sync, N_BLOCKS, dev)
    st = rx.init_state()
    _, _, chans = rx.front_end(st, blocks)
    _, exts = ofdm_sync.extended_windows(sync, st.syncs.tail, chans)
    check_metric_kernel("detect_metric_onepass", kernels.autocorr_metric,
                        1e-4, exts, M16,
                        f"B3 generic instance, M=16 windows "
                        f"{tuple(exts.shape)}")
    return launches


def run_app(main_fn, argv) -> str:
    """One CLI ``main(argv)`` with its standard output captured; raises
    unless it returns 0."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    if rc != 0:
        raise AssertionError(f"{argv}: exit {rc}, {out.getvalue()[-400:]}")
    return out.getvalue()


def app_count(text: str, what: str) -> int:
    """A count of the RX apps' report (``valid packets``, ...), 0 when the
    line is absent."""
    got = re.search(what + r"\s+:\s+(\d+)", text)
    return int(got.group(1)) if got else 0


def tx_draws(n, seed, user, payload):
    """The (header, payload) of each packet id as the flexframe and packet
    TX apps draw them from their seed: the id in header bytes 0-1, the
    other header bytes and the payload random."""
    rng = np.random.default_rng(seed)
    out = []
    for pid in range(n):
        h = np.empty(user, np.uint8)
        h[0], h[1] = (pid >> 8) & 0xFF, pid & 0xFF
        h[2:] = rng.integers(0, 256, user - 2, dtype=np.uint8)
        out.append((h, rng.integers(0, 256, payload, dtype=np.uint8)))
    return out


def ff_sync(frame64=False):
    """The flexframe_rx (or, with ``frame64``, packet_rx) synchronizer."""
    from liquid_usrp_tpu_torch.framing import flexframe as ff
    from liquid_usrp_tpu_torch.framing import flexframe_sync as fs
    if frame64:
        return fs.make_flex_sync(ff.make_flex_params(), block_size=FF_BLOCK,
                                 max_payload=ff.FRAME64_PAYLOAD,
                                 max_frames=FF_MAX_FRAMES,
                                 header_user=ff.FRAME64_HEADER_USER)
    return fs.make_flex_sync(ff.make_flex_params(), block_size=FF_BLOCK,
                             max_payload=FF_MAX_PAYLOAD,
                             max_frames=FF_MAX_FRAMES)


def ff_decode(sync, stream, dev, gmsk=False):
    """The resampled ``stream`` through ``iter_sync_results`` as the RX
    apps drive it (8-block batched dispatches, single-block steps for the
    rest): every detected frame, in stream order, as a dict.  With
    ``gmsk`` the GMSK synchronizer's entry points drive ``sync``."""
    from liquid_usrp_tpu_torch.apps.common import iter_sync_results
    from liquid_usrp_tpu_torch.framing import flexframe_sync as fs
    from liquid_usrp_tpu_torch.framing import gmskframe as gf
    step, init, batched = (
        (gf.make_gmsk_sync_step, gf.gmsk_sync_init,
         gf.gmsk_sync_blocks_batched) if gmsk else
        (fs.make_flex_sync_step, fs.flex_sync_init,
         fs.flex_sync_blocks_batched))
    frames = []
    for r in iter_sync_results(
            step(sync), init(sync, dev), stream, sync.block_size,
            sync.overlap, batched_fn=lambda st, b: batched(sync, st, b),
            batch_blocks=FF_BATCH):
        for i in np.nonzero(r.detected)[0]:
            frames.append(dict(
                t=int(r.t_start[i]), valid=bool(r.payload_valid[i]),
                header=r.header[i].copy(), cfo=float(r.cfo[i]),
                payload=r.payload[i][:int(r.payload_len[i])].copy()))
    return sorted(frames, key=lambda f: f["t"])


def check_ff_frames(what, frames, sent, cfo=None, exact_count=True,
                    atol=FF_CFO_ATOL):
    """Raise unless the payload-valid ``frames`` are the ``sent`` (header,
    payload) pairs byte for byte in stream order (and, with
    ``exact_count``, nothing else was detected), each offset within
    ``atol`` of ``cfo``.  Returns the largest offset error."""
    ok = [f for f in frames if f["valid"]]
    if len(ok) != len(sent) or (exact_count and len(frames) != len(sent)):
        raise AssertionError(f"{what}: {len(ok)} valid of {len(frames)} "
                             f"detected for {len(sent)} sent")
    for f, (h, p) in zip(ok, sent):
        if not (np.array_equal(f["header"], h) and
                np.array_equal(f["payload"], p)):
            raise AssertionError(f"{what}: frame at {f['t']} is not the "
                                 f"packet sent there")
    if cfo is None:
        return 0.0
    err = max(abs(f["cfo"] - cfo) for f in ok)
    if not err <= atol:
        raise AssertionError(f"{what}: CFO estimate off by {err}")
    return err


def ff_transmit(path, dev):
    """``flexframe_tx.main`` at its defaults (``FF_FRAMES`` frames of
    ``FF_PAYLOAD`` bytes, seed ``FF_SEED``, ``-r 2.0``) into ``path``: the
    file stream and the stream the RX apps decode (resampled at
    ``FF_RX_RATE`` on ``dev``)."""
    from liquid_usrp_tpu_torch.apps import flexframe_tx
    from liquid_usrp_tpu_torch.apps.common import resample_stream
    from liquid_usrp_tpu_torch.io.streams import read_iq
    run_app(flexframe_tx.main, ["-o", path, "-N", str(FF_FRAMES), "-P",
                                str(FF_PAYLOAD), "-s", str(FF_SEED)])
    file_stream = read_iq(path)
    return file_stream, resample_stream(file_stream, FF_RX_RATE, dev)


def ff_dispatch_input(sync, rx_stream, dev):
    """The sync state carried into dispatch ``FF_DISPATCH`` of
    ``rx_stream`` and that dispatch's ``[FF_BATCH, block]`` blocks, on
    ``dev``."""
    from liquid_usrp_tpu_torch.framing import flexframe_sync as fs
    first = FF_DISPATCH * FF_BATCH
    exts = ff_windows(sync, rx_stream, first)
    st = fs.FlexSyncState(
        tail=exts[0, :sync.overlap].to(dev),
        base=torch.tensor(first * sync.block_size - sync.overlap,
                          dtype=torch.int32, device=dev))
    return st, exts[:, sync.overlap:].contiguous().to(dev)


def ff_windows(sync, stream, first_block, n=FF_BATCH):
    """The host extended windows ``[n, overlap + block]`` of blocks
    ``first_block ..`` of the resampled ``stream``, as the sync sees them
    from its initial state."""
    bs = sync.block_size
    full = np.zeros(sync.overlap + (first_block + n) * bs, np.complex64)
    body = stream[:(first_block + n) * bs]
    full[sync.overlap:sync.overlap + len(body)] = body
    return torch.as_tensor(full).unfold(0, sync.overlap + bs, bs)[
        first_block:first_block + n]


def check_ff_front_end(sync, rx_stream, file_stream, dev):
    """The flexframe front end and the RX/TX resamplers on the card against
    the port on the CPU.  ``_mf_and_detect`` over every 8-block dispatch of
    ``rx_stream``: ``detected`` and the detected offsets identical, ``mf``
    within 1e-5 of max |mf|, the metric within 1e-4 where the window energy
    is at least ``FF_METRIC_LOUD`` times the silence floor (the float32
    cumsum of the energy sums in another order on each device: near the
    floor that moves the metric, and can move the gate); ``msresamp_block``
    at 0.5 on
    ``file_stream`` and at 2.0 on ``rx_stream``: the same count, ``y``
    within 1e-5 of max |y|."""
    from liquid_usrp_tpu_torch.framing import flexframe_sync as fs
    from liquid_usrp_tpu_torch.ops import resamp
    from liquid_usrp_tpu_torch.ops.corr import comb_moving_sum
    bs = sync.block_size
    n_blocks = -(-len(rx_stream) // bs) + -(-sync.overlap // bs) + 1
    mf_err = m_loud = m_all = 0.0
    flips = n_det = n_dispatches = 0
    half, shift = 32, 32 * sync.params.k     # preamble halves, as the sync
    for first in range(0, n_blocks - FF_BATCH + 1, FF_BATCH):
        ext = ff_windows(sync, rx_stream, first)
        got = [v.cpu() for v in fs._mf_and_detect(sync, ext.to(dev))]
        mf, metric, _, _, det, locs = fs._mf_and_detect(sync, ext)
        # the offsets of undetected slots are unspecified (top-k ties)
        if not (torch.equal(got[4], det) and
                torch.equal(got[5][det], locs[det])):
            raise AssertionError(f"flexframe front end, blocks {first}..: "
                                 f"candidates differ from the CPU's")
        mf_err = max(mf_err, float((got[0] - mf).abs().max() /
                                   mf.abs().max().clamp(min=1e-30)))
        pw = mf.abs() ** 2
        n = metric.shape[-1]
        e = comb_moving_sum(pw, half, sync.params.k, n + shift)
        energy = e[..., :n] + e[..., shift:]
        floor = 1e-4 * 64 * (pw.mean(-1, keepdim=True) + 1e-12)
        diff = (got[1] - metric).abs()
        loud = energy >= FF_METRIC_LOUD * floor
        m_all = max(m_all, float(diff.max()))
        if bool(loud.any()):
            m_loud = max(m_loud, float(diff[loud].max()))
        flips += int(((got[1] == 0) != (metric == 0)).sum())
        n_det += int(det.sum())
        n_dispatches += 1
    print(f"flexframe front end on the card vs the CPU over "
          f"{n_dispatches} dispatches ({n_det} detections, identical with "
          f"their offsets): mf max diff {mf_err:.3e} of max |mf| "
          f"(limit 1e-5); metric max abs diff {m_loud:.3e} where the energy "
          f">= {FF_METRIC_LOUD:g}x the floor (limit 1e-4), {m_all:.3e} "
          f"anywhere with {flips} silence-gate flips (not held)",
          flush=True)
    if not (mf_err <= 1e-5 and m_loud <= 1e-4 and n_det > 0):
        raise AssertionError("flexframe front end: the card disagrees with "
                             "the CPU")
    for rate, x in ((FF_RX_RATE, file_stream), (2.0, rx_stream)):
        ms = resamp.msresamp_create(rate)
        n = len(x) - len(x) % (2 ** ms.num_halfband)
        out = []
        for d in (dev, torch.device("cpu")):
            _, y, _, c = resamp.msresamp_block(
                ms, resamp.msresamp_state(ms, d),
                torch.as_tensor(x[:n], device=d))
            out.append((int(c), y[:int(c)].cpu()))
        err = float((out[0][1] - out[1][1]).abs().max() /
                    out[1][1].abs().max())
        print(f"msresamp_block at rate {rate} on the card vs the CPU: "
              f"{out[0][0]} outputs (CPU {out[1][0]}) from {n}, max diff "
              f"{err:.3e} of max |y| (limit 1e-5)", flush=True)
        if not (out[0][0] == out[1][0] and err <= 1e-5):
            raise AssertionError(f"msresamp_block at rate {rate}: the card "
                                 f"disagrees with the CPU")


def run_flexframe(dev, tmpdir, label):
    """The single-carrier flexframe path at the app defaults (phases 12,
    13 and 15).  Returns the kernel launch counts of its runs."""
    from liquid_usrp_tpu_torch.apps import flexframe_rx
    from liquid_usrp_tpu_torch.apps.common import (apply_channel,
                                                   occupied_power,
                                                   resample_stream)
    from liquid_usrp_tpu_torch.framing import flexframe as ff
    from liquid_usrp_tpu_torch.framing import flexframe_sync as fs
    from liquid_usrp_tpu_torch.models.ofdmtxrx import _to_host
    from liquid_usrp_tpu_torch.ops import kernels, resamp
    path = str(Path(tmpdir) / "flexframe.iq")
    sent = tx_draws(FF_FRAMES, FF_SEED, ff.FLEX_HEADER_USER, FF_PAYLOAD)
    sync = ff_sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    file_stream, rx_stream = ff_transmit(path, dev)
    t_tx = time.perf_counter() - t0
    text = run_app(flexframe_rx.main, ["-i", path, "-q"])
    if app_count(text, "valid packets") != FF_FRAMES:
        raise AssertionError(f"flexframe_rx: {text[-400:]}")
    frames = ff_decode(sync, rx_stream, dev)
    check_ff_frames("flexframe sync", frames, sent)
    flags = {"snr": "20", "cfo": str(FF_CFO)}
    text = run_app(flexframe_rx.main, ["-i", path, "-q", "--snr", "20",
                                       "--cfo", str(FF_CFO)])
    if app_count(text, "valid packets") != FF_FRAMES:
        raise AssertionError(f"flexframe_rx --snr 20 --cfo {FF_CFO}: "
                             f"{text[-400:]}")
    impaired = resample_stream(apply_channel(
        file_stream, flags, signal_power=occupied_power(file_stream)),
        FF_RX_RATE, dev)
    cfo_rx = FF_CFO / FF_RX_RATE
    cfo_err = check_ff_frames(f"flexframe sync, --snr 20 --cfo {FF_CFO}",
                              ff_decode(sync, impaired, dev), sent, cfo_rx,
                              exact_count=False)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    print(f"flexframe: flexframe_tx wrote {FF_FRAMES} frames of "
          f"{FF_PAYLOAD} bytes ({len(file_stream)} samples, "
          f"{t_tx:.1f} s); flexframe_rx and the sync decode "
          f"{FF_FRAMES}/{FF_FRAMES}, headers and payloads byte for byte in "
          f"stream order ({len(rx_stream)} samples at k=2); with --snr 20 "
          f"--cfo {FF_CFO} {FF_FRAMES}/{FF_FRAMES} by the app and the sync, "
          f"offsets within {cfo_err:.2e} of {cfo_rx} (limit {FF_CFO_ATOL}); "
          f"kernel launches {launches}", flush=True)

    check_ff_front_end(sync, rx_stream, file_stream, dev)

    # decode-verified timings (CUDA events): whole-stream decodes, each
    # checked; one 8-block dispatch (``FF_DISPATCH``) from the state the
    # sync carries into it, each giving the same count; the RX resampler
    # over the file
    runs = []
    for _ in range(FF_TIMED_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        frames = ff_decode(sync, rx_stream, dev)
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end))
        check_ff_frames("flexframe, timed run", frames, sent)
    st, blocks = ff_dispatch_input(sync, rx_stream, dev)
    counts = []

    def dispatch():
        _, res = fs.flex_sync_blocks_batched(sync, st, blocks)
        counts.append(int(_to_host(res).payload_valid.sum()))
    disp_ms = cuda_ms(dispatch, 5)
    if len(set(counts)) != 1 or counts[0] <= 0:
        raise AssertionError(f"flexframe timed dispatches decoded {counts}")
    ms = resamp.msresamp_create(FF_RX_RATE)
    x_file = torch.as_tensor(file_stream[:len(file_stream) - len(
        file_stream) % 2 ** ms.num_halfband], device=dev)
    ms_rx = cuda_ms(lambda: resamp.msresamp_block(
        ms, resamp.msresamp_state(ms, dev), x_file), 3)
    sps = len(rx_stream) / (min(runs) * 1e-3)
    print(f"flexframe timing: {sps / 1e6:.4f} MS/s decode-verified (best of "
          f"{FF_TIMED_RUNS} whole-stream runs, {min(runs):.1f} ms for "
          f"{len(rx_stream)} samples at k=2, {FF_FRAMES}/{FF_FRAMES} each); "
          f"{disp_ms:.3f} ms per {FF_BATCH}-block dispatch (blocks "
          f"{FF_DISPATCH * FF_BATCH}.., {counts[0]} frames); RX msresamp at "
          f"{FF_RX_RATE} over the {len(file_stream)}-sample file "
          f"{ms_rx:.3f} ms on {label}", flush=True)
    return launches


def run_packet(dev, tmpdir):
    """The packet (frame64) path at the app defaults (phase 14).  Returns
    the kernel launch counts of its runs."""
    from liquid_usrp_tpu_torch.apps import packet_rx, packet_tx
    from liquid_usrp_tpu_torch.apps.common import resample_stream
    from liquid_usrp_tpu_torch.framing import flexframe as ff
    from liquid_usrp_tpu_torch.io.streams import read_iq
    from liquid_usrp_tpu_torch.ops import kernels
    path = str(Path(tmpdir) / "packet.iq")
    sent = tx_draws(FF_FRAMES, FF_SEED, ff.FRAME64_HEADER_USER,
                    ff.FRAME64_PAYLOAD)
    kernels.reset_launch_counts()
    run_app(packet_tx.main, ["-o", path, "-N", str(FF_FRAMES)])
    text = run_app(packet_rx.main, ["-i", path, "-q"])
    foreign = app_count(text, "non-frame64 bursts")
    if app_count(text, "valid packets") != FF_FRAMES or foreign:
        raise AssertionError(f"packet_rx: {text[-400:]}")
    stream = read_iq(path)
    check_ff_frames("frame64 sync", ff_decode(
        ff_sync(frame64=True), resample_stream(stream, FF_RX_RATE, dev),
        dev), sent)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    print(f"packet: packet_tx wrote {FF_FRAMES} frame64 bursts "
          f"({len(stream)} samples); packet_rx {FF_FRAMES}/{FF_FRAMES} "
          f"valid, {foreign} foreign bursts; the sync returns the "
          f"{FF_FRAMES} headers and payloads byte for byte; kernel launches "
          f"{launches}", flush=True)
    return launches


def gm_sync(conv=False):
    """The gmskframe_rx synchronizer (with ``--conv``: ``conv``)."""
    from liquid_usrp_tpu_torch.framing import gmskframe as gf
    return gf.make_gmsk_sync(gf.make_gmsk_params(), block_size=GM_BLOCK,
                             max_payload=GM_MAX_PAYLOAD,
                             max_frames=GM_MAX_FRAMES, enable_conv=conv)


def gm_transmit(path, *extra):
    """``gmskframe_tx.main`` at its defaults (``GM_FRAMES`` frames of
    ``GM_PAYLOAD`` bytes, seed ``GM_SEED``) and ``extra`` flags into
    ``path``: the stream (``gmskframe_rx`` decodes it at the file rate)."""
    from liquid_usrp_tpu_torch.apps import gmskframe_tx
    from liquid_usrp_tpu_torch.io.streams import read_iq
    run_app(gmskframe_tx.main, ["-o", path, "-N", str(GM_FRAMES), "-P",
                                str(GM_PAYLOAD), "-s", str(GM_SEED),
                                *extra])
    return read_iq(path)


def gm_front_end_vs_cpu(sync, stream, dev):
    """The GMSK front end on the card against the port on the CPU, over
    every 8-block dispatch of ``stream`` (phase 17)."""
    from liquid_usrp_tpu_torch.framing import gmskframe as gf
    from liquid_usrp_tpu_torch.ops.corr import comb_moving_sum
    bs, k = sync.block_size, sync.params.k
    n_t = gf.PRE_BITS + gf.SYNC_BITS
    seg, n_seg = gf.DETECT_SEG, n_t // gf.DETECT_SEG
    shift = seg * k
    n_blocks = -(-len(stream) // bs) + -(-sync.overlap // bs) + 1
    z_err = m_loud = m_all = 0.0
    flips = n_det = n_dispatches = 0
    for first in range(0, n_blocks - GM_BATCH + 1, GM_BATCH):
        ext = ff_windows(sync, stream, first, GM_BATCH)
        got = [v.cpu() for v in gf._front_end(sync, ext.to(dev))]
        z, metric, det, locs = gf._front_end(sync, ext)
        # the same detected offsets in each window; their slot order may
        # differ (the clean stream's frames peak within 4e-5 of each other,
        # which the rounding of the energy's cumsum can reorder), and the
        # offsets of undetected slots are unspecified (top-k ties)
        same = torch.equal(got[2].sum(-1), det.sum(-1)) and all(
            torch.equal(got[3][r][got[2][r]].sort().values,
                        locs[r][det[r]].sort().values)
            for r in range(det.shape[0]))
        if not same:
            raise AssertionError(f"GMSK front end, blocks {first}..: "
                                 f"candidates differ from the CPU's")
        z_err = max(z_err, float((got[0] - z).abs().max() /
                                 z.abs().max().clamp(min=1e-30)))
        # the template span's energy at symbol stride, against its silence
        # floor (1e-3 of the window's mean |z|^2 over the span)
        n = metric.shape[-1]
        pz = z.abs() ** 2
        e = comb_moving_sum(pz, seg, k, n + (n_seg - 1) * shift)
        energy = sum(e[..., s * shift:s * shift + n] for s in range(n_seg))
        floor = 1e-3 * n_t * pz.mean(-1, keepdim=True)
        loud = energy >= FF_METRIC_LOUD * floor
        diff = (got[1] - metric).abs()
        m_all = max(m_all, float(diff.max()))
        if bool(loud.any()):
            m_loud = max(m_loud, float(diff[loud].max()))
        flips += int(((got[1] == 0) != (metric == 0)).sum())
        n_det += int(det.sum())
        n_dispatches += 1
    print(f"GMSK front end on the card vs the CPU over {n_dispatches} "
          f"dispatches ({n_det} detections, the same offsets): "
          f"z max diff {z_err:.3e} of max |z| (limit 1e-5); metric max abs "
          f"diff {m_loud:.3e} where the span energy >= "
          f"{FF_METRIC_LOUD:g}x its floor (limit 1e-4), {m_all:.3e} "
          f"anywhere with {flips} gate flips (not held)", flush=True)
    if not (z_err <= 1e-5 and m_loud <= 1e-4 and n_det > 0):
        raise AssertionError("GMSK front end: the card disagrees with the "
                             "CPU")


def gm_dispatch_input(sync, stream, dev):
    """The GMSK sync state carried into dispatch ``GM_DISPATCH`` of
    ``stream`` and that dispatch's ``[GM_BATCH, block]`` blocks, on
    ``dev``."""
    from liquid_usrp_tpu_torch.framing import gmskframe as gf
    first = GM_DISPATCH * GM_BATCH
    exts = ff_windows(sync, stream, first, GM_BATCH)
    st = gf.GmskSyncState(
        tail=exts[0, :sync.overlap].to(dev),
        base=torch.tensor(first * sync.block_size - sync.overlap,
                          dtype=torch.int32, device=dev))
    return st, exts[:, sync.overlap:].contiguous().to(dev)


def gm_timing(sync, stream, sent, dev, what, label):
    """Decode-verified samples/s over the whole stream (best of
    ``GM_TIMED_RUNS``, each checked) and ms per 8-block dispatch (blocks
    ``GM_DISPATCH * GM_BATCH``.., from the state the sync carries into
    them; each giving the same count).  Returns (MS/s, dispatch ms)."""
    from liquid_usrp_tpu_torch.framing import gmskframe as gf
    from liquid_usrp_tpu_torch.models.ofdmtxrx import _to_host
    runs = []
    for _ in range(GM_TIMED_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        frames = ff_decode(sync, stream, dev, gmsk=True)
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end))
        check_ff_frames(f"{what}, timed run", frames, sent,
                        exact_count=False)
    st, blocks = gm_dispatch_input(sync, stream, dev)
    counts = []

    def dispatch():
        _, res = gf.gmsk_sync_blocks_batched(sync, st, blocks)
        counts.append(int(_to_host(res).payload_valid.sum()))
    disp_ms = cuda_ms(dispatch, 3)
    if len(set(counts)) != 1 or counts[0] <= 0:
        raise AssertionError(f"{what} timed dispatches decoded {counts}")
    sps = len(stream) / (min(runs) * 1e-3)
    print(f"{what} timing: {sps / 1e6:.4f} MS/s decode-verified (best of "
          f"{GM_TIMED_RUNS} whole-stream runs, {min(runs):.1f} ms for "
          f"{len(stream)} samples, {len(sent)}/{len(sent)} each); "
          f"{disp_ms:.3f} ms per {GM_BATCH}-block dispatch (blocks "
          f"{GM_DISPATCH * GM_BATCH}.., {counts[0]} frames) on {label}",
          flush=True)
    return sps, disp_ms


def run_gmsk(dev, tmpdir, label):
    """The GMSK path at the app defaults (phases 16, 17 and 19 without
    ``--conv``).  Returns the kernel launch counts of its runs."""
    from liquid_usrp_tpu_torch.apps import gmskframe_rx
    from liquid_usrp_tpu_torch.apps.common import (apply_channel,
                                                   occupied_power)
    from liquid_usrp_tpu_torch.ops import kernels
    path = str(Path(tmpdir) / "gmsk.iq")
    sent = tx_draws(GM_FRAMES, GM_SEED, 8, GM_PAYLOAD)
    sync = gm_sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stream = gm_transmit(path)
    t_tx = time.perf_counter() - t0
    text = run_app(gmskframe_rx.main, ["-i", path, "-q"])
    if app_count(text, "valid packets") != GM_FRAMES:
        raise AssertionError(f"gmskframe_rx: {text[-400:]}")
    # the reference's detector also fires on 2 spots of this clean stream
    # (header-invalid rows, the same in JAX): held are the 40 frames sent
    frames = ff_decode(sync, stream, dev, gmsk=True)
    check_ff_frames("GMSK sync", frames, sent, exact_count=False)
    n_det = len(frames)
    flags = {"snr": "20", "cfo": str(GM_CFO)}
    text = run_app(gmskframe_rx.main, ["-i", path, "-q", "--snr", "20",
                                       "--cfo", str(GM_CFO)])
    if app_count(text, "valid packets") != GM_FRAMES:
        raise AssertionError(f"gmskframe_rx --snr 20 --cfo {GM_CFO}: "
                             f"{text[-400:]}")
    impaired = apply_channel(stream, flags,
                             signal_power=occupied_power(stream))
    cfo_err = check_ff_frames(
        f"GMSK sync, --snr 20 --cfo {GM_CFO}",
        ff_decode(sync, impaired, dev, gmsk=True), sent, GM_CFO,
        exact_count=False, atol=GM_CFO_ATOL)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    print(f"GMSK: gmskframe_tx wrote {GM_FRAMES} frames of {GM_PAYLOAD} "
          f"bytes ({len(stream)} samples, {t_tx:.1f} s); gmskframe_rx and "
          f"the sync decode {GM_FRAMES}/{GM_FRAMES}, headers and payloads "
          f"byte for byte in stream order ({n_det} detections); with --snr "
          f"20 --cfo {GM_CFO} "
          f"{GM_FRAMES}/{GM_FRAMES} by the app and the sync, offsets within "
          f"{cfo_err:.2e} of {GM_CFO} (limit {GM_CFO_ATOL}); kernel "
          f"launches {launches}", flush=True)
    gm_front_end_vs_cpu(sync, stream, dev)
    gm_timing(sync, stream, sent, dev, "GMSK", label)
    return launches


def conv_vs_cpu(dev):
    """``conv_decode`` (v27, v29, v27p34) and ``rs_decode`` on the card
    against the port on the CPU, on the same noisy words (phase 18)."""
    from liquid_usrp_tpu_torch.ops import fec
    rng = np.random.default_rng(0xC0DE)
    cpu = torch.device("cpu")
    lines = []
    for s in (fec.FEC_CONV_V27, fec.FEC_CONV_V29, fec.FEC_CONV_V27P34):
        data = rng.integers(0, 256, (4, 200), dtype=np.uint8)
        enc = fec.fec_encode(s, torch.as_tensor(data)).numpy()
        bits = np.unpackbits(enc, axis=-1)
        noisy = torch.as_tensor(np.packbits(
            bits ^ (rng.random(bits.shape) < 0.03), axis=-1))
        got = fec.fec_decode(s, noisy.to(dev), 200).cpu()
        want = fec.fec_decode(s, noisy.to(cpu), 200)
        if not torch.equal(got, want):
            raise AssertionError(f"{fec.fec_name(s)}: the card's Viterbi "
                                 f"differs from the CPU's")
        n_ok = int((want.numpy() == data).all(-1).sum())
        lines.append(f"{fec.fec_name(s)} {n_ok}/4 rows corrected")
    data = rng.integers(0, 256, (4, 300), dtype=np.uint8)
    enc = fec.fec_encode(fec.FEC_RS8, torch.as_tensor(data)).numpy()
    for row, n_err in enumerate((0, 8, 16, 24)):
        for p in rng.choice(255, size=n_err, replace=False):
            enc[row, p] ^= int(rng.integers(1, 256))
    bad = torch.as_tensor(enc)
    got = fec.fec_decode(fec.FEC_RS8, bad.to(dev), 300).cpu()
    want = fec.fec_decode(fec.FEC_RS8, bad, 300)
    if not torch.equal(got, want):
        raise AssertionError("rs8: the card's decode differs from the CPU's")
    ok = (want.numpy() == data).all(-1)
    if not ok[:3].all():
        raise AssertionError(f"rs8 failed to correct 16 errors: {ok}")
    print(f"conv/RS on the card vs the CPU: bit for bit ({'; '.join(lines)}"
          f"; rs8 rows with 0/8/16/24 byte errors corrected {ok.tolist()})",
          flush=True)


def viterbi_ms(sync, stream, dev, label):
    """The Viterbi's ms per dispatch, inside the timed ``--conv`` dispatch
    (blocks ``GM_DISPATCH * GM_BATCH``..): the host-clock time of its
    second FEC stage (``_fec_batch`` in ``fec0``, v27 over the dispatch's
    detected v27 rows, header-valid or not; the first stage, ``fec1``, is
    ``none``), with a sync before and after it, mean over
    ``GM_TIMED_RUNS`` dispatches after a warm-up one.  The stage is timed
    by wrapping ``payload._fec_batch`` for these dispatches only."""
    from liquid_usrp_tpu_torch.framing import gmskframe as gf
    from liquid_usrp_tpu_torch.framing import payload as payload_codec
    from liquid_usrp_tpu_torch.ops import fec
    st, blocks = gm_dispatch_input(sync, stream, dev)
    v27 = list(sync.fecs).index(fec.FEC_CONV_V27)
    fec_batch = payload_codec._fec_batch
    stages = []

    def timed(scheme_ids, bufs, out_bytes, fecs, rows=None, **soft):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fec_batch(scheme_ids, bufs, out_bytes, fecs, rows=rows,
                        **soft)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        stages.append((ms, int(((scheme_ids == v27) & rows).sum()),
                       out_bytes))
        return out

    payload_codec._fec_batch = timed
    try:
        for _ in range(GM_TIMED_RUNS + 1):
            gf.gmsk_sync_blocks_batched(sync, st, blocks)
    finally:
        payload_codec._fec_batch = fec_batch
    # two stages a dispatch, fec1 then fec0; the first dispatch warms up
    f0 = stages[3::2]
    rows = {r for _, r, _ in f0}
    if len(f0) != GM_TIMED_RUNS or len(rows) != 1 or min(rows) <= 0:
        raise AssertionError(f"--conv dispatch FEC stages: {stages}")
    ms = sum(t for t, _, _ in f0) / len(f0)
    n_rows = rows.pop()
    steps = payload_codec._fit_bytes(fec.FEC_CONV_V27, f0[0][2],
                                     sync.enc_max) * 8 + 6
    print(f"Viterbi in the timed --conv dispatch (blocks "
          f"{GM_DISPATCH * GM_BATCH}.., fec0 stage: v27 over its {n_rows} "
          f"detected rows x {steps} trellis steps): "
          f"{' / '.join(f'{t:.2f}' for t, _, _ in f0)} ms, mean {ms:.2f} ms "
          f"per dispatch, {ms * 1e3 / steps:.2f} us per step on {label}",
          flush=True)
    return ms


def conv_loopback(name, tx, rx, tx_argv, rx_argv, tmpdir):
    """``tx`` writes ``CV_FRAMES`` frames with ``tx_argv`` and ``rx --conv
    rx_argv`` must detect and decode every one."""
    p = str(Path(tmpdir) / f"{name.split()[0]}_conv.iq")
    run_app(tx.main, ["-o", p, "-N", str(CV_FRAMES), *tx_argv])
    t0 = time.perf_counter()
    text = run_app(rx.main, ["-i", p, "-q", "--conv", *rx_argv])
    if app_count(text, "valid packets") != CV_FRAMES or \
            app_count(text, "frames detected") != CV_FRAMES:
        raise AssertionError(f"{name} --conv: {text[-400:]}")
    print(f"{name} --conv: {CV_FRAMES}/{CV_FRAMES} valid "
          f"({' '.join(tx_argv)}; rx {' '.join(rx_argv)}; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)


def run_conv(dev, tmpdir, label):
    """The conv/RS layer off the OFDM path (phases 18 and 19 with
    ``--conv``).  Returns the kernel launch counts of its runs."""
    from liquid_usrp_tpu_torch.apps import (flexframe_rx, flexframe_tx,
                                            gmskframe_rx)
    from liquid_usrp_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    conv_vs_cpu(dev)
    sync = gm_sync(conv=True)
    path = str(Path(tmpdir) / "gmsk_v27.iq")
    sent = tx_draws(GM_FRAMES, GM_SEED, 8, GM_PAYLOAD)
    stream = gm_transmit(path, "-c", "v27", "-k", "none")
    text = run_app(gmskframe_rx.main, ["-i", path, "-q", "--conv"])
    if app_count(text, "valid packets") != GM_FRAMES:
        raise AssertionError(f"gmskframe_rx --conv: {text[-400:]}")
    check_ff_frames("GMSK sync --conv", ff_decode(sync, stream, dev,
                                                  gmsk=True), sent,
                    exact_count=False)
    print(f"GMSK --conv: gmskframe_tx -c v27 -k none wrote {GM_FRAMES} "
          f"frames ({len(stream)} samples); gmskframe_rx --conv and the "
          f"sync decode {GM_FRAMES}/{GM_FRAMES} byte for byte", flush=True)
    gm_timing(sync, stream, sent, dev, "GMSK --conv", label)
    viterbi_ms(sync, stream, dev, label)
    conv_loopback("flexframe v27", flexframe_tx, flexframe_rx,
                  ["-P", "100", "-c", "v27", "-k", "none"], ["-p", "256"],
                  tmpdir)
    torch.cuda.synchronize()
    return dict(kernels.launches)


def run_ofdm_conv(tmpdir):
    """The OFDM app's ``--conv`` loopback with RS8 payloads (phase 18).
    Its detector is the OFDM path's (B1 at the app's default level), so
    its launch counts are returned apart."""
    from liquid_usrp_tpu_torch.apps import ofdmflexframe_rx, ofdmflexframe_tx
    from liquid_usrp_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    conv_loopback("ofdmflexframe rs8", ofdmflexframe_tx, ofdmflexframe_rx,
                  ["-P", "442", "-k", "rs8"], ["-p", "512"], tmpdir)
    torch.cuda.synchronize()
    if kernels.launches["detect_metric_xcorr_onepass"] <= 0:
        raise AssertionError("ofdmflexframe_rx --conv did not launch B1")
    return dict(kernels.launches)


def run_ofdm_v27(tmpdir):
    """The ``ofdm1_conv.v27`` cell's receiver (``OfdmTxRx`` at its defaults
    with ``--conv``: M=48, 8-block dispatches, the 2,048-byte budget at
    expansion 3, so that a v27 row decodes a trellis of ``VIT_BYTES``)
    over ``V27_FRAMES`` frames of ``ofdmflexframe_tx -c v27 -k none``, fed
    one dispatch a ``run_rx`` call, with the launch counts reset just
    before and the counters on (phase 18).  Every frame must come back
    valid; the Viterbi kernel must launch once in each dispatch that
    decodes a frame, over ``VIT_BYTES * 8 + 6`` steps each, the
    nearest-point kernel three times in each (the decision-directed pass,
    the demap, the payload EVM), and no B1-B5 kernel but B1 may launch.
    Returns the run's launch counts."""
    from liquid_usrp_tpu_torch.apps import ofdmflexframe_tx
    from liquid_usrp_tpu_torch.io.streams import read_iq
    from liquid_usrp_tpu_torch.models.ofdmtxrx import OfdmTxRx
    from liquid_usrp_tpu_torch.ops import kernels
    from liquid_usrp_tpu_torch.utils import profiling
    path = str(Path(tmpdir) / "ofdm_v27.iq")
    run_app(ofdmflexframe_tx.main, ["-o", path, "-N", str(V27_FRAMES),
                                    "-c", "v27", "-k", "none"])
    stream = read_iq(path)
    txrx = OfdmTxRx(enable_conv=True)
    txrx.start_rx()
    bs, nb = txrx._sync.block_size, txrx._batch_blocks
    # zeros after the stream until the carried overlap has drained (as
    # run_rx's flush pads), to whole dispatches
    blocks = -(-len(stream) // bs) + 1 + txrx._sync.overlap // bs + 1
    chunks = np.zeros((-(-blocks // nb), nb * bs), np.complex64)
    chunks.reshape(-1)[:len(stream)] = stream
    log_dir = str(Path(tmpdir) / "ofdm_v27_trace")
    kernels.reset_launch_counts()
    with profiling.trace(log_dir):
        per = [txrx.run_rx(chunk) for chunk in chunks]
        torch.cuda.synchronize()
    launches = dict(kernels.launches)
    with open(Path(log_dir) / "counters.json") as f:
        counters = json.load(f)
    rows = [r for got in per for r in got]
    pids = sorted((int(r["header"][0]) << 8) | int(r["header"][1])
                  for r in rows)
    if pids != list(range(V27_FRAMES)) or not all(
            r["header_valid"] and r["payload_valid"] and
            r["payload_len"] == 1200 for r in rows):
        raise AssertionError(f"ofdm1_conv.v27 receiver: packet ids {pids}, "
                             f"valid {[r['payload_valid'] for r in rows]}")
    decoding = sum(1 for got in per if got)
    want = dict(viterbi=decoding, viterbi_launches=decoding,
                viterbi_steps=decoding * (VIT_BYTES * 8 + 6),
                nearest=3 * decoding, nearest_launches=3 * decoding)
    seen = dict(viterbi=launches["viterbi"],
                viterbi_launches=counters.get("viterbi_launches", 0),
                viterbi_steps=counters.get("viterbi_steps", 0),
                nearest=launches["nearest"],
                nearest_launches=counters.get("nearest_launches", 0))
    if seen != want:
        raise AssertionError(f"ofdm1_conv.v27 receiver: {seen} over "
                             f"{len(per)} dispatches, {want} expected")
    other = {k: launches[k] for k in KERNELS
             if k != "detect_metric_xcorr_onepass" and launches[k]}
    if other or launches["detect_metric_xcorr_onepass"] <= 0:
        raise AssertionError(f"ofdm1_conv.v27 receiver launched {launches}")
    print(f"ofdm1_conv.v27 receiver: {V27_FRAMES}/{V27_FRAMES} v27 frames "
          f"valid over {len(per)} dispatches, {decoding} decoding a frame; "
          f"the Viterbi kernel launched {launches['viterbi']} times "
          f"({seen['viterbi_steps']} steps, the 2,052-byte budget each), "
          f"the nearest-point kernel {launches['nearest']} times; "
          f"B1-B5: {({k: launches[k] for k in KERNELS})}", flush=True)
    return launches


def llr_close(what, got, want, limit=SOFT_LLR_RTOL):
    """Raise unless LLRs ``got`` lie within ``limit`` of max |want| of
    ``want``, with equal signs wherever |want| exceeds that.  Returns the
    largest difference over max |want|."""
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max()) / scale
    sure = want.abs() > limit * scale
    if not (err <= limit and torch.equal(torch.sign(got[sure]),
                                         torch.sign(want[sure]))):
        raise AssertionError(f"{what}: LLRs off by {err:.3e} of max |llr| "
                             f"(limit {limit:g}) or signs differ")
    return err


def capture_soft_decode(batched, sync, st, blocks):
    """One soft dispatch ``batched(sync, st, blocks)``; returns the
    arguments it passed to ``payload.decode_payload_batch_soft`` (the
    dispatch's payload points and header fields), captured by wrapping the
    function for this dispatch only."""
    from liquid_usrp_tpu_torch.framing import payload as pc
    fn = pc.decode_payload_batch_soft
    got = []

    def spy(*args, **kw):
        got.append((args, kw))
        return fn(*args, **kw)

    pc.decode_payload_batch_soft = spy
    try:
        batched(sync, st, blocks)
    finally:
        pc.decode_payload_batch_soft = fn
    if len(got) != 1:
        raise AssertionError(f"soft dispatch decoded {len(got)} times")
    return got[0]


def soft_payload_vs_cpu(what, call):
    """``decode_payload_batch_soft`` on the card against the port on the
    CPU for one captured dispatch ``call``: ``payload_valid`` equal, and
    the payloads equal on the header-valid rows.  Returns (valid rows,
    header-valid rows)."""
    from liquid_usrp_tpu_torch.framing import payload as pc
    args, kw = call
    got = [v.cpu() for v in pc.decode_payload_batch_soft(*args, **kw)]
    cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
    want = pc.decode_payload_batch_soft(*cpu, **{
        k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()})
    hv = cpu[9]
    if not (torch.equal(got[1], want[1]) and
            torch.equal(got[0][hv], want[0][hv])):
        raise AssertionError(f"{what}: the card's soft payload decode "
                             f"differs from the CPU's")
    return int(want[1].sum()), int(hv.sum())


def golay_vs_cpu(dev, label):
    """``golay_decode_soft`` on ``SOFT_GOLAY_BLOCKS`` noisy header blocks:
    the card equals the CPU except on near-ties (the two best scores
    within ``NEAR_TIE`` of the best), which are counted; the same result
    again with TF32 on and ``set_float32_matmul_precision("medium")``,
    restored afterwards; and the ML stage's ms on one dispatch's header
    blocks (``R`` candidates x 11 blocks)."""
    from liquid_usrp_tpu_torch.ops import fec
    rng = np.random.default_rng(0x601A)
    c = fec._block_code(fec.FEC_GOLAY2412)
    msg = rng.integers(0, 2, (SOFT_GOLAY_BLOCKS, 12)).astype(np.uint8)
    cw = 2.0 * ((msg @ c.G) % 2) - 1.0
    L = torch.as_tensor((cw + 0.9 * rng.standard_normal(cw.shape))
                        .astype(np.float32))
    want = fec.golay_decode_soft(L)
    got = fec.golay_decode_soft(L.to(dev)).cpu()
    top2 = torch.topk(fec._golay_scores(L), 2).values
    tie = (top2[:, 0] - top2[:, 1]) <= NEAR_TIE * top2[:, 0].abs().clamp(
        min=1.0)
    differ = (got != want).any(-1)
    if (differ & ~tie).any():
        raise AssertionError(f"Golay ML: {int((differ & ~tie).sum())} "
                             f"blocks differ from the CPU off a near-tie")
    prev = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.set_float32_matmul_precision("medium")
        torch.backends.cuda.matmul.allow_tf32 = True
        again = fec.golay_decode_soft(L.to(dev)).cpu()
    finally:
        torch.set_float32_matmul_precision(prev)
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if not torch.equal(again, got):
        raise AssertionError("Golay ML: the result moved under matmul "
                             "precision 'medium' with TF32 on")
    hdr = L[:FF_BATCH * FF_MAX_FRAMES * 11].reshape(-1, 11, 24).to(dev)
    ms = cuda_ms(lambda: fec.golay_decode_soft(hdr), 20)
    errs = int((want.numpy() != msg).any(-1).sum())
    rows = torch.nonzero(differ).flatten().tolist()
    print(f"Golay ML on the card vs the CPU, {SOFT_GOLAY_BLOCKS} noisy "
          f"blocks ({errs} word errors): equal except {len(rows)} blocks "
          f"{rows[:20]}, all near-ties ({int(tie.sum())} near-ties at "
          f"{torch.nonzero(tie).flatten().tolist()[:20]}, best-two gap "
          f"<= {NEAR_TIE:g} of the best); unchanged under "
          f"set_float32_matmul_precision('medium') with TF32 on; ML stage "
          f"{ms:.3f} ms for one dispatch's {hdr.shape[0]} x 11 header "
          f"blocks on {label}", flush=True)
    return ms


def soft_ops_vs_cpu(dev, tmpdir, label):
    """The soft ops on the card against the port on the CPU (phase 20):
    ``generic_demod_soft`` on the payload points of a real flexframe soft
    dispatch (blocks ``FF_DISPATCH * FF_BATCH``.., 1024-byte QPSK frames)
    at tables of 64 (QPSK) and 256 (qam256) entries, with the demapper's
    stage ms and peak memory at that dispatch; ``decode_payload_batch_soft``
    on that dispatch; and the Golay ML decoder.  Returns the kernel launch
    counts of its runs."""
    from liquid_usrp_tpu_torch.framing import flexframe_sync as fs
    from liquid_usrp_tpu_torch.framing import payload as pc
    from liquid_usrp_tpu_torch.ops import kernels, modem
    kernels.reset_launch_counts()
    path = str(Path(tmpdir) / "flexframe_soft.iq")
    _, rx_stream = ff_transmit(path, dev)
    sync = ff_sync()._replace(soft=True)
    st, blocks = ff_dispatch_input(sync, rx_stream, dev)
    call = capture_soft_decode(fs.flex_sync_blocks_batched, sync, st,
                               blocks)
    points = call[0][3]
    R, n = points.shape
    max_bits = sync.enc_max * 8
    lines = []
    for n_tab, scheme, rows in ((64, modem.MOD_QPSK, R),
                                (256, modem.MOD_QAM256, SOFT_CPU_ROWS)):
        mod = torch.full((R,), scheme, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        got = pc.generic_demod_soft(points, mod, max_bits, n_tab)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e6
        ms = cuda_ms(lambda: pc.generic_demod_soft(points, mod, max_bits,
                                                   n_tab), 3)
        want = pc.generic_demod_soft(points[:rows].cpu(), mod[:rows].cpu(),
                                     max_bits, n_tab)
        err = llr_close(f"generic_demod_soft, table {n_tab}",
                        got[:rows].cpu(), want)
        lines.append(f"table {n_tab} ({modem.mod_name(scheme)}, {rows} rows "
                     f"vs the CPU): max diff {err:.2e} of max |llr|, "
                     f"{ms:.3f} ms, peak {peak:.1f} MB above its inputs")
        if n_tab == 64:
            demap = (ms, peak)
    n_ok, n_hv = soft_payload_vs_cpu("flexframe soft dispatch", call)
    torch.cuda.synchronize()
    print(f"soft demapper on the card vs the CPU at the flexframe dispatch "
          f"({R} candidates x {n} points, {max_bits} LLRs each; limit "
          f"{SOFT_LLR_RTOL:g}): {'; '.join(lines)}; "
          f"decode_payload_batch_soft equal to the CPU ({n_ok} valid of "
          f"{n_hv} header-valid rows) on {label}", flush=True)
    golay_vs_cpu(dev, label)
    return dict(kernels.launches), demap


def soft_loopback(name, tx, rx, tx_argv, rx_argv, tmpdir):
    """``tx`` writes ``SOFT_FRAMES`` v27 frames with ``tx_argv``; ``rx
    --conv --soft rx_argv`` must decode every one.  Returns the file."""
    p = str(Path(tmpdir) / f"{name}_soft.iq")
    run_app(tx.main, ["-o", p, "-N", str(SOFT_FRAMES), "-s", str(SOFT_SEED),
                      "-c", "v27", "-k", "none", *tx_argv])
    t0 = time.perf_counter()
    text = run_app(rx.main, ["-i", p, "-q", "--conv", "--soft", *rx_argv])
    if app_count(text, "valid packets") != SOFT_FRAMES:
        raise AssertionError(f"{name} --conv --soft: {text[-400:]}")
    print(f"{name} --conv --soft: {SOFT_FRAMES}/{SOFT_FRAMES} valid "
          f"({' '.join(tx_argv)}; rx {' '.join(rx_argv)}; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    return p


def ofdm_draws(n, seed, payload):
    """{packet id: payload} as ``ofdmflexframe_tx`` draws them."""
    rng = np.random.default_rng(seed)
    sent = {}
    for pid in range(n):
        rng.integers(0, 256, 6, dtype=np.uint8)      # header bytes 2..7
        sent[pid] = rng.integers(0, 256, payload, dtype=np.uint8)
    return sent


def run_soft_ofdm(dev, tmpdir):
    """The OFDM app's ``--conv --soft`` loopback (phase 21): the CLI and
    ``OfdmTxRx(enable_conv=True, soft=True)`` payload-exact.  Its detector
    is the OFDM path's (B1), so its launch counts are returned apart."""
    from liquid_usrp_tpu_torch.apps import ofdmflexframe_rx, ofdmflexframe_tx
    from liquid_usrp_tpu_torch.io.streams import read_iq
    from liquid_usrp_tpu_torch.models.ofdmtxrx import OfdmTxRx
    from liquid_usrp_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    p = soft_loopback("ofdmflexframe", ofdmflexframe_tx, ofdmflexframe_rx,
                      ["-P", "100"], ["-p", "512"], tmpdir)
    rx = OfdmTxRx(M=M, cp_len=CP, taper_len=TAPER, block_size=SC_BLOCK,
                  batch_blocks=SC_BATCH, max_payload=512, enable_conv=True,
                  soft=True, device=dev)
    rx.start_rx()
    check_sc_frames("OfdmTxRx --conv --soft", sc_decode(rx, read_iq(p)),
                    ofdm_draws(SOFT_FRAMES, SOFT_SEED, 100))
    torch.cuda.synchronize()
    if kernels.launches["detect_metric_xcorr_onepass"] <= 0:
        raise AssertionError("ofdmflexframe_rx --soft did not launch B1")
    print(f"OfdmTxRx --conv --soft: {SOFT_FRAMES}/{SOFT_FRAMES} payload "
          f"exact", flush=True)
    return dict(kernels.launches)


def frames_key(frames):
    return [(f["t"], f["header"].tobytes(), f["payload"].tobytes())
            for f in frames if f["valid"]]


def run_soft(dev, tmpdir, label):
    """The soft loopbacks of the flexframe and GMSK apps, the low-SNR
    GMSK file on the card against the CPU (phase 21) and the soft GMSK
    dispatch beside the hard one (phase 23).  Returns the kernel launch
    counts of its runs and the two dispatch times."""
    from liquid_usrp_tpu_torch.apps import (flexframe_rx, flexframe_tx,
                                            gmskframe_rx, gmskframe_tx)
    from liquid_usrp_tpu_torch.apps.common import (apply_channel,
                                                   occupied_power,
                                                   resample_stream)
    from liquid_usrp_tpu_torch.framing import flexframe as ff
    from liquid_usrp_tpu_torch.framing import flexframe_sync as fs
    from liquid_usrp_tpu_torch.framing import gmskframe as gf
    from liquid_usrp_tpu_torch.io.streams import read_iq
    from liquid_usrp_tpu_torch.models.ofdmtxrx import _to_host
    from liquid_usrp_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    p = soft_loopback("flexframe", flexframe_tx, flexframe_rx,
                      ["-P", "100"], ["-p", "256"], tmpdir)
    fsync = fs.make_flex_sync(ff.make_flex_params(), block_size=FF_BLOCK,
                              max_payload=256, max_frames=FF_MAX_FRAMES,
                              enable_conv=True, soft=True)
    check_ff_frames("flexframe sync --conv --soft", ff_decode(
        fsync, resample_stream(read_iq(p), FF_RX_RATE, dev), dev),
        tx_draws(SOFT_FRAMES, SOFT_SEED, ff.FLEX_HEADER_USER, 100))
    p = soft_loopback("gmskframe", gmskframe_tx, gmskframe_rx,
                      ["-P", str(GM_PAYLOAD)], [], tmpdir)
    soft = gm_sync(conv=True)._replace(soft=True)
    hard = gm_sync(conv=True)
    stream = read_iq(p)
    sent = tx_draws(SOFT_FRAMES, SOFT_SEED, 8, GM_PAYLOAD)
    check_ff_frames("GMSK sync --conv --soft", ff_decode(
        soft, stream, dev, gmsk=True), sent, exact_count=False)
    print(f"flexframe and GMSK syncs --conv --soft: {SOFT_FRAMES}/"
          f"{SOFT_FRAMES} each, headers and payloads byte for byte",
          flush=True)
    # near the header waterfall: the card's soft decode is the CPU's
    low = apply_channel(stream, {"snr": SOFT_SNR},
                        signal_power=occupied_power(stream))
    t0 = time.perf_counter()
    on_card = ff_decode(soft, low, dev, gmsk=True)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = ff_decode(soft, low, torch.device("cpu"), gmsk=True)
    t_cpu = time.perf_counter() - t0
    n_hard = len(frames_key(ff_decode(hard, low, dev, gmsk=True)))
    card_ok, cpu_ok = frames_key(on_card), frames_key(on_cpu)
    good = {(h.tobytes(), pl.tobytes()) for h, pl in sent}
    if card_ok != cpu_ok or any((h, pl) not in good
                                for _, h, pl in card_ok):
        raise AssertionError(f"GMSK --snr {SOFT_SNR} --conv --soft: the "
                             f"card's {len(card_ok)} valid frames are not "
                             f"the CPU's {len(cpu_ok)}")
    if len(card_ok) < n_hard:
        raise AssertionError(f"GMSK --snr {SOFT_SNR}: soft {len(card_ok)} "
                             f"< hard {n_hard}")
    print(f"GMSK v27 at --snr {SOFT_SNR} ({SOFT_FRAMES} frames): soft "
          f"{len(card_ok)}/{SOFT_FRAMES} valid on the card, the same frames "
          f"and bytes as the CPU's soft decode ({len(on_card)} detections "
          f"on the card, {len(on_cpu)} on the CPU; {t_card:.1f} s vs "
          f"{t_cpu:.1f} s), hard {n_hard}/{SOFT_FRAMES}", flush=True)
    # the soft and the hard --conv dispatch, blocks 8-15 of the 40-frame
    # v27 stream
    stream40 = gm_transmit(str(Path(tmpdir) / "gmsk_v27_soft.iq"), "-c",
                           "v27", "-k", "none")
    syncs = {"hard": hard, "soft": soft}
    st, blocks = gm_dispatch_input(soft, stream40, dev)
    counts = {"hard": [], "soft": []}
    runs = {"hard": [], "soft": []}
    # in turns (hard, soft, soft, hard), each turn after its own warm-up
    for what in ("hard", "soft", "soft", "hard"):
        def dispatch():
            _, res = gf.gmsk_sync_blocks_batched(syncs[what], st, blocks)
            counts[what].append(int(_to_host(res).payload_valid.sum()))
        runs[what].append(cuda_ms(dispatch, GM_TIMED_RUNS))
    for what, n in counts.items():
        if len(set(n)) != 1 or n[0] <= 0:
            raise AssertionError(f"GMSK {what} --conv dispatches decoded {n}")
    times = {w: sum(r) / len(r) for w, r in runs.items()}
    times.update({w + "_frames": n[0] for w, n in counts.items()})
    times.update({w + "_turns": r for w, r in runs.items()})
    call = capture_soft_decode(gf.gmsk_sync_blocks_batched, soft, st,
                               blocks)
    n_ok, n_hv = soft_payload_vs_cpu("GMSK v27 soft dispatch", call)
    torch.cuda.synchronize()
    turns = {w: " / ".join(f"{t:.3f}" for t in times[w + "_turns"])
             for w in ("hard", "soft")}
    print(f"GMSK --conv dispatch (blocks {GM_DISPATCH * GM_BATCH}.., "
          f"decode-verified, in turns hard, soft, soft, hard): hard "
          f"{times['hard']:.3f} ms ({turns['hard']}; {times['hard_frames']} "
          f"frames), --soft {times['soft']:.3f} ms ({turns['soft']}; "
          f"{times['soft_frames']} frames); the soft dispatch's payload "
          f"decode equals the CPU's ({n_ok} valid of {n_hv} header-valid "
          f"rows) on {label}", flush=True)
    return dict(kernels.launches), times


def run_a13(dev, tmpdir, label):
    """The measurement ops and small CLIs on the card (phase 22): AGC,
    spectrogram and ring log against the CPU; ``narrowband_tx`` ->
    ``asgram_rx`` / ``rssi`` on the card against the same apps on the
    CPU.  Returns the kernel launch counts of its runs."""
    import os
    from liquid_usrp_tpu_torch.apps import asgram_rx, narrowband_tx, rssi
    from liquid_usrp_tpu_torch.ops import agc, kernels, spectrum, window
    from liquid_usrp_tpu_torch.utils.device import DEVICE_ENV
    kernels.reset_launch_counts()
    rng = np.random.default_rng(0xA13)
    n = 1 << 16
    x = torch.as_tensor((np.repeat([0.3, 3.0, 0.05, 1.0], n // 4) *
                         (rng.normal(size=n) + 1j * rng.normal(size=n)))
                        .astype(np.complex64))
    outs = [agc.agc_block(agc.agc_init(0.01, device=d), x.to(d))
            for d in (dev, "cpu")]
    agc_err = max(float(((a.cpu() - b).abs() / b.abs().clamp(min=1e-6))
                        .max()) for a, b in zip(outs[0][1:3], outs[1][1:3]))
    sg = spectrum.spectrogram_create(64)
    got = spectrum.spectrogram_block(sg, x.to(dev))
    want = spectrum.spectrogram_block(sg, x)
    psd_err = float((got[0].cpu() - want[0]).abs().max())
    rings = [window.ring_init(1024, device=d) for d in (dev, "cpu")]
    for lo, hi in ((0, 700), (700, 900), (900, n)):
        rings = [window.ring_push(r, x[lo:hi].to(r.buf.device))
                 for r in rings]
    if not (agc_err <= 1e-5 and psd_err <= 1e-3 and
            torch.equal(got[2].cpu(), want[2]) and
            torch.equal(rings[0].buf.cpu(), rings[1].buf)):
        raise AssertionError(f"A13 ops: AGC {agc_err:.2e}, PSD {psd_err:.2e}"
                             f" dB, or peaks or ring logs differ")
    f = str(Path(tmpdir) / "nb.iq")
    run_app(narrowband_tx.main, ["-o", f, "-n", "20000"])
    texts = {}
    for where in ("card", "cpu"):
        if where == "cpu":
            os.environ[DEVICE_ENV] = "cpu"
        try:
            texts[where] = (run_app(asgram_rx.main, ["-i", f, "-L", "8"]),
                            run_app(rssi.main, ["-i", f, "-L", "4096"]))
        finally:
            os.environ.pop(DEVICE_ENV, None)
    peaks = {w: re.findall(r"f=([-+.\d]+)", t[0]) for w, t in texts.items()}
    levels = {w: [float(v) for v in re.findall(r"rssi =\s+([-.\d]+)", t[1])]
              for w, t in texts.items()}
    if not (len(peaks["card"]) == 8 and peaks["card"] == peaks["cpu"] and
            len(levels["card"]) == len(levels["cpu"]) > 0 and
            max(abs(a - b) for a, b in zip(levels["card"],
                                           levels["cpu"])) <= 0.011):
        raise AssertionError(f"asgram_rx / rssi on the card vs the CPU: "
                             f"{peaks} {levels}")
    torch.cuda.synchronize()
    print(f"A13 on the card vs the CPU: AGC over {n} samples within "
          f"{agc_err:.2e} (relative, limit 1e-5), spectrogram within "
          f"{psd_err:.2e} dB with the same peak bins, ring logs equal; "
          f"narrowband_tx -> asgram_rx (8 rows, peaks equal) and rssi "
          f"({len(levels['card'])} levels within 0.01 dB) on {label}",
          flush=True)
    return dict(kernels.launches)


def run_duplex(label):
    """``halfduplex_txrx -N 2`` delivers 2/2 and ``fullduplex_txrx``
    (its defaults) every frame both ways, on the card (phase 22).  Their
    OfdmTxRx endpoints detect with B1; their launch counts are returned."""
    from liquid_usrp_tpu_torch.apps import fullduplex_txrx, halfduplex_txrx
    from liquid_usrp_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    text = run_app(halfduplex_txrx.main, ["-N", "2", "-q"])
    if "2/2 delivered" not in text:
        raise AssertionError(f"halfduplex_txrx: {text[-300:]}")
    t1 = time.perf_counter()
    text = run_app(fullduplex_txrx.main, ["-q"])     # exits 1 on a loss
    n_ok = text.count("valid packets       :      5 (100.00%)")
    if n_ok != 2:
        raise AssertionError(f"fullduplex_txrx: {text[-600:]}")
    torch.cuda.synchronize()
    if kernels.launches["detect_metric_xcorr_onepass"] <= 0:
        raise AssertionError("the duplex runs did not launch B1")
    print(f"halfduplex_txrx -N 2: 2/2 delivered ({t1 - t0:.1f} s); "
          f"fullduplex_txrx: 5/5 both ways ({time.perf_counter() - t1:.1f} "
          f"s) on {label}", flush=True)
    return dict(kernels.launches)


def worker_errors():
    """Record the exceptions of threads that die (``threading.excepthook``)
    into the returned list until ``restore()``."""
    seen, old = [], threading.excepthook
    threading.excepthook = lambda args: seen.append(args.exc_value)

    def restore():
        threading.excepthook = old
        if seen:
            raise AssertionError(f"{len(seen)} worker thread(s) died: "
                                 f"{seen[0]!r}") from seen[0]
    return restore


def mc_frames_check(what, frames, sent):
    """Every sent (header bytes -> payload) decodes payload-exact among the
    ``MultichannelRx`` frames."""
    valid = {bytes(f["header"]): f for f in frames if f["payload_valid"]}
    missing = [h for h in sent if h not in valid or
               not np.array_equal(valid[h]["payload"], sent[h])]
    if missing:
        raise AssertionError(f"{what}: {len(missing)} of {len(sent)} "
                             f"frames not decoded payload-exact")
    return len(sent)


def mc_results_equal(a, b):
    """Two runs' per-step multichannel results (host tensors) agree: the
    same detections and offsets, the same payload-valid rows and bytes."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        det, ok = x.detected, x.payload_valid
        if not (torch.equal(det, y.detected) and
                torch.equal(ok, y.payload_valid) and
                torch.equal(x.t_start[det], y.t_start[det]) and
                torch.equal(x.payload[ok], y.payload[ok])):
            return False
    return True


def stream_runs(path, g1, step, init, dev):
    """(direct, pipelined) over the file's blocks of ``g1`` samples: the
    direct step loop (read a block, step, copy its results to the host)
    and ``NativeReader`` -> ``BlockPrefetcher`` -> ``run_pipelined``; each
    returns (per-step host results, seconds)."""
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    from liquid_usrp_tpu_torch.io import native
    from liquid_usrp_tpu_torch.io.pipeline import run_pipelined

    def host(res):
        return ofdm_sync.FrameResults(*(v.cpu() for v in res))

    def direct():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, out = init(), []
        for blk in native.NativeReader(path, g1):
            st, res = step(st, torch.as_tensor(blk, device=dev))
            out.append(host(res))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def piped():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = []
        run_pipelined(native.NativeReader(path, g1), step, init(),
                      lambda res: out.append(host(res)))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    return direct, piped


def run_streaming(blocks, flush, weights, expected, dev, tmpdir, label):
    """The streaming plumbing at the bench configuration (phase 24): the
    mixture through ``NativeWriter`` (bytes equal ``write_file``'s) and
    back through ``NativeReader`` -> ``BlockPrefetcher`` ->
    ``run_pipelined`` over ``make_mcrx_step`` (88/88 with ``bench.py``'s
    fingerprints, equal to the direct step loop, B1 launched); the TX
    worker at N=4 with 400-byte packets queued mid-stream while the main
    thread runs the receiver on the card; ``AsyncTxProducer``; the
    ``multichannel_txrx`` CLI.  A worker thread that dies fails the phase.
    Returns the launch counts, and what phase 26 times."""
    from liquid_usrp_tpu_torch.apps import multichannel_txrx
    from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
    from liquid_usrp_tpu_torch.io import native
    from liquid_usrp_tpu_torch.io.pipeline import AsyncTxProducer
    from liquid_usrp_tpu_torch.models.multichannel import (MultichannelRx,
                                                           MultichannelTx,
                                                           make_mcrx_step)
    from liquid_usrp_tpu_torch.ops import kernels
    restore = worker_errors()
    try:
        params = ofdm.make_ofdm_params(M, CP, TAPER)
        sync = ofdm_sync.make_sync(params, block_size=BLOCK,
                                   max_payload=MAX_PAYLOAD,
                                   max_frames=MAX_FRAMES, use_pallas=1)
        init, step = make_mcrx_step(N, sync, dev)
        g1 = 2 * N * BLOCK
        n_flush = -(-(sync.overlap // BLOCK + 1) // N_BLOCKS)
        host = np.concatenate([blocks.cpu().numpy()] +
                              [flush.cpu().numpy()] * n_flush)
        pw, pf = str(Path(tmpdir) / "mc_w.iq"), str(Path(tmpdir) / "mc_f.iq")
        with native.NativeWriter(pw) as w:
            for lo in range(0, len(host), g1):
                w.push(host[lo:lo + g1])
        native.write_file(pf, host)
        if Path(pw).read_bytes() != Path(pf).read_bytes():
            raise AssertionError("NativeWriter's file differs from "
                                 "write_file's")
        direct, piped = stream_runs(pw, g1, step, init, dev)
        kernels.reset_launch_counts()
        p_res, _ = piped()
        launches = dict(kernels.launches)
        d_res, _ = direct()
        w64 = torch.as_tensor(weights.astype(np.int64))
        cnt = sum(fingerprint(r, w64)[0] for r in p_res)
        fp = sum(fingerprint(r, w64)[1] for r in p_res)
        check_decoded("run_pipelined", cnt, fp, expected)
        if not mc_results_equal(p_res, d_res):
            raise AssertionError("run_pipelined's results differ from the "
                                 "direct step loop's")
        if launches["detect_metric_xcorr_onepass"] <= 0:
            raise AssertionError("run_pipelined did not launch B1")
        print(f"NativeWriter file ({len(host)} samples) equals write_file's "
              f"byte for byte; NativeReader -> BlockPrefetcher -> "
              f"run_pipelined over make_mcrx_step: {int(cnt.sum())}/"
              f"{sum(expected[0])} frames with bench.py's fingerprints, "
              f"equal to the direct step loop ({len(p_res)} steps); "
              f"launches {launches}", flush=True)

        # the TX worker: packets queued mid-stream, the receiver stepping
        # on the card in this thread while the worker steps in its own
        rng = np.random.default_rng(24)
        tx = MultichannelTx(N, M=M, cp_len=CP, taper_len=TAPER, device=dev)
        rx = MultichannelRx(N, M=M, cp_len=CP, taper_len=TAPER,
                            max_payload=MAX_PAYLOAD, device=dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        tx.start_worker(chunk=TXW_CHUNK, max_ahead=TXW_AHEAD)
        sent, frames, peak = {}, [], 0
        try:
            deadline = time.time() + 60
            while tx.samples_ahead < TXW_AHEAD and time.time() < deadline:
                time.sleep(0.005)
            peak = tx.samples_ahead
            for rep in range(TXW_PACKETS):
                for ch in range(N):
                    h = rng.integers(0, 256, 8, dtype=np.uint8)
                    h[:2] = rep, ch
                    p = rng.integers(0, 256, PAYLOAD, dtype=np.uint8)
                    tx.update_data(ch, h, p)
                    sent[bytes(h)] = p
                while not all(tx.is_channel_ready(c) for c in range(N)):
                    peak = max(peak, tx.samples_ahead)
                    frames += rx.execute(tx.read_samples(16384))
        finally:
            tx.stop_worker()
        peak = max(peak, tx.samples_ahead)
        frames += rx.execute(tx.read_samples(
            tx.samples_ahead + 2 * N * (2 * tx.chz.P + 64))) + rx.flush()
        torch.cuda.synchronize()
        n_ok = mc_frames_check("TX worker", frames, sent)
        if not TXW_AHEAD <= peak <= TXW_AHEAD + 2 * N * TXW_CHUNK:
            raise AssertionError(f"TX worker: {peak} samples ahead, bound "
                                 f"{TXW_AHEAD} + {2 * N * TXW_CHUNK}")
        print(f"TX worker (chunk {TXW_CHUNK}, max_ahead {TXW_AHEAD}): "
              f"{n_ok}/{len(sent)} frames queued mid-stream decode "
              f"payload-exact, the receiver stepping on the card in the "
              f"main thread; at most {peak} samples ahead (bound "
              f"{TXW_AHEAD + 2 * N * TXW_CHUNK}); "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        prod = AsyncTxProducer(MultichannelTx(N, M=M, cp_len=CP,
                                              taper_len=TAPER, device=dev),
                               block_channel_samples=256, depth=8)
        sent_p = {}
        for rep in range(2):
            for ch in range(N):
                h = rng.integers(0, 256, 8, dtype=np.uint8)
                h[:2] = 0x40 + rep, ch
                p = rng.integers(0, 256, PAYLOAD, dtype=np.uint8)
                prod.transmit_packet(ch, h, p)
                sent_p[bytes(h)] = p
        prod.close()
        air = np.concatenate(list(prod.blocks()))
        rx = MultichannelRx(N, M=M, cp_len=CP, taper_len=TAPER,
                            max_payload=MAX_PAYLOAD, device=dev)
        n_prod = mc_frames_check("AsyncTxProducer",
                                 rx.execute(air) + rx.flush(), sent_p)
        cli = []
        for argv in (["-q"], ["-n", str(N), "-P", str(PAYLOAD), "-R", "4",
                              "-q"]):
            text = run_app(multichannel_txrx.main, argv)
            ok, n_sent = map(int, re.search(
                r"payload-exact\s+:\s+(\d+) / (\d+) sent", text).groups())
            if not ok == n_sent > 0:
                raise AssertionError(f"multichannel_txrx {argv}: {ok} of "
                                     f"{n_sent} payload-exact")
            cli.append(f"{' '.join(argv)}: {ok}/{n_sent}")
        torch.cuda.synchronize()
        worker_launches = dict(kernels.launches)
        print(f"AsyncTxProducer: {n_prod}/{len(sent_p)} payload-exact; "
              f"multichannel_txrx {'; '.join(cli)} payload-exact on {label}",
              flush=True)
    finally:
        restore()
    runs = {"pipelined": launches, "worker": worker_launches}
    return runs, dict(direct=direct, piped=piped, w64=w64, g1=g1,
                      expected=expected)


def wlan_padded(stream, sync):
    """A host stream padded with the blocks that drain the sync's overlap,
    as ``[n_blocks, block_size]``."""
    bs = sync.block_size
    n_blocks = -(-len(stream) // bs) + sync.overlap // bs + 1
    x = np.zeros(n_blocks * bs, np.complex64)
    x[:len(stream)] = stream
    return x.reshape(n_blocks, bs)


def wlan_rows(stream, sync, dev):
    """The port's WLAN sync over a host stream on ``dev``: the detected
    rows (t_start, rate, length, signal_valid, psdu_valid, PSDU bytes,
    cfo, rssi) in stream order."""
    from liquid_usrp_tpu_torch.framing import wlan
    blocks = torch.as_tensor(wlan_padded(stream, sync), device=dev)
    step = wlan.make_wlan_sync_step(sync)
    state, rows = wlan.wlan_sync_init(sync, dev), []
    for blk in blocks:
        state, res = step(state, blk)
        res = wlan.WlanResults(*(v.cpu().numpy() for v in res))
        for i in np.nonzero(res.detected)[0]:
            rows.append((int(res.t_start[i]), int(res.rate[i]),
                         int(res.length[i]), bool(res.signal_valid[i]),
                         bool(res.psdu_valid[i]),
                         res.psdu[i][: int(res.length[i])].tobytes(),
                         float(res.cfo[i]), float(res.rssi[i])))
    return sorted(rows)


def wlan_rows_equal(what, got, want):
    """Card rows against CPU rows: exact but cfo (1e-5) and rssi (1e-4)."""
    if [r[:6] for r in got] != [r[:6] for r in want]:
        raise AssertionError(f"{what}: the card's rows differ from the CPU's"
                             f": {[r[:5] for r in got]} vs "
                             f"{[r[:5] for r in want]}")
    d_cfo = max((abs(a[6] - b[6]) for a, b in zip(got, want)), default=0.0)
    d_rssi = max((abs(a[7] - b[7]) for a, b in zip(got, want)), default=0.0)
    if not (d_cfo <= WLAN_CFO_ATOL and d_rssi <= WLAN_RSSI_ATOL):
        raise AssertionError(f"{what}: cfo {d_cfo:.2e}, rssi {d_rssi:.2e}")
    return d_cfo, d_rssi


def wlan_check_psdus(what, rows, psdus, n_want):
    """The PSDU-valid rows carry the regenerated PSDUs in order."""
    got = [r[5] for r in rows if r[4]]
    if len(got) != n_want or got != [p.tobytes() for p in psdus[:n_want]]:
        raise AssertionError(f"{what}: {len(got)} valid PSDUs, expected "
                             f"{n_want} equal to the regenerated ones")


def wlan_draws(n, P, seed=WLAN_SEED):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, P, dtype=np.uint8) for _ in range(n)]


def record_viterbi(fn):
    """Run ``fn()`` with the WLAN Viterbi's calls recorded: returns
    ``(fn(), [(pairs, bits)])`` on the device they ran on."""
    from liquid_usrp_tpu_torch.framing import wlan
    orig, calls = wlan._viterbi_soft, []

    def rec(pairs):
        bits = orig(pairs)
        calls.append((pairs, bits))
        return bits
    wlan._viterbi_soft = rec
    try:
        return fn(), calls
    finally:
        wlan._viterbi_soft = orig


def first_detecting_block(stream, sync, dev):
    """(state before, block) of the first block of ``stream`` whose sync
    step detects a frame, on ``dev``."""
    from liquid_usrp_tpu_torch.framing import wlan
    blocks = torch.as_tensor(wlan_padded(stream, sync), device=dev)
    state = wlan.wlan_sync_init(sync, dev)
    for blk in blocks:
        new, res = wlan.wlan_sync_block(sync, state, blk)
        if bool(res.psdu_valid.any()):
            return state, blk
        state = new
    raise AssertionError("no detecting block")


def run_wlan(dev, tmpdir, label):
    """The 802.11a path on the card (phase 25).  Returns the kernel launch
    counts of its runs and the streams phase 26 times."""
    from liquid_usrp_tpu_torch.apps import common, wlanframe_rx, wlanframe_tx
    from liquid_usrp_tpu_torch.framing import wlan
    from liquid_usrp_tpu_torch.io.streams import read_iq, write_iq
    from liquid_usrp_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sync = wlan.make_wlan_sync()
    draws = wlan_draws(WLAN_FRAMES, WLAN_PSDU)
    streams, worst = {}, (0.0, 0.0)
    for rate in sorted(wlan.WLAN_RATES):
        f = str(Path(tmpdir) / f"w{rate}.iq")
        run_app(wlanframe_tx.main, ["-o", f, "-r", str(rate), "-N",
                                    str(WLAN_FRAMES)])
        text = run_app(wlanframe_rx.main, ["-i", f, "-q"])
        if app_count(text, "valid PSDUs") != WLAN_FRAMES:
            raise AssertionError(f"wlanframe_rx -r {rate}: {text[-300:]}")
        stream = read_iq(f)
        streams[rate] = stream
        got = wlan_rows(stream, sync, dev)
        wlan_check_psdus(f"rate {rate}", got, draws, WLAN_FRAMES)
        flen = wlan.wlan_frame_length(rate, WLAN_PSDU)
        if [r[0] for r in got] != [200 + k * (flen + 200)
                                   for k in range(WLAN_FRAMES)]:
            raise AssertionError(f"rate {rate}: t_start {[r[0] for r in got]}")
        d = wlan_rows_equal(f"rate {rate}", got,
                            wlan_rows(stream, sync, "cpu"))
        worst = tuple(max(a, b) for a, b in zip(worst, d))
    print(f"wlanframe_tx -N {WLAN_FRAMES} -> wlanframe_rx: {WLAN_FRAMES}/"
          f"{WLAN_FRAMES} valid PSDUs at each of the 8 rates; the sync "
          f"driven directly returns the regenerated PSDUs byte for byte at "
          f"the CPU port's t_start (rows equal, cfo within {worst[0]:.2e}, "
          f"rssi within {worst[1]:.2e} dB); {time.perf_counter() - t0:.1f} "
          f"s", flush=True)

    t0 = time.perf_counter()
    mtu_sync = wlan.make_wlan_sync(max_psdu=WLAN_MTU)
    mtu = {}
    for rate in (6, 54):
        f = str(Path(tmpdir) / f"mtu{rate}.iq")
        run_app(wlanframe_tx.main, ["-o", f, "-r", str(rate), "-N",
                                    str(WLAN_MTU_FRAMES), "-P",
                                    str(WLAN_MTU)])
        text = run_app(wlanframe_rx.main, ["-i", f, "-p", str(WLAN_MTU),
                                           "-q"])
        if app_count(text, "valid PSDUs") != WLAN_MTU_FRAMES:
            raise AssertionError(f"wlanframe_rx -p {WLAN_MTU} at {rate}: "
                                 f"{text[-300:]}")
        mtu[rate] = read_iq(f)
        wlan_check_psdus(f"MTU at {rate}", wlan_rows(mtu[rate], mtu_sync,
                                                     dev),
                         wlan_draws(WLAN_MTU_FRAMES, WLAN_MTU),
                         WLAN_MTU_FRAMES)
    print(f"-P {WLAN_MTU} at 6 and 54 Mb/s: wlanframe_rx -p {WLAN_MTU} "
          f"{WLAN_MTU_FRAMES}/{WLAN_MTU_FRAMES} each, PSDUs byte for byte; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    f = str(Path(tmpdir) / "w24.iq")
    run_app(wlanframe_tx.main, ["-o", f, "-N", "3", "-r", "24", "-P", "90"])
    clean = read_iq(f)
    impaired = common.apply_channel(clean, {"snr": "15", "cfo": "0.002"},
                                    signal_power=common.occupied_power(clean))
    fi = str(Path(tmpdir) / "w24_impaired.iq")
    write_iq(fi, impaired)
    got = wlan_rows(read_iq(fi), sync, dev)
    wlan_rows_equal("impaired", got, wlan_rows(read_iq(fi), sync, "cpu"))
    wlan_check_psdus("impaired", got, wlan_draws(3, 90), 3)

    # the card against the CPU on the same inputs
    state, blk = first_detecting_block(streams[6], sync, dev)
    _, calls = record_viterbi(lambda: wlan.wlan_sync_block(sync, state, blk))
    n_pairs = 0
    for pairs, bits in calls:
        if not torch.equal(wlan._viterbi_soft(pairs.cpu()), bits.cpu()):
            raise AssertionError("WLAN Viterbi: the card's bits differ from "
                                 "the CPU's on a dispatch's pairs")
        n_pairs += pairs.shape[0] * pairs.shape[1]
    rng = np.random.default_rng(25)
    rnd = rng.normal(size=(4, 3000, 2)).astype(np.float32)
    rnd[1] = np.round(rnd[1] * 2) / 2                 # exact ties
    rnd[2, 1500:] = 0.0                               # erased tail
    rnd[3, rng.random((3000, 2)) < 0.3] = 0.0         # erasures
    rnd = torch.as_tensor(rnd)
    if not torch.equal(wlan._viterbi_soft(rnd.to(dev)).cpu(),
                       wlan._viterbi_soft(rnd)):
        raise AssertionError("WLAN Viterbi: the card's bits differ from the "
                             "CPU's on random pairs")
    pts = torch.as_tensor((rng.normal(size=20000) + 1j *
                           rng.normal(size=20000)).astype(np.complex64))
    llr_err = 0.0
    for bpsc in (1, 2, 4, 6):
        want = wlan._demap_soft(pts, bpsc)
        got_l = wlan._demap_soft(pts.to(dev), bpsc).cpu()
        llr_err = max(llr_err, float((got_l - want).abs().max()) /
                      float(want.abs().max()))
    if not llr_err <= SOFT_LLR_RTOL:
        raise AssertionError(f"WLAN soft demap: {llr_err:.2e} of max |LLR|")
    m_err, flips, n_ext = 0.0, 0, 0
    bs = sync.block_size
    for rate in (6, 54):
        blocks = wlan_padded(streams[rate], sync)
        x = np.concatenate([np.zeros(sync.overlap, np.complex64),
                            blocks.reshape(-1)])
        for b in range(len(blocks)):
            ext = torch.as_tensor(x[b * bs:b * bs + sync.overlap + bs])
            mc = wlan._wlan_metric(sync, ext.to(dev)).cpu()
            mh = wlan._wlan_metric(sync, ext)
            on = (mc != 0) & (mh != 0)
            flips += int(((mc != 0) ^ (mh != 0)).sum())
            if bool(on.any()):
                m_err = max(m_err, float((mc - mh)[on].abs().max()))
            n_ext += 1
    if not m_err <= WLAN_METRIC_ATOL:
        raise AssertionError(f"WLAN metric: card vs CPU {m_err:.2e}")
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    print(f"WLAN impaired (--snr 15 --cfo 0.002, rate 24, impaired once): "
          f"card rows equal the CPU's, 3/3 PSDUs; the Viterbi's bits equal "
          f"the CPU's on a dispatch's {n_pairs} pairs ({len(calls)} calls) "
          f"and on 12000 random pairs with ties and erasures; soft demap "
          f"within {llr_err:.2e} of max |LLR|; the metric within "
          f"{m_err:.2e} over {n_ext} windows where both gates are open "
          f"({flips} gate flips); on {label}", flush=True)
    return launches, dict(sync=sync, mtu_sync=mtu_sync, default=streams[6],
                          mtu=mtu[6])


def time_streaming(ctx, dev, label):
    """Phase 26, streaming: ``run_pipelined`` against the direct step loop
    in turns (direct, pipelined, pipelined, direct, ...), each run checked;
    the TX worker's output samples/s, its frames decode-checked."""
    from liquid_usrp_tpu_torch.models.multichannel import (MultichannelRx,
                                                           MultichannelTx)
    times = {"direct": [], "pipelined": []}
    order = ["direct", "pipelined", "pipelined", "direct"] * \
        (STREAM_TIMED_RUNS // 2)
    n_samples = None
    for side in order:
        res, sec = (ctx["direct"] if side == "direct" else ctx["piped"])()
        cnt = sum(fingerprint(r, ctx["w64"])[0] for r in res)
        fp = sum(fingerprint(r, ctx["w64"])[1] for r in res)
        check_decoded(f"timed {side}", cnt, fp, ctx["expected"])
        n_samples = len(res) * ctx["g1"]
        times[side].append(n_samples / sec)
    print(f"stream timings ({n_samples} samples a run, decode-verified, "
          f"in turns {order}): direct step loop "
          f"{[round(v / 1e6, 4) for v in times['direct']]} MS/s, "
          f"run_pipelined {[round(v / 1e6, 4) for v in times['pipelined']]}"
          f" MS/s on {label}", flush=True)

    rng = np.random.default_rng(26)
    tx = MultichannelTx(N, M=M, cp_len=CP, taper_len=TAPER, device=dev)
    tx.generate_samples(TXW_CHUNK)
    sent = {}
    for ch in range(N):
        h = rng.integers(0, 256, 8, dtype=np.uint8)
        h[0] = ch
        p = rng.integers(0, 256, PAYLOAD, dtype=np.uint8)
        tx.update_data(ch, h, p)
        sent[bytes(h)] = p
    total = 1 << 20
    restore = worker_errors()
    try:
        t0 = time.perf_counter()
        tx.start_worker(chunk=TXW_CHUNK, max_ahead=TXW_AHEAD)
        try:
            chunks = [tx.read_samples(16384) for _ in range(total // 16384)]
        finally:
            tx.stop_worker()
        sec = time.perf_counter() - t0
    finally:
        restore()
    rx = MultichannelRx(N, M=M, cp_len=CP, taper_len=TAPER,
                        max_payload=MAX_PAYLOAD, device=dev)
    mc_frames_check("timed TX worker",
                    rx.execute(np.concatenate(chunks)) + rx.flush(), sent)
    print(f"TX worker output: {total / sec / 1e6:.4f} MS/s ({total} samples "
          f"in {sec * 1e3:.1f} ms, chunk {TXW_CHUNK}, {N} frames decoded) on "
          f"{label}", flush=True)
    return times, total / sec


def time_wlan(ctx, dev, label):
    """Phase 26, WLAN: decode-verified input samples/s over the default
    stream; ms per detecting block and the DATA Viterbi's ms in that
    block, at -p 256 and -p 1500."""
    from liquid_usrp_tpu_torch.framing import wlan
    draws = wlan_draws(WLAN_FRAMES, WLAN_PSDU)
    rates = []
    for _ in range(WLAN_TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = wlan_rows(ctx["default"], ctx["sync"], dev)
        sec = time.perf_counter() - t0
        wlan_check_psdus("timed WLAN", rows, draws, WLAN_FRAMES)
        rates.append(len(ctx["default"]) / sec)
    out = {"sps": rates}
    for name, sync, stream in (("p256", ctx["sync"], ctx["default"]),
                               ("p1500", ctx["mtu_sync"], ctx["mtu"])):
        state, blk = first_detecting_block(stream, sync, dev)
        (_, want), calls = record_viterbi(
            lambda: wlan.wlan_sync_block(sync, state, blk))
        pairs, bits = max(calls, key=lambda c: c[0].shape[1])
        checks = []

        def one():
            _, res = wlan.wlan_sync_block(sync, state, blk)
            checks.append(res.psdu)

        ms = cuda_ms(one, 2)
        if not all(torch.equal(c, want.psdu) for c in checks):
            raise AssertionError(f"WLAN {name}: a timed block decoded "
                                 f"other PSDUs")
        vbits = []
        v_ms = cuda_ms(lambda: vbits.append(wlan._viterbi_soft(pairs)), 2)
        if not all(torch.equal(b, bits) for b in vbits):
            raise AssertionError(f"WLAN {name}: a timed Viterbi gave "
                                 f"other bits")
        out[name] = (ms, v_ms, tuple(pairs.shape))
    print(f"WLAN timings on {label}: default stream (rate 6, "
          f"{WLAN_FRAMES} x {WLAN_PSDU} bytes, {len(ctx['default'])} "
          f"samples) {[round(v / 1e6, 4) for v in rates]} MS/s "
          f"decode-verified; a detecting block at -p 256 "
          f"{out['p256'][0]:.2f} ms (the DATA Viterbi {out['p256'][1]:.2f} "
          f"ms over {out['p256'][2]} pairs), at -p 1500 "
          f"{out['p1500'][0]:.2f} ms (Viterbi {out['p1500'][1]:.2f} ms over "
          f"{out['p1500'][2]})", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 27: the parallel layer on ranks that share the card
# ---------------------------------------------------------------------------

def time_syncs():
    """The synchronizers of the time-sharded runs: the single-channel OFDM
    app defaults at the legacy detector, level 1 (B3), and the flexframe,
    GMSK and 802.11a RX app defaults."""
    from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync, wlan
    return {
        "ofdm": ofdm_sync.make_sync(
            ofdm.make_ofdm_params(M, CP, TAPER), block_size=SC_BLOCK,
            max_payload=SC_MAX_PAYLOAD, use_pallas=1, xcorr_detect=False),
        "flex": ff_sync(), "gmsk": gm_sync(), "wlan": wlan.make_wlan_sync()}


def time_padded(stream, sync, n_ranks=PAR_RANKS):
    """``stream`` padded with zeros to ``n_ranks`` equal chunks of whole
    blocks, each covering the sync's overlap, with at least one overlap of
    zeros after the stream: (padded, blocks per rank)."""
    bs = sync.block_size
    cb = max(-(-sync.overlap // bs),
             -(-(len(stream) + sync.overlap) // (n_ranks * bs)))
    x = np.zeros(n_ranks * cb * bs, np.complex64)
    x[:len(stream)] = stream
    return x, cb


def sequential_rows(sync, stream, dev):
    """The port's own block loop (each family's ``*_sync_block``) over a
    host stream on ``dev``: the results of every block stacked as host
    arrays ``[n_blocks * max_frames, ...]``, the rows the time-sharded run
    gives."""
    from liquid_usrp_tpu_torch.framing import flexframe_sync as fs
    from liquid_usrp_tpu_torch.framing import gmskframe as gf
    from liquid_usrp_tpu_torch.framing import ofdm_sync, wlan
    block_fn, init = {
        ofdm_sync.OfdmSync: (ofdm_sync.sync_block, ofdm_sync.sync_init),
        fs.FlexSync: (fs.flex_sync_block, fs.flex_sync_init),
        gf.GmskSync: (gf.gmsk_sync_block, gf.gmsk_sync_init),
        wlan.WlanSync: (wlan.wlan_sync_block, wlan.wlan_sync_init),
    }[type(sync)]
    bs = sync.block_size
    blocks = torch.as_tensor(stream.reshape(-1, bs), device=dev)
    state, rows = init(sync, dev), []
    for blk in blocks:
        state, res = block_fn(sync, state, blk)
        rows.append(res)
    return {f: torch.cat([getattr(r, f) for r in rows]).cpu().numpy()
            for f in rows[0]._fields}


def host_results(res) -> dict:
    return {f: np.asarray(v) for f, v in zip(res._fields, res)}


def keyed_rows(res) -> dict:
    """The detected rows of host results by ``(channel, t_start)`` (by
    ``t_start`` alone for one stream)."""
    det = res["detected"]
    return {tuple(int(i) for i in idx[:-1]) + (int(res["t_start"][idx]),):
            idx for idx in zip(*np.nonzero(det))}


def rows_equal(what, got, want):
    """Raise unless the detected rows of two host results are the same:
    flags, lengths, scheme fields and ``t_start`` exact, the valid bytes
    equal, ``rssi`` within 1e-3 dB, ``evm`` 0.05 dB, ``cfo`` 1e-5."""
    kg, kw = keyed_rows(got), keyed_rows(want)
    if kg.keys() != kw.keys():
        raise AssertionError(f"{what}: detected rows differ: "
                             f"{sorted(kg)[:8]} vs {sorted(kw)[:8]}")
    tol = {"rssi": 1e-3, "evm": 0.05, "cfo": 1e-5}
    for key, ig in kg.items():
        iw = kw[key]
        for f in got:
            a, b = got[f][ig], want[f][iw]
            if f in tol:
                ok = abs(float(a) - float(b)) <= tol[f]
            elif f in ("payload", "psdu"):
                n = int(got["payload_len" if f == "payload" else "length"][ig])
                ok = np.array_equal(a[:n], b[:n])
            elif f == "header":
                ok = not got["header_valid"][ig] or np.array_equal(a, b)
            else:
                ok = np.array_equal(a, b)
            if not ok:
                raise AssertionError(f"{what}: row {key} field {f}: {a} vs "
                                     f"{b}")
    return len(kg)


def host_fingerprint(res, weights):
    """:func:`fingerprint` of host results ``[N, rows]``."""
    from types import SimpleNamespace
    return fingerprint(
        SimpleNamespace(payload_valid=torch.as_tensor(res["payload_valid"]),
                        payload=torch.as_tensor(res["payload"])),
        torch.as_tensor(weights.astype(np.int64)))


def family_frames(name, res):
    """The frames of a time-sharded result in the form each family's
    check takes (``check_sc_frames``, ``check_ff_frames``, the WLAN rows
    of ``wlan_rows``)."""
    rows = sorted(np.nonzero(res["detected"])[0],
                  key=lambda r: int(res["t_start"][r]))
    if name == "wlan":
        return [(int(res["t_start"][r]), int(res["rate"][r]),
                 int(res["length"][r]), bool(res["signal_valid"][r]),
                 bool(res["psdu_valid"][r]),
                 res["psdu"][r][:int(res["length"][r])].tobytes(),
                 float(res["cfo"][r]), float(res["rssi"][r]))
                for r in rows]
    frames = []
    for r in rows:
        payload = res["payload"][r][:int(res["payload_len"][r])]
        frames.append(dict(
            t=int(res["t_start"][r]), valid=bool(res["payload_valid"][r]),
            payload_valid=bool(res["payload_valid"][r]),
            header=res["header"][r], payload=payload,
            cfo=float(res["cfo"][r])))
    return frames


def par_timed(run, x_local, rank, weights, n=PAR_TIMED_RUNS):
    """``n`` timed runs of a sharded receiver after a barrier each: this
    rank's wall seconds and collective seconds per run, and (rank 0) each
    run's per-channel counts and fingerprints."""
    import torch.distributed as dist
    from liquid_usrp_tpu_torch.parallel import _comm
    out = []
    for _ in range(n):
        dist.barrier()
        torch.cuda.synchronize()
        _comm.reset_stats()
        t0 = time.perf_counter()
        res = run(x_local)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        fp = None
        if rank == 0:
            cnt, f = host_fingerprint(host_results(res), weights)
            fp = (cnt.numpy(), f.numpy() & 0xFFFFFFFF)
        out.append((sec, _comm.stats["seconds"], _comm.stats["calls"], fp))
    return out


def par_bench_sync(level):
    from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
    return ofdm_sync.make_sync(ofdm.make_ofdm_params(M, CP, TAPER),
                               block_size=BLOCK, max_payload=MAX_PAYLOAD,
                               max_frames=MAX_FRAMES, use_pallas=level)


def par_world(rank, inp, weights):
    """Phase 27 in each rank of the 2x2 world sharing the card over gloo:
    the receivers, the transmitter, time sharding of four frame families
    and timed runs.  Returns this rank's launches and timings, and (rank
    0) the global results."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from liquid_usrp_tpu_torch.ops import kernels
    from liquid_usrp_tpu_torch.parallel import distributed, stream
    from liquid_usrp_tpu_torch.parallel.mesh import make_sdr_mesh
    m = make_sdr_mesh()
    tm = init_device_mesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                          (PAR_RANKS,), mesh_dim_names=("time",))
    out = {"launches": {}, "res": {}, "backend": dist.get_backend(),
           "device": str(distributed.local_device())}

    def once(name, run, mesh, x):
        kernels.reset_launch_counts()
        res = run(stream.shard_for(mesh, x, run.in_spec))
        torch.cuda.synchronize()
        out["launches"][name] = dict(kernels.launches)
        if rank == 0:
            out["res"][name] = (res if isinstance(res, np.ndarray)
                                else host_results(res))

    mix = inp["mix"]
    a2a = stream.sharded_mcrx(m, N, par_bench_sync(1), 1)
    once("a2a", a2a, m, mix)
    once("dup", stream.make_sharded_mcrx(m, N, par_bench_sync(2), 2), m,
         mix)
    once("piped", stream.sharded_mcrx(m, N, par_bench_sync(1), 1,
                                      n_steps=2), m,
         np.concatenate([mix, inp["flush"], inp["flush"]]).reshape(2, -1))
    once("mctx", stream.make_sharded_mctx(
        m, N, inp["tx_streams"].shape[1] // PAR_RANKS), m,
        inp["tx_streams"])
    for name, sync in time_syncs().items():
        x, cb = inp["time"][name]
        once(f"time_{name}", stream.make_time_sharded_sync(tm, sync, cb),
             tm, x)
    out["timed"] = par_timed(a2a, stream.shard_for(m, mix, a2a.in_spec),
                             rank, weights)
    return out


def par_nccl(rank, inp, weights):
    """Phase 27 in a 1-rank NCCL world on the card: ``sharded_mcrx`` on a
    1x1 mesh, checked and timed."""
    import torch.distributed as dist
    from liquid_usrp_tpu_torch.ops import kernels
    from liquid_usrp_tpu_torch.parallel import stream
    from liquid_usrp_tpu_torch.parallel.mesh import make_sdr_mesh
    m = make_sdr_mesh()
    run = stream.sharded_mcrx(m, N, par_bench_sync(1), PAR_RANKS)
    x = stream.shard_for(m, inp["mix"], run.in_spec)
    kernels.reset_launch_counts()
    res = host_results(run(x))
    torch.cuda.synchronize()
    return {"backend": dist.get_backend(), "res": res,
            "launches": dict(kernels.launches),
            "timed": par_timed(run, x, rank, weights)}


def single_loop(mix, sync, weights, expected, dev):
    """Seconds of the single-process ``make_mcrx_step`` loop over ``mix``,
    after one warm-up loop; both decode-verified."""
    from liquid_usrp_tpu_torch.models.multichannel import make_mcrx_step
    init, step = make_mcrx_step(N, sync, dev)
    w64 = torch.as_tensor(weights.astype(np.int64), device=dev)
    g = 2 * N * sync.block_size
    x = torch.as_tensor(mix, device=dev)
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, cnt, fp = init(), 0, 0
        for lo in range(0, len(mix), g):
            st, res = step(st, x[lo:lo + g])
            c, f = fingerprint(res, w64)
            cnt, fp = cnt + c, fp + f
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        check_decoded("single-process make_mcrx_step loop", cnt, fp,
                      expected)
    return sec


def check_par_launches(what, runs, kernel):
    """Every rank launched ``kernel`` and no other kernel of B1-B5."""
    for rank, launched in enumerate(runs):
        other = {k: v for k, v in launched.items()
                 if k in KERNELS and k != kernel and v}
        if other or (kernel is not None and launched[kernel] <= 0):
            raise AssertionError(f"{what}, rank {rank}: launched "
                                 f"{launched}, expected {kernel} only")


def run_parallel(ctx, dev, tmpdir, label):
    """The parallel layer on the card (phase 27): a 2x2 world of ranks
    that share it over gloo and a 1-rank NCCL world, checked against the
    single-process paths, with timings in turns.  Returns every rank's
    launch counts."""
    from liquid_usrp_tpu_torch.framing import flexframe as ff
    from liquid_usrp_tpu_torch.parallel import distributed
    t_phase = time.perf_counter()
    weights, expected = ctx["weights"], ctx["expected"]
    mix = np.concatenate([ctx["blocks"].cpu().numpy(),
                          ctx["flush"].cpu().numpy()])
    sync1 = par_bench_sync(1)
    syncs = time_syncs()
    # the app-default streams of phases 7, 12, 16 and 25 and the rows of
    # the port's own block loop over them (the sequential reference)
    sc_stream, sc_sent = sc_transmit(str(Path(tmpdir) / "par_sc.iq"))
    _, ff_stream = ff_transmit(str(Path(tmpdir) / "par_ff.iq"), dev)
    gm_stream = gm_transmit(str(Path(tmpdir) / "par_gm.iq"))
    raw = {"ofdm": sc_stream, "flex": ff_stream, "gmsk": gm_stream,
           "wlan": ctx["wlan_stream"]}
    t0 = time.perf_counter()
    padded = {k: time_padded(v, syncs[k]) for k, v in raw.items()}
    seq = {k: sequential_rows(syncs[k], padded[k][0], dev) for k in raw}
    t_seq = time.perf_counter() - t0
    inp = {"mix": mix, "flush": ctx["flush"].cpu().numpy(),
           "tx_streams": np.ascontiguousarray(ctx["tx_streams"].T),
           "time": padded}

    single = [single_loop(mix, sync1, weights, expected, dev)]
    t0 = time.perf_counter()
    world = distributed.spawn(par_world, PAR_RANKS, inp, weights,
                              timeout_s=PAR_TIMEOUT_S)
    t_world = time.perf_counter() - t0
    t0 = time.perf_counter()
    (nccl,) = distributed.spawn(par_nccl, 1, inp, weights,
                                timeout_s=PAR_TIMEOUT_S)
    t_nccl = time.perf_counter() - t0
    single.append(single_loop(mix, sync1, weights, expected, dev))

    # the 2x2 world: gloo on ranks that share the card, NCCL where the host
    # has a card per rank (as distributed.spawn chooses)
    own = PAR_RANKS <= torch.cuda.device_count()
    backend = "nccl" if own else "gloo"
    wname = (f"2x2 {backend} world (" + ("a card per rank" if own else
                                        f"{PAR_RANKS} ranks sharing cuda:0")
             + ")")
    for rank, out in enumerate(world):
        want = (backend, f"cuda:{rank if own else 0}")
        if (out["backend"], out["device"]) != want:
            raise AssertionError(f"2x2 world rank {rank} on {out['backend']}"
                                 f", {out['device']}: expected {want}")
    res = world[0]["res"]
    lv = {"a2a": "detect_metric_xcorr_onepass",
          "dup": "detect_candidates_onepass",
          "piped": "detect_metric_xcorr_onepass"}
    for name, kernel in lv.items():
        check_decoded(f"{wname}, {name}",
                      *host_fingerprint(res[name], weights), expected)
        check_par_launches(f"{wname}, {name}",
                           [o["launches"][name] for o in world], kernel)
    n_rows = rows_equal("n_steps=2 against one-shot", res["piped"],
                        res["a2a"])
    b1 = [o["launches"]["a2a"]["detect_metric_xcorr_onepass"]
          for o in world]
    b2 = [o["launches"]["dup"]["detect_candidates_onepass"] for o in world]
    print(f"parallel, {wname}: sharded_mcrx (a2a, use_pallas=1) and make_sharded_mcrx "
          f"(use_pallas=2) decode {sum(expected[0])}/{sum(expected[0])} "
          f"over {len(mix)} samples with bench.py's fingerprints; B1 "
          f"launched {b1} by the ranks, B2 {b2}; n_steps=2 over the "
          f"mixture and three flush chunks gives the one-shot run's "
          f"{n_rows} rows; {t_world:.1f} s for the world", flush=True)

    # the sharded TX against the sequential synthesizer, then decoded
    tx_mix, ref = res["mctx"], ctx["mixture"]
    tx_err = float(np.abs(tx_mix - ref).max() / np.abs(ref).max())
    if not tx_err <= 1e-5:
        raise AssertionError(f"make_sharded_mctx: {tx_err:.2e} of the "
                             f"peak from make_mctx_step's")
    check_par_launches("make_sharded_mctx", [o["launches"]["mctx"]
                                             for o in world], None)
    from liquid_usrp_tpu_torch.models.multichannel import \
        make_mcrx_batched_step
    init, step = make_mcrx_batched_step(N, sync1, N_BLOCKS, dev)
    w64 = torch.as_tensor(weights.astype(np.int64), device=dev)
    tx_blocks = torch.as_tensor((tx_mix + 0.01 * ctx["noise"]).reshape(-1)
                                .astype(np.complex64), device=dev)
    n_flush = -(-(sync1.overlap // sync1.block_size + 1) // N_BLOCKS)
    total, _, _ = decode_stream(step, init, tx_blocks, ctx["flush"],
                                n_flush, w64)
    check_decoded("make_sharded_mctx -> single-process RX", *total,
                  expected)
    print(f"parallel, make_sharded_mctx on the 2x2 world: within "
          f"{tx_err:.2e} of its peak of make_mctx_step's mixture, "
          f"{sum(expected[0])}/{sum(expected[0])} through the "
          f"single-process receiver", flush=True)

    # time sharding on the 4 ranks, against the sequential block loop
    for name in raw:
        key = f"time_{name}"
        got = res[key]
        n = rows_equal(f"time-sharded {name}", got, seq[name])
        frames = family_frames(name, got)
        if name == "ofdm":
            check_sc_frames("time-sharded OFDM", frames, sc_sent)
            kernel = "detect_metric_onepass"
        elif name == "flex":
            check_ff_frames("time-sharded flexframe", frames,
                            tx_draws(FF_FRAMES, FF_SEED, ff.FLEX_HEADER_USER,
                                     FF_PAYLOAD))
            kernel = None
        elif name == "gmsk":
            check_ff_frames("time-sharded GMSK", frames,
                            tx_draws(GM_FRAMES, GM_SEED, 8, GM_PAYLOAD),
                            exact_count=False)
            kernel = None
        else:
            wlan_check_psdus("time-sharded WLAN", frames,
                             wlan_draws(WLAN_FRAMES, WLAN_PSDU), WLAN_FRAMES)
            kernel = None
        check_par_launches(f"time-sharded {name}",
                           [o["launches"][key] for o in world], kernel)
        x, cb = padded[name]
        print(f"parallel, time-sharded {name} on 4 ranks ({cb} blocks of "
              f"{syncs[name].block_size} each, {len(raw[name])} samples "
              f"padded to {len(x)}): {n} detected rows equal to the "
              f"sequential loop's, every frame decoded; launches "
              f"{[{k: v for k, v in o['launches'][key].items() if v} for o in world]}",
              flush=True)

    # the 1-rank NCCL world
    if nccl["backend"] != "nccl":
        raise AssertionError(f"1-rank world on {nccl['backend']}")
    check_decoded("1-rank NCCL world", *host_fingerprint(nccl["res"],
                                                         weights), expected)
    check_par_launches("1-rank NCCL world", [nccl["launches"]],
                       "detect_metric_xcorr_onepass")
    rows_equal(f"1-rank NCCL against the {wname}", nccl["res"],
               res["a2a"])

    # timings (ranks sharing one card, not scaling), each run checked
    def rates(timed):
        for _, _, _, fp in timed[0]:          # rank 0's checks
            for ch in range(N):
                if (int(fp[0][ch]) != expected[0][ch] or
                        int(fp[1][ch]) != expected[1][ch]):
                    raise AssertionError("a timed sharded run decoded "
                                         "other frames")
        walls = [max(t[k][0] for t in timed) for k in range(len(timed[0]))]
        share = [sum(t[k][1] for t in timed) / sum(t[k][0] for t in timed)
                 for k in range(len(timed[0]))]
        return [len(mix) / w for w in walls], share, timed[0][0][2]

    gloo_sps, gloo_share, gloo_calls = rates([o["timed"] for o in world])
    nccl_sps, nccl_share, nccl_calls = rates([nccl["timed"]])
    single_sps = [len(mix) / s for s in single]
    print(f"parallel timings on {label}, "
          + ("a card per rank" if own else "ranks sharing one card (not "
             "scaling)")
          + f", decode-verified over {len(mix)} samples: {wname} "
          f"{[round(v / 1e6, 4) for v in gloo_sps]} MS/s, 1-rank NCCL "
          f"world {[round(v / 1e6, 4) for v in nccl_sps]} MS/s, the "
          f"single-process make_mcrx_step loop "
          f"{[round(v / 1e6, 4) for v in single_sps]} MS/s (in turns: "
          f"single, {backend} x{PAR_TIMED_RUNS}, NCCL x{PAR_TIMED_RUNS}, "
          f"single); collectives {[f'{v:.1%}' for v in gloo_share]} of a "
          f"rank's run over {backend}"
          + ("" if own else " through pinned host copies")
          + f" ({gloo_calls} calls a run), "
          f"{[f'{v:.1%}' for v in nccl_share]} over NCCL ({nccl_calls} "
          f"calls, enqueue and wait); the sequential loops {t_seq:.1f} s, "
          f"the NCCL world {t_nccl:.1f} s, the phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return [l for o in world for l in o["launches"].values()] + \
        [nccl["launches"]]


# ---------------------------------------------------------------------------
# phase 28: the receiver-fidelity sweep against the JAX curves
# ---------------------------------------------------------------------------

def jax_curve(name):
    """The rows of ``docs/ber_{name}.json``, by SNR."""
    path = Path(__file__).resolve().parent / "docs" / f"ber_{name}.json"
    return sorted(json.loads(path.read_text())["rows"],
                  key=lambda r: r["snr_db"])


def curve_at(rows, value, s, log):
    """``value(row)`` at ``s`` dB between the rows, held flat beyond them:
    log-linear where both neighbours are positive (``log``), else
    linear."""
    x = [r["snr_db"] for r in rows]
    y = [value(r) for r in rows]
    if s <= x[0]:
        return y[0]
    if s >= x[-1]:
        return y[-1]
    i = next(k for k in range(len(x)) if x[k] >= s)
    t = (s - x[i - 1]) / (x[i] - x[i - 1])
    if log and y[i - 1] > 0 and y[i] > 0:
        return float(np.exp(np.log(y[i - 1]) + t * (np.log(y[i]) -
                                                    np.log(y[i - 1]))))
    return y[i - 1] + t * (y[i] - y[i - 1])


def rule_a(what, row, rows):
    """Rule (a): the port's PER at s lies between the JAX curve's at s +
    0.5 dB and at s - 0.5 dB, and its detections (a fraction of the frames
    sent) between the curve's at s - 0.5 and s + 0.5, each bound widened
    by 3 binomial standard deviations of the port's frame count.  Returns
    the PER window, clipped to [0, 1]."""
    n, s = row["frames_sent"], row["snr_db"]

    def sd(p):
        p = min(max(p, 0.0), 1.0)
        return (p * (1.0 - p) / n) ** 0.5

    def window(value, log, falling):
        a = curve_at(rows, value, s + FID_SHIFT_DB, log)
        b = curve_at(rows, value, s - FID_SHIFT_DB, log)
        lo, hi = (a, b) if falling else (b, a)
        return lo - FID_SIGMAS * sd(lo), hi + FID_SIGMAS * sd(hi)

    per_w = window(lambda r: r["packet_error_rate"], True, True)
    det_w = window(lambda r: r["frames_detected"] / r["frames_sent"], False,
                   False)
    per, det = row["packet_error_rate"], row["frames_detected"] / n
    if not per_w[0] <= per <= per_w[1]:
        raise AssertionError(f"{what}: PER {per} outside rule (a)'s "
                             f"[{per_w[0]:.4f}, {per_w[1]:.4f}]")
    if not det_w[0] <= det <= det_w[1]:
        raise AssertionError(f"{what}: {row['frames_detected']} detections "
                             f"of {n} outside rule (a)'s "
                             f"[{det_w[0] * n:.1f}, {det_w[1] * n:.1f}]")
    return max(per_w[0], 0.0), min(per_w[1], 1.0)


def waterfall_points(rows):
    """The JAX curve's waterfall: PER within ``FID_WATERFALL``, and the
    first point below 1 % after it."""
    pts = [r["snr_db"] for r in rows
           if FID_WATERFALL[0] <= r["packet_error_rate"] <= FID_WATERFALL[1]]
    below = [r["snr_db"] for r in rows
             if r["packet_error_rate"] < 0.01 and r["snr_db"] > max(pts)]
    return pts + below[:1]


def fid_point(bs, cfg, stream, noisy, snr, dev):
    """(row, score, seconds, dispatches, launches) of one sweep point on
    the card: counts reset just before, read just after."""
    from liquid_usrp_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets = bs.receive(cfg, noisy)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = dict(kernels.launches)
    if noisy.device != dev:
        raise AssertionError("the sweep's stream left the card")
    sc = bs.score(dets, stream.positions, stream.payloads, FID_PAYLOAD)
    return bs.row(sc, snr), sc, sec, dets.dispatches, launches


def fid_line(what, row, jax_row, sec):
    jper = "none" if jax_row is None else f"{jax_row['packet_error_rate']:.3f}"
    jber = "none" if jax_row is None else f"{jax_row['payload_ber']:.3e}"
    return (f"{what} at {row['snr_db']:5.1f} dB: {row['frames_sent']} "
            f"frames, {row['frames_detected']} detected, "
            f"{row['header_errors']} header errors, PER "
            f"{row['packet_error_rate']:.3f} (JAX {jper}), BER "
            f"{row['payload_ber']:.3e} (JAX {jber}), {sec:.2f} s")


def fid_jax_row(rows, snr):
    return next((r for r in rows if r["snr_db"] == snr), None)


def fid_profiled(bs, cfg, stream, noisy, snr, dev, kernel):
    """A sweep point whose every dispatch must launch ``kernel`` once by
    the wrapper's count, and no other kernel of B1-B5.  Then, at the
    sweep's own shapes (the extended windows of the first dispatch, which
    holds frames), the wrapper against its plain version under
    ``check_kernels``' limits and the kernel traced by ``torch.profiler``:
    every one of ``DEVICE_ITERS`` wrapper calls must show one launch of the
    CUDA kernel (``kernel_device_us``).  Last, the point's dispatches run
    once more under the profiler, and the kernel records it saw are
    reported beside the dispatches (the wrappers' counts are the check: a
    profiler window over a whole point, opened at the first dispatch, lost
    a dispatch's record in most runs made after phases 24-27: the
    profiler can lose the records of a window's first launches, so the
    window opens with ``open_window``'s spin kernels, as
    ``kernel_device_us``'s do).  Returns the point's (row, score,
    seconds, dispatches, launches), the kernel's device microseconds at
    these shapes, its error against the plain version and the profiler's
    (records, dispatches) over the path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from liquid_usrp_tpu_torch.framing import ofdm_sync
    from liquid_usrp_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = []
    for res in bs.dispatches(cfg, noisy):
        results.append(res)
        counted = dict(kernels.launches)
        kernels.reset_launch_counts()
        if counted[kernel] != 1 or any(v for k, v in counted.items()
                                       if k in KERNELS and k != kernel):
            raise AssertionError(
                f"level {cfg.sync.use_pallas} at {snr} dB, dispatch "
                f"{len(results)}: launched {counted}, expected {kernel} "
                f"once")
    sec = time.perf_counter() - t0
    n = len(results)
    dets = bs.collect(results)
    sc = bs.score(dets, stream.positions, stream.payloads, FID_PAYLOAD)
    sync = cfg.sync
    M = sync.params.M
    blocks = torch.zeros(bs.BLOCKS * sync.block_size, dtype=torch.complex64,
                         device=dev)
    head = noisy[:blocks.shape[0]]
    blocks[:head.shape[0]] = head
    _, exts = ofdm_sync.extended_windows(
        sync, ofdm_sync.sync_init(sync, dev).tail[None],
        blocks.reshape(1, bs.BLOCKS, sync.block_size))
    b1 = kernel == "detect_metric_xcorr_onepass"
    what = f"{'B1' if b1 else 'B2'} at the sweep's shapes {tuple(exts.shape)}"
    if b1:
        tmpl = ofdm_sync.sync_tables(sync, dev).xc_tmpl
        args = (exts, tmpl, ofdm_sync._xc_span(len(tmpl)),
                sync.block_size + 2 * M + 1)
        err = b1_vs_plain(args, what)
    else:
        args = (exts, M // 4, 2 * M - M // 4, M, sync.block_size,
                sync.threshold, sync.max_frames)
        err = b2_vs_plain(args, what)
    fn = getattr(kernels, kernel)
    us = kernel_device_us(lambda: fn(*args), KERNELS[kernel]["kernel"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        open_window()
        for _ in bs.dispatches(cfg, noisy):
            pass
        torch.cuda.synchronize()
    seen = sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and KERNELS[kernel]["kernel"] in e.key)
    kernels.reset_launch_counts()
    return (bs.row(sc, snr), sc, sec, n, {k: (n if k == kernel else 0)
                                          for k in kernels.launches}), \
        us, err, (seen, n)


def run_fidelity(dev, label):
    """Phase 28: the port's BER/PER sweep (``apps/ber_sweep.py``) on the
    card at the sweep's own configs, held to the JAX curves: (a) uncoded
    OFDM (level 1, B1), flexframe and GMSK at 200 frames over each JAX
    waterfall under rule (a); (b) OFDM at levels 0, 1 (B1) and 2 (B2) on
    the same noisy streams at the two points that bracket 10 % PER: level
    1 within a frame of level 0's detections and at most
    ``FID_LEVEL_FLIPS`` flips of ``payload_valid``, B1 and B2 launched once
    in every dispatch (the wrappers' counts) and held to their plain
    versions at the sweep's shapes (``fid_profiled``); (c) v27 soft
    for each family at one waterfall point, soft and hard on one stream,
    both under rule (a) against their JAX curves, soft PER below hard.
    Returns (the runs' launch counts, the sweep's B1 and B2 launches)."""
    from liquid_usrp_tpu_torch.apps import ber_sweep as bs
    t_phase = time.perf_counter()
    runs, sweep = [], {"detect_metric_xcorr_onepass": 0,
                       "detect_candidates_onepass": 0}

    def count(launches, level_kernel=None):
        runs.append(launches)
        other = {k: v for k, v in launches.items()
                 if k in KERNELS and k != level_kernel and v}
        if other:
            raise AssertionError(f"the sweep launched {other}")
        if level_kernel is not None:
            sweep[level_kernel] += launches[level_kernel]

    b1, b2 = "detect_metric_xcorr_onepass", "detect_candidates_onepass"
    noisy_ofdm = {}
    for fam in ("ofdm", "flex", "gmsk"):
        rows = jax_curve(fam)
        cfg = bs.make_config(fam, FID_PAYLOAD)
        t0 = time.perf_counter()
        stream = bs.build_stream(cfg, FID_FRAMES, 0, dev)
        t_tx = time.perf_counter() - t0
        for snr in waterfall_points(rows):
            noisy = bs.add_noise(stream, snr)
            if fam == "ofdm":
                noisy_ofdm[snr] = (stream, noisy)
            row, _, sec, n_disp, launches = fid_point(bs, cfg, stream, noisy,
                                                      snr, dev)
            count(launches, b1 if fam == "ofdm" else None)
            per_w = rule_a(f"{fam} uncoded", row, rows)
            print(fid_line(f"fidelity {fam} uncoded", row,
                           fid_jax_row(rows, snr), sec)
                  + f", {n_disp} dispatches; rule (a) PER window "
                  f"[{per_w[0]:.3f}, {per_w[1]:.3f}]", flush=True)
        print(f"fidelity {fam}: {FID_FRAMES} frames built on {dev} in "
              f"{t_tx:.2f} s", flush=True)

    rows = jax_curve("ofdm")
    for snr in FID_LEVEL_SNRS:
        stream, noisy = noisy_ofdm[snr]        # points of (a)'s waterfall
        got, dev_us, errs, traced = {}, {}, {}, {}
        for level, kernel in ((0, None), (1, b1), (2, b2)):
            cfg = bs.make_config("ofdm", FID_PAYLOAD, use_pallas=level)
            if kernel is None:
                got[level] = fid_point(bs, cfg, stream, noisy, snr, dev)
            else:
                got[level], dev_us[level], errs[level], traced[level] = \
                    fid_profiled(bs, cfg, stream, noisy, snr, dev, kernel)
            count(got[level][4], kernel)
        (r0, s0, *_), (r1, s1, *_), (r2, s2, *_) = (got[0], got[1], got[2])
        p0 = r0["packet_error_rate"]
        flips1 = int((s1.frame_ok != s0.frame_ok).sum())
        flips2 = int((s2.frame_ok != s0.frame_ok).sum())
        print(f"fidelity ofdm levels at {snr} dB on one noisy stream: "
              f"detected {r0['frames_detected']} / {r1['frames_detected']} /"
              f" {r2['frames_detected']}, PER {p0:.3f} / "
              f"{r1['packet_error_rate']:.3f} / {r2['packet_error_rate']:.3f}"
              f" (levels 0 / 1 / 2; JAX level 0 "
              f"{fid_jax_row(rows, snr)['packet_error_rate']:.3f}); "
              f"payload_valid flips against level 0: {flips1} (level 1, "
              f"limit {FID_LEVEL_FLIPS}), {flips2} (level 2); B1 and B2 once "
              f"in each of {got[1][3]} / {got[2][3]} dispatches by the "
              f"wrappers' counts; at the sweep's shapes against the plain "
              f"versions {errs[1]:.3e} / {errs[2]:.3e}, {DEVICE_ITERS} of "
              f"{DEVICE_ITERS} launches in the profiler "
              f"({dev_us[1]:.2f} / {dev_us[2]:.2f} us each); the profiler "
              f"over the path saw {traced[1][0]} / {traced[2][0]} kernel "
              f"records in {traced[1][1]} / {traced[2][1]} dispatches; "
              f"{got[0][2]:.2f} / {got[1][2]:.2f} / {got[2][2]:.2f} s",
              flush=True)
        if abs(r1["frames_detected"] - r0["frames_detected"]) > 1:
            raise AssertionError(f"level 1 detected {r1['frames_detected']}"
                                 f", level 0 {r0['frames_detected']}")
        if flips1 > FID_LEVEL_FLIPS:
            raise AssertionError(f"level 1's payload_valid differs from "
                                 f"level 0's in {flips1} frames (limit "
                                 f"{FID_LEVEL_FLIPS})")

    print(f"fidelity v27 soft: {FID_SOFT_FRAMES} frames a point"
          + ("" if FID_SOFT_FRAMES == FID_FRAMES else
             f" (cut from {FID_FRAMES} to fit the phase's time)"), flush=True)
    for fam, snr in FID_SOFT_SNR.items():
        soft_rows = jax_curve(f"{fam}_v27_soft")
        hard_rows = jax_curve(f"{fam}_v27_hard")
        soft = bs.make_config(fam, FID_PAYLOAD, "v27", "none", soft=True)
        hard = bs.make_config(fam, FID_PAYLOAD, "v27", "none")
        stream = bs.build_stream(soft, FID_SOFT_FRAMES, 0, dev)
        noisy = bs.add_noise(stream, snr)
        out = {}
        for what, cfg, rows in (("soft", soft, soft_rows),
                                ("hard", hard, hard_rows)):
            row, _, sec, n_disp, launches = fid_point(bs, cfg, stream, noisy,
                                                      snr, dev)
            count(launches, b1 if fam == "ofdm" else None)
            per_w = rule_a(f"{fam} v27 {what}", row, rows)
            out[what] = row
            print(fid_line(f"fidelity {fam} v27 {what}", row,
                           fid_jax_row(rows, snr), sec)
                  + f", {n_disp} dispatches; rule (a) PER window "
                  f"[{per_w[0]:.3f}, {per_w[1]:.3f}]", flush=True)
        if not (out["soft"]["packet_error_rate"] <
                out["hard"]["packet_error_rate"]):
            raise AssertionError(f"{fam} v27 at {snr} dB: soft PER "
                                 f"{out['soft']['packet_error_rate']} not "
                                 f"below hard "
                                 f"{out['hard']['packet_error_rate']}")
    # fault C6: the payload bits of every matched detection count, header
    # valid or not, so where headers fail the BER holds the conv/RS bytes
    # of header-invalid rows (decoded as JAX decodes them)
    rows = jax_curve("gmsk_v27_hard")
    hard = bs.make_config("gmsk", FID_PAYLOAD, "v27", "none")
    stream = bs.build_stream(hard, FID_FRAMES, 0, dev)
    for snr in FID_INVALID_SNRS:
        row, _, sec, n_disp, launches = fid_point(
            bs, hard, stream, bs.add_noise(stream, snr), snr, dev)
        count(launches)
        print(fid_line("fidelity gmsk v27 hard, header-invalid rows decoded",
                       row, fid_jax_row(rows, snr), sec)
              + f", {n_disp} dispatches", flush=True)
    print(f"fidelity on {label}: every point within rule (a); the sweep "
          f"launched B1 {sweep[b1]} and B2 {sweep[b2]} times, B3-B5 0; the "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return runs, sweep


# ---------------------------------------------------------------------------
# phase 29: every OFDM size the JAX package takes
# ---------------------------------------------------------------------------

def lm_kernels(m, exts, params):
    """B1, B2 and B3 against their plain versions on the extended windows
    ``exts`` of M = ``m`` (the limits of phase 3); then the times of the
    kernel of ``LM_CONFIGS[m]``, whose wrapper launches ``LM_KERNELS``."""
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    from liquid_usrp_tpu_torch.ops import kernels
    tmpl = np.tile(params.s0_time, 2)
    span = ofdm_sync._xc_span(len(tmpl))
    lag, L = m // 4, 2 * m - m // 4
    b1_args = (exts, tmpl, span, SC_BLOCK + 2 * m + 1)
    b2_args = (exts, lag, L, m, SC_BLOCK, 0.5, 8)
    shape = tuple(exts.shape)
    errs = {"detect_metric_xcorr_onepass":
            b1_vs_plain(b1_args, f"B1 at M={m} {shape}"),
            "detect_candidates_onepass":
            b2_vs_plain(b2_args, f"B2 at M={m} {shape}"),
            "detect_metric_onepass":
            metric_vs_plain("detect_metric_onepass", kernels.autocorr_metric,
                            1e-4, exts, m, f"B3 at M={m} {shape}")}
    name = LM_CONFIGS[m][2]
    if name == "detect_metric_xcorr_onepass":
        plain, args = kernels.detect_metric_xcorr_plain, b1_args
        nf = work(name, *shape, n_metric=b1_args[3], tmpl=tmpl, span=span)
    elif name == "detect_candidates_onepass":
        plain, args = kernels.detect_candidates_plain, b2_args
        nf = work(name, *shape, span=L, lag=lag)
    else:
        plain, args = kernels.autocorr_metric, (exts, lag, L)
        nf = work(name, *shape, span=L, lag=lag)
    return timed(name, getattr(kernels, name), plain, args, errs[name], nf,
                 shape, label=f"{name} at M={m}", kernel=lm_names(name, m))


def lm_names(name, m):
    """The CUDA kernels of ``LM_KERNELS[name]`` that a call launches at M
    = ``m`` (B2's chunk totals only where a block is more than one
    chunk)."""
    if name != "detect_candidates_onepass":
        return LM_KERNELS[name]
    from liquid_usrp_tpu_torch.ops import kernels
    names = kernels.candidates_kernels(m // 4, 2 * m - m // 4, m)
    if not set(names) <= set(LM_KERNELS[name]):
        raise AssertionError(f"B2 at M={m} launches {names}")
    return names


def lm_redesign(dev):
    """B1's period fold at ``LM_FOLD_SIZES``, B2's window sums at
    ``LM_B2_SIZES`` and B3's at ``LM_W3_SIZES`` and ``LM_W3_SHORT``, on
    windows of the single-channel path's first dispatch at each M (its
    shape, ``[SC_BATCH, overlap + SC_BLOCK]``): seeded 0.01-rms noise with
    the S0 template at an offset of each row that the outputs reach, and
    in row 0 a +40 dB copy of it before quiet noise (B2's detect region
    ``[M, n_out - M)``, which holds every row's template).  Each against
    its plain version (the limits of phase 3), B1's fold path and B2's
    window-sum path taken and counted, and timed (device time of the
    path's kernels, bound, share).  Returns {label: timed entry}."""
    from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
    from liquid_usrp_tpu_torch.ops import kernels
    out = {}
    gen = np.random.default_rng(2912)

    def windows(m):
        params = ofdm.make_ofdm_params(m, m // 8, TAPER)
        tmpl = np.tile(params.s0_time, 2).astype(np.complex64)
        sync = ofdm_sync.make_sync(params, block_size=SC_BLOCK,
                                   max_payload=SC_MAX_PAYLOAD)
        shape = (SC_BATCH, sync.overlap + SC_BLOCK)
        x = (0.01 * (gen.normal(size=shape) + 1j * gen.normal(size=shape))
             ).astype(np.complex64)
        x[0, 100:100 + len(tmpl)] += 100.0 * tmpl
        for r in range(SC_BATCH):
            pos = 3 * len(tmpl) + 611 * r
            x[r, pos:pos + len(tmpl)] += tmpl
        return params, tmpl, torch.as_tensor(x, device=dev)

    name = "detect_metric_xcorr_onepass"
    for m in LM_FOLD_SIZES:
        params, tmpl, exts = windows(m)
        span = ofdm_sync._xc_span(len(tmpl))
        args = (exts, tmpl, span, SC_BLOCK + 2 * m + 1)
        shape = tuple(exts.shape)
        kernels.reset_launch_counts()
        err = b1_vs_plain(args, f"B1 fold at M={m} {shape}")
        if kernels.xcorr_paths["fold"] != 1:
            raise AssertionError(f"B1 at M={m} took {kernels.xcorr_paths}")
        out[f"B1 M={m}"] = timed(
            name, kernels.detect_metric_xcorr_onepass,
            kernels.detect_metric_xcorr_plain, args, err,
            work(name, *shape, n_metric=args[3], tmpl=tmpl, span=span),
            shape, label=f"B1 period fold at M={m}",
            kernel=LM_KERNELS[name], plain_iters=LM_PLAIN_ITERS)
    name = "detect_candidates_onepass"
    for m in LM_B2_SIZES:
        exts = windows(m)[2]
        shape = tuple(exts.shape)
        lag, span = m // 4, 2 * m - m // 4
        args = (exts, lag, span, m, shape[1] - span - lag + 1 - 2 * m, 0.5,
                8)
        kernels.reset_launch_counts()
        err = b2_vs_plain(args, f"B2 window sums at M={m} {shape}")
        if kernels.cand_paths["window_sums"] != 1:
            raise AssertionError(f"B2 at M={m} took {kernels.cand_paths}")
        out[f"B2 M={m}"] = timed(
            name, kernels.detect_candidates_onepass,
            kernels.detect_candidates_plain, args, err,
            work(name, *shape, span=span, lag=lag), shape,
            label=f"B2 window sums at M={m}", kernel=lm_names(name, m),
            plain_iters=LM_PLAIN_ITERS)
    name = "detect_metric_onepass"
    geoms = [(m, m // 4, 2 * m - m // 4) for m in LM_W3_SIZES]
    geoms.append((M, *LM_W3_SHORT))
    for m, lag, span in geoms:
        exts = windows(m)[2]
        shape = tuple(exts.shape)
        what = f"M={m}" if m != M else f"lag={lag} span={span}"
        err = metric_vs_plain(name, kernels.autocorr_metric, 1e-4, exts, m,
                              f"B3 window sums at {what} {shape}", lag=lag,
                              span=span)
        kern = LM_KERNELS[name] if span > 9 else ("w3_direct_kernel",)
        out[f"B3 {what}"] = timed(
            name, kernels.detect_metric_onepass, kernels.autocorr_metric,
            (exts, lag, span), err, work(name, *shape, span=span, lag=lag),
            shape, label=f"B3 window sums at {what}", kernel=kern,
            plain_iters=LM_PLAIN_ITERS)
    return out


def lm_sweep(dev):
    """Launch-only: at every M of ``LM_SWEEP`` the kernel of each detect
    level that M reaches (B1 at level 1, B2 at level 2 from M = 32, B3
    below it and on the legacy detector) returns finite output of its
    shape on 2 rows of seeded noise."""
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    from liquid_usrp_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(29)
    for m in LM_SWEEP:
        n = 4 * m + LM_SWEEP_BLOCK
        x = torch.randn((2, n), dtype=torch.complex64, device=dev,
                        generator=gen)
        lag, span = m // 4, 2 * m - m // 4
        tmpl = np.exp(2j * np.pi * np.arange(2 * m) / 4).astype(np.complex64)
        n_metric = LM_SWEEP_BLOCK + 2 * m + 1
        outs = [(kernels.detect_metric_xcorr_onepass(
            x, tmpl, ofdm_sync._xc_span(2 * m), n_metric), (2, n_metric))]
        outs += [(v, (2, n - span - lag + 1))
                 for v in kernels.detect_metric_onepass(x, lag, span)]
        if m >= 32:
            outs += [(v, (2, 8)) for v in kernels.detect_candidates_onepass(
                x, lag, span, m, LM_SWEEP_BLOCK, 0.5, 8)]
        torch.cuda.synchronize()
        for out, want in outs:
            if tuple(out.shape) != want or not bool(
                    torch.isfinite(out).all()):
                raise AssertionError(f"sweep at M={m}: an output of shape "
                                     f"{tuple(out.shape)} (want {want}) or "
                                     f"not finite")
    print(f"launch-only sweep: {len(LM_SWEEP)} sizes (M = 8..4,096 by 4, "
          f"6,144, 8,192), B1 and B3 at each and B2 from M = 32: finite "
          f"outputs of their shapes, {time.perf_counter() - t0:.1f} s",
          flush=True)


def lm_sync_rows(sync, stream, device):
    """Every detected row of ``stream`` through ``sync_block`` block by
    block on ``device`` (zero-padded to whole blocks, an overlap and a
    block after it), as host dicts in stream order."""
    from liquid_usrp_tpu_torch.framing import ofdm_sync
    bs = sync.block_size
    n_blk = -(-(len(stream) + sync.overlap) // bs) + 1
    x = np.zeros(n_blk * bs, np.complex64)
    x[:len(stream)] = stream
    st = ofdm_sync.sync_init(sync, device)
    rows = []
    for b in range(n_blk):
        st, res = ofdm_sync.sync_block(
            sync, st, torch.as_tensor(x[b * bs:(b + 1) * bs], device=device))
        res = {f: v.cpu().numpy() for f, v in res._asdict().items()}
        for k in np.nonzero(res["detected"])[0]:
            rows.append({f: res[f][k] for f in (
                "t_start", "header_valid", "payload_valid", "header",
                "payload_len", "payload", "cfo")})
    return sorted(rows, key=lambda r: int(r["t_start"]))


def lm_decode(m, stream, sent, dev):
    """``sync_block`` on the card at M = ``m`` and its ``LM_CONFIGS``
    detect config: every sent frame payload-exact, the kernel launched,
    and the rows of the port's CPU path on the same samples (t_start,
    flags, valid headers and payloads exact; cfo within 1e-5)."""
    from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
    from liquid_usrp_tpu_torch.ops import kernels
    xcorr, level, name = LM_CONFIGS[m]
    sync = ofdm_sync.make_sync(
        ofdm.make_ofdm_params(m, m // 8, TAPER), block_size=LM_BLOCK,
        max_payload=LM_MAX_PAYLOAD, max_frames=4, use_pallas=level,
        xcorr_detect=xcorr)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = lm_sync_rows(sync, stream, dev)
    card_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    if launches[name] <= 0:
        raise AssertionError(f"M={m}: {name} was not launched")
    if name == "detect_candidates_onepass" and \
            kernels.cand_paths["window_sums"] != launches[name]:
        raise AssertionError(f"M={m}: B2 took {kernels.cand_paths}")
    frames = [dict(header=r["header"], payload_valid=bool(r["payload_valid"]),
                   payload=r["payload"][:int(r["payload_len"])])
              for r in got]
    check_sc_frames(f"sync_block at M={m} on the card", frames, sent)
    want = lm_sync_rows(sync, stream, "cpu")
    if [int(r["t_start"]) for r in got] != [int(r["t_start"])
                                            for r in want]:
        raise AssertionError(f"M={m}: the card's rows start elsewhere than "
                             f"the CPU's")
    for g, w in zip(got, want):
        same = (g["header_valid"] == w["header_valid"] and
                g["payload_valid"] == w["payload_valid"] and
                abs(float(g["cfo"]) - float(w["cfo"])) <= 1e-5 and
                (not g["header_valid"] or
                 np.array_equal(g["header"], w["header"])) and
                (not g["payload_valid"] or
                 np.array_equal(g["payload"], w["payload"])))
        if not same:
            raise AssertionError(f"M={m}: the row at {int(g['t_start'])} "
                                 f"differs from the CPU's")
    print(f"sync_block at M={m} (xcorr_detect={xcorr}, use_pallas={level}) "
          f"on the card: {len(sent)}/{len(sent)} payload-exact in "
          f"{card_s:.2f} s, {len(got)} rows equal to the CPU's; {name} "
          f"launched {launches[name]} times", flush=True)
    return launches


def rob_blocks(rng):
    """tests/test_robustness.py's adversarial blocks."""
    t = np.arange(ROB_BLOCK)
    return {
        "zeros": np.zeros(ROB_BLOCK, np.complex64),
        "dc": np.full(ROB_BLOCK, 0.7 + 0.3j, np.complex64),
        "tone": np.exp(2j * np.pi * 0.1251 * t).astype(np.complex64),
        "alias_tone": np.exp(2j * np.pi * t / 12).astype(np.complex64),
        "impulses": (np.where(t % 257 == 0, 1000.0, 0.0) + 0j
                     ).astype(np.complex64),
        "amp_step": np.where(t < ROB_BLOCK // 2, 1e-6, 1e6).astype(
            np.complex64) * np.exp(1j * 0.3),
        "denormal": (1e-38 * (rng.normal(size=ROB_BLOCK) +
                              1j * rng.normal(size=ROB_BLOCK))
                     ).astype(np.complex64),
    }


def lm_robustness(dev):
    """tests/test_robustness.py's OFDM promises at detect levels 1 (B1)
    and 2 (B2) on the card: two blocks of each adversarial kind from a
    fresh state validate nothing and leave the state finite; after a
    NaN/Inf block and a flush block, a clean frame decodes payload-exact
    (and nothing else)."""
    from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
    from liquid_usrp_tpu_torch.ops import kernels
    params = ofdm.make_ofdm_params(M, CP, TAPER)
    runs = []
    for level, name in ((1, "detect_metric_xcorr_onepass"),
                        (2, "detect_candidates_onepass")):
        sync = ofdm_sync.make_sync(params, block_size=ROB_BLOCK,
                                   max_payload=64, max_frames=4,
                                   use_pallas=level)
        kernels.reset_launch_counts()
        for tag, blk in rob_blocks(np.random.default_rng(29)).items():
            st = ofdm_sync.sync_init(sync, dev)
            for _ in range(2):
                st, res = ofdm_sync.sync_block(
                    sync, st, torch.as_tensor(blk, device=dev))
            if bool(res.payload_valid.any()) or not bool(
                    torch.isfinite(st.tail).all()):
                raise AssertionError(f"level {level}, {tag}: a false frame "
                                     f"or non-finite state")
        rng = np.random.default_rng(30)
        header = rng.integers(0, 256, 8, dtype=np.uint8)
        payload = rng.integers(0, 256, 48, dtype=np.uint8)
        burst = ofdm.assemble_frame(params, ofdm.default_props(),
                                    torch.as_tensor(header),
                                    torch.as_tensor(payload)).numpy()
        clean = np.zeros(ROB_BLOCK, np.complex64)
        clean[500:500 + len(burst)] = burst
        clean += (0.005 * (rng.normal(size=ROB_BLOCK) + 1j *
                           rng.normal(size=ROB_BLOCK))).astype(np.complex64)
        st = ofdm_sync.sync_init(sync, dev)
        st, _ = ofdm_sync.sync_block(sync, st, torch.as_tensor(
            np.full(ROB_BLOCK, np.nan + 1j * np.inf, np.complex64),
            device=dev))
        got = []
        zero = np.zeros(ROB_BLOCK, np.complex64)
        for blk in (zero, clean, zero, zero):
            st, res = ofdm_sync.sync_block(sync, st,
                                           torch.as_tensor(blk, device=dev))
            for k in torch.nonzero(res.payload_valid).flatten().tolist():
                got.append(res.payload[k][:int(res.payload_len[k])].cpu()
                           .numpy())
        if len(got) != 1 or not np.array_equal(got[0], payload):
            raise AssertionError(f"level {level}: {len(got)} frames after "
                                 f"the NaN/Inf block")
        if kernels.launches[name] <= 0:
            raise AssertionError(f"level {level}: {name} was not launched")
        runs.append(dict(kernels.launches))
        print(f"robustness at level {level} on the card: "
              f"{len(rob_blocks(rng))} adversarial kinds, no false frame, "
              f"finite state; the frame after the NaN/Inf block "
              f"payload-exact; {name} launched {kernels.launches[name]} "
              f"times", flush=True)
    return runs


def run_large_m(dev, label):
    """Phase 29: B1-B3 at the sizes where they leave their M=48 tilings,
    held to their plain versions at the app's shapes and timed; the
    launch-only sweep; ``sync_block`` on the card at M = 512, 1,028 and
    1,152; the robustness blocks at levels 1 and 2; ``ofdmflexframe_rx``
    and ``multichannel_rx`` at ``-M 1028``.  Returns (launches per run,
    the kernels' times by M)."""
    from liquid_usrp_tpu_torch.apps import (multichannel_rx, multichannel_tx,
                                            ofdmflexframe_rx)
    from liquid_usrp_tpu_torch.framing import ofdm
    from liquid_usrp_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    runs, times = [], {}
    with tempfile.TemporaryDirectory() as tmpdir:
        for m in LM_CONFIGS:
            path = str(Path(tmpdir) / f"ofdm{m}.iq")
            stream, sent = sc_transmit(path, m, m // 8, LM_FRAMES,
                                       LM_PAYLOAD)
            params = ofdm.make_ofdm_params(m, m // 8, TAPER)
            # the app's first dispatch: the file, then 0.01-rms noise
            rng = np.random.default_rng(m)
            n = SC_BATCH * SC_BLOCK
            padded = (0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))
                      ).astype(np.complex64)
            padded[:len(stream)] += stream[:n]
            times[m] = lm_kernels(m, sc_windows(params, padded, dev),
                                  params)
            runs.append(lm_decode(m, stream, sent, dev))
        sizes = lm_redesign(dev)
        lm_sweep(dev)
        runs += lm_robustness(dev)
        kernels.reset_launch_counts()
        text = run_app(ofdmflexframe_rx.main,
                       ["-i", str(Path(tmpdir) / "ofdm1028.iq"), "-M",
                        "1028", "-C", "128", "-T", str(TAPER), "-q"])
        n_of = app_count(text, "valid packets")
        mc = str(Path(tmpdir) / "mc1028.iq")
        run_app(multichannel_tx.main, ["-o", mc, "-n", "2", "-N", "3",
                                       "-P", str(LM_PAYLOAD), "-M", "1028",
                                       "-C", "128"])
        text = run_app(multichannel_rx.main, ["-i", mc, "-n", "2", "-M",
                                              "1028", "-C", "128"])
        n_mc = app_count(text, "valid packets")
        runs.append(dict(kernels.launches))
        if n_of != LM_FRAMES or n_mc != 6:
            raise AssertionError(f"-M 1028: ofdmflexframe_rx {n_of}/"
                                 f"{LM_FRAMES}, multichannel_rx {n_mc}/6 "
                                 f"valid")
        if runs[-1]["detect_metric_xcorr_onepass"] <= 0:
            raise AssertionError("-M 1028: B1 was not launched")
    print(f"-M 1028 on the card: ofdmflexframe_rx {n_of}/{LM_FRAMES} and "
          f"multichannel_rx {n_mc}/6 valid (B1 launched "
          f"{runs[-1]['detect_metric_xcorr_onepass']} times)", flush=True)
    print("large M on " + label + ", kernel device time (us), bound (us, "
          "by), share: " + "; ".join(
              f"{t_name} at M={m} {t['kernel_ms'] * 1e3:.2f}, "
              f"{t['bound_ms'] * 1e3:.2f} ({t['bound_by']}), "
              f"{t['bound_ms'] / t['kernel_ms']:.1%}"
              for m, t in times.items()
              for t_name in [LM_CONFIGS[m][2]]) +
          f"; phase 29 {time.perf_counter() - t0:.1f} s", flush=True)
    print("redesigned paths on " + label + ", kernel device time (us), "
          "bound (us, by), share: " + "; ".join(
              f"{what} {t['kernel_ms'] * 1e3:.2f}, "
              f"{t['bound_ms'] * 1e3:.2f} ({t['bound_by']}), "
              f"{t['bound_ms'] / t['kernel_ms']:.1%}"
              for what, t in sizes.items()), flush=True)
    return runs, times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import liquid_usrp_tpu_torch
    here = Path(__file__).resolve().parent
    if Path(liquid_usrp_tpu_torch.__file__).resolve().parent.parent != here:
        print("chip_smoke: liquid_usrp_tpu_torch is not the checkout beside "
              "this script", file=sys.stderr)
        return 1
    from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync
    from liquid_usrp_tpu_torch.models.multichannel import Mcrx
    from liquid_usrp_tpu_torch.ops import _build
    t_start = time.perf_counter()
    label = card()
    print(label, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    _build.load_library()
    info = _build.build_info()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({'built' if info['built'] else 'cached'} {info['path']})",
          flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    params = ofdm.make_ofdm_params(M, CP, TAPER)
    props = ofdm.default_props()
    sync1 = ofdm_sync.make_sync(params, block_size=BLOCK,
                                max_payload=MAX_PAYLOAD,
                                max_frames=MAX_FRAMES, use_pallas=1)
    margin = sync1.overlap + 8 * M
    total = BLOCK * N_BLOCKS
    t0 = time.perf_counter()
    mixture, payloads = build_mixture(params, props, total, margin, dev)
    nrng = np.random.default_rng(1)
    noise = (nrng.normal(size=mixture.shape) +
             1j * nrng.normal(size=mixture.shape)).astype(np.complex64)
    g = 2 * N * BLOCK * N_BLOCKS
    blocks = torch.as_tensor((mixture + 0.01 * noise).reshape(g), device=dev)
    # the same frames and noise, each channel offset by its CFOS entry
    cfo_mixture, _ = build_mixture(params, props, total, margin, dev, CFOS)
    cfo_blocks = torch.as_tensor((cfo_mixture + 0.01 * noise).reshape(g),
                                 device=dev)
    flush = torch.as_tensor((0.01 * (nrng.normal(size=g) + 1j *
                                     nrng.normal(size=g))
                             ).astype(np.complex64), device=dev)
    weights = np.random.default_rng(0xF1B5).integers(
        0, 1 << 32, MAX_PAYLOAD, dtype=np.uint32)
    expected = expected_fingerprints(payloads, weights)
    print(f"mixtures: {len(mixture)} samples, {sum(expected[0])} frames "
          f"({expected[0]} per channel), without and with CFO {CFOS}, "
          f"built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    times = check_kernels(sync1, Mcrx(N, sync1, N_BLOCKS, dev), blocks)
    times["viterbi"] = check_viterbi_kernel(dev)
    times["nearest"] = check_nearest_kernel(dev)

    launches, step_ms, path_runs = {}, {}, []
    for level in (0, 1, 2):
        lv_launch, step_ms[level] = run_level(
            level, params, (blocks, cfo_blocks), flush, weights, expected,
            dev, label)
        path_runs.append(lv_launch)
        for name, k in KERNELS.items():
            if k["level"] == level:
                launches[name] = lv_launch[name]

    check_class_entry(dev)
    print(f"main path ms/step by level {step_ms}", flush=True)

    with tempfile.TemporaryDirectory() as tmpdir:
        sc_path = str(Path(tmpdir) / "ofdmflexframe.iq")
        stream, sent = sc_transmit(sc_path)
        times.update(check_autocorr_kernels(sc_windows(params, stream,
                                                       dev)))
        sc_launches, _ = run_single_channel(stream, sent, sc_path, dev,
                                            label)
        path_runs += [*sc_launches.values(),
                      check_debug_print(stream, dev, tmpdir)]
    path_runs.append(run_mcrx_m16(noise, flush, weights, dev))
    with tempfile.TemporaryDirectory() as tmpdir:
        ff_runs = [run_flexframe(dev, tmpdir, label),
                   run_packet(dev, tmpdir)]
    # the flexframe and packet paths run no kernel
    for name in KERNELS:
        n = sum(run[name] for run in ff_runs)
        if n != 0:
            raise AssertionError(f"{name} was launched {n} times by the "
                                 f"flexframe and packet paths")
    print(f"flexframe and packet paths: B1-B5 launched 0 times "
          f"({', '.join(KERNELS)})", flush=True)
    path_runs += ff_runs
    with tempfile.TemporaryDirectory() as tmpdir:
        gm_runs = [run_gmsk(dev, tmpdir, label),
                   run_conv(dev, tmpdir, label)]
        ofdm_conv = run_ofdm_conv(tmpdir)
        ofdm_v27 = run_ofdm_v27(tmpdir)
    # the GMSK path and the conv/RS layer run no kernel
    for name in KERNELS:
        n = sum(run[name] for run in gm_runs)
        if n != 0:
            raise AssertionError(f"{name} was launched {n} times by the "
                                 f"GMSK and conv runs")
    print(f"GMSK and conv runs: B1-B5 launched 0 times "
          f"({', '.join(KERNELS)}); the OFDM --conv run, on the OFDM "
          f"path's detector: {ofdm_conv}", flush=True)
    path_runs += gm_runs + [ofdm_conv, ofdm_v27]
    with tempfile.TemporaryDirectory() as tmpdir:
        soft_ops, demap = soft_ops_vs_cpu(dev, tmpdir, label)
        soft_runs, soft_times = run_soft(dev, tmpdir, label)
        soft_ofdm = run_soft_ofdm(dev, tmpdir)
        a13 = run_a13(dev, tmpdir, label)
    duplex = run_duplex(label)
    # the soft GMSK and flexframe runs and the A13 ops run no kernel; the
    # soft OFDM run and the duplex CLIs run the OFDM detector, B1, only
    for name in KERNELS:
        n = soft_ops[name] + soft_runs[name] + a13[name]
        if n != 0:
            raise AssertionError(f"{name} was launched {n} times by the "
                                 f"soft and A13 runs")
    for what, run in (("soft OFDM", soft_ofdm), ("duplex", duplex)):
        other = {k: v for k, v in run.items()
                 if k in KERNELS and k != "detect_metric_xcorr_onepass" and v}
        if other:
            raise AssertionError(f"the {what} runs launched {other}")
    print(f"soft and A13 runs: B1-B5 launched 0 times; the soft OFDM run "
          f"{soft_ofdm} and the duplex runs {duplex}, B1 only", flush=True)
    print(f"soft timings on {label}: GMSK --conv --soft dispatch "
          f"{soft_times['soft']:.3f} ms vs --conv {soft_times['hard']:.3f} "
          f"ms; soft demapper at the flexframe dispatch {demap[0]:.3f} ms, "
          f"peak {demap[1]:.1f} MB", flush=True)
    path_runs += [soft_ops, soft_runs, soft_ofdm, a13, duplex]
    # phase 28 runs here, before the threads and worlds of phases 24-27
    fid_runs, fid_sweep = run_fidelity(dev, label)
    path_runs += fid_runs
    for name, n in fid_sweep.items():
        launches[name] += n
    lm_runs, _ = run_large_m(dev, label)
    path_runs += lm_runs
    with tempfile.TemporaryDirectory() as tmpdir:
        stream_launch, stream_ctx = run_streaming(blocks, flush, weights,
                                                  expected, dev, tmpdir,
                                                  label)
        wlan_launch, wlan_ctx = run_wlan(dev, tmpdir, label)
        time_streaming(stream_ctx, dev, label)
        time_wlan(wlan_ctx, dev, label)
        par_launch = run_parallel(dict(
            blocks=blocks, flush=flush, noise=noise, weights=weights,
            expected=expected, mixture=mixture,
            tx_streams=bench_streams(params, props, total, margin, dev)[0],
            wlan_stream=wlan_ctx["default"]), dev, tmpdir, label)
    # the streaming runs detect with B1 (and only B1); WLAN runs no kernel
    for what, run in stream_launch.items():
        other = {k: v for k, v in run.items()
                 if k in KERNELS and k != "detect_metric_xcorr_onepass" and v}
        if other or run["detect_metric_xcorr_onepass"] <= 0:
            raise AssertionError(f"the {what} runs launched {run}")
    if any(wlan_launch.values()):
        raise AssertionError(f"the WLAN runs launched {wlan_launch}")
    b1 = {k: v["detect_metric_xcorr_onepass"]
          for k, v in stream_launch.items()}
    print(f"streaming runs: B1 only, launched {b1}; WLAN runs: B1-B5 "
          f"launched 0 times", flush=True)
    path_runs += [*stream_launch.values(), wlan_launch, *par_launch]
    # B3 is on the single-channel path (legacy detector, level 1); B4 and
    # B5 are on no path (the JAX package calls them only from tests): their
    # counts over every path run above must be 0
    launches["detect_metric_onepass"] = \
        sc_launches[(False, 1)]["detect_metric_onepass"]
    for name in ("detect_metric_fused_2d", "detect_metric_fused"):
        launches[name] = sum(run[name] for run in path_runs)
        if launches[name] != 0:
            raise AssertionError(f"{name}, on no path, was launched "
                                 f"{launches[name]} times by the paths")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"profiler windows: {PROFILER_SPINS['windows']}, each opened by "
          f"{SPIN_OPEN} spin kernels, {PROFILER_SPINS['seen']} of their "
          f"{PROFILER_SPINS['launched']} records seen (at least "
          f"{PROFILER_SPINS['least']} in a window), "
          f"{PROFILER_SPINS['retraced']} traced again", flush=True)

    print("kernel device time (us), bound (us, by), share: " + "; ".join(
        f"{name} {t['kernel_ms'] * 1e3:.2f}, {t['bound_ms'] * 1e3:.2f} "
        f"({t['bound_by']}), {t['bound_ms'] / t['kernel_ms']:.1%}"
        for name, t in times.items()), flush=True)
    # ms: the wrapper; kernel_ms: the CUDA kernel alone on the device.  No
    # single PyTorch call computes any of these metrics: library_ms null.
    vit = {k: v for k, v in VITERBI.items() if k != "kernel"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": launches[name],
         **times[name], "library_ms": None}
        for name, k in KERNELS.items()] + [
        {"name": "viterbi", "route": "cuda", **vit,
         "launches": ofdm_v27["viterbi"],
         **times["viterbi"], "library_ms": None},
        {"name": "nearest", "route": "cuda",
         **{k: v for k, v in NEAREST.items() if k != "kernel"},
         "launches": ofdm_v27["nearest"],
         **times["nearest"], "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
