"""The detect stage's share of its roofline: the least time its work takes
on the H100 (``profiling.xcorr_work``: the segmented S0 cross-correlation
metric at every detect offset of each extended window of a dispatch, the
samples it reaches and the template read once and the metric written
once; the larger of bytes over the HBM rate and float32
operations over the float32 peak) times the calls, over the device time of
the kernels that compute it on the timed path."""
import numpy as np

from .. import txgen
from ..profiling import bound, xcorr_work

# the CUDA kernels that compute the metric: one of the first two a call
CALLS = ("xcorr_metric_kernel", "xcorr_fold_kernel")
KERNELS = CALLS + ("xcorr_fold_sum_kernel",)
XC_SEG = 24                    # the longest coherence segment


def least_seconds(config: dict) -> float:
    p = txgen.ofdm_params(config["M"], config["cp_len"], config["taper_len"])
    tmpl = np.tile(p.s0_time, txgen.NUM_S0)
    span = max(s for s in range(1, min(XC_SEG, len(tmpl)) + 1)
               if len(tmpl) % s == 0)
    rows = config.get("num_channels", 1) * (config.get("n_blocks") or
                                            config["batch_blocks"])
    return bound(*xcorr_work(rows, config["block_size"] + 2 * p.M + 1,
                             tmpl, span))[0]


def read(trace, cell):
    ops = [o for o in trace.device if any(k in o.name for k in KERNELS)]
    calls = sum(1 for o in ops if any(k in o.name for k in CALLS))
    if not calls:
        return None
    busy = sum(o.end - o.start for o in ops) * 1e-6
    return 100.0 * calls * least_seconds(cell["config"]) / busy
