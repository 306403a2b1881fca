"""The exchange's share of its roofline on rank 0: the least time of the
bytes that the configuration's (time, channel) layout must move from rank
0 a dispatch, at NVLink 4's rate in one direction, times the dispatches,
over the device time of the NCCL kernels in rank 0's window (not the
``nccl:*`` ranges that the profiler mirrors onto the card's timeline
around each collective).

The bytes (``least_bytes``): rank 0's channelized samples of the other
channel shards' channels (the all-to-all), one sync overlap of its own
channels (the halo to the next time row) and one analysis-filter memory
(the halo to the next fine chunk), complex64.  The results' gather is left
out, so a change that gathers fewer bytes cannot push the share past 100 %.
An NCCL kernel spins while its peer is late, so the share reads lockstep
skew as well as the link's speed."""
from .. import txgen

# the H100 SXM's NVLink 4: 900 GB/s both ways (NVIDIA's H100 datasheet)
NVLINK_BYTES = 450e9           # one direction
SAMPLE = 8                     # complex64
KERNELS = ("ncclDevKernel", "ncclKernel")   # NCCL's kernels, by release


def least_bytes(config: dict) -> int:
    N = config["num_channels"]
    n_time, n_ch = config["mesh"]
    N_loc = N // n_ch
    B_sub = config["block_size"] * config["chunk_blocks"]
    a2a = B_sub * N_loc * (n_ch - 1) * SAMPLE
    sync_halo = N_loc * txgen.receiver_overlap(config) * SAMPLE
    ana_halo = 2 * N * 4 * (2 * config["analyzer_m"]) * SAMPLE
    return a2a + sync_halo + ana_halo


def read(trace, cell):
    busy = sum(o.end - o.start for o in trace.device
               if o.name.startswith(KERNELS)) * 1e-6
    if not busy:
        return None
    least = least_bytes(cell["config"]) / NVLINK_BYTES
    return 100.0 * trace.dispatches * least / busy
