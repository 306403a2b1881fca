"""The benchmark's result sink: a dispatch's ``FrameResults`` to the host in
one copy, and the reported frames as columns."""
from __future__ import annotations

import numpy as np
import torch


def to_host(res) -> dict:
    """The detected rows of a results tuple of device tensors (fields of
    shape ``[N, n_blocks, max_frames, ...]``), brought to the host in one
    device-to-host copy of all fields packed as bytes."""
    packed = torch.cat([v.contiguous().reshape(-1).view(torch.uint8)
                        for v in res]).cpu().numpy()
    out, off = {}, 0
    for name, v in zip(res._fields, res):
        n = v.numel() * v.element_size()
        dt = torch.empty(0, dtype=v.dtype).numpy().dtype
        out[name] = packed[off:off + n].view(dt).reshape(tuple(v.shape))
        off += n
    det = np.nonzero(out["detected"])
    rows = {k: v[det] for k, v in out.items()}
    rows["channel"] = det[0]
    return rows


def frame_rows(dispatches: list) -> dict:
    """Columns over every reported frame of ``dispatches`` (in order)."""
    if not dispatches:
        return {"channel": np.zeros(0, np.int64), "t": np.zeros(0, np.int64)}
    cols = {k: np.concatenate([d[k] for d in dispatches])
            for k in dispatches[0]}
    cols["t"] = cols.pop("t_start").astype(np.int64)
    cols["payload"] = list(cols["payload"])
    return cols
