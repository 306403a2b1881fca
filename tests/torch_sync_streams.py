"""Port-side helpers for the large-M and robustness tests: an OFDM stream of
frames at one subcarrier count, and the rows ``sync_block`` decodes from
it block by block on a device.  Imports no JAX, so the card's tests use it
too; pytest does not collect it."""
import numpy as np
import torch

from liquid_usrp_tpu_torch.framing import ofdm, ofdm_sync


def params_at(M: int):
    """The OFDM parameters of the large-M tests: cp = M/8, taper 4."""
    return ofdm.make_ofdm_params(M, M // 8, 4)


def frame_stream(M: int, n_frames: int, seed: int, payload: int = 48,
                 noise: float = 0.01):
    """``(stream, sent)``: ``n_frames`` frames (default props, random
    8-byte headers and ``payload``-byte payloads) with gaps of 1.5 frames,
    in complex Gaussian noise of rms ``noise`` per component;
    ``sent``: (start, header, payload) of each frame."""
    params = params_at(M)
    rng = np.random.default_rng(seed)
    frames, sent, pos = [], [], 3 * M
    for _ in range(n_frames):
        h = rng.integers(0, 256, 8, dtype=np.uint8)
        p = rng.integers(0, 256, payload, dtype=np.uint8)
        f = ofdm.assemble_frame(params, ofdm.default_props(),
                                torch.as_tensor(h),
                                torch.as_tensor(p)).numpy()
        frames.append((pos, f))
        sent.append((pos, h, p))
        pos += len(f) + 3 * len(f) // 2
    x = np.zeros(pos, np.complex64)
    for start, f in frames:
        x[start:start + len(f)] = f
    x += (noise * (rng.normal(size=pos) + 1j * rng.normal(size=pos))
          ).astype(np.complex64)
    return x, sent


def padded_blocks(sync, stream: np.ndarray) -> np.ndarray:
    """``stream`` zero-padded to whole blocks, one overlap and a block
    after its end (so every frame leaves the detect region), as
    ``[n_blocks, block_size]``."""
    bs = sync.block_size
    n_blk = -(-(len(stream) + sync.overlap) // bs) + 1
    x = np.zeros(n_blk * bs, np.complex64)
    x[:len(stream)] = stream
    return x.reshape(n_blk, bs)


def sync_rows(sync, stream: np.ndarray, device) -> list:
    """Every detected row of ``stream`` through ``sync_block`` block by
    block on ``device``, in stream order: dicts of ``t_start``,
    ``header_valid``, ``payload_valid``, ``header``, ``payload`` (its
    ``payload_len`` bytes) and ``cfo``."""
    st = ofdm_sync.sync_init(sync, device)
    rows = []
    for blk in padded_blocks(sync, stream):
        st, res = ofdm_sync.sync_block(sync, st,
                                       torch.as_tensor(blk, device=device))
        res = {f: v.cpu().numpy() for f, v in res._asdict().items()}
        for k in np.nonzero(res["detected"])[0]:
            rows.append(dict(
                t_start=int(res["t_start"][k]),
                header_valid=bool(res["header_valid"][k]),
                payload_valid=bool(res["payload_valid"][k]),
                header=res["header"][k],
                payload=res["payload"][k][:int(res["payload_len"][k])],
                cfo=float(res["cfo"][k])))
    return sorted(rows, key=lambda r: r["t_start"])


def assert_decodes_sent(rows: list, sent: list) -> None:
    """Every sent frame has one payload-valid row with its header and
    payload, and no other row is payload-valid."""
    valid = [r for r in rows if r["payload_valid"]]
    assert len(valid) == len(sent), (len(valid), len(sent))
    for r, (_, h, p) in zip(valid, sent):
        np.testing.assert_array_equal(r["header"], h)
        np.testing.assert_array_equal(r["payload"], p)


def assert_same_rows(got: list, want: list, cfo_atol: float = 1e-5) -> None:
    """Two row lists equal: t_start and flags exact, the header where it
    is valid and the payload where it is valid exact, cfo within
    ``cfo_atol``."""
    assert [r["t_start"] for r in got] == [r["t_start"] for r in want]
    for g, w in zip(got, want):
        for f in ("header_valid", "payload_valid"):
            assert g[f] == w[f], (g["t_start"], f)
        if g["header_valid"]:
            np.testing.assert_array_equal(g["header"], w["header"])
        if g["payload_valid"]:
            np.testing.assert_array_equal(g["payload"], w["payload"])
        assert abs(g["cfo"] - w["cfo"]) <= cfo_atol, g["t_start"]
