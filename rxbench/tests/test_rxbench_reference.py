"""The reference's estimate check: judged at each frame's S0, and for a
frame in the last M - 1 samples of a detect region, which the receiver
decodes from a clamped window, over that window too."""
import numpy as np

from rxbench import manifest, reference, txgen


def _case():
    c = manifest.cell("ofdm1_conv.golay")["config"]
    bs, M = c["block_size"], c["M"]
    first = 10 * bs - txgen.receiver_overlap(c)   # block 10's window start
    T = np.array([first + 1000, first + bs + 10])   # mid-region, clamp zone
    loop = np.random.default_rng(7).standard_normal((400_000, 2)) @ \
        np.array([1, 1j])
    return c, M, T, loop


def _rows(T, rssi, cfo):
    return {"channel": np.zeros(len(T), np.int64), "t": T,
            "rssi": np.asarray(rssi, float), "cfo": np.asarray(cfo, float)}


def _at(loop, c, T, start):
    M = c["M"]
    ch = np.zeros(len(T), np.int64)
    w_at = reference.channel_samples(loop, c, ch, T, 2 * M)
    w_win = reference.channel_samples(loop, c, ch, start, 2 * M)
    return reference.estimates(w_at, w_win, M)


def test_window_start_clamps_only_the_last_samples():
    c, M, T, _ = _case()
    start = reference.window_start(T, c)
    assert start[0] == T[0]
    assert 0 < T[1] - start[1] < M


def test_estimates_at_the_s0_or_over_the_clamped_window():
    c, M, T, loop = _case()
    idx = np.arange(len(T))
    start = reference.window_start(T, c)
    at = _at(loop, c, T, T)
    win = _at(loop, c, T, start)
    # a receiver that reads at the S0, or over its clamped window: no gap
    for rssi, cfo in (at, win):
        r, f, clamped = reference.estimate_gaps(_rows(T, rssi, cfo), idx,
                                                loop, c)
        assert clamped == 1
        assert r < 1e-9 and f < 1e-12
    # the clamped window differs from the S0 on this stream
    assert abs(win[0][1] - at[0][1]) > 1e-2
    # a frame that is not clamped is held to its S0 alone
    early = _at(loop, c, T, T - 10)
    r, f, _ = reference.estimate_gaps(_rows(T, early[0], early[1]), idx[:1],
                                      loop, c)
    assert r > 1e-2 and f > 1e-6
