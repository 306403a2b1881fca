"""narrowband_tx — continuous random-symbol narrowband TX to an IQ file.

Port of ``liquid_usrp_tpu/apps/narrowband_tx.py`` (same flags, defaults
and output): random M-ary symbols from ``-s``'s NumPy generator, a
matched-filter interpolator with a selectable Nyquist pulse
(``firdes_prototype``; k=2, m=9, beta=0.2), then ``msresamp`` at ``-r``.
Runs on the first CUDA device (``LIQUID_USRP_TORCH_DEVICE=cpu`` asks for
the CPU).

    python -m liquid_usrp_tpu_torch.apps.narrowband_tx -o out.iq
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..io.streams import write_iq
from ..ops import fir as fir_mod
from ..ops import modem as modem_mod
from ..ops import resamp as resamp_mod
from ..ops.filter_design import PULSE_TYPES, firdes_prototype
from ..utils.device import default_device
from .common import parse_args, print_usage_schemes

USAGE = """narrowband_tx -o out.iq [options]
  h : usage                     o : output IQ file (required)
  g : soft gain dB (-12)        n : number of symbols (4096)
  m : mod scheme (qpsk)         t : pulse type (rrcos; %s)
  k : samples/symbol (2)        M : filter semi-length (9)
  b : excess bandwidth (0.2)    r : output resampling rate (1.0)
  s : RNG seed (42)
""" % ",".join(PULSE_TYPES)


def main(argv=None) -> int:
    flags, _ = parse_args(argv if argv is not None else sys.argv[1:],
                          "ho:g:n:m:t:k:M:b:r:s:")
    if "h" in flags:
        print(USAGE)
        print_usage_schemes()
        return 0
    out = flags.get("o")
    if not out:
        print(USAGE)
        return 1
    gain = 10 ** (float(flags.get("g", -12.0)) / 20.0)
    n_syms = int(flags.get("n", 4096))
    mod = modem_mod.mod_from_name(flags.get("m", "qpsk"))
    ptype = flags.get("t", "rrcos")
    k = int(flags.get("k", 2))
    m = int(flags.get("M", 9))
    beta = float(flags.get("b", 0.2))
    rate = float(flags.get("r", 1.0))
    rng = np.random.default_rng(int(flags.get("s", 42)))

    dev = default_device()
    taps = firdes_prototype(ptype, k, m, beta).astype(np.float32) * \
        np.sqrt(k)
    Mc = 1 << modem_mod.bits_per_symbol(mod)
    syms = modem_mod.modulate(mod, torch.as_tensor(
        rng.integers(0, Mc, n_syms), device=dev))
    st = fir_mod.firinterp_init(len(taps), k, device=dev)
    # flush the interpolator with 2m zero symbols: the last pulses'
    # trailing energy lives in the carried filter state
    syms_f = torch.cat([syms, torch.zeros(2 * m, dtype=syms.dtype,
                                          device=dev)])
    _, samples = fir_mod.firinterp_block(taps, k, st, syms_f)
    baseband = samples.cpu().numpy() * gain
    if rate != 1.0:
        ms = resamp_mod.msresamp_create(rate)
        rst = resamp_mod.msresamp_state(ms, dev)
        # zero-pad for the resampler chain's group delay as well
        pad = np.zeros(64, np.complex64)
        div = 2 ** ms.num_halfband if not ms.is_interp else 1
        full = np.concatenate([baseband, pad])
        full = full[: len(full) - len(full) % max(div, 1)]
        rst, y, valid, count = resamp_mod.msresamp_block(
            ms, rst, torch.as_tensor(np.asarray(full, np.complex64),
                                     device=dev))
        baseband = y[:int(count)].cpu().numpy()
    write_iq(out, baseband)
    print(f"narrowband_tx: wrote {n_syms} {modem_mod.mod_name(mod)} symbols "
          f"({ptype} pulse, {len(baseband)} samples) to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
