"""Build and load the package's CUDA kernels.

The sources in ``liquid_usrp_tpu_torch/csrc/`` have a plain C interface;
``nvcc`` compiles each ``.cu`` file for Hopper (``sm_90a``), all of them at
once in parallel, and links the objects into one shared library under
``build/kernels/`` at the repository root, named by a hash of the sources
and flags; ``ctypes`` loads it.  The build runs at first use, takes
seconds, and is reused while the sources are unchanged.  A missing
compiler or a failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "build_info"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_SIGNATURES = {
    # ext, rows, len, tre, tim, ea, tmpl, ea_d, n_tmpl, span, n_metric,
    # floors, out, stream
    "xcorr_metric_launch": ([_VP, _I, _I, _VP, _VP, _VP, _VP, _VP, _I, _I,
                             _I, _VP, _VP, _VP], _I),
    # ext, rows, len, span, n_seg, P, J, g, n_metric, floors, taps, meta,
    # part, out, stream
    "xcorr_fold_launch": ([_VP, _I, _I, _I, _I, _I, _I, _I, _I, _VP, _VP,
                           _VP, _VP, _VP, _VP], _I),
    # ext, rows, len, lag, span, win, T, thr, floors, n_out, n_seg,
    # segval, segarg, segcre, segcim, scratch, stream
    "detect_candidates_launch": ([_VP, _I, _I, _I, _I, _I, _I, _F, _VP, _I,
                                  _I, _VP, _VP, _VP, _VP, _VP, _VP], _I),
    # rows, n_out, lag, span, win, n_seg -> scratch bytes
    "detect_candidates_scratch": ([_I, _I, _I, _I, _I, _I], _LL),
    # lag, span, win -> the path's code
    "detect_candidates_path": ([_I, _I, _I], _I),
    # ext, rows, len, lag, span, floors, n_out, metric, c, scratch, stream
    "autocorr_metric_launch": ([_VP, _I, _I, _I, _I, _VP, _I, _VP, _VP,
                                _VP, _VP], _I),
    # rows, n_out, lag, span -> scratch bytes
    "autocorr_metric_scratch": ([_I, _I, _I, _I], _LL),
    # cre, cim, cp, rows, len, lag, span, floors, n_out, metric, c, stream
    "autocorr_prefix_launch": ([_VP, _VP, _VP, _I, _I, _I, _I, _VP, _I, _VP,
                                _VP, _VP], _I),
    # bm, rows, T, S, P, pidw, big, scratch, bits, stream
    "viterbi_launch": ([_VP, _I, _I, _I, _I, _VP, _I, _VP, _VP, _VP], _I),
    # rows, T, S, P -> scratch bytes
    "viterbi_scratch": ([_I, _I, _I, _I], _LL),
    # x, K, n, table, C, arg, best, stream
    "nearest_launch": ([_VP, _I, _I, _VP, _I, _VP, _VP, _VP], _I),
}

_LIB: list = []
_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    if _LIB:
        return _LIB[0]
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = _BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    built = not out.exists()
    if built:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cus = [p for p in srcs if p.suffix == ".cu"]
        objs = [tmp.with_name(f"{tmp.name}.{p.stem}.o") for p in cus]
        try:
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for o, p in zip(objs, cus)]
            outs = [(p.name, proc.communicate()[0], proc.returncode)
                    for p, proc in zip(cus, procs)]
            log = "".join(text for _, text, _ in outs)
            bad = [f"{name} ({rc})" for name, _, rc in outs if rc != 0]
            if bad:
                raise RuntimeError(f"nvcc failed for {', '.join(bad)}:\n"
                                   f"{log}")
            proc = subprocess.run(
                [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            for o in [*objs, tmp]:
                o.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(out))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _INFO.update(path=str(out), seconds=time.perf_counter() - t0,
                 built=built, log=log)
    _LIB.append(lib)
    return lib


def build_info() -> dict:
    """Where the library is, how long loading (and building) took, and
    the compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) when this process built it."""
    return dict(_INFO)
