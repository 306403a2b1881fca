"""Carry streaming state and results between the JAX package and the port.

The port keeps the JAX state and result NamedTuples' class and field names
(``McrxState``, ``MctxState``, ``OfdmSyncState``, ``NcoState``,
``PfbchState``, ``FrameResults``, ``FlexSyncState``, ``FlexResults``,
``GmskSyncState``, ``FirState``, ``ResampState``, ``MsresampState``,
``WlanSyncState``, ``WlanResults``), so
one conversion moves a mid-stream state across: :func:`from_jax_tree` takes a tree whose leaves
are NumPy arrays (``jax.device_get`` of a JAX state, or what
``liquid_usrp_tpu/utils/checkpoint.py`` saves) and builds the port's
NamedTuples with tensors on ``device`` (the card unless asked for
another); :func:`to_numpy_tree` is the
inverse.  Plain tuples and lists (``MsresampState.hb_states``) are walked
element by element.  NCO phases, uint32 in JAX, are int64 tensors in the
port.
Classes are matched by name, so this module imports no JAX code.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framing.flexframe_sync import FlexResults, FlexSyncState
from ..framing.gmskframe import GmskSyncState
from ..framing.ofdm_sync import FrameResults, OfdmSyncState
from ..framing.wlan import WlanResults, WlanSyncState
from ..models.multichannel import McrxState, MctxState
from ..ops.fir import FirState
from ..ops.nco import NcoState
from ..ops.pfb import PfbchState
from ..ops.resamp import MsresampState, ResampState
from .device import default_device

__all__ = ["from_jax_tree", "to_numpy_tree"]

_CLASSES = {c.__name__: c for c in (
    McrxState, MctxState, OfdmSyncState, NcoState, PfbchState, FrameResults,
    FlexSyncState, FlexResults, GmskSyncState, FirState, ResampState,
    MsresampState, WlanSyncState, WlanResults)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def from_jax_tree(tree, device=None):
    """JAX state/result tree with NumPy leaves -> the port's tree, on
    ``device`` (``None``: the card, ``utils/device.py``)."""
    device = default_device(device)
    if _is_namedtuple(tree):
        cls = _CLASSES.get(type(tree).__name__)
        if cls is None or cls._fields != tree._fields:
            raise TypeError(f"no port counterpart for {type(tree).__name__}"
                            f"{tree._fields}")
        return cls(*(from_jax_tree(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_jax_tree(v, device) for v in tree)
    a = np.asarray(tree)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a)).to(device)


def to_numpy_tree(tree):
    """The port's state/result tree -> the same NamedTuples with NumPy
    leaves; NCO phases come back as uint32, as JAX holds them."""
    if isinstance(tree, NcoState):
        return NcoState(*(np.asarray(v.cpu().numpy(), np.uint32)
                          for v in tree))
    if _is_namedtuple(tree):
        return type(tree)(*(to_numpy_tree(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    return tree.detach().cpu().numpy()
