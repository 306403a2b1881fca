"""liquid_usrp_tpu_torch — the PyTorch/CUDA port of ``liquid_usrp_tpu``.

Same layout and names as the JAX package (``ops``, ``framing``, ``models``,
``io``, ``apps``, ``utils``), so each module's counterpart is easy to find.
Every stream operator keeps its ``step(state, block) -> (state', out)``
contract and the JAX state/result NamedTuple field names; tensors may live
on the CPU or on a CUDA device, and each function runs where its inputs
live.  The hand-written CUDA kernels (``csrc/``, bound in ``ops/kernels.py``)
launch for CUDA tensors; a CPU tensor takes the kernel's plain PyTorch
version.

This package imports ``torch`` and NumPy and never ``jax``.

Numerics: the GF(2) coding layer (CRC, FEC) runs its bit products as
float32 matmuls, exact only at full float32 precision, so TF32 is switched
off for matmuls and cuDNN at import.
"""
import torch as _torch

__version__ = "0.1.0"

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
