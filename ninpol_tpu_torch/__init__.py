"""ninpol_tpu_torch: nodal interpolation for finite-volume schemes on
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch counterpart of ``ninpol_tpu`` (the JAX/Pallas package beside
it, which stays the reference): given a mesh and a cell-centred variable,
compute per-node weights over the surrounding cells plus Neumann boundary
corrections, returned as a scipy CSR matrix.  This package imports no JAX.

Numerics: the weights are float64 end to end.  The GLS solve kernel's
preconditioner runs in float32, and its plain PyTorch version forms
float32 Gram products with ``torch`` matmuls; on a CUDA device those would
silently run in TF32 (about three decimal digits) if TF32 were allowed, so
importing this package turns TF32 OFF for matmuls and cuDNN.
"""
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .interpolator import Interpolator  # noqa: E402
from ._grid.grid import Grid  # noqa: E402
from ._io.mesh import Mesh, CellBlock, read as read_mesh, write as write_mesh  # noqa: E402

__version__ = "0.1.0"
__all__ = ["Interpolator", "Grid", "Mesh", "CellBlock", "read_mesh",
           "write_mesh"]
