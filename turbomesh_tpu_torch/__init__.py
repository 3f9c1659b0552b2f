"""turbomesh_tpu_torch — block-structured mesh generation on PyTorch/CUDA.

The PyTorch port of ``turbomesh_tpu`` (2-D block-structured elliptic mesh
generation for turbomachinery CFD), for an NVIDIA H100:

- the NumPy front end (clustering laws, splines, blocking templates, TFI
  node placement, boundary classification, host oracle) is carried as a
  jax-free copy of the JAX package's modules, so the port runs where JAX
  is not installed;
- the device smoothing path (f64 FGMRES over a matrix-free Winslow
  operator, f32 Schur / glued-multigrid preconditioner, device-resident
  Picard loop with the White control-function update) is torch code on an
  explicit ``device``;
- the block-sharded path (``parallel``) runs that solve with the blocks
  cut across the ranks of a ``torch.distributed`` group, and 3-D meshes
  come from stacked cuts (``extrude``, ``io.cgns3d``);
- the zebra line-relaxation half-sweep is a hand-written CUDA kernel
  (``csrc/zebra.cu``, wrapper ``ops.zebra``).

Module layout and function names mirror ``turbomesh_tpu``. This package
imports torch and never jax.
"""

from . import types  # noqa: F401
from . import clustering  # noqa: F401
from . import spline  # noqa: F401
from . import geometry  # noqa: F401
from . import edge  # noqa: F401
from . import tfi  # noqa: F401
from . import boundary  # noqa: F401
from . import mesh  # noqa: F401
from . import machine  # noqa: F401

__version__ = "0.1.0"
