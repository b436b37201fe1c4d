"""pumiumtally_tpu_torch — track-length flux tallies on unstructured tet
meshes, on PyTorch with a hand-written CUDA walk kernel for NVIDIA Hopper.

The port of ``pumiumtally_tpu`` (JAX on a TPU), which stays beside it as
the reference. Entry points place their tensors on the CUDA card unless
the caller passes ``device="cpu"``; on the CPU the walk is its plain
PyTorch version. This package imports ``torch`` and ``numpy``, never
``jax`` and nothing of ``pumiumtally_tpu``.
"""
from .api import PumiTally
from .core.state import ParticleState
from .core.tally import make_flux
from .mesh.box import build_box
from .mesh.core import TetMesh
from .mesh.io import load_mesh
from .parallel.partitioned_api import PartitionedTally
from .utils.config import TallyConfig

__all__ = [
    "PumiTally",
    "ParticleState",
    "PartitionedTally",
    "TallyConfig",
    "TetMesh",
    "build_box",
    "load_mesh",
    "make_flux",
]
