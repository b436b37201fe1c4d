"""pumiumtally_tpu_torch — track-length flux tallies on unstructured tet
meshes, on PyTorch with a hand-written CUDA walk kernel for NVIDIA Hopper.

The port of ``pumiumtally_tpu`` (JAX on a TPU), which stays beside it as
the reference. Entry points place their tensors on the CUDA card unless
the caller passes ``device="cpu"``; on the CPU the walk is its plain
PyTorch version. This package imports ``torch`` and ``numpy``, never
``jax`` and nothing of ``pumiumtally_tpu``.

The names below load their modules on first use, so that a tool that
needs none of them (the lint, ``python -m pumiumtally_tpu_torch.analysis``)
starts without importing torch.
"""
import importlib

# name -> the module that defines it
_EXPORTS = {
    "PumiTally": ".api",
    "ParticleState": ".core.state",
    "PartitionedTally": ".parallel.partitioned_api",
    "TallyConfig": ".utils.config",
    "TetMesh": ".mesh.core",
    "build_box": ".mesh.box",
    "load_mesh": ".mesh.io",
    "make_flux": ".core.tally",
}

__all__ = sorted(_EXPORTS, key=str.lower)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module, __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
