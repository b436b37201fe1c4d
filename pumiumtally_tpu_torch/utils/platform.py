"""Device selection for the port's entry points.

Every entry point that places tensors (``build_box``, ``TetMesh.from_numpy``,
``load_mesh``, ``PumiTally``, ``make_flux``, ``make_particle_state``) takes
``device=``. The default is the CUDA
card: the port exists to run the walk there, so a box without CUDA raises
instead of quietly computing on the CPU. Tests and CPU-only callers pass
``device="cpu"``, which runs the plain PyTorch walk.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point places its tensors on.

    ``None`` means ``torch.device("cuda")``. A CUDA device is refused with
    a clear error when ``torch.cuda.is_available()`` is False; there is no
    fallback to the CPU."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pumiumtally_tpu_torch places its tensors on the CUDA card by "
            "default, but torch.cuda.is_available() is False here; pass "
            "device='cpu' to run the plain PyTorch walk on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        # Tensors report an indexed device; resolve so devices compare.
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
