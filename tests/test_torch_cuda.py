"""The CUDA walk kernel on the card (marker ``cuda``; skipped without one).

This file imports nothing of JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The kernel (``csrc/walk.cu``, built with ``--fmad=false``) computes the
plain walk's arithmetic operation for operation, so elements, material
ids, done flags, stats and positions must agree exactly; the flux agrees
to the reordering of its atomic adds (rtol 1e-10 in float64, 1e-4 in
float32).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

FLUX_RTOL = {torch.float64: 1e-10, torch.float32: 1e-4}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _jittered(nx, dtype, device):
    from pumiumtally_tpu_torch.mesh.box import build_box_arrays
    from pumiumtally_tpu_torch.mesh.core import TetMesh

    coords, tets = build_box_arrays(1.0, 1.0, 1.0, nx, nx, nx)
    rng = np.random.default_rng(4)
    interior = (coords > 1e-9).all(axis=1) & (coords < 1 - 1e-9).all(axis=1)
    coords = coords.copy()
    coords[interior] += rng.uniform(-0.2 / nx, 0.2 / nx, (interior.sum(), 3))
    cid = (coords[tets].mean(axis=1)[:, 0] > 0.5).astype(np.int32)
    return TetMesh.from_numpy(coords, tets, cid, dtype=dtype, device=device)


@pytest.mark.parametrize("robust", [True, False])
@pytest.mark.parametrize("initial", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain(cuda, dtype, initial, robust):
    from pumiumtally_tpu_torch.ops import walk, walk_cuda

    mesh = _jittered(6, dtype, cuda)
    n, G = 4096, 4
    rng = np.random.default_rng(9)

    def t(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda, dt)

    elem = t(rng.integers(0, mesh.ntet, n).astype(np.int32), torch.int32)
    origin = mesh.centroids()[elem.long()].contiguous()
    dest = t(rng.uniform(-0.1, 1.1, (n, 3)), dtype)
    fly = t(rng.uniform(size=n) > 0.1, torch.bool)
    w = t(rng.uniform(0.5, 2.0, n), dtype)
    g = t(rng.integers(0, G + 1, n).astype(np.int32), torch.int32)
    mat = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    kw = dict(initial=initial, max_crossings=mesh.ntet + 8, n_groups=G,
              robust=robust)
    args = (mesh, origin, dest, elem, fly, w, g, mat)
    before = walk_cuda.LAUNCHES
    k = walk_cuda.trace(*args, torch.zeros(mesh.ntet * G * 2, dtype=dtype,
                                           device=cuda), **kw)
    p = walk.trace(*args, torch.zeros(mesh.ntet * G * 2, dtype=dtype,
                                      device=cuda), **kw)
    torch.cuda.synchronize()
    assert walk_cuda.LAUNCHES == before + 1
    for name in ("elem", "material_id", "done", "stats", "lane_iters",
                 "position", "track_length"):
        assert torch.equal(getattr(k, name), getattr(p, name)), name
    torch.testing.assert_close(
        k.flux, p.flux, rtol=FLUX_RTOL[dtype], atol=0
    )


def test_facade_on_card_conserves_track_length(cuda):
    from pumiumtally_tpu_torch import PumiTally, TallyConfig, build_box
    from pumiumtally_tpu_torch.ops import walk_cuda

    n = 2048
    mesh = build_box(1.0, 1.0, 1.0, 8, 8, 8, dtype=torch.float64)
    tally = PumiTally(mesh, n, TallyConfig(n_groups=2, dtype=torch.float64))
    assert tally.device.type == "cuda"
    before = walk_cuda.LAUNCHES
    rng = np.random.default_rng(2)
    prev = rng.uniform(0.05, 0.95, (n, 3))
    tally.initialize_particle_location(prev.reshape(-1).copy())
    path = 0.0
    for _ in range(3):
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        dest = (prev + d * rng.exponential(0.2, (n, 1))).reshape(-1)
        flying = np.ones(n, np.int8)
        mats = np.zeros(n, np.int32)
        tally.move_to_next_location(
            dest, flying, np.ones(n), rng.integers(0, 2, n).astype(np.int32),
            mats,
        )
        final = dest.reshape(n, 3)
        path += np.linalg.norm(final - prev, axis=1).sum()
        prev = final.copy()
        assert not flying.any() and (mats == -1).all()
    assert walk_cuda.LAUNCHES == before + 4
    np.testing.assert_allclose(tally.raw_flux[..., 0].sum(), path, rtol=1e-9)


def test_kernel_rejects_mixed_devices(cuda):
    from pumiumtally_tpu_torch.ops import walk_cuda

    mesh = _jittered(2, torch.float32, cuda)
    n = 8
    args = [
        mesh,
        torch.zeros(n, 3, device=cuda),
        torch.zeros(n, 3, device=cuda),
        torch.zeros(n, dtype=torch.int32),  # on the CPU: refused
        torch.ones(n, dtype=torch.bool, device=cuda),
        torch.ones(n, device=cuda),
        torch.zeros(n, dtype=torch.int32, device=cuda),
        torch.zeros(n, dtype=torch.int32, device=cuda),
        torch.zeros(mesh.ntet * 2, device=cuda),
    ]
    with pytest.raises(ValueError, match="elem"):
        walk_cuda.trace(*args, initial=False, max_crossings=10, n_groups=1)
