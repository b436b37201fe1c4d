"""The port's synthetic transport (``pumiumtally_tpu_torch/models/
transport.py``) on ``device="cpu"``, mirroring tests/test_transport.py in
both drive modes: the smoke on a two-region box (both regions flown,
downscatter filling group 1, escapes or roulette kills, the ``.vtu``
written; ``slow`` as there) and the track-length envelope. Host mode
draws with numpy, so the port's SyntheticTransport and the JAX package's,
from one seed, make the same moves: their counters are equal and their
fluxes agree at the parity bar."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import pumiumtally_tpu as jpt
from pumiumtally_tpu.models import transport as jtransport
from pumiumtally_tpu_torch import PumiTally, TallyConfig
from pumiumtally_tpu_torch.mesh.box import build_box_arrays
from pumiumtally_tpu_torch.mesh.core import TetMesh
from pumiumtally_tpu_torch.models.transport import (
    Material,
    SyntheticTransport,
    TransportStats,
)
from torch_twins import TOL, twin_meshes

MODES = ["megastep", "host"]


def _two_region_mesh(cells=4, dtype=torch.float32):
    coords, tets = build_box_arrays(1.0, 1.0, 1.0, cells, cells, cells)
    centroids = coords[tets].mean(axis=1)
    class_id = (centroids[:, 0] > 0.5).astype(np.int32)
    return TetMesh.from_numpy(coords, tets, class_id, dtype=dtype,
                              device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("mode", MODES)
def test_transport_smoke(tmp_path, mode):
    mesh = _two_region_mesh()
    tally = PumiTally(mesh, 64, TallyConfig(n_groups=2, tolerance=1e-6),
                      device="cpu")
    sim = SyntheticTransport(
        tally, materials={0: Material(2.0, 0.4), 1: Material(8.0, 0.6)},
        seed=3, mode=mode)
    out = str(tmp_path / "flux.vtu")
    stats = sim.run(batches=2, output=out)
    assert stats.batches == 2 and stats.events > 0
    assert stats.collisions > 0 and stats.absorbed_weight > 0
    assert stats.boundary_escapes + stats.roulette_kills > 0
    assert os.path.exists(out)
    flux = tally.raw_flux
    assert (flux[..., 0] >= 0).all() and flux[..., 0].sum() > 0
    cid = mesh.class_id.numpy()
    assert flux[cid == 0, :, 0].sum() > 0
    assert flux[cid == 1, :, 0].sum() > 0
    assert flux[:, 1, 0].sum() > 0


@pytest.mark.parametrize("mode", MODES)
def test_flux_tracks_track_length_envelope(mode):
    mesh = _two_region_mesh(3)
    tally = PumiTally(mesh, 32, TallyConfig(n_groups=2, tolerance=1e-6),
                      device="cpu")
    sim = SyntheticTransport(tally, seed=11, mode=mode)
    sim.run(batches=1)
    total = float(tally.raw_flux[..., 0].sum())
    assert 0 < total <= (tally.num_particles * sim.stats.events
                         * np.sqrt(3))


def test_refuses_unknown_mode():
    tally = PumiTally(_two_region_mesh(2), 4, TallyConfig(), device="cpu")
    with pytest.raises(ValueError, match="mode"):
        SyntheticTransport(tally, mode="graph")


def test_source_params_from_materials():
    """The Material map becomes the megastep's tables, with a seed drawn
    per batch from its numpy stream, as the JAX package's does."""
    tally = PumiTally(_two_region_mesh(2), 4, TallyConfig(), device="cpu")
    mats = {0: Material(2.0, 0.4), 1: Material(8.0, 0.6)}
    a = SyntheticTransport(tally, materials=mats, seed=5)
    b = jtransport.SyntheticTransport.__new__(jtransport.SyntheticTransport)
    b.materials, b.default_material = mats, jtransport.Material()
    b.survival_weight, b.rng = 0.1, np.random.default_rng(5)
    pa, pb = a._source_params(), b._source_params()
    assert pa.cache_key() == pb.cache_key()
    assert a._source_params().seed == b._source_params().seed


def test_host_mode_matches_jax_transport():
    """Host mode, the OpenMC call pattern: the port's SyntheticTransport
    and the JAX package's, same numpy seed, same mesh (float64), one
    batch."""
    jmesh, pmesh = twin_meshes(torch.float64, nx=3, classes=(0, 1))
    mats = {0: Material(2.0, 0.4), 1: Material(8.0, 0.6)}
    jmats = {c: jtransport.Material(m.sigma_t, m.absorption)
             for c, m in mats.items()}
    jt = jpt.PumiTally(jmesh, 24, jpt.TallyConfig(
        n_groups=2, dtype=np.float64, tolerance=1e-8))
    pt = PumiTally(pmesh, 24, TallyConfig(n_groups=2, dtype=torch.float64,
                                          tolerance=1e-8), device="cpu")
    js = jtransport.SyntheticTransport(jt, materials=jmats, seed=7,
                                       max_events=30, mode="host")
    ps = SyntheticTransport(pt, materials=mats, seed=7, max_events=30,
                            mode="host")
    js.run_batch()
    ps.run_batch()
    assert isinstance(ps.stats, TransportStats)
    for f in ("batches", "events", "collisions", "boundary_escapes",
              "roulette_kills"):
        assert getattr(ps.stats, f) == getattr(js.stats, f), f
    np.testing.assert_allclose(ps.stats.absorbed_weight,
                               js.stats.absorbed_weight, rtol=1e-12)
    _, rtol, atol = TOL[torch.float64]
    np.testing.assert_allclose(pt.raw_flux, np.asarray(jt.raw_flux),
                               rtol=rtol, atol=atol)
