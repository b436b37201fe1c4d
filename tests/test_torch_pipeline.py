"""The port's streaming pipeline
(``pumiumtally_tpu_torch/models/pipeline.py``) on ``device="cpu"``.

Mirrors ``tests/test_pipeline.py``: the flux of a pipelined run equals
the sum of the same batches walked one after another (bitwise, through
the port's ``walk_cuda.trace``), per-batch outputs come back in
submission order, lagging by ``depth``, and ``want_outputs=False`` reads
no outputs back. Against the JAX ``StreamingTallyPipeline`` in float64
the flux agrees within 1e-10 relative per bin and the positions within
1e-12. Kept at 3^3 boxes and at most 64 lanes a batch.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pumiumtally_tpu as jpt
from pumiumtally_tpu.models.pipeline import (
    StreamingTallyPipeline as JaxPipeline,
)
from pumiumtally_tpu.utils.config import TallyConfig as JaxConfig
from pumiumtally_tpu_torch import TallyConfig
from pumiumtally_tpu_torch.convert import MESH_FIELDS, mesh_from_jax_arrays
from pumiumtally_tpu_torch.models.pipeline import (
    BatchResult,
    StreamingTallyPipeline,
)
from pumiumtally_tpu_torch.ops import walk_cuda

DTYPE = torch.float64


@pytest.fixture(scope="module")
def meshes():
    jmesh = jpt.build_box(1.0, 1.0, 1.0, 3, 3, 3, dtype=jnp.float64)
    pmesh = mesh_from_jax_arrays(
        {f: np.asarray(getattr(jmesh, f)) for f in MESH_FIELDS}, "cpu")
    return jmesh, pmesh


def _batches(mesh, n, k, seed=0):
    """tests/test_pipeline.py::_batches."""
    rng = np.random.default_rng(seed)
    cent = mesh.centroids().numpy()
    out = []
    for _ in range(k):
        elem = rng.integers(0, mesh.ntet, n).astype(np.int32)
        dest = rng.uniform(-0.05, 1.05, (n, 3))
        weight = rng.uniform(0.5, 2.0, n)
        group = rng.integers(0, 2, n).astype(np.int32)
        out.append((cent[elem], dest, elem, weight, group))
    return out


def _sequential(mesh, batches, cfg):
    """The batches walked one after another into one flux."""
    flux = torch.zeros(mesh.ntet * cfg.n_groups * 2, dtype=cfg.dtype)
    positions = []
    for origin, dest, elem, weight, group in batches:
        n = len(elem)
        r = walk_cuda.trace(
            mesh, torch.from_numpy(origin), torch.from_numpy(dest),
            torch.from_numpy(elem), torch.ones(n, dtype=torch.bool),
            torch.from_numpy(weight), torch.from_numpy(group),
            torch.full((n,), -1, dtype=torch.int32), flux,
            initial=False, max_crossings=mesh.ntet + 64,
            n_groups=cfg.n_groups, tolerance=cfg.tolerance,
        )
        positions.append(r.position.numpy())
    return flux.numpy().reshape(mesh.ntet, cfg.n_groups, 2), positions


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipeline_matches_sequential(meshes, depth):
    _, mesh = meshes
    cfg = TallyConfig(n_groups=2, tolerance=1e-6, dtype=DTYPE)
    batches = _batches(mesh, 40, 5)
    pipe = StreamingTallyPipeline(mesh, cfg, depth=depth)
    for k, (origin, dest, elem, weight, group) in enumerate(batches, 1):
        pipe.submit(origin, dest, elem, weight, group)
        assert len(list(pipe.results())) == max(0, k - depth)
    flux = pipe.finish()
    ref, positions = _sequential(mesh, batches, cfg)
    np.testing.assert_array_equal(flux, ref)
    got = list(pipe.results())
    assert [b.index for b in got] == [0, 1, 2, 3, 4]
    for b, want in zip(got, positions):
        np.testing.assert_array_equal(b.position, want)
        assert b.all_done and b.stats["truncated"] == 0
        assert b.n_segments == b.stats["segments"] > 0
        assert b.shape_key is None and b.xpoints is None


def test_pipeline_matches_jax_pipeline(meshes):
    """Against the JAX pipeline on the same float64 tables: flux within
    1e-10 relative per bin, positions within 1e-12, elements and material
    ids equal."""
    jmesh, mesh = meshes
    batches = _batches(mesh, 40, 5)
    jpipe = JaxPipeline(jmesh, jpt.TallyConfig(
        n_groups=2, tolerance=1e-6, dtype=jnp.float64), depth=2)
    pipe = StreamingTallyPipeline(
        mesh, TallyConfig(n_groups=2, tolerance=1e-6, dtype=DTYPE), depth=2)
    for b in batches:
        jpipe.submit(*b)
        pipe.submit(*b)
    jflux, flux = jpipe.finish(), pipe.finish()
    np.testing.assert_allclose(flux, jflux, rtol=1e-10, atol=1e-12)
    for b, jb in zip(pipe.results(), jpipe.results()):
        assert b.index == jb.index
        np.testing.assert_allclose(b.position, jb.position, rtol=0,
                                   atol=1e-12)
        np.testing.assert_array_equal(b.elem, jb.elem)
        np.testing.assert_array_equal(b.material_id, jb.material_id)
        assert b.n_segments == jb.n_segments and b.all_done == jb.all_done


def test_pipeline_no_outputs_mode(meshes):
    """want_outputs=False: the flux of the run with outputs, and nothing
    read back."""
    _, mesh = meshes
    cfg = TallyConfig(n_groups=2, tolerance=1e-6, dtype=DTYPE)
    batches = _batches(mesh, 24, 4, seed=2)
    runs = {}
    for want in (True, False):
        pipe = StreamingTallyPipeline(mesh, cfg, depth=3, want_outputs=want)
        for b in batches:
            pipe.submit(*b)
        runs[want] = (pipe.finish(), list(pipe.results()))
    assert runs[False][0][..., 0].sum() > 0
    np.testing.assert_array_equal(runs[False][0], runs[True][0])
    assert runs[False][1] == [] and len(runs[True][1]) == 4


def test_pipeline_defaults_and_walk_stats_off(meshes):
    """Omitted weights, groups, flags and material ids take the JAX
    pipeline's defaults (1, 0, flying, -1); with walk_stats off a batch's
    segments and all_done come from its readback's tail and flags."""
    _, mesh = meshes
    origin, dest, elem, _, _ = _batches(mesh, 16, 1, seed=4)[0]
    n = len(elem)
    out = {}
    for stats in (True, False):
        cfg = TallyConfig(n_groups=2, tolerance=1e-6, dtype=DTYPE,
                          walk_stats=stats)
        pipe = StreamingTallyPipeline(mesh, cfg, depth=1)
        pipe.submit(origin, dest, elem)
        pipe.submit(origin, dest, elem, np.ones(n), np.zeros(n, np.int32),
                    np.ones(n, bool), np.full(n, -1, np.int32))
        flux = pipe.finish()
        a, b = pipe.results()
        np.testing.assert_array_equal(a.position, b.position)
        np.testing.assert_array_equal(flux[..., 1, :], 0.0)
        assert a.n_segments == b.n_segments > 0 and a.all_done
        assert (a.stats is None) == (not stats)
        out[stats] = (flux, a.n_segments)
    np.testing.assert_array_equal(out[True][0], out[False][0])
    assert out[True][1] == out[False][1]


def test_pipeline_unported_surfaces(meshes):
    _, mesh = meshes
    pipe = StreamingTallyPipeline(mesh, TallyConfig(dtype=DTYPE))
    with pytest.raises(NotImplementedError, match="A7"):
        pipe.submit_source(np.zeros((2, 3)), np.zeros(2, np.int32), 3)
    assert pipe.shape_keys() == {}
    assert BatchResult._fields[-1] == "shape_key"


def test_pipeline_refuses_batch_sd_like_jax(meshes):
    """The pipeline walks with per-segment squares and never folds batch
    squares, so both packages refuse sd_mode='batch' rather than fill the
    odd entries with something else."""
    jmesh, mesh = meshes
    with pytest.raises(NotImplementedError, match="sd_mode='segment' only"):
        JaxPipeline(jmesh, JaxConfig(dtype=jnp.float64, sd_mode="batch"))
    with pytest.raises(NotImplementedError, match="sd_mode='segment' only"):
        StreamingTallyPipeline(mesh, TallyConfig(dtype=DTYPE,
                                                 sd_mode="batch"))
