"""The partitioned exchange round and the integrity vector's dispatch, on
the CPU.

The exchange (``ops/walk_partitioned.py::_exchange``) runs the kernels of
``csrc/exchange.cu`` on CUDA tensors and its plain version
``_exchange_plain`` on CPU tensors; the integrity vector
(``ops/integrity_cuda.py::integrity_vector``) the kernel of
``csrc/integrity.cu`` or ``ops/walk.py::integrity_vector``. Here the
plain exchange runs through the whole step against the JAX package's
``make_partitioned_step`` (tests/test_mesh_partition.py's step, float64,
x64) in the regime no other test reaches: ``exchange_size=2`` (emigrants
wait rounds for their block) and a slot layout of ``cap`` slots a part,
the most any part holds at the start, so that parts full of their own
lanes drop immigrants. The slot state the exchange moves (ids,
validity, elements, materials, done flags, groups, weights,
destinations), ``n_dropped``, the rounds and the exchange's round stats
are bitwise the JAX step's; positions and track lengths within the
partitioned tests' atol 1e-12 (the reference's XLA:CPU FMA contraction,
ROADMAP.md queue C), the slab flux within their atol 1e-11. The
dispatches take the plain path on the CPU and raise on any other device
but CUDA (``meta`` here), and the wrappers' argument checks raise
ValueError on inputs built on the CPU, before any dispatch. The kernels
themselves are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phases 15, 16, 18 and 19).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from pumiumtally_tpu.ops import walk_partitioned as jwp
from pumiumtally_tpu.parallel.mesh_partition import partition_mesh as jpartition
from pumiumtally_tpu.parallel.particle_sharding import (
    make_device_mesh as jdevice_mesh,
)
from pumiumtally_tpu_torch.ops import exchange_cuda, integrity_cuda
from pumiumtally_tpu_torch.ops import walk as pwalk
from pumiumtally_tpu_torch.ops import walk_partitioned as pwp
from pumiumtally_tpu_torch.parallel.mesh_partition import partition_mesh
from pumiumtally_tpu_torch.parallel.particle_sharding import make_device_mesh

from torch_twins import twin_meshes

N_PARTS = 4
N_LANES = 48
SEED = 2  # a batch whose tight layout drops immigrants (halo 0 and 1)
FLUX_ATOL = 1e-11
ATOL = 1e-12
# Moved by the exchange without arithmetic: bitwise. Positions and track
# lengths come out of the walk phases, whose float64 arithmetic the JAX
# reference contracts into FMAs on XLA:CPU (ROADMAP.md queue C): the
# partitioned tests' atol 1e-12.
SLOT_FIELDS = ("particle_id", "valid", "elem", "material_id", "done",
               "group", "weight", "dest")
WALKED_FIELDS = ("position", "track_length")


@pytest.fixture(scope="module")
def box():
    return twin_meshes(torch.float64, nx=4)  # 384 tets


def _batch(mesh):
    rng = np.random.default_rng(SEED)
    elem = rng.integers(0, mesh.ntet, N_LANES).astype(np.int32)
    origin = mesh.centroids().numpy()[elem]
    dest = np.clip(origin + rng.uniform(-0.9, 0.9, (N_LANES, 3)), -0.2, 1.2)
    return elem, dict(origin=origin, dest=dest,
                      weight=rng.uniform(0.5, 2.0, N_LANES),
                      group=rng.integers(0, 2, N_LANES).astype(np.int32),
                      material_id=np.full(N_LANES, -1, np.int32))


@pytest.fixture(scope="module", params=[0, 1], ids=["halo0", "halo1"])
def tight_steps(request, box):
    """The JAX step and the port's plain step on one batch in a tight
    slot layout with ``exchange_size=2``."""
    jm, pm = box
    halo = request.param
    elem, fields = _batch(pm)
    part = partition_mesh(pm, N_PARTS, halo_layers=halo)
    cap = int(np.bincount(part.owner[elem], minlength=N_PARTS).max())
    kw = dict(n_groups=2, max_crossings=pm.ntet + 8, tolerance=1e-8,
              exchange_size=2)
    jpart = jpartition(jm, N_PARTS, halo_layers=halo)
    dm = jdevice_mesh(N_PARTS)
    placed = jwp.distribute_particles(jpart, dm, elem, fields, cap=cap)
    flux = jax.device_put(jnp.zeros((N_PARTS, jpart.max_local * 4)),
                          NamedSharding(dm, JP("p")))
    jres = jwp.make_partitioned_step(dm, jpart, **kw)(
        placed["origin"], placed["dest"], placed["elem"],
        jnp.zeros_like(placed["valid"]), placed["material_id"],
        placed["weight"], placed["group"], placed["particle_id"],
        placed["valid"], flux)
    pdm = make_device_mesh(N_PARTS, "cpu")
    ours = pwp.distribute_particles(part, pdm, elem, fields, cap=cap)
    res = pwp.make_partitioned_step(pdm, part, **kw)(
        ours["origin"], ours["dest"], ours["elem"],
        torch.zeros_like(ours["valid"]), ours["material_id"],
        ours["weight"], ours["group"], ours["particle_id"], ours["valid"],
        torch.zeros(N_PARTS, part.max_local * 4, dtype=torch.float64))
    return jres, res


def test_plain_exchange_step_matches_jax_with_overflow_and_drops(
        tight_steps):
    jres, res = tight_steps
    for f in SLOT_FIELDS:
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(jres, f)), f)
    for f in WALKED_FIELDS:
        np.testing.assert_allclose(getattr(res, f).numpy(),
                                   np.asarray(getattr(jres, f)), rtol=0,
                                   atol=ATOL, err_msg=f)
    np.testing.assert_array_equal(res.n_dropped.numpy(),
                                  np.asarray(jres.n_dropped))
    np.testing.assert_array_equal(res.n_rounds.numpy(),
                                  np.asarray(jres.n_rounds))
    R = res.round_stats.shape[2]
    np.testing.assert_array_equal(res.round_stats.numpy()[:, :5],
                                  np.asarray(jres.round_stats)[:, :5, :R])
    np.testing.assert_allclose(res.flux.numpy(), np.asarray(jres.flux),
                               rtol=0, atol=FLUX_ATOL)
    # The regime: drops, and emigrants left waiting for a later round.
    rs = res.round_stats.numpy()
    assert int(res.n_dropped.sum()) > 0
    assert (rs[:, 1] < rs[:, 0]).any()
    assert (rs[:, 2] > rs[:, 3]).any()  # a part received more than it holds


# --------------------------------------------------------------------- #
# The dispatches and the wrappers' argument checks
# --------------------------------------------------------------------- #
def _round_state(device="cpu", dtype=torch.float64, K=None, P_l=2, cap=8,
                 seed=0):
    """A round's slot state: half the slots valid, some pending for
    another of ``P_l`` parts."""
    rng = np.random.default_rng(seed)
    n = P_l * cap

    def t(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    valid = rng.uniform(size=n) < 0.5
    target = np.where(valid & (rng.uniform(size=n) < 0.5),
                      rng.integers(0, P_l, n), -1)
    s = dict(cur=t(rng.uniform(size=(n, 3)), dtype),
             dest=t(rng.uniform(size=(n, 3)), dtype),
             weight=t(rng.uniform(size=n), dtype),
             pseg=t(rng.uniform(size=n), dtype),
             pid=t(np.arange(n), torch.int32),
             group=t(rng.integers(0, 2, n), torch.int32),
             material_id=t(np.full(n, -1), torch.int32),
             elem=t(rng.integers(0, 4, n), torch.int32),
             done=t(np.zeros(n, bool), torch.bool),
             valid=t(valid, torch.bool), target=t(target, torch.int32),
             target_elem=t(rng.integers(0, 4, n), torch.int32),
             prev=t(np.full(n, -1), torch.int32),
             stuck=t(rng.integers(0, 6, n), torch.int32), xp=None, kx=None)
    if K is not None:
        s["xp"] = t(rng.uniform(size=(n, K, 3)), dtype)
        s["kx"] = t(rng.integers(0, K + 2, n), torch.int32)
    return s


def _round_args(s, P_l=2, cap=8, E=2, max_local=4):
    dropped = torch.zeros(P_l, dtype=torch.int64, device=s["cur"].device)
    return (pwp.Collectives(pwp.RankLayout(0, P_l, s["cur"].device)), P_l,
            0, P_l, cap, E, max_local, None, s, dropped)


@pytest.mark.parametrize("K", [None, 2])
def test_exchange_takes_the_plain_path_on_the_cpu(K):
    """``_exchange`` on CPU tensors is ``_exchange_plain``: the same slot
    state, stats and drops, and no kernel launch."""
    a, b = _round_state(K=K), _round_state(K=K)
    before = (exchange_cuda.BUCKET_LAUNCHES, exchange_cuda.ADOPT_LAUNCHES)
    got = pwp._exchange(*_round_args(a))
    args = _round_args(b)
    want = pwp._exchange_plain(*args)
    assert torch.equal(got, want)
    assert int(want[:, 1].sum()) > 0  # rows were sent
    for k, v in a.items():
        if v is not None:
            assert torch.equal(v, b[k]), k
    assert "send" not in a  # no kernel workspace on the CPU
    assert (exchange_cuda.BUCKET_LAUNCHES,
            exchange_cuda.ADOPT_LAUNCHES) == before


def test_dispatches_raise_on_a_device_other_than_cuda():
    s = _round_state(device="meta")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        pwp._exchange(*_round_args(s))
    n = 8
    lanes = dict(in_flight=torch.ones(n, dtype=torch.bool, device="meta"),
                 done=torch.ones(n, dtype=torch.bool, device="meta"))
    f = dict(dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        integrity_cuda.integrity_vector(
            lanes["in_flight"], lanes["done"], torch.ones(n, **f),
            torch.ones(n, **f), torch.zeros(n, 3, **f),
            torch.zeros(n, 3, **f), torch.zeros(16, **f), False)


@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_integrity_dispatch_takes_the_plain_path_on_the_cpu(dtype, initial):
    rng = np.random.default_rng(1)
    n = 64

    def t(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dt)

    args = (t(rng.uniform(size=n) < 0.8, torch.bool),
            t(rng.uniform(size=n) < 0.7, torch.bool),
            t(rng.uniform(0.5, 2.0, n)), t(rng.uniform(size=n)),
            t(rng.uniform(size=(n, 3))), t(rng.uniform(size=(n, 3))),
            t(np.concatenate([rng.uniform(size=30), [-1.0, np.nan]])))
    before = integrity_cuda.LAUNCHES
    got = integrity_cuda.integrity_vector(*args, initial)
    assert torch.equal(got, pwalk.integrity_vector(*args, initial))
    assert int(got[3]) == 2 and integrity_cuda.LAUNCHES == before


def _bad_exchange_inputs():
    """(label, mutate(s, kwargs)) cases ``exchange_cuda.check`` refuses."""

    def field(name, fn):
        def go(s, kw):
            s[name] = fn(s[name])
        return go

    def size(**over):
        def go(s, kw):
            kw.update(over)
        return go

    def both(s, kw):
        s["xp"] = torch.zeros(s["cur"].shape[0], 2, 3, dtype=s["cur"].dtype)

    return [
        ("weight dtype", field("weight", lambda v: v.float())),
        ("pid dtype", field("pid", lambda v: v.long())),
        ("valid dtype", field("valid", lambda v: v.to(torch.int32))),
        ("cur shape", field("cur", lambda v: v[:, :2].contiguous())),
        ("dest contiguity", field("dest", lambda v: v.t().contiguous().t())),
        ("E above cap", size(E=9)),
        ("E zero", size(E=0)),
        ("parts", size(P=exchange_cuda.MAX_PARTS + 1)),
        ("canon dtype", size(canon=torch.zeros(8, dtype=torch.int32))),
        ("dropped dtype", size(dropped=torch.zeros(2, dtype=torch.int32))),
        ("points without counts", both),
        ("cur dtype", field("cur", lambda v: v.half())),
    ]


@pytest.mark.parametrize("label,mutate", _bad_exchange_inputs(),
                         ids=[c[0] for c in _bad_exchange_inputs()])
def test_exchange_checks_refuse_bad_inputs(label, mutate):
    s = _round_state()
    kw = dict(P=2, lo=0, P_l=2, cap=8, E=2, max_local=4, canon=None,
              dropped=torch.zeros(2, dtype=torch.int64))
    mutate(s, kw)
    with pytest.raises(ValueError):
        exchange_cuda.check(s, **kw)
    with pytest.raises(ValueError):  # before the dispatch, on the CPU
        pwp._exchange(pwp.Collectives(pwp.RankLayout(0, 2, s["cur"].device)),
                      kw["P"], kw["lo"], kw["P_l"], kw["cap"], kw["E"],
                      kw["max_local"], kw["canon"], s, kw["dropped"])


def test_integrity_checks_refuse_bad_inputs():
    n = 8
    ok = dict(in_flight=torch.ones(n, dtype=torch.bool),
              done=torch.ones(n, dtype=torch.bool),
              weight=torch.ones(n), pseg=torch.ones(n),
              cur=torch.zeros(n, 3), origin=torch.zeros(n, 3),
              flux=torch.zeros(16))
    integrity_cuda.check(**ok)
    for name, bad in (("in_flight", torch.ones(n, dtype=torch.int32)),
                      ("weight", torch.ones(n, dtype=torch.float64)),
                      ("cur", torch.zeros(n, 2)),
                      ("origin", torch.zeros(3, n).t()),
                      ("flux", torch.zeros(16, 2).t()),
                      ("pseg", torch.ones(n + 1))):
        with pytest.raises(ValueError):
            integrity_cuda.check(**dict(ok, **{name: bad}))
    ints = dict(flux=torch.zeros(16, dtype=torch.int32),
                weight=torch.ones(n, dtype=torch.int32))
    with pytest.raises(ValueError):
        integrity_cuda.check(**dict(ok, **ints))


def test_send_rows_and_workspace_sizes():
    """The row bytes the kernels write (csrc ``row_bytes_of``) and the
    workspace a step allocates once: the padded blocks, never cleared."""
    for dtype, item in ((torch.float32, 4), (torch.float64, 8)):
        for K in (0, 8):
            assert exchange_cuda.row_bytes(dtype, K) == (8 + 3 * K) * item + 32
    s = _round_state(K=8)
    ws = exchange_cuda.workspace(s, 4, 2, 8, 2, 8)
    assert tuple(ws["buf"].shape) == (2, 4, 2, (8 + 24) * 8 + 32)
    assert ws["buf"].dtype == torch.uint8
    assert tuple(ws["rows"].shape) == (2, 4)
    assert ws["rows"].dtype == torch.int32
    assert ws["counts"].numel() == 2 * 5 * 1 and ws["free"].numel() == 2
    assert ws["info"].numel() == 2 * 6
