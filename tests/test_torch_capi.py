"""The port's C ABI (``pumiumtally_tpu_torch/capi.py`` and
``csrc/host/``): the bridge library, the demo host and the replay host,
built with g++ and driven on the CPU (``PUMI_TPU_PLATFORM=cpu``).

Mirrors tests/test_c_api.py: a C ``main()`` linked against the port's
bridge creates a tally on a mesh file, flies particles and reads back
clipped positions, reset flying flags, material ids and the raw flux.

* the demo's ``FLUX_SUM`` equals the JAX facade's on the same 16-particle
  scenario (rel 1e-6, as tests/test_c_api.py holds the JAX bridge);
* the replay host (a recorded run of a few hundred particles and two moves
  on a two-material box) is held BITWISE to the port's in-process
  ``PumiTally`` on the same mesh file (flux and every write-back), and
  per bin to the JAX facade within the float32 cross-package tolerances of
  tests/test_torch_api.py, queue C's sliver allowance included;
* the write-backs land in the caller's buffers (memoryviews over numpy
  arrays) under every ``io_pipeline`` mode;
* the port's header declares what ``native/include/pumi_tally.h`` declares;
* a bad mesh path gives NULL from ``pumi_tally_create`` and
  ``pumi_tally_last_error`` names the cause.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess

import numpy as np
import pytest

from pumiumtally_tpu_torch import capi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, MOVES, G = 300, 2, 3


def _toolchain_reason():
    if shutil.which("g++") is None or shutil.which("gcc") is None:
        return "g++/gcc unavailable"
    try:
        capi.python_flags()
    except RuntimeError as e:
        return str(e)
    return None


pytestmark = pytest.mark.skipif(
    _toolchain_reason() is not None,
    reason=f"native toolchain unavailable: {_toolchain_reason()}",
)


@pytest.fixture(scope="module")
def hosts():
    return capi.build_bridge()


def _save_box(path, nx, classes=False):
    from pumiumtally_tpu_torch.mesh.box import build_box_arrays
    from pumiumtally_tpu_torch.mesh.io import save_npz

    coords, tets = build_box_arrays(1.0, 1.0, 1.0, nx, nx, nx)
    cid = np.zeros(tets.shape[0], np.int32)
    if classes:
        cid = (coords[tets].mean(axis=1)[:, 0] > 0.5).astype(np.int32) + 1
    save_npz(str(path), coords, tets, cid)
    return coords, tets, cid


def _run(exe, *args, timeout=300):
    return subprocess.run([exe, *map(str, args)], env=capi.host_env("cpu"),
                          capture_output=True, text=True, timeout=timeout)


def test_demo_host_matches_jax_facade(hosts, tmp_path):
    mesh_file = tmp_path / "box.npz"
    coords, tets, cid = _save_box(mesh_file, 2)
    out_vtu = tmp_path / "flux.vtu"
    r = _run(hosts["demo_host"], mesh_file, out_vtu)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert r.stdout.splitlines()[-1] == "OK"
    assert out_vtu.exists()
    flux_sum = float(next(ln for ln in r.stdout.splitlines()
                          if ln.startswith("FLUX_SUM")).split()[1])

    # The same scenario through the JAX facade (tests/test_c_api.py).
    from pumiumtally_tpu import PumiTally, TallyConfig
    from pumiumtally_tpu.mesh.core import TetMesh

    n = 16
    t = PumiTally(TetMesh.from_numpy(coords, tets, cid), n,
                  TallyConfig(n_groups=2))
    pos = np.zeros((n, 3))
    pos[:, 0] = 0.2 + 0.6 * np.arange(n) / n
    pos[:, 1:] = 0.5
    t.initialize_particle_location(pos.ravel())
    dests = pos.copy()
    dests[:, 0] += 2.0
    t.move_to_next_location(
        dests, np.ones(n, np.int8), np.ones(n),
        (np.arange(n) % 2).astype(np.int32), np.full(n, -1, np.int32))
    assert flux_sum == pytest.approx(float(t.raw_flux[..., 0].sum()),
                                     rel=1e-6)


def _recorded_run():
    rng = np.random.default_rng(20)
    pos = rng.uniform(0.05, 0.95, (N, 3))
    moves, prev = [], pos
    for _ in range(MOVES):
        d = rng.normal(size=(N, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        dest = prev + d * rng.exponential(0.3, (N, 1))
        flying = (rng.uniform(size=N) > 0.1).astype(np.int8)
        moves.append((dest, flying, rng.uniform(0.5, 2.0, N),
                      rng.integers(0, G, N).astype(np.int32),
                      np.zeros(N, np.int32)))
        prev = np.where(flying[:, None] == 1, dest, prev)
    return pos, moves


def _drive(tally, pos, moves):
    """Drive a facade with copies of the recorded run; its write-backs."""
    tally.initialize_particle_location(pos.reshape(-1).copy())
    outs = []
    for dest, flying, weights, groups, mats in moves:
        d, f, m = dest.reshape(-1).copy(), flying.copy(), mats.copy()
        tally.move_to_next_location(d, f, weights.copy(), groups.copy(), m)
        outs.append((d.reshape(N, 3), f, m))
    return outs


@pytest.fixture(scope="module")
def replayed(hosts, tmp_path_factory):
    work = tmp_path_factory.mktemp("replay")
    mesh_file = work / "box.npz"
    _save_box(mesh_file, 4, classes=True)
    pos, moves = _recorded_run()
    capi.write_replay_inputs(str(work), pos, moves)
    ntet = 6 * 4 ** 3
    r = _run(hosts["replay_host"], mesh_file, work, N, MOVES, G,
             ntet * G * 2)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    secs = capi.parse_host_seconds(r.stdout)
    assert len(secs["move_s"]) == MOVES and secs["create_s"] > 0
    assert {"init_s", "flux_s", "write_s"} <= set(secs)
    assert (work / "flux.vtu").exists()
    out = capi.read_replay_outputs(str(work), N, MOVES)
    return dict(out, mesh_file=str(mesh_file), pos=pos, inputs=moves)


def test_replay_host_bitwise_port_facade(replayed):
    from pumiumtally_tpu_torch import PumiTally, TallyConfig

    t = PumiTally(replayed["mesh_file"], N, TallyConfig(n_groups=G),
                  device="cpu")
    outs = _drive(t, replayed["pos"], replayed["inputs"])
    flux = np.asarray(t.raw_flux, np.float64).ravel()
    assert replayed["flux"].tobytes() == flux.tobytes()
    for (cd, cf, cm), (pd, pf, pm) in zip(replayed["moves"], outs):
        assert cd.tobytes() == pd.tobytes()
        assert cf.tobytes() == pf.tobytes() and not cf.any()
        assert cm.tobytes() == pm.tobytes()
    # The write-backs did their work: lanes that left the box stop on it
    # with material -1, a crossing of the class boundary stops there.
    last = replayed["moves"][-1]
    assert (last[2] == -1).any() and (last[2] >= 1).any()
    assert (last[0] >= -1e-6).all() and (last[0] <= 1 + 1e-6).all()


def test_replay_host_matches_jax_facade(replayed):
    from pumiumtally_tpu import PumiTally, TallyConfig

    jt = PumiTally(replayed["mesh_file"], N, TallyConfig(n_groups=G))
    outs = _drive(jt, replayed["pos"], replayed["inputs"])
    # tests/test_torch_api.py's float32 tolerances; a bin's absolute error
    # may reach the position tolerance times the largest weight (queue C's
    # sliver allowance: XLA:CPU's FMAs place a tie on another side).
    pos_tol, rtol = 1e-5, 1e-4
    atol = pos_tol * max(float(m[2].max()) for m in replayed["inputs"])
    for (cd, cf, cm), (jd, jf, jm) in zip(replayed["moves"], outs):
        np.testing.assert_allclose(cd, jd, rtol=0, atol=pos_tol)
        np.testing.assert_array_equal(cf, jf)
        np.testing.assert_array_equal(cm, jm)
    want = np.asarray(jt.raw_flux, np.float64).ravel()
    np.testing.assert_allclose(replayed["flux"], want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("mode", ["packed", "overlap", "legacy"])
def test_write_backs_land_in_caller_buffers(monkeypatch, tmp_path, mode):
    """The bridge's memoryviews over the caller's memory: each mode's
    write-backs reach them (no copy in between)."""
    monkeypatch.setenv("PUMI_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("PUMI_TPU_IO_PIPELINE", mode)
    mesh_file = tmp_path / "box.npz"
    _save_box(mesh_file, 3)
    n = 8
    h = capi.create(str(mesh_file), n, 2)
    try:
        assert capi._registry[h]._io == mode
        pos = np.full((n, 3), 0.5)
        capi.initialize_particle_location(h, memoryview(pos).cast("B"),
                                          3 * n)
        dest = pos.copy()
        dest[:, 0] = np.linspace(-1.0, 2.0, n)
        want_x = np.clip(dest[:, 0], 0.0, 1.0)
        flying = np.ones(n, np.int8)
        mats = np.full(n, 7, np.int32)
        capi.move_to_next_location(
            h, memoryview(dest).cast("B"), memoryview(flying),
            memoryview(np.ones(n)).cast("B"),
            memoryview(np.zeros(n, np.int32)).cast("B"),
            memoryview(mats).cast("B"), 3 * n)
        np.testing.assert_allclose(dest[:, 0], want_x, atol=1e-6)
        assert not flying.any() and (mats == -1).all()
        flux = np.zeros(27 * 6 * 2 * 2)
        got = capi.get_flux(h, memoryview(flux).cast("B"), flux.size)
        assert got == flux.size and flux[0::2].sum() > 0
    finally:
        capi.destroy(h)
    assert h not in capi._registry


def _declarations(path):
    text = open(path).read()
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    return " ".join(text.split())


def test_header_declares_the_jax_abi():
    port = os.path.join(capi.HOST_DIR, "include", "pumi_tally.h")
    jax = os.path.join(REPO, "native", "include", "pumi_tally.h")
    assert _declarations(port) == _declarations(jax)
    names = re.findall(r"\b(pumi_tally_\w+)\s*\(", _declarations(port))
    assert sorted(set(names)) == sorted([
        "pumi_tally_create", "pumi_tally_destroy", "pumi_tally_get_flux",
        "pumi_tally_initialize_particle_location", "pumi_tally_last_error",
        "pumi_tally_move_to_next_location", "pumi_tally_write"])


@pytest.mark.parametrize("name,cause", [
    ("missing.npz", "No such file"),
    ("mesh.stl", "unsupported mesh format"),
])
def test_bad_mesh_path_returns_null(hosts, tmp_path, name, cause):
    r = _run(hosts["demo_host"], tmp_path / name, tmp_path / "out.vtu",
             timeout=120)
    assert r.returncode == 1
    assert "create failed:" in r.stderr and cause in r.stderr, r.stderr
    assert "OK" not in r.stdout

