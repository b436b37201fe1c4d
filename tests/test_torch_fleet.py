"""The port's serving fleet on the CPU: the router, the routing journal and
the gateway (``pumiumtally_tpu_torch/serving/{fleet,gateway}.py``).

Mirrors every case of tests/test_fleet.py on its 2x2x2 box with
``device="cpu"``: an idempotent resubmission returns the original id and
the key is journaled before the job reaches a member; a refused request
journals no key; placement balances load and breaks ties by warmth; a
torn or wrong-schema FLEET.json and a missing one are refused; the
gateway answers 400, 404 and 409 where the JAX gateway does and cancels
idempotently; the router's exporter mounts ``/fleet``; migration, member
death and router recovery lose no job, run none twice and end bitwise
the fault-free fleet; ``GET /result`` decodes bitwise. The JAX cases
marked slow drain real quanta; on the port's CPU path they compile
nothing and run here unmarked.

Against the JAX package: after the same submissions both routers' FLEET.json
hold equal ``accepted``, ``requests`` and ``assignments`` (submission only
enqueues, so JAX compiles nothing); a ``/result`` payload is byte-equal
for the same array and either package's ``decode_result`` reads the
other's; one fleet-served job's flux agrees with the JAX facade's
``run_source_moves`` of the same padded request (1e-10 relative per bin
in float64; float32 within queue C's sliver allowance). The journals'
texts equal ``json.dumps(doc, indent=1, sort_keys=True)`` byte for byte
(``RequestTexts`` keeps each request's text between flushes).
"""
from __future__ import annotations

import dataclasses
import json
import os
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pumiumtally_tpu as jpt
from pumiumtally_tpu.ops.source import SourceParams as JaxSourceParams
from pumiumtally_tpu.serving import FleetRouter as JaxFleetRouter
from pumiumtally_tpu.serving import synthetic_requests as jax_requests
from pumiumtally_tpu.serving.gateway import TallyGateway as JaxGateway
from pumiumtally_tpu.serving.gateway import decode_result as jax_decode
from pumiumtally_tpu_torch import TallyConfig, build_box
from pumiumtally_tpu_torch.serving import (
    FleetJournal,
    FleetRouter,
    TallyGateway,
    decode_result,
    synthetic_requests,
)
from pumiumtally_tpu_torch.serving.fleet import FLEET_FILE, FLEET_SCHEMA
from pumiumtally_tpu_torch.serving.journal import (
    RequestJSON,
    SchedulerJournal,
    request_text,
    request_to_json,
)
from torch_serving_twins import padded
from torch_twins import JDT, TOL, twin_meshes


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in (
        "PUMI_TPU_MEGASTEP", "PUMI_TPU_KERNEL", "PUMI_TPU_IO_PIPELINE",
        "PUMI_TPU_TUNING", "PUMI_TPU_AOT_FAULT", "PUMI_TPU_PROM_PORT",
        "PUMI_TPU_FAULTS", "PUMI_TPU_FLEET_OBS",
    ):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def mesh():
    return build_box(1.0, 1.0, 1.0, 2, 2, 2, device="cpu")


def _cfg(**kw):
    return TallyConfig(tolerance=1e-6, **kw)


def _router(tmp_path, mesh, n_members=2, **kw):
    kw.setdefault("quantum_moves", 2)
    kw.setdefault("max_resident", 2)
    return FleetRouter(
        mesh, _cfg(), fleet_dir=str(tmp_path / "fleet"),
        n_members=n_members, bank=None, device="cpu", **kw,
    )


def _reference_results(tmp_path, mesh, requests, **kw):
    """The fault-free fleet run of the same requests."""
    ref = FleetRouter(
        mesh, _cfg(), fleet_dir=str(tmp_path / "ref"), n_members=2,
        bank=None, quantum_moves=2, max_resident=2, device="cpu", **kw,
    )
    try:
        for r in requests:
            ref.submit(r, idempotency_key=f"key-{r.job_id}")
        ref.run()
        return {r.job_id: np.asarray(ref.result(r.job_id)).copy()
                for r in requests}
    finally:
        ref.close()


# --------------------------------------------------------------------- #
# Idempotent submission and its journal record
# --------------------------------------------------------------------- #
def test_idempotent_resubmit_same_id_and_journaled(tmp_path, mesh):
    router = _router(tmp_path, mesh)
    try:
        req = synthetic_requests(mesh, 1, class_sizes=(24,))[0]
        first = router.submit(req, idempotency_key="key-a")
        other = dataclasses.replace(req, job_id=None)
        again = router.submit(other, idempotency_key="key-a")
        assert again == first
        assert len(router.jobs()) == 1
        assert router.stats()["placements"] == {
            "member-0": 1, "member-1": 0,
        }
        doc = FleetJournal(router.journal.dir).load()
        assert doc["accepted"] == {"key-a": first}
        assert first in doc["assignments"]
        assert doc["n_submitted"] == 1
    finally:
        router.close()


def test_submission_validation(tmp_path, mesh):
    router = _router(tmp_path, mesh)
    try:
        req = synthetic_requests(mesh, 1, class_sizes=(24,))[0]
        with pytest.raises(ValueError, match="journal-safe"):
            router.submit(req, idempotency_key="../escape")
        with pytest.raises(ValueError, match="journal-safe"):
            router.submit(req, idempotency_key="")
        router.submit(req)
        with pytest.raises(ValueError, match="duplicate job id"):
            router.submit(req)
        doc = FleetJournal(router.journal.dir).load()
        assert doc["accepted"] == {}
    finally:
        router.close()


# --------------------------------------------------------------------- #
# Placement
# --------------------------------------------------------------------- #
def test_placement_balances_across_members(tmp_path, mesh):
    router = _router(tmp_path, mesh, n_members=4)
    try:
        for r in synthetic_requests(mesh, 8, class_sizes=(24,)):
            router.submit(r)
        assert [m.placed for m in router.members] == [2, 2, 2, 2]
        owners = {router.member_of(f"sat-{i:04d}") for i in range(8)}
        assert owners == {0, 1, 2, 3}
    finally:
        router.close()


def test_placement_prefers_warm_member_on_load_tie(tmp_path, mesh):
    router = _router(tmp_path, mesh, n_members=2)
    try:
        reqs = synthetic_requests(mesh, 3, class_sizes=(24, 130, 24))
        assert router.member_of(router.submit(reqs[0])) == 0
        assert router.member_of(router.submit(reqs[1])) == 1
        # A load tie: member 0 is warm for the small class.
        assert router.member_of(router.submit(reqs[2])) == 0
    finally:
        router.close()


# --------------------------------------------------------------------- #
# Torn or foreign routing journal
# --------------------------------------------------------------------- #
def test_torn_fleet_journal_rejected(tmp_path, mesh):
    fdir = tmp_path / "torn"
    fdir.mkdir()
    (fdir / FLEET_FILE).write_text('{"schema": 1, "members": 2, "acc')
    with pytest.raises(ValueError, match="not valid JSON"):
        FleetJournal(str(fdir)).load()
    with pytest.raises(ValueError, match="not valid JSON"):
        FleetRouter.recover(str(fdir), mesh, _cfg(), device="cpu")


def test_wrong_schema_fleet_journal_rejected(tmp_path, mesh):
    fdir = tmp_path / "schema"
    fdir.mkdir()
    (fdir / FLEET_FILE).write_text(
        json.dumps({"schema": FLEET_SCHEMA + 1, "members": 2})
    )
    with pytest.raises(ValueError, match="schema"):
        FleetJournal(str(fdir)).load()


def test_recover_without_journal_rejected(tmp_path, mesh):
    with pytest.raises(ValueError, match="nothing to recover"):
        FleetRouter.recover(str(tmp_path / "empty"), mesh, _cfg(),
                            device="cpu")


# --------------------------------------------------------------------- #
# The gateway's validation and cancel (every job stays queued)
# --------------------------------------------------------------------- #
def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, body: bytes):
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_gateway_validation_and_cancel(tmp_path, mesh):
    router = _router(tmp_path, mesh)
    gateway = TallyGateway(router, port=0)
    try:
        url = gateway.url
        assert _get(f"{url}/healthz") == (200, {"ok": True})
        status, body = _post(f"{url}/submit", b"{not json")
        assert status == 400 and "not JSON" in body["error"]
        status, body = _post(f"{url}/submit", b"[1, 2]")
        assert status == 400 and "JSON object" in body["error"]
        wire = request_to_json(
            synthetic_requests(mesh, 1, class_sizes=(24,))[0]
        )
        status, body = _post(
            f"{url}/submit", json.dumps(dict(wire, job_id="..")).encode()
        )
        assert status == 400
        status, body = _post(
            f"{url}/submit",
            json.dumps(dict(wire, idempotency_key=7)).encode(),
        )
        assert status == 400 and "idempotency_key" in body["error"]
        status, body = _post(
            f"{url}/submit",
            json.dumps({"n_moves": 4, "source": {}}).encode(),
        )
        assert status == 400 and "bad request" in body["error"]
        status, body = _get(f"{url}/status/{'a' * 200}")
        assert status == 400
        status, _ = _get(f"{url}/result/{'a' * 200}")
        assert status == 400
        status, body = _get(f"{url}/status/never-submitted")
        assert status == 404
        status, body = _get(f"{url}/nope")
        assert status == 404 and "POST /submit" in body["routes"]

        accepted = json.dumps(
            dict(wire, idempotency_key="key-g")
        ).encode()
        status, body = _post(f"{url}/submit", accepted)
        assert status == 200
        job = body["job"]
        status, body = _post(f"{url}/submit", accepted)
        assert (status, body["job"]) == (200, job)
        assert len(router.jobs()) == 1

        status, body = _get(f"{url}/status/{job}")
        assert status == 200
        assert body["state"] == "queued" and body["member"] == 0
        status, body = _get(f"{url}/result/{job}")
        assert status == 409

        status, body = _post(f"{url}/cancel", b'{"job": "ghost"}')
        assert status == 404
        status, body = _post(f"{url}/cancel", b"{}")
        assert status == 400
        status, body = _post(
            f"{url}/cancel", json.dumps({"job": job}).encode()
        )
        assert (status, body["cancelled"]) == (200, True)
        status, body = _post(
            f"{url}/cancel", json.dumps({"job": job}).encode()
        )
        assert (status, body["cancelled"]) == (200, False)
        status, body = _get(f"{url}/status/{job}")
        assert body["outcome"] == "cancelled"
        status, body = _get(f"{url}/result/{job}")
        assert status == 409
    finally:
        gateway.stop()
        router.close()


def test_exporter_mounts_fleet_endpoint(tmp_path, mesh, monkeypatch):
    monkeypatch.setenv("PUMI_TPU_PROM_PORT", "0")
    router = _router(tmp_path, mesh)
    try:
        assert router._exporter is not None
        base = f"http://127.0.0.1:{router._exporter.port}"
        with urllib.request.urlopen(f"{base}/buildz", timeout=30) as r:
            info = json.loads(r.read())
        assert "/fleet" in info["endpoints"]
        with urllib.request.urlopen(f"{base}/fleet", timeout=30) as r:
            fleet = json.loads(r.read())
        assert [m["member"] for m in fleet["members"]] == [0, 1]
        assert all(m["alive"] for m in fleet["members"])
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/missing", timeout=30)
        assert err.value.code == 404 and "/fleet" in err.value.read().decode()
    finally:
        router.close()


# --------------------------------------------------------------------- #
# Real quanta: migration, member death, recovery, the result over HTTP
# --------------------------------------------------------------------- #
def test_migration_bitwise_vs_uninterrupted(tmp_path, mesh):
    requests = synthetic_requests(mesh, 2, class_sizes=(24,), n_moves=8)
    ref = _reference_results(tmp_path, mesh, requests)
    router = _router(tmp_path, mesh)
    try:
        for r in requests:
            router.submit(r, idempotency_key=f"key-{r.job_id}")
        router.step()
        moving = next(j for j in router.jobs() if not j.terminal)
        src = router.member_of(moving.id)
        dst = router.migrate(moving.id)
        assert dst != src and router.member_of(moving.id) == dst
        router.run()
        for r in requests:
            assert np.array_equal(
                np.asarray(router.result(r.job_id)), ref[r.job_id]
            ), f"{r.job_id} not bitwise across migration"
        stats = router.stats()
        assert stats["migrations"] == 1
        assert stats["outcomes"] == {"completed": 2}
        assert sum(
            m.registry.counter(
                "pumi_jobs_recovered_total"
            ).value(source="migrated")
            for m in router.members
        ) == 1
        trace = [
            json.loads(line)
            for line in open(router.journal.trace_path())
            if line.strip()
        ]
        links = [t for t in trace if t.get("name") == "migrated"]
        assert [t["job_id"] for t in links] == [moving.id]
    finally:
        router.close()


def test_member_kill_zero_lost_zero_duplicated(tmp_path, mesh):
    requests = synthetic_requests(mesh, 6, class_sizes=(24,), n_moves=6)
    ref = _reference_results(tmp_path, mesh, requests)
    router = _router(tmp_path, mesh, n_members=3)
    try:
        for r in requests:
            router.submit(r, idempotency_key=f"key-{r.job_id}")
        router.step()
        victim_jobs = [
            r.job_id for r in requests if router.member_of(r.job_id) == 0
        ]
        assert victim_jobs
        router.kill_member(0)
        assert not router.members[0].alive
        assert router.registry.gauge("pumi_fleet_members").value() == 2
        assert router.registry.gauge(
            "pumi_fleet_queue_depth"
        ).value(member="m0") == 0
        for jid in victim_jobs:
            assert router.member_of(jid) != 0
        router.run()
        ids = sorted(j.id for j in router.jobs())
        assert ids == sorted(r.job_id for r in requests)
        for r in requests:
            assert np.array_equal(
                np.asarray(router.result(r.job_id)), ref[r.job_id]
            ), f"{r.job_id} not bitwise across member death"
        stats = router.stats()
        assert stats["alive"] == 2
        assert stats["outcomes"] == {"completed": 6}
        assert stats["migrations"] >= len(victim_jobs)
    finally:
        router.close()


def test_recovery_preserves_idempotency_keys(tmp_path, mesh):
    requests = synthetic_requests(mesh, 4, class_sizes=(24,), n_moves=6)
    ref = _reference_results(tmp_path, mesh, requests)
    fdir = str(tmp_path / "fleet")
    router = FleetRouter(
        mesh, _cfg(), fleet_dir=fdir, n_members=2, bank=None,
        quantum_moves=2, max_resident=2, device="cpu",
    )
    accepted = {}
    for r in requests:
        accepted[r.job_id] = router.submit(
            r, idempotency_key=f"key-{r.job_id}"
        )
    router.step()
    router.abandon()  # the crash model: no graceful flush
    router = FleetRouter.recover(
        fdir, mesh, _cfg(), bank=None, quantum_moves=2, max_resident=2,
        device="cpu",
    )
    try:
        for r in requests:
            assert router.submit(
                r, idempotency_key=f"key-{r.job_id}"
            ) == accepted[r.job_id]
        assert len(router.jobs()) == len(requests)
        router.run()
        for r in requests:
            assert np.array_equal(
                np.asarray(router.result(r.job_id)), ref[r.job_id]
            ), f"{r.job_id} not bitwise across router recovery"
        stats = router.stats()
        assert stats["recovered"] >= 1
        assert stats["outcomes"] == {"completed": len(requests)}
    finally:
        router.close()


def test_result_roundtrip_bitwise_over_http(tmp_path, mesh):
    requests = synthetic_requests(mesh, 2, class_sizes=(24,), n_moves=4)
    router = _router(tmp_path, mesh)
    gateway = TallyGateway(router, port=0)
    try:
        for r in requests:
            wire = dict(
                request_to_json(r), idempotency_key=f"key-{r.job_id}"
            )
            status, body = _post(
                f"{gateway.url}/submit", json.dumps(wire).encode()
            )
            assert (status, body["job"]) == (200, r.job_id)
        router.run()
        for r in requests:
            status, body = _get(f"{gateway.url}/result/{r.job_id}")
            assert status == 200
            assert np.array_equal(
                decode_result(body), np.asarray(router.result(r.job_id))
            )
    finally:
        gateway.stop()
        router.close()


# --------------------------------------------------------------------- #
# The journals' texts
# --------------------------------------------------------------------- #
def test_journal_texts_are_json_dumps(tmp_path, mesh):
    """Both journals write the bytes of ``json.dumps(doc, indent=1,
    sort_keys=True)``. A plain request dict's text is kept by its journal
    between flushes, made again when the object changes and dropped with
    its job; a ``RequestJSON`` keeps its texts itself, shared by every
    journal that holds it. Number lists that repr cannot render as json
    (NaN, bools, mixed nesting) go through json."""
    rng = np.random.default_rng(5)
    for req in (
        {"origins": rng.random((7, 3)).tolist(), "n_moves": 2,
         "weights": rng.random(7).tolist(), "groups": [0, 3, 1, 1, 2, 0, 4],
         "source": {"seed": 3, "sigma_t": {"1": 2.5}}, "job_id": "a",
         "trace_id": None},
        {"origins": [[1e-05, -2.5e300, 3.0]], "weights": [float("nan")],
         "groups": [True], "n_moves": 1},
        {"origins": [[1.0], 2.0], "weights": [], "groups": [[]]},
    ):
        assert request_text(req) == json.dumps(req, indent=1,
                                                sort_keys=True)
    reqs = {f"j{i}": {"origins": rng.random((3, 3)).tolist(), "n_moves": i}
            for i in range(3)}
    journal = SchedulerJournal(str(tmp_path / "member"))
    entries = [{"id": k, "index": i, "request": v}
               for i, (k, v) in enumerate(reqs.items())]
    for cut in (3, 2, 3):
        journal.flush(entries[:cut], quantum_moves=2)
        want = {"schema": 2, "quantum_moves": 2,
                "jobs": {e["id"]: e for e in entries[:cut]}}
        assert open(journal.path).read() == json.dumps(
            want, indent=1, sort_keys=True) + "\n"
    kept = journal._texts._kept
    text = kept["j1"][1][3]
    journal.flush(entries, quantum_moves=2)
    assert kept["j1"][1][3] is text
    entries[1] = dict(entries[1], request=dict(reqs["j1"], n_moves=9))
    journal.flush(entries, quantum_moves=2)
    assert kept["j1"][1][3] is not text
    assert '"n_moves": 9' in open(journal.path).read()
    journal.flush(entries[:1], quantum_moves=2)
    assert set(kept) == {"j0"}
    # The router's request, held by FLEET.json and two member journals.
    req = request_to_json(synthetic_requests(mesh, 1, class_sizes=(5,))[0])
    assert isinstance(req, RequestJSON)
    fleet = FleetJournal(str(tmp_path / "fleet"))
    doc = {"members": 2, "n_submitted": 1, "accepted": {"k": "sat-0000"},
           "requests": {"sat-0000": req}, "assignments": {}, "evicted": {},
           "breaches": {}}
    fleet.flush(doc)
    assert open(fleet.path).read() == json.dumps(
        dict(doc, schema=FLEET_SCHEMA), indent=1, sort_keys=True) + "\n"
    assert fleet.load() == dict(doc, schema=FLEET_SCHEMA)
    entry = [{"id": "sat-0000", "index": 0, "request": req}]
    journal.flush(entry, quantum_moves=2)
    text = req.texts[3]
    SchedulerJournal(str(tmp_path / "adopter")).flush(entry, quantum_moves=2)
    assert req.texts[3] is text and sorted(req.texts) == [0, 2, 3]
    assert open(tmp_path / "adopter" / "JOBS.json").read() == \
        open(journal.path).read()


# --------------------------------------------------------------------- #
# Against the JAX package
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def twins():
    return {dt: twin_meshes(dt, nx=2) for dt in (torch.float32,
                                                 torch.float64)}


def test_fleet_journal_matches_jax(tmp_path, twins):
    """The same submissions (with and without keys, a dedup, four
    members) leave equal ``accepted``, ``requests`` and ``assignments`` in
    both routers' FLEET.json."""
    jmesh, pmesh = twins[torch.float64]
    docs = []
    for tag, router_cls, reqs_fn, cfg, kw in (
        ("port", FleetRouter, synthetic_requests,
         TallyConfig(dtype=torch.float64, tolerance=1e-6),
         dict(device="cpu")),
        ("jax", JaxFleetRouter, jax_requests,
         jpt.TallyConfig(dtype=jnp.float64, tolerance=1e-6), {}),
    ):
        mesh = pmesh if tag == "port" else jmesh
        router = router_cls(
            mesh, cfg, fleet_dir=str(tmp_path / tag), n_members=4,
            bank=None, quantum_moves=2, max_resident=2, **kw)
        try:
            reqs = reqs_fn(mesh, 6, class_sizes=(24, 130), n_moves=4,
                           seed=2)
            for i, r in enumerate(reqs):
                router.submit(r, idempotency_key=(
                    None if i == 3 else f"key-{r.job_id}"))
            router.submit(reqs[0], idempotency_key="key-sat-0000")
            docs.append(json.load(open(router.journal.path)))
        finally:
            router.close()
    for key in ("accepted", "requests", "assignments", "n_submitted",
                "members", "evicted", "breaches"):
        assert docs[0][key] == docs[1][key], key
    assert len(docs[0]["accepted"]) == 5


def test_result_payloads_match_jax(tmp_path):
    """``GET /result``'s payload for the same array is byte-equal in both
    packages, and each package's ``decode_result`` reads the other's."""
    flux = np.random.default_rng(3).random((48, 2, 2))

    class Owner:
        @staticmethod
        def result(job_id):
            return flux

    payloads = []
    for cls in (TallyGateway, JaxGateway):
        gw = cls(Owner, port=0)
        try:
            status, payload = gw._result("job-1")
        finally:
            gw.stop()
        assert status == 200
        payloads.append(json.dumps(payload, sort_keys=True))
    assert payloads[0] == payloads[1]
    mine, theirs = (json.loads(p) for p in payloads)
    for decode in (decode_result, jax_decode):
        for payload in (mine, theirs):
            got = decode(payload)
            assert got.dtype == flux.dtype and got.tobytes() == flux.tobytes()
    f32 = flux.astype(np.float32)
    Owner.result = staticmethod(lambda job_id: f32)
    gw = TallyGateway(Owner, port=0)
    try:
        assert jax_decode(gw._result("j")[1]).tobytes() == f32.tobytes()
    finally:
        gw.stop()


@pytest.fixture(scope="module")
def jax_served(twins):
    """Per dtype: one synthetic job (40 particles, 4 moves) and the JAX
    facade's flux of its padded request, chunked by the quantum (2)."""
    out = {}
    for dt, (jmesh, _) in twins.items():
        req = jax_requests(jmesh, 1, class_sizes=(40,), n_moves=4,
                           seed=3)[0]
        origins, w, g, alive = padded(req)
        jt = jpt.PumiTally(jmesh, origins.shape[0], jpt.TallyConfig(
            dtype=JDT[dt], tolerance=1e-6, megastep=2))
        jt.initialize_particle_location(origins.reshape(-1).copy())
        jt.run_source_moves(
            4, JaxSourceParams(**dataclasses.asdict(req.source)),
            weights=w, groups=g, alive=alive)
        out[dt] = np.asarray(jt.raw_flux)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fleet_served_job_matches_jax_facade(tmp_path, twins, jax_served,
                                             dtype):
    """One job served by a 2-member fleet over HTTP
    (``run_fleet_saturation``) against the JAX facade's
    ``run_source_moves`` of the same padded request."""
    from pumiumtally_tpu_torch.serving import run_fleet_saturation

    pmesh = twins[dtype][1]
    out = run_fleet_saturation(
        pmesh, _cfg(dtype=dtype), fleet_dir=str(tmp_path / "f"),
        n_jobs=1, class_sizes=(40,), n_moves=4, seed=3, quantum_moves=2,
        device="cpu")
    assert out["per_job"][0]["outcome"] == "completed"
    assert out["via_http"] and out["fleet"]["alive"] == 2
    got = out["results"]["sat-0000"]
    pos_tol, rtol, atol = TOL[dtype]
    np.testing.assert_allclose(
        got, jax_served[dtype], rtol=rtol,
        atol=atol if dtype == torch.float64 else pos_tol)


def test_fleet_cli_serves_crashes_and_resumes(tmp_path, monkeypatch, capsys):
    """``python -m pumiumtally_tpu_torch.serving --fleet 2``'s ``main``:
    a router killed by ``kill_server_at_quantum:3`` raises; ``--resume``
    recovers the fleet, every re-POSTed key dedups, and the JSON last
    line names the members; the fluxes equal a fault-free fleet's."""
    from pumiumtally_tpu_torch.obs import fleetview
    from pumiumtally_tpu_torch.resilience.faultinject import InjectedKill
    from pumiumtally_tpu_torch.serving.__main__ import main

    argv = ["--device", "cpu", "--demo", "3", "--moves", "4", "--quantum",
            "2", "--fleet", "2", "--port", "0", "--bank", "off"]
    assert main(argv + ["--journal", str(tmp_path / "clean"),
                        "--out", str(tmp_path / "clean.json")]) == 0
    clean = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setenv("PUMI_TPU_FAULTS", "kill_server_at_quantum:3")
    fdir = str(tmp_path / "fleet")
    with pytest.raises(InjectedKill):
        main(argv + ["--journal", fdir])
    monkeypatch.delenv("PUMI_TPU_FAULTS")
    capsys.readouterr()
    assert main(argv + ["--journal", fdir, "--resume",
                        "--out", str(tmp_path / "out.json")]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["summary"]["members"] == 2
    assert summary["summary"]["outcomes"] == {"completed": 3}
    assert summary["summary"]["recovered"] >= 1
    assert FleetJournal(fdir).load()["n_submitted"] == 3
    out = json.load(open(tmp_path / "out.json"))
    ref = json.load(open(tmp_path / "clean.json"))
    assert out["flux_sha256"] == ref["flux_sha256"]
    assert len(ref["flux_sha256"]) == 3
    assert clean["summary"]["outcomes"] == {"completed": 3}
    assert clean["summary"]["placements"] == {"member-0": 2, "member-1": 1}
    assert fleetview.main(["--check", fdir]) == 0


def test_migration_reuses_the_quantum_boundary_checkpoint(tmp_path, mesh,
                                                          monkeypatch):
    """A journaled member wrote the job's checkpoint at the quantum
    boundary the migration preempts it at: the migration saves nothing
    more, the target restores that file, and the flux is bitwise the
    fault-free fleet's (quanta of 2 there: the source loop is bitwise in
    its chunking). A checkpoint file that is gone is written again."""
    from pumiumtally_tpu_torch import PumiTally

    requests = synthetic_requests(mesh, 2, class_sizes=(24,), n_moves=8)
    ref = _reference_results(tmp_path, mesh, requests)
    saves = []
    real = PumiTally.save_checkpoint

    def counted(self, path, *a, **kw):
        saves.append((os.path.basename(path), self.iter_count))
        return real(self, path, *a, **kw)

    monkeypatch.setattr(PumiTally, "save_checkpoint", counted)
    router = _router(tmp_path, mesh, quantum_moves=1)
    try:
        for r in requests:
            router.submit(r, idempotency_key=f"key-{r.job_id}")
        router.step()
        assert sorted(saves) == [("sat-0000.ckpt.npz", 1),
                                 ("sat-0001.ckpt.npz", 1)]
        router.migrate("sat-0000")
        assert len(saves) == 2
        router.step()  # the adopter restores it and runs a quantum
        sched = router.members[router.member_of("sat-0000")].scheduler
        job = sched.job("sat-0000")
        assert job.moves_done == 2 and ("sat-0000.ckpt.npz", 2) in saves
        n = len(saves)
        sched.preempt_job("sat-0000")  # at the boundary just written
        assert len(saves) == n
        router.step()  # re-admitted from that file, one more quantum
        assert job.moves_done == 3 and saves[-1] == ("sat-0000.ckpt.npz", 3)
        n = len(saves)
        os.remove(job.checkpoint)  # a file that is gone is written again
        sched.preempt_job("sat-0000")
        assert saves[n:] == [("sat-0000.ckpt.npz", 3)]
        router.run()
        for r in requests:
            assert np.array_equal(router.result(r.job_id), ref[r.job_id])
    finally:
        router.close()
