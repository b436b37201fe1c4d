"""The port's resilience layer (``resilience/store.py``, ``runner.py``,
``coordinator.py``, ``faultinject.py``, ``utils/checkpoint.py``,
``utils/signals.py``) on ``device="cpu"``.

Mirrors test_resilience's durable-checkpoint cases (atomic writes, the
per-array digest, the dtype check, keep-N rotation with the
corrupt-generation fallback, a mismatched checkpoint still raising, the
sweep of orphaned temporary files), its fault grammar and environment
cases, its runner cases (die_at_move then auto-resume bitwise equal to an
uninterrupted run, a transient retried with backoff bitwise, retries
exhausted, retry snapshots off, SIGTERM flushing the last generation, a
deferred signal delivered when the move raises, corrupt_ckpt through the
runner, a NaN source quarantined, retries after a walk failure and after
a write-back failure re-seeing the original inputs, quarantine counts
riding checkpoints). The quarantine cases already in
tests/test_torch_quarantine.py are not repeated.

Also the megastep's single-device checkpoint and runner cases of
test_megastep (checkpoint restore mid-run, a transient retried at
megastep granularity, the mid-call checkpoint cadence), test_convergence's
``test_checkpoint_restore_rebases_batch_statistics``, and the port's own
verdicts: chip loss on the plain facade flushes the last good generation
and re-raises the loss, a mid-move preemption flushes the
last good generation, and the coordinator's probe and classification.
"""
from __future__ import annotations

import json
import os
import signal

import numpy as np
import pytest
import torch

from pumiumtally_tpu_torch import PumiTally, TallyConfig, build_box
from pumiumtally_tpu_torch.integrity import (
    DispatchTimeoutError,
    FatalIntegrityViolation,
)
from pumiumtally_tpu_torch.ops.source import SourceParams
from pumiumtally_tpu_torch.resilience.coordinator import (
    VERDICTS,
    DeviceError,
    ResilienceCoordinator,
)
from pumiumtally_tpu_torch.resilience.faultinject import (
    ChipLostError,
    FaultInjector,
    FaultPlan,
    InjectedKill,
    InjectedPreemption,
    InjectedTransientFault,
    parse_faults,
    plan_from_env,
)
from pumiumtally_tpu_torch.resilience.runner import (
    RETRYABLE,
    ResilientRunner,
)
from pumiumtally_tpu_torch.resilience.store import CheckpointStore
from pumiumtally_tpu_torch.utils.checkpoint import verify_checkpoint
from torch_twins import twin_meshes

N = 16


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.delenv("PUMI_TPU_FAULTS", raising=False)
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    monkeypatch.delenv("PUMI_TPU_MEGASTEP", raising=False)


@pytest.fixture(scope="module")
def mesh():
    return build_box(1.0, 1.0, 1.0, 4, 4, 4, device="cpu")


def _tally(mesh, **cfg_kw):
    return PumiTally(mesh, N, TallyConfig(tolerance=1e-6, **cfg_kw),
                     device="cpu")


def _fresh(mesh, **cfg_kw):
    t = _tally(mesh, **cfg_kw)
    rng = np.random.default_rng(42)
    t.initialize_particle_location(rng.uniform(0.1, 0.9, (N, 3)).ravel())
    return t


def _inputs(i):
    """Deterministic per-move inputs, so an interrupted run can replay the
    moves an uninterrupted run made."""
    rng = np.random.default_rng(100 + i)
    return (
        rng.uniform(0.05, 0.95, (N, 3)).ravel().copy(),
        np.ones(N, np.int8),
        rng.uniform(0.5, 2.0, N),
        rng.integers(0, 2, N).astype(np.int32),
        np.full(N, -1, np.int32),
    )


def _drive(t, first, last):
    for i in range(first, last + 1):
        t.move_to_next_location(*_inputs(i))


# ===================================================================== #
# Durable checkpoints
# ===================================================================== #
def test_atomic_save_never_leaves_truncated_file(mesh, tmp_path,
                                                 monkeypatch):
    path = str(tmp_path / "t.npz")
    t = _fresh(mesh)
    _drive(t, 1, 1)
    t.save_checkpoint(path)
    before = open(path, "rb").read()

    def boom(f, **arrays):
        f.write(b"PK\x03\x04 partial garbage")
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(np, "savez_compressed", boom)
    _drive(t, 2, 2)
    with pytest.raises(OSError):
        t.save_checkpoint(path)
    monkeypatch.undo()
    assert open(path, "rb").read() == before
    assert verify_checkpoint(path)["iter_count"] == 1
    assert not [p for p in os.listdir(tmp_path) if ".tmp-" in p]


def test_digest_detects_corruption(mesh, tmp_path):
    path = str(tmp_path / "t.npz")
    t = _fresh(mesh)
    _drive(t, 1, 1)
    t.save_checkpoint(path)
    meta = verify_checkpoint(path)
    assert set(meta["array_sha256"]) >= {"flux", "origin", "elem"}
    FaultInjector(parse_faults("corrupt_ckpt")).corrupt_file(path)
    with pytest.raises(Exception):
        verify_checkpoint(path)
    b = _fresh(mesh)
    with pytest.raises(Exception):
        b.restore_checkpoint(path)
    assert b.iter_count == 0  # nothing half-applied


def _tamper_meta(path, **fields):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays.pop("meta").tobytes()).decode())
    meta.update(fields)
    np.savez_compressed(
        path, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
        **arrays)


def test_dtype_mismatch_rejected(mesh, tmp_path):
    path = str(tmp_path / "t.npz")
    t = _fresh(mesh)
    t.save_checkpoint(path)
    _tamper_meta(path, dtype="float64")
    b = _fresh(mesh)
    with pytest.raises(ValueError, match="dtype"):
        b.restore_checkpoint(path)


def test_store_rotation_and_corrupt_fallback(mesh, tmp_path):
    store = CheckpointStore(str(tmp_path / "cks"), keep=2)
    t = _fresh(mesh)
    for i in range(1, 4):
        _drive(t, i, i)
        store.save(t)
    assert [it for it, _ in store.entries()] == [2, 3]
    assert store.find_latest()[0] == 3
    FaultInjector(parse_faults("corrupt_ckpt")).corrupt_file(
        store.path_for(3))
    assert store.find_latest()[0] == 2
    b = _fresh(mesh)
    assert store.restore_latest(b) == 2
    assert b.iter_count == 2
    FaultInjector(parse_faults("corrupt_ckpt")).corrupt_file(
        store.path_for(2))
    assert store.find_latest() is None
    assert store.restore_latest(_fresh(mesh)) is None


def test_mismatched_checkpoint_still_raises(mesh, tmp_path):
    store = CheckpointStore(str(tmp_path / "cks"))
    store.save(_fresh(mesh))
    wrong = PumiTally(build_box(1.0, 1.0, 1.0, 2, 2, 2, device="cpu"), N,
                      TallyConfig(tolerance=1e-6), device="cpu")
    with pytest.raises(ValueError, match="different mesh"):
        store.restore_latest(wrong)


def test_store_sweeps_orphaned_tmp_files(mesh, tmp_path):
    d = tmp_path / "cks"
    d.mkdir()
    orphan = d / "ckpt-00000001.npz.tmp-abc123"
    orphan.write_bytes(b"half-written garbage")
    uncommitted = d / "ckpt-00000002.shards"
    uncommitted.mkdir()
    (uncommitted / "shard-000.npz").write_bytes(b"x")
    store = CheckpointStore(str(d))
    assert not orphan.exists() and not uncommitted.exists()
    store.save(_fresh(mesh))
    assert store.find_latest() is not None


# ===================================================================== #
# Fault grammar
# ===================================================================== #
def test_parse_faults_grammar():
    p = parse_faults("nan_src:0.01,die_at_move:3,corrupt_ckpt,seed:5")
    assert (p.nan_src, p.die_at_move, p.corrupt_ckpt, p.seed) == (
        0.01, 3, True, 5)
    assert not parse_faults("").any()
    assert parse_faults("transient_at_move:2").transient_at_move == 2
    p = parse_faults("chip_down_at_move:4,chip:2,preempt_at_move:6")
    assert (p.chip_down_at_move, p.chip, p.preempt_at_move) == (4, 2, 6)
    assert p.any()
    assert parse_faults("torn_shard:2").torn_shard == 2
    with pytest.raises(ValueError, match="unknown fault"):
        parse_faults("explode:1")
    with pytest.raises(ValueError, match="probability"):
        parse_faults("nan_src:2.0")
    with pytest.raises(ValueError, match="torn_shard"):
        parse_faults("torn_shard:0")


@pytest.mark.parametrize("spec", [
    "nan_src:0.01,die_at_move:3,corrupt_ckpt,seed:5",
    "bitflip_flux:2,sdc_walk:3,hang_at_move:4,hang_seconds:0.5",
    "chip_down_at_move:4,chip:2,preempt_at_move:6,torn_shard:2",
    "poison_job:1,transient_quantum:2,kill_server_at_quantum:3",
    "wedge_member:0,slow_member:1:3.5,disk_full_at:2",
    "", "explode:1", "nan_src:2.0", "slow_member:1:0.5",
])
def test_fault_plans_are_the_jax_packages(spec):
    """Every clause parses to the JAX package's plan, or fails with its
    message."""
    from pumiumtally_tpu.resilience import faultinject as jfi

    try:
        want = jfi.parse_faults(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_faults(spec)
        assert str(got.value) == str(e)
        return
    got = parse_faults(spec)
    assert {f: getattr(got, f) for f in FaultPlan.__dataclass_fields__} == {
        f: getattr(want, f) for f in FaultPlan.__dataclass_fields__}


def test_plan_from_env(monkeypatch):
    monkeypatch.setenv("PUMI_TPU_FAULTS", "nan_src:0.5,seed:9")
    inj = FaultInjector()
    assert inj.plan.nan_src == 0.5 and inj.plan.seed == 9
    assert plan_from_env() == inj.plan
    d = np.zeros((N, 3))
    hit = inj.corrupt_destinations(d, move=1)
    assert hit > 0 and np.isnan(d).any()
    d2 = np.zeros((N, 3))
    assert FaultInjector().corrupt_destinations(d2, move=1) == hit
    np.testing.assert_array_equal(np.isnan(d), np.isnan(d2))


# ===================================================================== #
# The supervisor
# ===================================================================== #
def test_die_at_move_resume_bitwise_identical(mesh, tmp_path):
    ref = _fresh(mesh)
    _drive(ref, 1, 5)
    d = str(tmp_path / "cks")
    a = _tally(mesh)
    run_a = ResilientRunner(a, d, every_moves=1, handle_signals=False,
                            faults=FaultInjector(parse_faults("die_at_move:4")))
    rng = np.random.default_rng(42)
    run_a.initialize_particle_location(rng.uniform(0.1, 0.9, (N, 3)).ravel())
    with pytest.raises(InjectedKill):
        for i in range(1, 6):
            run_a.move_to_next_location(*_inputs(i))
    assert a.iter_count == 3

    b = _tally(mesh)
    run_b = ResilientRunner(b, d, every_moves=1, handle_signals=False)
    assert run_b.resumed_from == 3
    run_b.initialize_particle_location(rng.uniform(0.1, 0.9, (N, 3)).ravel())
    for i in range(1, 6):
        if b.iter_count >= i:
            continue
        run_b.move_to_next_location(*_inputs(i))
    run_b.close()
    np.testing.assert_array_equal(b.raw_flux, ref.raw_flux)
    np.testing.assert_array_equal(b.element_ids, ref.element_ids)
    assert b.total_segments == ref.total_segments
    assert b.metrics.counter("pumi_resumes_total").value() == 1


@pytest.mark.parametrize("io", ["packed", "overlap", "legacy"])
def test_transient_retry_with_backoff(mesh, tmp_path, io):
    ref = _fresh(mesh, io_pipeline=io)
    _drive(ref, 1, 3)
    delays = []
    t = _fresh(mesh, io_pipeline=io)
    run = ResilientRunner(
        t, str(tmp_path / "cks"), every_moves=10, handle_signals=False,
        max_retries=3, backoff_base=0.25,
        faults=FaultInjector(parse_faults("transient_at_move:2")),
        sleep=delays.append)
    _drive(run, 1, 3)
    np.testing.assert_array_equal(t.raw_flux, ref.raw_flux)
    assert delays == [0.25]
    assert t.metrics.counter("pumi_move_retries_total").value() == 1
    assert run.recovery_stats["rollbacks"] == 1


def test_retry_snapshots_off_propagates_transients(mesh, tmp_path):
    t = _fresh(mesh)
    run = ResilientRunner(
        t, str(tmp_path / "cks"), handle_signals=False,
        retry_snapshots=False, sleep=lambda s: None,
        faults=FaultInjector(parse_faults("transient_at_move:1")))
    assert run._good is None
    with pytest.raises(InjectedTransientFault):
        run.move_to_next_location(*_inputs(1))


def test_transient_exhausts_retries(mesh, tmp_path):
    class AlwaysTransient(FaultInjector):
        def maybe_transient(self, move):
            raise InjectedTransientFault("flaky forever")

    t = _fresh(mesh)
    run = ResilientRunner(t, str(tmp_path / "cks"), handle_signals=False,
                          max_retries=2, faults=AlwaysTransient(),
                          sleep=lambda s: None)
    with pytest.raises(InjectedTransientFault):
        run.move_to_next_location(*_inputs(1))


def test_snapshot_is_not_written_by_later_moves(mesh, tmp_path):
    """The walk adds into the flux in place: the retry anchor is a clone,
    so a failed move after it cannot leak into the rollback (a viewed
    snapshot would double the move on replay)."""
    t = _fresh(mesh)
    run = ResilientRunner(t, str(tmp_path / "cks"), handle_signals=False,
                          every_moves=100, sleep=lambda s: None)
    _drive(run, 1, 1)
    good = run._good[2]["flux"].clone()
    _drive(t, 2, 2)  # unsupervised: mutates t.flux in place
    np.testing.assert_array_equal(run._good[2]["flux"].numpy(),
                                  good.numpy())
    assert run._good[2]["flux"].data_ptr() != t.flux.data_ptr()


def test_sigterm_flushes_final_checkpoint(mesh, tmp_path):
    t = _fresh(mesh)
    store = CheckpointStore(str(tmp_path / "cks"))
    run = ResilientRunner(t, store, every_moves=1000)
    try:
        _drive(run, 1, 2)
        assert store.find_latest() is None
        with pytest.raises(SystemExit) as exc:
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(100):
                pass
        assert exc.value.code == 128 + signal.SIGTERM
        assert store.find_latest()[0] == 2
        assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    finally:
        run._uninstall_signal_handlers()


def test_pending_signal_delivered_when_move_raises(mesh, tmp_path):
    t = _fresh(mesh)
    store = CheckpointStore(str(tmp_path / "cks"))
    run = ResilientRunner(t, store, every_moves=1000)
    try:
        def bad_move(*args, **kwargs):
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(100):
                pass
            raise RuntimeError("caller bug mid-move")

        t.move_to_next_location = bad_move
        with pytest.raises(SystemExit) as exc:
            run.move_to_next_location(*_inputs(1))
        assert exc.value.code == 128 + signal.SIGTERM
        assert store.find_latest()[0] == 0
    finally:
        run._uninstall_signal_handlers()


def test_corrupt_ckpt_fault_through_runner(mesh, tmp_path):
    t = _fresh(mesh)
    run = ResilientRunner(t, str(tmp_path / "cks"), every_moves=1,
                          handle_signals=False,
                          faults=FaultInjector(parse_faults("corrupt_ckpt")))
    _drive(run, 1, 2)
    assert len(run.store.entries()) >= 1
    assert run.store.find_latest() is None


def test_nan_source_quarantined_not_crash(mesh, tmp_path):
    t = _tally(mesh, quarantine=True)
    rng = np.random.default_rng(42)
    run = ResilientRunner(
        t, str(tmp_path / "cks"), every_moves=1000, handle_signals=False,
        faults=FaultInjector(parse_faults("nan_src:0.3,seed:7")))
    run.initialize_particle_location(rng.uniform(0.1, 0.9, (N, 3)).ravel())
    _drive(run, 1, 3)
    tm = t.telemetry()
    assert tm["quarantined"] > 0
    assert tm["quarantined"] == tm["totals"]["quarantined"]
    assert np.isfinite(t.raw_flux).all()
    assert t.quarantined_lanes().sum() == tm["quarantined"]
    inj = t.metrics.counter("pumi_injected_faults_total")
    assert inj.value(kind="nan_src") == tm["quarantined"]


def test_retry_after_walk_failure_keeps_quarantine_semantics(mesh,
                                                             tmp_path):
    """A device error inside the walk, after the quarantine scan: the
    retry re-sees the original inputs, the lane is quarantined again (not
    walked to the sanitized zeros) and its count ends at 1."""
    t = _fresh(mesh, quarantine=True)
    orig, fired = t._trace, []

    def flaky(*args, **kwargs):
        if not fired:
            fired.append(True)
            raise DeviceError("device lost mid-walk")
        return orig(*args, **kwargs)

    t._trace = flaky
    run = ResilientRunner(t, str(tmp_path / "cks"), every_moves=1000,
                          handle_signals=False, sleep=lambda s: None)
    dest, fly, w, g, mats = _inputs(1)
    held = t.state.origin.numpy()[4].astype(np.float64).copy()
    dest.reshape(N, 3)[4] = np.nan
    run.move_to_next_location(dest, fly, w, g, mats)
    assert t.metrics.counter("pumi_move_retries_total").value() == 1
    assert t.quarantined_lanes()[4] == 1
    np.testing.assert_allclose(dest.reshape(N, 3)[4], held, atol=1e-6)
    assert np.isfinite(t.raw_flux).all()


def test_retry_after_copyback_failure_rearms_out_params(mesh, tmp_path):
    """A retryable error after the write-backs (the points' store, with
    record_xpoints): the retry re-arms the caller's original inputs."""
    cfg = dict(record_xpoints=4)
    ref, t = _tally(mesh, **cfg), _tally(mesh, **cfg)
    pos = np.random.default_rng(42).uniform(0.1, 0.9, (N, 3))
    for x in (ref, t):
        x.initialize_particle_location(pos.ravel().copy())
    ref.move_to_next_location(*_inputs(1))
    orig, fired = t._store_xpoints, []

    def flaky(result):
        if not fired:
            fired.append(True)
            raise DeviceError("device lost at the points' store")
        return orig(result)

    t._store_xpoints = flaky
    run = ResilientRunner(t, str(tmp_path / "cks"), every_moves=1000,
                          handle_signals=False, sleep=lambda s: None)
    run.move_to_next_location(*_inputs(1))
    assert t.iter_count == 1
    np.testing.assert_array_equal(t.raw_flux, ref.raw_flux)
    np.testing.assert_array_equal(t.intersection_points()[1],
                                  ref.intersection_points()[1])


def test_quarantined_lanes_ride_checkpoints(mesh, tmp_path):
    path = str(tmp_path / "t.npz")
    t = _fresh(mesh, quarantine=True)
    dest, fly, w, g, mats = _inputs(1)
    dest.reshape(N, 3)[6] = np.nan
    t.move_to_next_location(dest, fly, w, g, mats)
    t.save_checkpoint(path)
    b = _tally(mesh, quarantine=True)
    b.restore_checkpoint(path)
    np.testing.assert_array_equal(b.quarantined_lanes(),
                                  t.quarantined_lanes())


# ===================================================================== #
# Verdicts of the single-device coordinator
# ===================================================================== #
def test_chip_loss_flushes_last_good_and_names_a9(mesh, tmp_path):
    """Chip loss on the plain facade flushes the last good generation and
    re-raises the ChipLostError itself, as the JAX package does; so does
    ``elastic=False``. The name is the test's from before the elastic
    recovery was ported, when the loss raised NotImplementedError naming
    A9; nothing names A9 now."""
    t = _fresh(mesh)
    run = ResilientRunner(
        t, str(tmp_path / "cks"), every_moves=1000, handle_signals=False,
        faults=FaultInjector(parse_faults("chip_down_at_move:2")),
        sleep=lambda s: None)
    _drive(run, 1, 1)
    # The plain facade has no smaller mesh: the loss itself propagates
    # after the flush.
    with pytest.raises(ChipLostError):
        run.move_to_next_location(*_inputs(2))
    assert run.store.find_latest()[0] == 1
    assert t.metrics.counter("pumi_rollbacks_total").value(
        cause="chip-lost") == 1
    # elastic=False: the declared degradation, the loss itself propagates.
    t2 = _fresh(mesh)
    run2 = ResilientRunner(
        t2, str(tmp_path / "cks2"), handle_signals=False, elastic=False,
        faults=FaultInjector(parse_faults("chip_down_at_move:1")))
    with pytest.raises(ChipLostError):
        run2.move_to_next_location(*_inputs(1))


def test_midmove_preemption_flushes_last_good(mesh, tmp_path):
    t = _fresh(mesh)
    run = ResilientRunner(
        t, str(tmp_path / "cks"), every_moves=1000, handle_signals=False,
        faults=FaultInjector(parse_faults("preempt_at_move:3")))
    _drive(run, 1, 2)
    with pytest.raises(InjectedPreemption):
        run.move_to_next_location(*_inputs(3))
    assert run.store.find_latest()[0] == 2
    assert t.iter_count == 2


def test_coordinator_probe_and_verdicts(mesh):
    t = _fresh(mesh)
    co = ResilienceCoordinator(t)
    assert co.probe_chips() == {0: True}
    assert co.classify(InjectedTransientFault("x")) == "transient"
    assert co.classify(DispatchTimeoutError("x")) == "transient"
    assert co.classify(DeviceError("x")) == "transient"
    assert co.classify(InjectedPreemption("x")) == "preempted"
    assert co.classify(FatalIntegrityViolation("x")) == "persistent"
    assert co.classify(ChipLostError("x", chip=0)) == "chip-lost"
    co.note_down(0)
    assert co.classify(DispatchTimeoutError("x")) == "chip-lost"
    assert co.consume_last_probe() == {0: False}
    assert set(VERDICTS) == {"transient", "chip-lost", "preempted",
                             "persistent"}
    assert DeviceError in RETRYABLE and DispatchTimeoutError in RETRYABLE
    snap = t.metrics.snapshot()
    assert "pumi_chip_health" in json.dumps(snap)


# ===================================================================== #
# The megastep (test_megastep's single-device checkpoint and runner
# cases)
# ===================================================================== #
MEGA_N = 64
SRC = SourceParams(sigma_t={1: 4.0, 2: 9.0}, absorption={1: 0.3, 2: 0.5},
                   survival_weight=0.2, seed=13)


@pytest.fixture(scope="module")
def mesh64():
    return twin_meshes(torch.float64, nx=4, jitter=0.2, seed=11,
                       classes=(1, 2))[1]


def _mega(mesh64, k=2):
    return PumiTally(mesh64, MEGA_N, TallyConfig(
        n_groups=2, dtype=torch.float64, tolerance=1e-8, megastep=k),
        device="cpu")


def _mega_pos():
    return np.random.default_rng(3).uniform(0.1, 0.9, (MEGA_N, 3)).ravel()


def _single_state(t):
    s = t.state
    return {
        "flux": t.raw_flux, "origin": s.origin.numpy(),
        "elem": s.elem.numpy(), "material_id": s.material_id.numpy(),
        "weight": s.weight.numpy(), "group": s.group.numpy(),
        "alive": s.in_flight.numpy(),
    }


def test_single_chip_megastep_checkpoint_restore(mesh64, tmp_path):
    a = _mega(mesh64, 3)
    a.initialize_particle_location(_mega_pos().copy())
    a.run_source_moves(3, SRC, weights=np.ones(MEGA_N))
    path = str(tmp_path / "mega.npz")
    a.save_checkpoint(path)
    a.run_source_moves(3, SRC)
    b = _mega(mesh64, 3)
    b.restore_checkpoint(path)
    b.run_source_moves(3, SRC)
    sa, sb = _single_state(a), _single_state(b)
    for name in sa:
        np.testing.assert_array_equal(sb[name], sa[name], err_msg=name)
    assert a.iter_count == b.iter_count == 6


def test_runner_megastep_transient_retry(mesh64, tmp_path):
    def run(tag, faults=None):
        t = _mega(mesh64)
        with ResilientRunner(t, str(tmp_path / tag), every_moves=2,
                             handle_signals=False, sleep=lambda s: None,
                             faults=faults) as r:
            r.initialize_particle_location(_mega_pos().copy())
            r.run_source_moves(2, SRC, weights=np.ones(MEGA_N))
            r.run_source_moves(2, SRC)
            r.run_source_moves(2, SRC)
        return t

    a = run("clean")
    b = run("faulty", FaultInjector(FaultPlan(transient_at_move=3)))
    sa, sb = _single_state(a), _single_state(b)
    for name in sa:
        np.testing.assert_array_equal(sb[name], sa[name], err_msg=name)
    assert b.metrics.counter("pumi_move_retries_total").value() == 1


def test_runner_megastep_midcall_checkpoint_cadence(mesh64, tmp_path):
    t = _mega(mesh64)
    with ResilientRunner(t, str(tmp_path / "cadence"), every_moves=2,
                         handle_signals=False, sleep=lambda s: None) as r:
        r.initialize_particle_location(_mega_pos().copy())
        r.run_source_moves(6, SRC, weights=np.ones(MEGA_N))
        assert r.store.find_latest() is not None
        assert t.iter_count == 6
        assert t.metrics.counter("pumi_checkpoints_total").value() >= 3
    ref = _mega(mesh64)
    ref.initialize_particle_location(_mega_pos().copy())
    ref.run_source_moves(6, SRC, weights=np.ones(MEGA_N))
    sa, sb = _single_state(t), _single_state(ref)
    for name in sa:
        np.testing.assert_array_equal(sa[name], sb[name], err_msg=name)


def test_megastep_integrity_halt_under_the_runner(mesh64, tmp_path,
                                                   monkeypatch):
    """A bitflip after the first chunk under integrity="halt": the next
    chunk's check raises and the runner flushes the last good chunk."""
    monkeypatch.setenv("PUMI_TPU_FAULTS", "bitflip_flux:2")
    t = PumiTally(mesh64, MEGA_N, TallyConfig(
        n_groups=2, dtype=torch.float64, megastep=2, integrity="halt"),
        device="cpu")
    run = ResilientRunner(t, str(tmp_path / "cks"), every_moves=100,
                          handle_signals=False, sleep=lambda s: None)
    run.initialize_particle_location(_mega_pos().copy())
    run.run_source_moves(2, SRC, weights=np.ones(MEGA_N))
    with pytest.raises(FatalIntegrityViolation):
        run.run_source_moves(2, SRC)
    assert run.store.find_latest()[0] == 2


# ===================================================================== #
# test_convergence's checkpoint case
# ===================================================================== #
def _conv_cfg():
    return TallyConfig(n_groups=2, dtype=torch.float64, tolerance=1e-8,
                       convergence=True, rel_err_target=0.05)


def _conv_drive(t, moves, seed=17):
    rng = np.random.default_rng(seed)
    n = t.num_particles
    pos = rng.uniform(0.05, 0.95, (n, 3))
    t.initialize_particle_location(pos.ravel().copy(), n * 3)
    prev = pos
    for _ in range(moves):
        dest = np.clip(prev + rng.normal(0, 0.25, (n, 3)), -0.1, 1.1)
        buf = dest.ravel().copy()
        fly = np.ones(n, np.int8)
        fly[::7] = 0
        t.move_to_next_location(buf, fly, rng.uniform(0.5, 2.0, n),
                                rng.integers(0, 2, n).astype(np.int32),
                                np.full(n, 9, np.int32), buf.size)
        prev = buf.reshape(n, 3)


def _conv_continue(t, moves, seed=23):
    rng = np.random.default_rng(seed)
    n = t.num_particles
    for _ in range(moves):
        buf = rng.uniform(0.05, 0.95, (n, 3)).ravel().copy()
        t.move_to_next_location(buf, np.ones(n, np.int8), np.ones(n),
                                np.zeros(n, np.int32),
                                np.full(n, 9, np.int32))


def test_checkpoint_restore_rebases_batch_statistics(mesh64, tmp_path):
    a = PumiTally(mesh64, MEGA_N, _conv_cfg(), device="cpu")
    _conv_drive(a, moves=3)
    assert a.telemetry()["convergence"]["n_batches"] == 3
    path = str(tmp_path / "conv.npz")
    a.save_checkpoint(path)
    b = PumiTally(mesh64, MEGA_N, _conv_cfg(), device="cpu")
    b.restore_checkpoint(path)
    conv = b.telemetry()["convergence"]
    assert conv["n_batches"] == 0 and not b.converged()
    _conv_continue(b, 2)
    assert b.telemetry()["convergence"]["n_batches"] == 2
    assert b.relative_error().shape == (mesh64.ntet, 2)
