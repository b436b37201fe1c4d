"""Checkpoint and resume of a tally run.

Counterpart of ``pumiumtally_tpu/utils/checkpoint.py`` with its
single-file format, so a checkpoint written by either package restores in
the other. The tally's state is additive, so the checkpoint is exactly
(flux accumulator, particle state, iteration counter), saved as one
compressed ``.npz`` with a mesh fingerprint so that it can never be
resumed against a different mesh.

Durability, as in the JAX package:

  * every write is atomic: serialized to a temporary file in the same
    directory, fsync'd, then ``os.replace``d over the target, so a crash
    or a full disk mid-write never leaves a truncated ``.npz`` under the
    real name;
  * every array carries a sha256 digest in the meta block, checked on
    load before any tally state is overwritten (``verify_checkpoint``,
    ``CheckpointIntegrityError``);
  * restore checks format, kind, mesh, dtype, sd_mode and run shape and
    raises on any mismatch rather than resuming (or casting) another run.

The file's layout is the JAX package's: the flux as ``[ntet, G, 2]``, the
particle state in device slot order, ``perm`` (int32, empty while the
layout is the identity) and ``particle_id`` as the JAX facade writes
them, and ``meta["dtype"]`` spelled as numpy spells it (``"float32"``).
The port keeps its slot permutation on the card: ``perm`` is read from
it on save and the card's copy is rebuilt from ``particle_id`` on
restore. The mesh fingerprint hashes the dtype string, shape and bytes of
``tet2vert`` (int32), ``coords`` (the mesh dtype) and ``class_id``
(int32): the arrays the JAX package hashes under its tests' x64 mode too,
since its ``TetMesh`` keeps ``tet2vert`` and ``class_id`` as int32 in
either mode, so one mesh gives one fingerprint in both packages.

Sharded generations (a ``<name>.shards`` directory of ``shard-*.npz``
payload splits, written concurrently, and a ``MANIFEST.json`` naming
every shard with its sha256, committed last) are written
(``save_sharded_checkpoint``), verified and restored here for both
facades, in the JAX package's layout.

The partitioned facade's payload (``kind: "partitioned"``) stores the
flux assembled in global element order, so it resumes under another part
count or halo depth, the host particle state in particle order, the
megastep's physics lanes, and, while a device-sourced run holds its slot
state on the device, that state (``src_*``, with ``src_layout`` = [parts,
cap]): a restore into the same layout continues the run bit for bit, a
restore into another one re-distributes from the particle state.

``snapshot_state`` / ``restore_state`` keep the same payload in memory,
on the device (the partitioned facade's slabs and slot state as device
clones, its host mirrors as copies): the ``ResilientRunner``'s retry
anchor. The port's flux is
updated in place by every walk, so a snapshot clones every device tensor
it keeps and a restore assigns fresh clones: neither the next move nor
an abandoned watchdog worker can write into a snapshot or into what a
rollback restored.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np
import torch

FORMAT_VERSION = 1

#: Suffix marking a sharded (directory) generation; everything else is
#: the single-file ``.npz`` layout.
SHARD_SUFFIX = ".shards"

#: The two-phase-commit record of a sharded generation, written last.
MANIFEST_NAME = "MANIFEST.json"

# The particle-state fields of the payload and their torch dtypes (None:
# the walk dtype).
_STATE = (
    ("origin", None), ("dest", None), ("elem", torch.int32),
    ("in_flight", torch.bool), ("weight", None), ("group", torch.int32),
    ("material_id", torch.int32), ("particle_id", torch.int32),
)


class CheckpointIntegrityError(ValueError):
    """A checkpoint file failed its integrity check (truncated container,
    missing array, or per-array sha256 mismatch). Distinct from the
    plain ``ValueError`` of a mismatched (wrong mesh or config) but
    intact checkpoint: the resilience layer skips corrupt generations
    and falls back, while a genuine mismatch propagates to the caller."""


def np_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch or numpy dtype (``torch.float32`` →
    ``float32``)."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).replace("torch.", ""))
    return np.dtype(dtype)


def _host(a) -> np.ndarray:
    """A host numpy view (CPU) or copy (card) of a tensor or array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def mesh_fingerprint(mesh) -> str:
    """Stable content hash of the mesh the tally ran on (connectivity,
    coordinates, region ids; see the module docstring)."""
    h = hashlib.sha256()
    for arr in (mesh.tet2vert, mesh.coords, mesh.class_id):
        a = np.ascontiguousarray(_host(arr))
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _fingerprint(tally) -> str:
    """``mesh_fingerprint`` of the tally's mesh, computed once a tally (a
    tally's mesh does not change)."""
    fp = getattr(tally, "_mesh_fingerprint", None)
    if fp is None:
        fp = tally._mesh_fingerprint = mesh_fingerprint(tally.mesh)
    return fp


def _array_digest(arr) -> str:
    """sha256 over dtype + shape + raw bytes: the per-array integrity unit
    stored in the meta block and checked again on load."""
    a = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def _normalize(filename: str) -> str:
    # np.savez_compressed appends ".npz"; normalize on both sides so any
    # filename round-trips.
    return filename if filename.endswith(".npz") else filename + ".npz"


def is_sharded(path: str) -> bool:
    """True when ``path`` names a sharded (directory) generation: by the
    ``.shards`` suffix, or by being a directory on disk."""
    return path.endswith(SHARD_SUFFIX) or os.path.isdir(path)


def fsync_dir(directory: str) -> None:
    """Best-effort fsync of a directory, making the renames and unlinks
    inside it durable across power loss. Used by ``atomic_savez`` (after
    the rename) and by ``CheckpointStore``'s rotation (after the
    deletions). Filesystems that refuse it are tolerated: the data fsync
    and the rename already rule out torn files there."""
    try:
        dfd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def atomic_write_bytes(filename: str, data: bytes) -> None:
    """Write a small blob durably: temporary file, fsync, rename,
    directory fsync."""
    directory = os.path.dirname(os.path.abspath(filename)) or "."
    fd, tmp = tempfile.mkstemp(
        dir=directory, prefix=os.path.basename(filename) + ".tmp-"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, filename)
        fsync_dir(directory)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(filename: str, obj) -> None:
    """``atomic_write_bytes`` of ``obj`` as JSON (indent 1, sorted keys,
    trailing newline)."""
    atomic_write_bytes(
        filename,
        (json.dumps(obj, indent=1, sort_keys=True) + "\n").encode(),
    )


def atomic_savez(filename: str, **arrays) -> str:
    """``np.savez_compressed`` with crash-safe semantics: write to a
    temporary file in the same directory, flush and fsync, then
    ``os.replace`` over the target and fsync the directory. A crash or a
    full disk at any point leaves either the old file or nothing."""
    filename = _normalize(filename)
    directory = os.path.dirname(os.path.abspath(filename)) or "."
    fd, tmp = tempfile.mkstemp(
        dir=directory, prefix=os.path.basename(filename) + ".tmp-"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, filename)
        fsync_dir(directory)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return filename


def _write_checkpoint(filename: str, meta: dict, arrays: dict) -> str:
    meta = dict(
        meta,
        array_sha256={k: _array_digest(v) for k, v in arrays.items()},
    )
    return atomic_savez(
        filename,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        **arrays,
    )


def _verify_integrity(arrays: dict, meta: dict, filename: str) -> None:
    """Hash every loaded array again against the meta block's digests.
    Files without digests (no ``array_sha256`` key) pass: their container
    CRC is the only protection they ever had."""
    digests = meta.get("array_sha256")
    if digests is None:
        return
    for name, want in digests.items():
        if name not in arrays:
            raise CheckpointIntegrityError(
                f"checkpoint {filename}: array {name!r} missing"
            )
        got = _array_digest(arrays[name])
        if got != want:
            raise CheckpointIntegrityError(
                f"checkpoint {filename}: array {name!r} sha256 mismatch "
                f"(stored {want[:12]}…, recomputed {got[:12]}…) — the "
                "file is corrupt; falling back to an older generation "
                "is the resilience layer's job (CheckpointStore)"
            )


def _read_npz(filename: str) -> tuple[dict, dict]:
    with np.load(_normalize(filename)) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        arrays = {k: z[k] for k in z.files if k != "meta"}
    return meta, arrays


def verify_checkpoint(filename: str) -> dict:
    """Standalone integrity check: load the meta block and hash every
    array again. Returns the meta dict; raises
    ``CheckpointIntegrityError`` (or the container's own zip or OS
    errors) on corruption, and ``ValueError`` for an intact file of
    another format. Touches no tally. Sharded generations go through the
    manifest check."""
    if is_sharded(filename):
        return verify_sharded_checkpoint(filename)
    filename = _normalize(filename)
    meta, arrays = _read_npz(filename)
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {filename}: format "
            f"{meta.get('format_version')} != {FORMAT_VERSION}"
        )
    _verify_integrity(arrays, meta, filename)
    return meta


def load_meta(filename: str) -> dict:
    if is_sharded(filename):
        return _read_manifest(filename)["meta"]
    with np.load(_normalize(filename)) as z:
        return json.loads(bytes(z["meta"].tobytes()).decode())


# --------------------------------------------------------------------- #
# Sharded generations: reader
# --------------------------------------------------------------------- #
def _file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _read_manifest(dirname: str) -> dict:
    """Load the commit record; its absence (a torn multi-shard write) is
    corruption: the whole generation is skipped."""
    manifest_path = os.path.join(dirname, MANIFEST_NAME)
    if not os.path.exists(manifest_path):
        raise CheckpointIntegrityError(
            f"sharded checkpoint {dirname}: {MANIFEST_NAME} missing — "
            "the generation was never committed (torn multi-shard "
            "write); falling back to an older generation is the "
            "resilience layer's job (CheckpointStore)"
        )
    try:
        with open(manifest_path, "rb") as f:
            manifest = json.loads(f.read().decode())
    except (OSError, ValueError) as e:
        raise CheckpointIntegrityError(
            f"sharded checkpoint {dirname}: unreadable manifest ({e})"
        ) from e
    if manifest.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"sharded checkpoint {dirname}: format "
            f"{manifest.get('format_version')} != {FORMAT_VERSION}"
        )
    return manifest


def _verify_shard_files(dirname: str, manifest: dict) -> list[str]:
    """Every shard the manifest names must exist and hash clean; any miss
    rejects the whole generation. Returns the shard paths in numeric
    shard order."""
    shards = manifest.get("shards", {})
    if len(shards) != int(manifest.get("n_shards", -1)):
        raise CheckpointIntegrityError(
            f"sharded checkpoint {dirname}: manifest names "
            f"{len(shards)} shard(s) but declares "
            f"n_shards={manifest.get('n_shards')}"
        )

    def _index(name: str) -> int:
        digits = "".join(c for c in name if c.isdigit())
        return int(digits) if digits else -1

    paths = []
    for name in sorted(shards, key=_index):
        path = os.path.join(dirname, name)
        if not os.path.exists(path):
            raise CheckpointIntegrityError(
                f"sharded checkpoint {dirname}: shard {name!r} missing"
            )
        got = _file_digest(path)
        if got != shards[name]:
            raise CheckpointIntegrityError(
                f"sharded checkpoint {dirname}: shard {name!r} sha256 "
                f"mismatch (manifest {shards[name][:12]}…, recomputed "
                f"{got[:12]}…) — torn or bit-rotted shard; the whole "
                "generation is rejected"
            )
        paths.append(path)
    return paths


def _load_sharded_arrays(dirname: str, manifest: dict) -> dict:
    """Digest-check every shard file, then load and concatenate the
    per-shard chunks back into the payload arrays."""
    parts = []
    for path in _verify_shard_files(dirname, manifest):
        smeta, arrays = _read_npz(path)
        _verify_integrity(arrays, smeta, path)
        parts.append(arrays)
    return {
        name: np.concatenate([p[name] for p in parts], axis=0)
        for name in parts[0]
    }


def verify_sharded_checkpoint(dirname: str) -> dict:
    """Standalone integrity check of a sharded generation: the manifest is
    there and every shard it names exists and hashes clean. Returns the
    facade meta; ``CheckpointIntegrityError`` on any torn or corrupt
    condition."""
    manifest = _read_manifest(dirname)
    _verify_shard_files(dirname, manifest)
    return manifest["meta"]


def _restore_sharded(dirname: str, tally, expected_kind=None) -> None:
    manifest = _read_manifest(dirname)
    meta = manifest["meta"]
    _validate_meta(meta, tally, expected_kind=expected_kind)
    arrays = _load_sharded_arrays(dirname, manifest)
    if expected_kind == "partitioned":
        _apply_partitioned(tally, meta, arrays)
    else:
        _apply_plain(tally, meta, arrays)


# --------------------------------------------------------------------- #
# Sharded generations: writer
# --------------------------------------------------------------------- #
def shard_name(index: int) -> str:
    return f"shard-{int(index):03d}.npz"


def save_sharded_checkpoint(dirname: str, tally,
                            n_shards: int | None = None) -> int:
    """Write one sharded generation with two-phase commit, as the JAX
    package does. Phase 1 splits the facade's payload into ``n_shards``
    first-axis chunks (one a mesh part by default; every payload array is
    per particle, per element or per slot, so reassembly is a
    concatenation) and writes one digest-carrying npz a shard,
    concurrently, each atomically. Phase 2 commits ``MANIFEST.json``
    (the facade meta and every shard's whole-file sha256) atomically,
    last. A manifest already there is removed before any shard is
    touched, so a crash mid-rewrite leaves an uncommitted directory that
    readers skip, never a manifest naming half-written shards. Returns the
    shard count."""
    if hasattr(tally, "flux_slabs"):
        meta, arrays = _partitioned_payload(tally)
    else:
        meta, arrays = _plain_payload(tally)
    if n_shards is None:
        n_shards = int(getattr(tally, "n_parts", 1))
    n_shards = max(1, int(n_shards))
    os.makedirs(dirname, exist_ok=True)
    manifest_path = os.path.join(dirname, MANIFEST_NAME)
    if os.path.exists(manifest_path):
        os.unlink(manifest_path)
        fsync_dir(dirname)
    chunks = {name: np.array_split(np.asarray(a), n_shards)
              for name, a in arrays.items()}

    def write(i: int) -> str:
        shard_meta = {"format_version": FORMAT_VERSION, "shard": int(i),
                      "n_shards": int(n_shards)}
        return _write_checkpoint(
            os.path.join(dirname, shard_name(i)), shard_meta,
            {name: np.ascontiguousarray(chunks[name][i]) for name in arrays})

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(n_shards, 8)) as ex:
        paths = list(ex.map(write, range(n_shards)))
    manifest = {
        "format_version": FORMAT_VERSION,
        "meta": meta,
        "n_shards": int(n_shards),
        "shards": {os.path.basename(p): _file_digest(p) for p in paths},
    }
    atomic_write_bytes(manifest_path, json.dumps(manifest, indent=1).encode())
    return n_shards


def _validate_meta(meta: dict, tally, expected_kind: str | None) -> None:
    """Restore-side validation: format, kind, mesh identity, dtype, run
    shape. Raises on any mismatch rather than resuming another run."""
    if meta["format_version"] != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format {meta['format_version']} != "
            f"{FORMAT_VERSION}"
        )
    kind = meta.get("kind")
    if kind != expected_kind:
        raise ValueError(
            f"checkpoint kind {kind!r} does not match this facade "
            f"(expected {expected_kind!r}: use "
            f"{'PartitionedTally' if kind == 'partitioned' else 'PumiTally'}"
            ".restore_checkpoint for this file)"
        )
    if meta["mesh_fingerprint"] != _fingerprint(tally):
        raise ValueError("checkpoint was written against a different mesh")
    ck_dt = meta.get("dtype")
    want = np_dtype(tally.config.dtype)
    if ck_dt is not None and np.dtype(ck_dt) != want:
        raise ValueError(
            f"checkpoint dtype is {ck_dt} but this tally is configured "
            f"dtype={want}; restoring would "
            "silently cast the accumulator (e.g. f64 → f32 loses the "
            "precision contract) — rebuild the tally with the "
            "checkpoint's dtype"
        )
    ck_sd = meta.get("sd_mode", "segment")
    if ck_sd != tally.config.sd_mode:
        raise ValueError(
            f"checkpoint slot-1 statistic is sd_mode={ck_sd!r} but this "
            f"tally is configured sd_mode={tally.config.sd_mode!r}; "
            "per-segment and per-move batch squares cannot be mixed"
        )
    if meta["num_particles"] != tally.num_particles:
        raise ValueError(
            f"checkpoint has {meta['num_particles']} particles, tally "
            f"has {tally.num_particles}"
        )
    if meta["n_groups"] != tally.config.n_groups:
        raise ValueError(
            f"checkpoint has {meta['n_groups']} energy groups, config "
            f"has {tally.config.n_groups}"
        )


# --------------------------------------------------------------------- #
# The facade's payload
# --------------------------------------------------------------------- #
def _plain_meta(tally, host: bool) -> dict:
    """The payload's meta block (the mesh fingerprint only for a file: a
    snapshot is never validated)."""
    meta = {
        "format_version": FORMAT_VERSION,
        "num_particles": tally.num_particles,
        "n_groups": tally.config.n_groups,
        "iter_count": tally.iter_count,
        "total_segments": tally.total_segments,
        "initialized": tally._initialized,
        "dtype": str(np_dtype(tally.config.dtype)),
        # Per-segment and per-move batch squares in slot 1 do not mix:
        # checked on restore.
        "sd_mode": tally.config.sd_mode,
    }
    if host:
        meta["mesh_fingerprint"] = _fingerprint(tally)
    return meta


def _plain_payload(tally, host: bool = True) -> tuple[dict, dict]:
    """``(meta, arrays)`` of the tally. ``host``: numpy arrays in the
    file's layout (a device→host copy each); else clones of the device
    tensors (the in-memory snapshot). Either way every array is a copy:
    the walk updates the flux in place, so a view would follow it."""
    s = tally.state
    if host:
        def get(t):
            return t.detach().to("cpu", copy=True).numpy()
        flux = tally.raw_flux  # a host copy, [ntet, G, 2]
    else:
        def get(t):
            return t.detach().clone()
        flux = get(tally.flux)
    arrays = {"flux": flux}
    arrays.update({name: get(getattr(s, name)) for name, _ in _STATE})
    arrays["perm"] = (
        np.array(tally._perm, copy=True) if tally._perm is not None
        else np.empty(0, np.int64)
    )
    # Per-lane quarantine counts are resumable: a resumed or rolled-back
    # run must neither lose nor double its degraded-mode report.
    q = getattr(tally, "_quarantined", None)
    arrays["quarantined"] = (
        q.copy() if q is not None else np.empty(0, np.int64)
    )
    return _plain_meta(tally, host), arrays


def _fresh(a, dtype, device) -> torch.Tensor:
    """A tensor on ``device`` in ``dtype`` that shares storage with
    nothing the caller keeps."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, dtype).clone()
    return torch.from_numpy(np.array(a, copy=True)).to(device, dtype)


def _apply_plain(tally, meta: dict, arrays: dict) -> None:
    """Load a payload (numpy arrays from a file, or a snapshot's device
    clones) into the tally, with the resets of its derived state: the
    slot permutation on the card, the sort counter, the convergence
    batches and the batch-sd snapshot."""
    dtype, dev = tally.config.dtype, tally.device
    # Both the canonical [ntet, G, 2] and a flat flux are accepted.
    tally.flux = _fresh(arrays["flux"], dtype, dev).reshape(-1)
    tally.state = tally.state.replace(**{
        name: _fresh(arrays[name], dt or dtype, dev) for name, dt in _STATE
    })
    tally.iter_count = int(meta["iter_count"])
    tally.total_segments = int(meta["total_segments"])
    tally._initialized = bool(meta["initialized"])
    perm = np.asarray(arrays["perm"])
    tally._perm = None if perm.size == 0 else perm.astype(np.int32)
    # The card's copy of the slot permutation is the restored particle
    # ids (slot i holds particle particle_id[i]); the next periodic sort
    # recomputes its artifacts.
    tally._perm_dev = (tally.state.particle_id.long()
                       if tally._perm is not None else None)
    tally._traces_since_sort = 1
    if tally._origin_h is None:
        # The first move's record-buffer estimate reads the host origin
        # (particle order).
        origin = _host(arrays["origin"]).astype(np.float64)
        if tally._perm is not None:
            out = np.empty_like(origin)
            out[tally._perm] = origin
            origin = out
        tally._origin_h = origin
    # Batch statistics are monitor state, not resumable state: they
    # re-base on the restored accumulator.
    tally._reset_convergence()
    _apply_quarantined(tally, arrays)
    if tally._prev_even is not None:
        # sd_mode="batch": at a move boundary the even-entry snapshot
        # equals the current even entries.
        tally._prev_even = tally.flux[0::2].clone()


def _apply_quarantined(tally, arrays: dict) -> None:
    """Restore the per-lane quarantine counts where both sides track them
    (quarantine on, payload with a matching array)."""
    q = arrays.get("quarantined")
    if (
        getattr(tally, "_quarantined", None) is not None
        and q is not None
        and q.size == tally._quarantined.size
    ):
        tally._quarantined = np.asarray(q, np.int64).copy()


def save_checkpoint(filename: str, tally, n_shards: int | None = None
                    ) -> None:
    """Serialize a PumiTally's resumable state (atomic write, per-array
    digests; module docstring). A ``.shards`` name writes the sharded
    two-phase layout instead (``n_shards`` splits, default one)."""
    if is_sharded(filename):
        save_sharded_checkpoint(filename, tally, n_shards=n_shards)
        return
    meta, arrays = _plain_payload(tally)
    _write_checkpoint(_normalize(filename), meta, arrays)


def restore_checkpoint(filename: str, tally) -> None:
    """Restore state saved by ``save_checkpoint`` (of either package)
    into a PumiTally built with the same mesh and configuration. Raises on
    any mismatch or integrity failure before any tally state is
    overwritten. A sharded generation of one device restores too."""
    if is_sharded(filename):
        _restore_sharded(filename, tally)
        return
    meta, arrays = _read_npz(filename)
    _validate_meta(meta, tally, expected_kind=None)
    _verify_integrity(arrays, meta, filename)
    _apply_plain(tally, meta, arrays)


# --------------------------------------------------------------------- #
# The partitioned facade's payload
# --------------------------------------------------------------------- #
# The megastep's slot state in the payload (``src_<name>``) and the torch
# dtypes it is restored in (None: the walk dtype).
_SRC = (("pos", None), ("elem", torch.int32), ("material_id", torch.int32),
        ("weight", None), ("group", torch.int32), ("pid", torch.int32),
        ("valid", torch.bool), ("alive", torch.bool))


def _partitioned_payload(tally, host: bool = True) -> tuple[dict, dict]:
    """``(meta, arrays)`` of a PartitionedTally, the JAX package's
    layout. ``host``: numpy arrays in the file's layout, the megastep's
    slot state folded back into the particle state first (the flux
    assembled in global element order); else the in-memory snapshot,
    whose slabs and slot state are device clones (the host mirrors are
    copies either way)."""
    if host and tally._src is not None:
        tally._sync_source_state()
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "partitioned",
        "num_particles": tally.num_particles,
        "n_groups": tally.config.n_groups,
        "iter_count": tally.iter_count,
        "total_segments": tally.total_segments,
        "total_rounds": tally.total_rounds,
        "initialized": tally._initialized,
        "dtype": str(np_dtype(tally.config.dtype)),
        "sd_mode": tally.config.sd_mode,
    }
    if host:
        meta["mesh_fingerprint"] = _fingerprint(tally)
    q = tally._quarantined
    arrays = {
        "flux": (tally.raw_flux if host
                 else tally.flux_slabs.detach().clone()),
        "positions": tally.positions.copy(),
        "elem_global": tally.elem_global.copy(),
        "material_id": tally.material_id.copy(),
        "quarantined": q.copy() if q is not None else np.empty(0, np.int64),
        "weights": tally.weights.copy(),
        "groups": tally.groups.copy(),
        "alive": tally.alive.copy(),
    }
    if tally._src is not None:
        meta["src_layout"] = [int(tally.n_parts), int(tally.cap)]
        for name, _ in _SRC:
            t = tally._src[name].detach()
            arrays[f"src_{name}"] = (t.to("cpu", copy=True).numpy() if host
                                     else t.clone())
    return meta, arrays


def _apply_partitioned(tally, meta: dict, arrays: dict) -> None:
    """Load a partitioned payload into the tally: the flux into its own
    slab layout (a file's assembled flux, or a snapshot's slabs), the
    particle state, and the slot state when the payload's layout is the
    tally's (else the next ``run_source_moves`` re-distributes). Then the
    derived state: the batch-sd snapshot and the convergence batches."""
    from ..parallel.mesh_partition import disassemble_global_flux

    dtype, dev = tally.config.dtype, tally.device
    flux = arrays["flux"]
    if isinstance(flux, torch.Tensor):
        tally.flux_slabs = _fresh(flux, dtype, dev)
    else:
        slabs = disassemble_global_flux(
            tally.partition, np.asarray(flux).astype(np_dtype(dtype)))
        tally.flux_slabs = _fresh(slabs.reshape(slabs.shape[0], -1), dtype,
                                  dev)
    tally.positions = np.asarray(arrays["positions"], np.float64).copy()
    tally.elem_global = np.asarray(arrays["elem_global"], np.int64).copy()
    tally.material_id = np.asarray(arrays["material_id"], np.int32).copy()
    if "weights" in arrays:
        tally.weights = np.asarray(arrays["weights"], np.float64).copy()
        tally.groups = np.asarray(arrays["groups"], np.int32).copy()
        tally.alive = np.asarray(arrays["alive"]).astype(bool).copy()
    layout = meta.get("src_layout")
    if layout is not None and list(layout) == [int(tally.n_parts),
                                               int(tally.cap)]:
        tally._src = {name: _fresh(arrays[f"src_{name}"], dt or dtype, dev)
                      for name, dt in _SRC}
    else:
        tally._src = None
    tally.iter_count = int(meta["iter_count"])
    tally.total_segments = int(meta["total_segments"])
    tally.total_rounds = int(meta["total_rounds"])
    tally._initialized = bool(meta["initialized"])
    _apply_quarantined(tally, arrays)
    if tally._prev_even is not None:
        # At a move boundary the even-entry snapshot equals the even
        # entries.
        tally._prev_even = tally.flux_slabs[:, 0::2].reshape(-1).clone()
    tally._reset_convergence()


def save_partitioned_checkpoint(filename: str, tally,
                                n_shards: int | None = None) -> None:
    """Serialize a PartitionedTally's resumable state: the flux assembled
    (layout independent: it resumes under another part count or halo
    depth), the particle state, the megastep's slot state and the
    counters, atomically with per-array digests. A ``.shards`` name
    writes the sharded two-phase layout (one npz a mesh part by
    default)."""
    if is_sharded(filename):
        save_sharded_checkpoint(filename, tally, n_shards=n_shards)
        return
    meta, arrays = _partitioned_payload(tally)
    _write_checkpoint(_normalize(filename), meta, arrays)


def restore_partitioned_checkpoint(filename: str, tally) -> None:
    """Restore state saved by ``save_partitioned_checkpoint`` (of either
    package) into a PartitionedTally on the same mesh, in any layout;
    validation and the integrity check run before any state is
    overwritten."""
    if is_sharded(filename):
        _restore_sharded(filename, tally, expected_kind="partitioned")
        return
    meta, arrays = _read_npz(filename)
    _validate_meta(meta, tally, expected_kind="partitioned")
    _verify_integrity(arrays, meta, filename)
    _apply_partitioned(tally, meta, arrays)


# --------------------------------------------------------------------- #
# In-memory snapshots (the ResilientRunner's retry anchor)
# --------------------------------------------------------------------- #
def snapshot_state(tally) -> tuple:
    """The resumable state as clones on the tally's device (host copies of
    the partitioned facade's mirrors): the payload of a checkpoint without
    serialization. The runner takes one after every good move so that a
    transient failure rolls back without losing the moves since the last
    file."""
    if hasattr(tally, "flux_slabs"):
        meta, arrays = _partitioned_payload(tally, host=False)
        return ("partitioned", meta, arrays)
    meta, arrays = _plain_payload(tally, host=False)
    return ("plain", meta, arrays)


def restore_state(tally, snap: tuple) -> None:
    """Apply a ``snapshot_state`` payload back onto the tally it came from
    (no validation: same process, same object), as fresh clones, so the
    snapshot stays good for a second rollback."""
    kind, meta, arrays = snap
    if kind == "partitioned":
        _apply_partitioned(tally, meta, arrays)
    else:
        _apply_plain(tally, meta, arrays)
