"""Rotating generations of durable checkpoints.

Own copy of ``pumiumtally_tpu/resilience/store.py``. One directory holds the run's checkpoint history, one generation per
entry, in either on-disk layout (utils/checkpoint.py):

  * ``ckpt-<iteration>.npz``    — single atomic file (per-array sha256);
  * ``ckpt-<iteration>.shards`` — a DIRECTORY of per-mesh-part shard
    npz files plus a ``MANIFEST.json`` committed last (two-phase
    commit). The port reads and verifies such generations; it writes
    them only when ``shards`` forces a count, and the sharded writer of
    the partitioned facade is ROADMAP.md A9b.

The store keeps the newest ``keep`` generations, and
``find_latest``/``restore_latest`` walk newest→oldest SKIPPING corrupt
generations — a torn write or bit-rot in the newest generation falls
back to the previous one instead of killing the resume. For sharded
generations "corrupt" is atomic over the WHOLE generation: a missing
manifest, a missing shard, or any shard digest mismatch rejects every
shard of that generation together (no Frankenstein restore mixing
shard vintages). A genuinely mismatched checkpoint (wrong mesh/config)
still raises: that is a caller bug, not corruption, and silently
skipping it would resume the wrong run.
"""
from __future__ import annotations

import os
import re
import shutil

from ..utils.checkpoint import (
    MANIFEST_NAME,
    SHARD_SUFFIX,
    CheckpointIntegrityError,
    fsync_dir,
    verify_checkpoint,
)
from ..utils.log import log_info, log_warn

_NAME_RE = re.compile(r"^(?P<prefix>.+)-(?P<it>\d+)\.npz$")
_SHARD_RE = re.compile(r"^(?P<prefix>.+)-(?P<it>\d+)\.shards$")


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3,
                 prefix: str = "ckpt",
                 shards: int | str | None = "auto"):
        """``shards`` picks the on-disk generation layout: "auto"
        (default) writes one shard per mesh part for partitioned
        tallies and the single-file layout for everything else; an int
        forces that shard count; None/0 forces single-file (the pre-
        sharding behavior, byte-identical)."""
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = directory
        self.keep = int(keep)
        self.prefix = prefix
        self.shards = shards
        #: Shard count of the last ``save`` (0 for single-file) — the
        #: supervisor's pumi_checkpoint_shards_written_total feed.
        self.last_shards = 0
        os.makedirs(directory, exist_ok=True)
        self._sweep_orphaned_tmp()

    def _sweep_orphaned_tmp(self) -> None:
        """A SIGKILL/power-loss mid-write leaves atomic temp files
        behind (in-process cleanup never ran), and a crash between the
        two commit phases leaves an UNCOMMITTED (manifest-less) shard
        directory; rotation ignores non-generation names, so sweep
        both here or they accumulate forever across preemption
        cycles. (No writer can be live at construction time.)"""
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if name.startswith(f"{self.prefix}-") and ".tmp-" in name:
                try:
                    os.unlink(path)
                except OSError:
                    pass
            elif _SHARD_RE.match(name) and os.path.isdir(path):
                # Temp litter INSIDE a shard dir is always sweepable;
                # the dir itself only when it was never committed.
                for inner in os.listdir(path):
                    if ".tmp-" in inner:
                        try:
                            os.unlink(os.path.join(path, inner))
                        except OSError:
                            pass
                if not os.path.exists(
                    os.path.join(path, MANIFEST_NAME)
                ):
                    shutil.rmtree(path, ignore_errors=True)

    # ------------------------------------------------------------------ #
    def path_for(self, iteration: int) -> str:
        return os.path.join(
            self.directory, f"{self.prefix}-{int(iteration):08d}.npz"
        )

    def shard_dir_for(self, iteration: int) -> str:
        return os.path.join(
            self.directory,
            f"{self.prefix}-{int(iteration):08d}{SHARD_SUFFIX}",
        )

    def valid_path_for(self, iteration: int) -> str | None:
        """An existing generation of this iteration that passes its
        integrity check, else None. The runner consults this before
        re-flushing a rollback target: rewriting a committed sharded
        generation in place would UN-COMMIT it first (manifest removed
        before the shards are rewritten), opening a crash window on
        the very generation the flush exists to preserve — and within
        one supervised run the iteration uniquely keys the trajectory,
        so a valid existing generation already holds the state."""
        for path in (
            self.shard_dir_for(iteration), self.path_for(iteration)
        ):
            if os.path.exists(path):
                try:
                    verify_checkpoint(path)
                    return path
                except Exception:
                    continue
        return None

    def entries(self) -> list[tuple[int, str]]:
        """(iteration, path) pairs sorted oldest→newest; sharded
        directory generations and single-file generations interleave
        by iteration (backward compatibility: a run can switch layouts
        mid-history, e.g. across an elastic reshard)."""
        out = []
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            m = _NAME_RE.match(name)
            if m and m.group("prefix") == self.prefix:
                out.append((int(m.group("it")), path))
                continue
            m = _SHARD_RE.match(name)
            if (
                m
                and m.group("prefix") == self.prefix
                and os.path.isdir(path)
            ):
                out.append((int(m.group("it")), path))
        return sorted(out)

    # ------------------------------------------------------------------ #
    def _shards_for(self, tally) -> int:
        if self.shards in (None, 0):
            return 0
        if self.shards == "auto":
            return int(getattr(tally, "n_parts", 0) or 0)
        return int(self.shards)

    def save(self, tally) -> str:
        """Write the tally's checkpoint as the next generation and
        rotate old generations out. Partitioned tallies (under the
        default ``shards="auto"``) get the sharded two-phase layout —
        one npz per mesh part, manifest committed last."""
        n = self._shards_for(tally)
        if n:
            path = self.shard_dir_for(tally.iter_count)
            tally.save_checkpoint(path, n_shards=n)
            self.last_shards = n
        else:
            path = self.path_for(tally.iter_count)
            tally.save_checkpoint(path)
            self.last_shards = 0
        self._rotate()
        return path

    def _rotate(self) -> None:
        removed = False
        for _, path in self.entries()[: -self.keep]:
            try:
                if os.path.isdir(path):
                    shutil.rmtree(path)
                else:
                    os.unlink(path)
                removed = True
            except OSError as e:
                log_warn(
                    f"checkpoint rotation could not remove {path}: {e}"
                )
        if removed:
            # Make the unlinks durable: without the directory fsync a
            # power cut can resurrect a rotated-out generation while
            # losing the newest rename — find_latest would then resume
            # an OLDER state than the rotation promised survives
            # (utils/checkpoint.fsync_dir).
            fsync_dir(self.directory)

    # ------------------------------------------------------------------ #
    def find_latest(self) -> tuple[int, str] | None:
        """Newest generation that passes the integrity check; corrupt
        generations are skipped with a warning (the fallback contract
        — for sharded generations a missing manifest or any bad shard
        digest rejects the whole generation atomically). The same
        mismatch-vs-corruption rule as ``restore_latest``: an INTACT
        file of another format/shape raises instead of being skipped,
        so the two lookups always agree on a directory."""
        for it, path in reversed(self.entries()):
            try:
                verify_checkpoint(path)
                return it, path
            except CheckpointIntegrityError as e:
                log_warn(f"skipping corrupt checkpoint {path}: {e}")
            except ValueError:
                raise
            except Exception as e:
                log_warn(f"skipping unreadable checkpoint {path}: {e}")
        return None

    def restore_latest(self, tally) -> int | None:
        """Restore the newest VALID generation into ``tally``; returns
        its iteration, or None when no restorable generation exists.
        Corruption (bad container, failed digest, torn shard set)
        falls back to the previous generation; a clean-but-mismatched
        checkpoint raises — see the module docstring for why the two
        differ."""
        for it, path in reversed(self.entries()):
            try:
                tally.restore_checkpoint(path)
                log_info(
                    f"resumed from checkpoint {path}", iteration=it
                )
                return it
            except CheckpointIntegrityError as e:
                log_warn(f"skipping corrupt checkpoint {path}: {e}")
            except ValueError:
                # Intact but incompatible (mesh/dtype/shape): caller bug.
                raise
            except Exception as e:
                # Unreadable container (truncated zip, zlib error, OS
                # error): corruption by another name — fall back.
                log_warn(f"skipping unreadable checkpoint {path}: {e}")
        return None
