"""Async checkpoint / resume — the durability layer (counterpart of
``hops_tpu/runtime/checkpoint.py``).

The reference delegates checkpointing to framework callbacks writing
into the run's logdir (``ModelCheckpoint(filepath=logdir)``,
``torch.save`` — SURVEY.md §5 "Checkpoint / resume") and has **no
auto-resume of a killed run**. This module closes that gap on
``torch.save`` / ``torch.load(weights_only=True)``:

- **async** saves: :meth:`CheckpointManager.save` copies every tensor of
  the state to host memory before it returns — the port's train steps
  update weights and optimizer moments in place, so a lazy snapshot
  would save a later step's values under this step's number — and a
  background thread writes the copy;
- **atomic publish**: a step's files are written into a hidden
  temporary directory and renamed to ``<dir>/<step>`` only when
  complete, so a crash mid-write leaves no visible step;
- ``restore_or_init`` — the one-call auto-resume the reference lacked;
- **integrity manifests** — every published step gets a
  ``manifest_<step>.json`` sidecar with per-file sizes and the SHA-256
  of each 64 MiB chunk of each file (hashed on a pool of threads: one
  sequential digest of a GB-sized state costs seconds on every save and
  restore). Restore verifies the candidate step against its manifest
  first; a corrupt or partial step (truncated write, bitrot, a
  preemption mid-publish) is **quarantined** — renamed to
  ``corrupt_<step>.quarantined``, preserved for forensics, invisible to
  the step scan — and restore falls back to the newest *valid* step
  instead of crashing the resume path.

A state is a :class:`~hops_tpu_torch.models.common.TrainState` (or
``BNTrainState``): its module's ``state_dict()`` (BatchNorm statistics
are buffers), its optimizer's ``state_dict()`` and its other fields
(``step``, ``seed``). Any other nesting of dicts, lists and tuples of
tensors and Python scalars saves as is. A step directory holds
``state.pt`` and ``index.json``, which names the files and the state's
kind.

Default directory is the active run's ``checkpoints/`` subdir, so the
reference's "durability = logdir synced to the Experiments dataset"
story carries over unchanged.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from hops_tpu_torch.runtime import faultinject, flight, rundir
from hops_tpu_torch.runtime.logging import get_logger
from hops_tpu_torch.telemetry.metrics import REGISTRY

log = get_logger(__name__)

_m_quarantined = REGISTRY.counter(
    "hops_tpu_checkpoint_quarantined_total",
    "Checkpoint steps quarantined as corrupt/partial at restore time",
)
_m_snapshot = REGISTRY.histogram(
    "hops_tpu_checkpoint_snapshot_seconds",
    "Time a taken save holds its caller: the state's copy to host memory",
)
_m_write = REGISTRY.histogram(
    "hops_tpu_checkpoint_write_seconds",
    "Time to write, publish and checksum one step (on the writer thread "
    "for async saves)",
)
_m_bytes = REGISTRY.counter(
    "hops_tpu_checkpoint_bytes_total", "Bytes of the checkpoint steps published",
)
_m_restore = REGISTRY.histogram(
    "hops_tpu_checkpoint_restore_seconds",
    "Time of a restore: verification, quarantines and the load",
)

_INDEX = "index.json"
_STATE = "state.pt"
_FORMAT = "hops_tpu_torch.checkpoint/1"
_TMP_PREFIX = ".tmp-"
# Temporary directories of writes in flight in this process: a manager
# opened on the same directory must not sweep them away.
_in_flight: set[Path] = set()
_in_flight_lock = threading.Lock()


class CheckpointCorruptError(RuntimeError):
    """An explicitly requested step failed integrity verification."""


class StepAlreadyExistsError(ValueError):
    """A forced save named a step that is already published."""


def _file_sha256(path: Path, chunk: int = 1 << 20) -> str:
    """Streaming digest: checkpoint files are multi-GB — reading one
    whole into host memory per save/restore would spike RSS by the
    largest file."""
    h = hashlib.sha256()
    with path.open("rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return h.hexdigest()
            h.update(block)


_DIGEST_CHUNK = 64 << 20  # bytes each digest of a checkpoint file covers


def _file_chunk_sha256(path: Path, chunk: int) -> list[str]:
    """The SHA-256 of each ``chunk``-byte piece of ``path``, in order,
    computed on a pool of threads (``os.pread`` and ``hashlib`` release
    the GIL), block by block so no piece is held whole in memory."""
    size = path.stat().st_size
    fd = os.open(path, os.O_RDONLY)

    def digest(start: int) -> str:
        h, off, end = hashlib.sha256(), start, min(start + chunk, size)
        while off < end:
            block = os.pread(fd, min(1 << 20, end - off), off)
            if not block:  # truncated since the stat: the size check reports it
                break
            h.update(block)
            off += len(block)
        return h.hexdigest()

    try:
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            return list(pool.map(digest, range(0, size, chunk)))
    finally:
        os.close(fd)


def _default_dir() -> str:
    stack = rundir._active.get()
    if stack:
        return stack[-1].checkpoint_dir
    return str(Path(rundir.logdir()) / "checkpoints")


def default_directory() -> str:
    """The directory a ``CheckpointManager()`` with no argument uses:
    the active run's ``checkpoints/`` subdir (or the logdir fallback)."""
    return _default_dir()


# -- data-state sidecars ------------------------------------------------------
#
# Input-pipeline iterator state (epoch, shard cursor, seed) is a tiny
# JSON-able dict, not a tensor tree; storing it INSIDE the checkpoint
# would change its structure for every restore template that predates
# it. It rides alongside instead: one small JSON file per checkpointed
# step, written atomically, so `run_preemptible` can resume the exact
# batch stream.


def _data_state_path(directory: str | Path, step: int) -> Path:
    return Path(directory) / f"data_state_{int(step)}.json"


def save_data_state(directory: str | Path | None, step: int, state: dict) -> None:
    """Persist an input-pipeline snapshot next to checkpoint ``step``."""
    path = _data_state_path(directory or _default_dir(), step)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(state))
    os.replace(tmp, path)


def load_data_state(directory: str | Path | None, step: int) -> dict | None:
    """The input-pipeline snapshot saved with checkpoint ``step``, or
    None if that step carries no data state (pre-loader checkpoints)."""
    path = _data_state_path(directory or _default_dir(), step)
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        return None  # the normal pre-loader / no-sidecar case
    except (OSError, ValueError) as e:
        # A sidecar that EXISTS but won't load means the resume will
        # silently start from the wrong input position — at least make
        # that diagnosable.
        log.warning("data-state sidecar %s unreadable (%s: %s); resuming "
                    "without input-pipeline position", path,
                    type(e).__name__, e)
        return None


# -- state <-> payload --------------------------------------------------------


def _is_train_state(state: Any) -> bool:
    return (dataclasses.is_dataclass(state) and not isinstance(state, type)
            and isinstance(getattr(state, "model", None), nn.Module)
            and isinstance(getattr(state, "optimizer", None), torch.optim.Optimizer))


def _host_copy(tree: Any) -> Any:
    """A copy of ``tree`` whose tensors live in host memory and share
    nothing with the originals. Device tensors are copied synchronously:
    the values are those of the moment of the call, whatever the stream
    does next. A numpy array is stored as a tensor (the loader takes
    tensors only) and comes back as an array through :func:`_place`."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.to("cpu", copy=True) if t.device.type != "cpu" else t.clone()
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree, copy=True))
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _snapshot(state: Any) -> tuple[str, Any]:
    """``(kind, payload)``: the state as host-memory tensors and scalars."""
    if _is_train_state(state):
        fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
                  if f.name not in ("model", "optimizer")}
        return "train_state", {
            "model": _host_copy(state.model.state_dict()),
            "optimizer": _host_copy(state.optimizer.state_dict()),
            "fields": _host_copy(fields),
        }
    return "tree", _host_copy(state)


def _place(loaded: Any, template: Any) -> Any:
    """``loaded`` with each tensor moved to its template tensor's device
    and dtype, or made an array where the template holds one."""
    if isinstance(template, torch.Tensor) and isinstance(loaded, torch.Tensor):
        return loaded.to(template.device, template.dtype)
    if isinstance(template, np.ndarray) and isinstance(loaded, torch.Tensor):
        return loaded.numpy().astype(template.dtype, copy=False)
    if isinstance(template, dict) and isinstance(loaded, dict):
        return {k: _place(v, template.get(k)) for k, v in loaded.items()}
    if isinstance(template, (list, tuple)) and isinstance(loaded, (list, tuple)):
        return type(template)(_place(v, t) for v, t in zip(loaded, template))
    return loaded


class CheckpointManager:
    """Versioned checkpoints of a train state under one directory.

    ``async_save=True`` (default) returns from :meth:`save` as soon as
    the state is copied to host memory; call :meth:`wait` (or
    :meth:`close`) before reading the files back. Saves are serialized:
    when :meth:`save` returns, every EARLIER step is published, has its
    manifest, and older steps beyond ``max_to_keep`` are pruned.

    A save is taken (``save`` returns True) when ``force=True`` or when
    the step is newer than the latest published one and either a
    multiple of ``save_interval_steps`` or the directory's first.
    A published step is never overwritten: a forced save of one raises
    :class:`StepAlreadyExistsError`.
    """

    def __init__(
        self,
        directory: str | Path | None = None,
        max_to_keep: int = 3,
        async_save: bool = True,
        save_interval_steps: int = 1,
    ):
        self.directory = Path(directory or _default_dir()).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self._async = async_save
        self._max_to_keep = max_to_keep
        self._interval = max(int(save_interval_steps), 1)
        self._corrupt_steps: set[int] = set()  # faultinject.checkpoint.save
        self._writer: threading.Thread | None = None
        self._writing: int | None = None
        self._write_error: BaseException | None = None
        self._sweep_abandoned_writes()

    # -- writing --------------------------------------------------------------

    def _sweep_abandoned_writes(self) -> None:
        """Remove temporary directories that no live write owns: the
        leftovers of a process killed mid-write."""
        with _in_flight_lock:
            for p in self.directory.glob(f"{_TMP_PREFIX}*"):
                if p not in _in_flight:
                    shutil.rmtree(p, ignore_errors=True)

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        step = int(step)
        self._finish_write()  # saves are serialized: earlier steps publish first
        steps = self.all_steps()
        if force:
            if step in steps:
                raise StepAlreadyExistsError(
                    f"checkpoint for step {step} already exists under {self.directory}")
        elif steps and (step <= steps[-1] or step % self._interval):
            return False
        # The fault point fires on ACTUAL saves, so a plan's passage
        # schedule counts checkpoints, not loop iterations. Corrupt mode
        # damages THIS step's files once its manifest is written
        # (post-publish bitrot — the manifest records healthy checksums,
        # so restore must catch the mismatch).
        if faultinject.fire("checkpoint.save"):
            self._corrupt_steps.add(step)
        t0 = time.monotonic()
        kind, payload = _snapshot(state)
        _m_snapshot.observe(time.monotonic() - t0)
        tmp = self.directory / f"{_TMP_PREFIX}{step}-{uuid.uuid4().hex[:8]}"
        with _in_flight_lock:
            _in_flight.add(tmp)
        self._writing, self._write_error = step, None
        if self._async:
            self._writer = threading.Thread(
                target=self._write, args=(step, kind, payload, tmp),
                name=f"checkpoint-write-{step}", daemon=True)
            self._writer.start()
        else:
            self._write(step, kind, payload, tmp)
            self._finish_write()
        return True

    def _write(self, step: int, kind: str, payload: Any, tmp: Path) -> None:
        """Write, publish, checksum. Runs on the writer thread for async
        saves; an error is kept and raised by the next
        :meth:`_finish_write` on the caller's thread."""
        t0 = time.monotonic()
        try:
            tmp.mkdir(parents=True)
            torch.save(payload, tmp / _STATE)
            (tmp / _INDEX).write_text(json.dumps(
                {"format": _FORMAT, "step": step, "kind": kind, "files": [_STATE]}))
            for name in (_STATE, _INDEX):
                with open(tmp / name, "rb") as f:
                    os.fsync(f.fileno())
            final = self._step_dir(step)
            if final.exists():
                raise StepAlreadyExistsError(
                    f"checkpoint for step {step} already exists under {self.directory}")
            os.replace(tmp, final)
            dir_fd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(dir_fd)
            finally:
                os.close(dir_fd)
            _m_bytes.inc(self._write_manifest(step))
            _m_write.observe(time.monotonic() - t0)
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller's thread
            self._write_error = e
            shutil.rmtree(tmp, ignore_errors=True)
        finally:
            with _in_flight_lock:
                _in_flight.discard(tmp)

    def _finish_write(self) -> None:
        """Join the write in flight, apply an armed corruption fault,
        prune beyond ``max_to_keep`` and garbage-collect manifests, then
        raise the write's error if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        step, self._writing = self._writing, None
        err, self._write_error = self._write_error, None
        if step is not None and err is None and step in self._corrupt_steps:
            self._corrupt_steps.discard(step)  # armed fault: post-manifest bitrot
            faultinject.corrupt_directory(self._step_dir(step))
        steps = self.all_steps()
        for old in steps[: max(len(steps) - self._max_to_keep, 0)]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
        self._gc_manifests()
        if err is not None:
            raise err

    # -- integrity manifests --------------------------------------------------

    def _manifest_path(self, step: int) -> Path:
        return self.directory / f"manifest_{int(step)}.json"

    def _step_dir(self, step: int) -> Path:
        return self.directory / str(int(step))

    def _gc_manifests(self) -> None:
        """Unlink manifests whose step was pruned or quarantined."""
        keep = set(self.all_steps())
        for p in self.directory.glob("manifest_*.json"):
            try:
                s = int(p.stem.rsplit("_", 1)[-1])
            except ValueError:
                continue
            if s not in keep:
                try:
                    p.unlink()
                except OSError as e:
                    log.warning("manifest GC could not remove %s: %s", p, e)

    def _write_manifest(self, step: int) -> int:
        """Checksum a published step into its manifest; returns the
        step's bytes."""
        step_dir = self._step_dir(step)
        files = {}
        for p in sorted(step_dir.rglob("*")):
            if not p.is_file():
                continue
            files[p.relative_to(step_dir).as_posix()] = {
                "size": p.stat().st_size,
                "chunk_bytes": _DIGEST_CHUNK,
                "sha256_chunks": _file_chunk_sha256(p, _DIGEST_CHUNK),
            }
        tmp = self._manifest_path(step).with_suffix(".json.tmp")
        tmp.write_text(json.dumps({"step": int(step), "files": files}))
        os.replace(tmp, self._manifest_path(step))
        return sum(f["size"] for f in files.values())

    def verify_step(self, step: int) -> str | None:
        """Integrity-check ``step`` against its manifest. Returns None
        when it passes (or predates manifests — nothing to check
        against), else a human-readable description of the damage."""
        manifest_path = self._manifest_path(step)
        try:
            manifest = json.loads(manifest_path.read_text())
        except FileNotFoundError:
            return None  # legacy step: no manifest to verify against
        except (OSError, ValueError) as e:
            return f"manifest unreadable ({type(e).__name__}: {e})"
        step_dir = self._step_dir(step)
        for rel, meta in manifest.get("files", {}).items():
            p = step_dir / rel
            try:
                size = p.stat().st_size
                if size != meta["size"]:
                    return f"{rel}: size {size} != manifest {meta['size']}"
                if "sha256_chunks" in meta:
                    ok = _file_chunk_sha256(p, meta["chunk_bytes"]) == meta["sha256_chunks"]
                else:  # a manifest of whole-file digests
                    ok = _file_sha256(p) == meta["sha256"]
                if not ok:
                    return f"{rel}: checksum mismatch"
            except OSError as e:
                return f"{rel}: unreadable ({type(e).__name__}: {e})"
        return None

    def _step_looks_damaged(self, step: int) -> str | None:
        """Cheap structural triage for manifest-less steps: the step's
        index file must exist and parse, and name files that exist.
        Returns a description of the damage, or None when the structure
        is intact (in which case a restore failure is more plausibly a
        template/code bug)."""
        step_dir = self._step_dir(step)
        try:
            index = json.loads((step_dir / _INDEX).read_text())
        except FileNotFoundError:
            return f"missing {_INDEX}"
        except (OSError, ValueError) as e:
            return f"{_INDEX} unparsable ({type(e).__name__})"
        for name in index.get("files", []):
            if not (step_dir / name).is_file():
                return f"missing {name}"
        return None

    def quarantine(self, step: int, reason: str) -> Path:
        """Move a damaged step out of the step scan (rename to
        ``corrupt_<step>.quarantined`` — preserved for forensics) and
        drop its manifest."""
        step = int(step)
        flight.record("quarantine", step=step, reason=reason)
        step_dir = self._step_dir(step)
        target = self.directory / f"corrupt_{step}.quarantined"
        if target.exists():  # re-quarantine of the same step number
            suffix = 1
            while (self.directory / f"corrupt_{step}.{suffix}.quarantined").exists():
                suffix += 1
            target = self.directory / f"corrupt_{step}.{suffix}.quarantined"
        os.replace(step_dir, target)
        try:
            self._manifest_path(step).unlink()
        except OSError:
            pass  # no manifest (legacy step) — nothing else to drop
        _m_quarantined.inc()
        log.error("checkpoint step %d is corrupt (%s): quarantined to %s",
                  step, reason, target)
        return target

    def save_data_state(self, step: int, state: dict) -> None:
        """Sidecar snapshot of input-pipeline state for ``step`` (see
        :func:`save_data_state`). Sidecars whose checkpoint step was
        pruned (``max_to_keep``) are unlinked here — they no longer
        correspond to any restorable step and would otherwise
        accumulate one file per save forever."""
        save_data_state(self.directory, step, state)
        keep = set(self.all_steps())
        keep.add(int(step))  # an async save may not be published yet
        for p in self.directory.glob("data_state_*.json"):
            try:
                s = int(p.stem.rsplit("_", 1)[-1])
            except ValueError:
                continue
            if s not in keep:
                try:
                    p.unlink()
                except OSError as e:
                    # A permission error mid-GC must not fail the SAVE
                    # that triggered it — the sidecar is merely stale.
                    if not isinstance(e, FileNotFoundError):
                        log.warning("sidecar GC could not remove %s: %s", p, e)

    def load_data_state(self, step: int) -> dict | None:
        return load_data_state(self.directory, step)

    # -- reading --------------------------------------------------------------

    def _load(self, step: int, template: Any) -> Any:
        payload = torch.load(self._step_dir(step) / _STATE, map_location="cpu",
                             weights_only=True)
        if not _is_train_state(template):
            return _place(payload, template)
        template.model.load_state_dict(payload["model"], strict=True)
        template.optimizer.load_state_dict(payload["optimizer"])
        return dataclasses.replace(template, **payload["fields"])

    def restore(self, state_template: Any, step: int | None = None) -> Any:
        """Restore into the template.

        A train state's module and optimizer are loaded in place, on
        their device, and a copy of the state with the saved ``step``
        (and other fields) is returned; any other tree comes back with
        its tensors on the template's devices and dtypes.

        ``step=None`` restores the newest **valid** step: candidates
        failing manifest verification — and manifest-less legacy steps
        whose actual restore raises — are quarantined
        (:meth:`quarantine`) and the next-newest step is tried, so one
        truncated write cannot brick the resume path. An explicit
        ``step`` is restored as asked: verification failure raises
        :class:`CheckpointCorruptError` and nothing is renamed.
        """
        self._finish_write()
        t0 = time.monotonic()
        restored = self._restore(state_template, step)
        _m_restore.observe(time.monotonic() - t0)
        return restored

    def _restore(self, state_template: Any, step: int | None) -> Any:
        if step is not None:
            reason = self.verify_step(int(step))
            if reason is not None:
                raise CheckpointCorruptError(
                    f"checkpoint step {step} under {self.directory} failed "
                    f"verification: {reason}")
            return self._load(int(step), state_template)
        # The fault point counts passages of AUTO restores only: an
        # explicit-step restore has no "latest" to damage and must not
        # silently consume a chaos plan's scheduled corruption.
        corrupt_latest = faultinject.fire("checkpoint.restore")
        while True:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {self.directory}")
            if corrupt_latest:  # armed fault: at-rest damage, found now
                corrupt_latest = False
                faultinject.corrupt_directory(self._step_dir(step))
            reason = self.verify_step(step)
            if reason is None:
                try:
                    return self._load(step, state_template)
                except Exception as e:  # noqa: BLE001 — filtered just below
                    if self._manifest_path(step).exists():
                        # Checksums passed, restore still failed: the
                        # files are intact, so this is a template/code
                        # error, not corruption — quarantining would
                        # destroy a good checkpoint.
                        raise
                    damage = self._step_looks_damaged(step)
                    if damage is None:
                        # Manifest-less (legacy) step whose structure
                        # is intact: a caller-side template bug raises
                        # here too, and quarantining on it would eat
                        # EVERY pre-manifest checkpoint one loop
                        # iteration at a time. Only demonstrable
                        # damage gets a legacy step quarantined.
                        raise
                    reason = f"restore failed ({type(e).__name__}: {e}); {damage}"
            self.quarantine(step, reason)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        """Published steps, oldest first (temporary and quarantined
        directories are not steps)."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and p.is_dir())

    def wait(self) -> None:
        self._finish_write()

    def close(self) -> None:
        self._finish_write()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def restore_or_init(state: Any, directory: str | Path | None = None) -> tuple[Any, int]:
    """Auto-resume: latest checkpoint if one exists, else ``state`` as-is.

    Returns ``(state, next_step)`` — the step to continue from (0 for a
    fresh run). The wrapper-function pattern stays a straight line:

        state = create_train_state(...)
        state, start = checkpoint.restore_or_init(state)
        for step in range(start, num_steps): ...
    """
    with CheckpointManager(directory, async_save=False) as mgr:
        if mgr.latest_step() is None:
            return state, 0
        # Auto-restore: a corrupt/partial newest step is quarantined and
        # the newest VALID one restores instead (see CheckpointManager
        # .restore) — after which latest_step() IS the restored step.
        try:
            restored = mgr.restore(state)
        except FileNotFoundError:
            # Every candidate step was quarantined: a fresh start is
            # the correct (and loudly logged) outcome.
            log.error("all checkpoint steps under %s were corrupt; "
                      "starting from step 0", mgr.directory)
            return state, 0
        step = mgr.latest_step()
        log.info("resumed from checkpoint step=%d dir=%s", step, mgr.directory)
        return restored, step + 1
