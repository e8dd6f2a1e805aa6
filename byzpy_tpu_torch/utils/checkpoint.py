"""Checkpoint / resume, and durable host-state snapshots.

Counterpart of ``byzpy_tpu/utils/checkpoint.py``, with the same typed
surface. Two tiers live here:

* :class:`CheckpointManager` saves and restores training state (params,
  optimizer state, round counters: any structure of tensors and Python
  values) a step per file. The reference wraps orbax, which the card's
  host does not have; the port writes each step with ``torch.save`` to a
  temporary file and renames it into place (ROADMAP C). ``restore(like=)``
  puts every tensor on the device and in the dtype of the matching leaf
  of ``like``. Missing or corrupt state surfaces as the typed
  :class:`CheckpointNotFoundError` / :class:`CheckpointCorruptError`.
* :class:`SnapshotStore` is the lightweight sibling for host-side
  runtime state (the serving tier's durable round state, dedup tables,
  credit summaries): one self-contained pickle file per generation with
  an atomic rename and an embedded SHA-256 integrity digest, so a process
  killed mid-save can never leave a half-written generation that restore
  would trust — a torn or tampered file is detected and the previous
  generation answers instead. The payloads are the reference's (host
  numpy arrays and Python values). Saves can run off the event loop
  (:meth:`SnapshotStore.save_async`).
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import pickle
import re
import time
from typing import Any, List, Optional, Tuple

from ..observability import metrics as _obs_metrics


class CheckpointNotFoundError(FileNotFoundError):
    """No usable checkpoint exists where one was asked for; the message
    always names the directory searched."""


class CheckpointCorruptError(RuntimeError):
    """State exists but failed integrity/decode checks (every retained
    generation, for stores that keep several)."""


_CKPT_RE = re.compile(r"^step-(\d{12})\.pt$")


class CheckpointManager:
    """Step-numbered checkpoints of a structure of tensors, one
    ``torch.save`` file a step.

    >>> ckpt = CheckpointManager("/tmp/run1", max_to_keep=3)
    >>> ckpt.save(step=10, state={"params": params, "round": 10})
    >>> state = ckpt.restore()                  # latest
    >>> state = ckpt.restore(step=10, like=state_on_the_card)
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3) -> None:
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1 (got {max_to_keep})")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step-{int(step):012d}.pt")

    # -- write ---------------------------------------------------------------

    def save(self, step: int, state: Any, *, wait: bool = True) -> None:
        """Save ``state`` at ``step``: written to a temporary file, then
        renamed into place, so a reader sees the whole step or none of it.
        Steps beyond ``max_to_keep`` are pruned after the new one is in
        place. ``wait`` is the reference's (its saves may be
        asynchronous); this save has returned when it is durable."""
        import torch

        final = self._path(step)
        tmp = os.path.join(self.directory, f".tmp-{int(step):012d}-{os.getpid()}.pt")
        torch.save(state, tmp)
        os.replace(tmp, final)
        for old in self.all_steps()[: -self.max_to_keep]:
            try:
                os.remove(self._path(old))
            except OSError:  # pragma: no cover — already gone
                pass

    # -- read ----------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _CKPT_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def restore(self, step: Optional[int] = None, *, like: Any = None) -> Any:
        """Restore ``step`` (default: latest). ``like`` is a structure
        matching what was saved; each restored tensor takes the device and
        dtype of its leaf there (a leaf that is not a tensor leaves the
        value as loaded). Tensors load onto the CPU without ``like``.

        An empty directory (or an explicit ``step`` that does not exist)
        raises :class:`CheckpointNotFoundError` naming the directory; a
        present-but-unreadable step (a truncated or tampered file, a
        ``like`` that does not match what was saved) raises
        :class:`CheckpointCorruptError` with the cause chained."""
        import torch

        if step is None:
            step = self.latest_step()
            if step is None:
                raise CheckpointNotFoundError(f"no checkpoints under {self.directory}")
        elif int(step) not in self.all_steps():
            raise CheckpointNotFoundError(
                f"no checkpoint for step {step} under {self.directory} "
                f"(available: {self.all_steps()})"
            )
        try:
            state = torch.load(self._path(step), map_location="cpu", weights_only=False)
            return state if like is None else _like(state, like)
        except (KeyboardInterrupt, SystemExit):
            raise
        except FileNotFoundError as exc:
            raise CheckpointNotFoundError(
                f"checkpoint step {step} under {self.directory} is missing: {exc}"
            ) from exc
        except Exception as exc:  # noqa: BLE001 — typed surface for callers
            raise CheckpointCorruptError(
                f"checkpoint step {step} under {self.directory} failed to "
                f"restore: {type(exc).__name__}: {exc}"
            ) from exc

    def close(self) -> None:
        """Nothing to release (the reference closes its orbax manager)."""

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def _like(state: Any, like: Any) -> Any:
    """``state`` with every tensor moved to the device and dtype of the
    matching leaf of ``like``; a structure that differs raises."""
    import torch

    if isinstance(like, torch.Tensor):
        if not isinstance(state, torch.Tensor) or tuple(state.shape) != tuple(like.shape):
            raise ValueError(f"restored leaf {type(state).__name__} does not match a tensor of "
                             f"shape {tuple(like.shape)}")
        return state.to(device=like.device, dtype=like.dtype)
    if isinstance(like, dict):
        if not isinstance(state, dict) or set(state) != set(like):
            raise ValueError("restored dict keys differ from like's")
        return type(state)((k, _like(state[k], like[k])) for k in state)
    if isinstance(like, (list, tuple)):
        if not isinstance(state, (list, tuple)) or len(state) != len(like):
            raise ValueError("restored sequence differs from like's")
        items = [_like(a, b) for a, b in zip(state, like)]
        return type(state)(*items) if hasattr(state, "_fields") else type(state)(items)
    return state


def save_checkpoint(directory: str, step: int, state: Any) -> None:
    """One-shot save (convenience)."""
    with CheckpointManager(directory) as mgr:
        mgr.save(step, state)


def restore_checkpoint(
    directory: str, step: Optional[int] = None, *, like: Any = None
) -> Any:
    """One-shot restore (convenience)."""
    with CheckpointManager(directory) as mgr:
        return mgr.restore(step, like=like)


# ---------------------------------------------------------------------------
# host-state snapshot store (atomic rename + integrity digest)
# ---------------------------------------------------------------------------

_SNAP_MAGIC = b"BZSNAP1\n"
_SNAP_RE = re.compile(r"^snap-(\d{12})\.bzs$")


def _snapshot_latency() -> Any:
    return _obs_metrics.registry().histogram(
        "byzpy_checkpoint_save_seconds",
        help="host-state snapshot save latency (serialize + fsync + rename)",
    )


class SnapshotStore:
    """Generational, digest-verified pickle snapshots of host state.

    Layout: ``snap-<step:012d>.bzs`` files, each ``MAGIC + sha256-hex +
    "\\n" + pickle(state)``. A save serializes, writes to a dot-tmp file
    (flushed; fsync'd when ``fsync=True``), then ``os.replace``\\ s into
    place — readers only ever see absent or complete generations.
    :meth:`restore_latest` walks generations newest-first and returns the
    first that verifies; corrupt generations are reported in the result,
    and exhaustion raises :class:`CheckpointCorruptError`
    (:class:`CheckpointNotFoundError` when the directory holds nothing at
    all). Not a pytree checkpoint: values must pickle (numpy arrays,
    scalars, containers) — device arrays belong in
    :class:`CheckpointManager`."""

    def __init__(
        self, directory: str, *, max_to_keep: int = 3, fsync: bool = False
    ) -> None:
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1 (got {max_to_keep})")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.fsync = fsync
        os.makedirs(self.directory, exist_ok=True)

    # -- paths ---------------------------------------------------------------

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"snap-{step:012d}.bzs")

    def all_steps(self) -> List[int]:
        """Every generation present on disk, ascending (no verification)."""
        steps = []
        for name in os.listdir(self.directory):
            m = _SNAP_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- write ---------------------------------------------------------------

    def save(self, step: int, state: Any) -> str:
        """Atomically persist ``state`` as generation ``step``; returns
        the final path. Older generations beyond ``max_to_keep`` are
        pruned AFTER the new one is durable."""
        t0 = time.monotonic()
        payload = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
        digest = hashlib.sha256(payload).hexdigest().encode()
        final = self._path(step)
        tmp = os.path.join(
            self.directory, f".tmp-{step:012d}-{os.getpid()}.bzs"
        )
        with open(tmp, "wb") as fh:
            fh.write(_SNAP_MAGIC + digest + b"\n" + payload)
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())
        os.replace(tmp, final)
        for old in self.all_steps()[: -self.max_to_keep]:
            try:
                os.remove(self._path(old))
            except OSError:  # pragma: no cover — already gone
                pass
        _snapshot_latency().observe(time.monotonic() - t0)
        return final

    async def save_async(self, step: int, state: Any) -> str:
        """:meth:`save` on the default executor — the serving scheduler
        calls this so snapshot IO never stalls the admission loop."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self.save, step, state)

    # -- read ----------------------------------------------------------------

    def load(self, step: int) -> Any:
        """Load and verify ONE generation; raises
        :class:`CheckpointNotFoundError` if absent,
        :class:`CheckpointCorruptError` on any integrity failure."""
        path = self._path(step)
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except FileNotFoundError as exc:
            raise CheckpointNotFoundError(
                f"no snapshot for step {step} under {self.directory}"
            ) from exc
        if not blob.startswith(_SNAP_MAGIC):
            raise CheckpointCorruptError(f"{path}: bad magic")
        rest = blob[len(_SNAP_MAGIC):]
        nl = rest.find(b"\n")
        if nl != 64:  # sha256 hex is exactly 64 bytes
            raise CheckpointCorruptError(f"{path}: malformed digest header")
        digest, payload = rest[:nl], rest[nl + 1:]
        if hashlib.sha256(payload).hexdigest().encode() != digest:
            raise CheckpointCorruptError(f"{path}: integrity digest mismatch")
        try:
            return pickle.loads(payload)
        except Exception as exc:  # noqa: BLE001 — typed surface
            raise CheckpointCorruptError(
                f"{path}: digest ok but unpicklable: {exc}"
            ) from exc

    def restore_latest(self) -> Tuple[int, Any, List[int]]:
        """Newest generation that VERIFIES, as ``(step, state,
        skipped_corrupt_steps)`` — a torn/tampered newest generation
        falls back to the previous one instead of failing recovery.
        Raises :class:`CheckpointNotFoundError` on an empty store,
        :class:`CheckpointCorruptError` when every generation is bad."""
        steps = self.all_steps()
        if not steps:
            raise CheckpointNotFoundError(
                f"no snapshots under {self.directory}"
            )
        skipped: List[int] = []
        for step in reversed(steps):
            try:
                return step, self.load(step), skipped
            except CheckpointCorruptError:
                skipped.append(step)
        raise CheckpointCorruptError(
            f"every snapshot generation under {self.directory} is corrupt "
            f"(tried {list(reversed(steps))})"
        )


__all__ = [
    "CheckpointCorruptError",
    "CheckpointManager",
    "CheckpointNotFoundError",
    "SnapshotStore",
    "restore_checkpoint",
    "save_checkpoint",
]
