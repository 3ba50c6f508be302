"""Snapshot watcher: hot-swap trained params into a running serve loop.

Port of ``repro.serve.snapshot``, with the reference's publish-directory
protocol (writer side: ``train/checkpoints.py``'s ``Checkpointer(pointer=
True)``), so either package serves what the other publishes:

  * the trainer writes crash-consistent engine checkpoints
    (``ckpt_<step>.npz``, atomic tmp+fsync+rename, crc32 checksum) into the
    publish directory through its ``Checkpointer``;
  * after each save it atomically replaces a ``LATEST`` pointer file whose
    content is the newest checkpoint's *filename*, so readers never race a
    directory listing against pruning.

The watcher polls the pointer; on change it restores **only the params
subtree** through the checkpoint module's checksum- and template-checked
restore (the other keys, optimizer base, ψ queue and so on, are not read
into the template), stamps it with a monotonically increasing
*generation*, and hands it to the serve loop, which copies it into the
served weights between decode steps. A pointed-to file that vanished
under pruning, or a checkpoint that fails its checksum or template check,
is skipped and retried at the next poll; the serve loop keeps running on
its current snapshot.

Snapshots are f32 on disk (bf16 leaves are stored as f32) and take the
served params' dtype and device when restored; ``params_checksum`` is the
reference's ``tree_checksum`` of the params subtree in the served dtype,
under the reference's keys, so both packages report the same value for
the same file.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train.checkpoints import (CheckpointError, restore_extra,
                                           tree_checksum)

LATEST_POINTER = "LATEST"


def publish_pointer(directory: str, path: str) -> str:
    """Atomically point ``directory/LATEST`` at checkpoint ``path``
    (basename is stored; the pointer and its target share a directory)."""
    name = os.path.basename(path)
    target = os.path.join(directory, LATEST_POINTER)
    tmp = f"{target}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)
    return target


def read_pointer(directory: str) -> Optional[str]:
    """-> full path of the pointed-to checkpoint, or None (no pointer yet)."""
    try:
        with open(os.path.join(directory, LATEST_POINTER)) as f:
            name = f.read().strip()
    except FileNotFoundError:
        return None
    return os.path.join(directory, name) if name else None


@dataclass
class Snapshot:
    """One restored snapshot: the params and their provenance."""
    params: Any            # list in model.params() order, served dtype/device
    generation: int        # watcher-local monotonic counter (1-based)
    path: str              # checkpoint file it came from
    step: int              # trainer step recorded in the checkpoint
    params_checksum: str   # tree_checksum of the params subtree


def params_checksum(params, layout) -> str:
    """``tree_checksum({"params": ...})`` of a params list under the
    reference's keys (``layout``: ``train.checkpoints.layout_for``)."""
    return tree_checksum({"params": layout.to_tree(list(params))})


def _shape_only(tree):
    """A template tree whose leaves carry only shape and dtype (zero-stride
    arrays: no memory held for a full-width model)."""
    if isinstance(tree, dict):
        return {k: _shape_only(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shape_only(v) for v in tree)
    arr = np.asarray(tree)
    return np.broadcast_to(np.zeros((), arr.dtype), arr.shape)


class SnapshotWatcher:
    """Polls a publish directory and yields validated param snapshots.

    ``params_like`` is the serving model's params list (``model.params()``):
    the restore template (shapes and dtypes must match the trainer's, i.e.
    the same config and precision) and the dtype and device snapshots take.
    ``layout`` names the list in the reference's tree
    (``train.checkpoints.layout_for(model.module)``).
    """

    def __init__(self, publish_dir: str, params_like, *, layout,
                 min_poll_interval: float = 0.0, recorder=None):
        self.publish_dir = publish_dir
        self.params_like = list(params_like)
        self.layout = layout
        self.min_poll_interval = min_poll_interval
        self.recorder = recorder
        self.generation = 0
        self._template = {"params": _shape_only(layout.to_tree(self.params_like))}
        self._last_path: Optional[str] = None
        self._last_poll = 0.0

    def poll(self) -> Optional[Snapshot]:
        """-> a new Snapshot when the pointer moved, else None. Never
        raises on a torn, pruned or corrupt target: skips and retries."""
        now = time.monotonic()
        if now - self._last_poll < self.min_poll_interval:
            return None
        self._last_poll = now
        path = read_pointer(self.publish_dir)
        if path is None or path == self._last_path:
            return None
        t0 = time.monotonic()
        try:
            tree, extra = restore_extra(path, self._template)
        except CheckpointError:
            return None                      # pruned or invalid: retry later
        step = int(extra.get("step", -1))
        host = self.layout.from_tree(tree["params"])
        params = [torch.as_tensor(a).to(p.device, p.dtype)
                  for a, p in zip(host, self.params_like)]
        self._last_path = path
        self.generation += 1
        if self.recorder is not None:
            self.recorder.event("serve.snapshot_load",
                                generation=self.generation, step=step,
                                path=path, seconds=time.monotonic() - t0)
        return Snapshot(params=params, generation=self.generation, path=path,
                        step=step,
                        params_checksum=params_checksum(params, self.layout))

    def wait_for_first(self, timeout: float = 120.0,
                       poll_every: float = 0.2) -> Snapshot:
        """Block until the trainer publishes its first snapshot."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            snap = self.poll()
            if snap is not None:
                return snap
            time.sleep(poll_every)
        raise TimeoutError(
            f"no snapshot appeared under {self.publish_dir!r} within "
            f"{timeout:.0f}s (is the trainer running with --publish-dir?)")
