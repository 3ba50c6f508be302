"""Crash-consistent checkpointing: numpy ``.npz`` of flattened trees.

Port of ``repro.train.checkpoints``; the on-disk format is the
reference's, so a checkpoint written by either package restores in the
other:

  * one array member per tree leaf, keyed by its path as
    ``jax.tree_util`` spells it — ``['key']`` for a dict entry (dict keys
    sorted), ``[i]`` for a list or tuple entry, ``.field`` for a NamedTuple
    field — joined by ``/``. bf16 leaves are stored as f32 (npz has no
    bf16); the f32 image is exact, so a bf16 round-trip is lossless.
  * a ``__meta__`` JSON member: ``{"format": 2, "keys": [...], "checksum":
    "<crc32 hex over every key/dtype/shape/payload in sorted key order>",
    "extra": {...}}``. Format-1 files (no checksum) still restore.

Crash consistency: ``save`` writes to a temp file in the target directory,
fsyncs it and publishes it with ``os.replace``, which is atomic on POSIX,
so a reader sees the complete previous checkpoint or the complete new one.
``restore`` verifies the checksum and every leaf's shape and dtype against
the caller's template, raising :class:`CheckpointError` with the key.

Engine checkpoints. The port's params are a flat list of a module's
parameters and its rule state is a list beside it (``(m, v, t)`` for
``adam``); the JAX package's are trees. A :class:`Layout` names the list
in the JAX tree: :func:`layout_for` takes it from ``convert.py``
(``params_to_jax`` for the zoo and architecture models, ``cnn_to_jax`` for
the CNNs, whose conv weights and their momentum or Adam buffers are
permuted (out, in, kh, kw) ↔ (kh, kw, in, out)). So an engine checkpoint
has the reference's keys: ``['params']/...``, ``['state']/.base/...``,
``['state']/.queue/.buf`` and the other queue fields, ``['state']/.iter``,
``.accel_count``, ``.sub_iters`` (int32 0-d), ``['sched_state']/...``, and
``extra = {"kind": "engine", "step": N}``. The device form's Alg. 2
scratch (``DeviceISGDState.trips``) is not stored.

``restore_engine`` copies into the run's own tensors in place
(``core.isgd.assign_``): the fused engine's CUDA graph holds their
addresses, so a restore that handed back new tensors would leave the graph
training stale buffers (or force a new capture).

``Checkpointer(pointer=True)`` publishes each save to a serving process
through the atomic ``LATEST`` pointer (``repro_torch.serve.snapshot``).
In a multi-process (data-parallel) run process 0 writes and every other
process validates its own replica against the written file
(``Checkpointer(role="validate")``, after a barrier over the group).
"""
from __future__ import annotations

import json
import os
import re
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.isgd import DeviceISGDState, ISGDState, assign_

FORMAT_VERSION = 2


class CheckpointError(RuntimeError):
    """A checkpoint could not be restored (corrupt, truncated, or it does
    not match the requested template)."""


def _norm_path(path: str) -> str:
    """``np.savez`` appends ``.npz`` when the suffix is missing; normalizing
    both directions keeps ``save("ckpt"); restore("ckpt", ...)`` working."""
    return path if path.endswith(".npz") else path + ".npz"


# -- trees -------------------------------------------------------------------
def _children(node):
    """``[(path part, child)]`` of a container, None for a leaf; the parts
    and their order are ``jax.tree_util``'s."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def _leaves(tree, prefix=()):
    """``(key, leaf)`` of every leaf of ``tree``."""
    kids = _children(tree)
    if kids is None:
        yield "/".join(prefix), tree
        return
    for part, child in kids:
        yield from _leaves(child, prefix + (part,))


def _map(fn, tree, prefix=()):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``."""
    kids = _children(tree)
    if kids is None:
        return fn("/".join(prefix), tree)
    if tree is None:
        return None
    out = {part: _map(fn, child, prefix + (part,)) for part, child in kids}
    if isinstance(tree, dict):
        return {k: out[f"[{k!r}]"] for k in tree}
    if hasattr(tree, "_fields"):
        return type(tree)(*(out[f".{f}"] for f in tree._fields))
    return type(tree)(out[f"[{i}]"] for i in range(len(tree)))


def _numpy(leaf) -> np.ndarray:
    """A leaf as the array it is stored as (bf16 as f32)."""
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy()
    arr = np.asarray(leaf)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def _stored_dtype(leaf) -> np.dtype:
    """The dtype a template leaf's value is stored as on disk."""
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            return np.dtype(np.float32)
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return _numpy(leaf).dtype


def tree_arrays(tree) -> dict:
    """``{key: array}``: the members ``save`` writes for ``tree``."""
    return {key: _numpy(leaf) for key, leaf in _leaves(tree)}


def _checksum(arrays: dict) -> str:
    """crc32 over every key, dtype, shape and payload, in sorted key order
    (the reference's, so both packages agree on a file's checksum)."""
    crc = 0
    for key in sorted(arrays):
        arr = np.ascontiguousarray(arrays[key])
        head = f"{key}|{arr.dtype.str}|{arr.shape}".encode()
        crc = zlib.crc32(arr.tobytes(), zlib.crc32(head, crc))
    return f"{crc:08x}"


def tree_checksum(tree) -> str:
    """Content checksum of a tree: equal to ``repro.train.checkpoints
    .tree_checksum`` of the JAX tree with the same keys and values."""
    return _checksum(tree_arrays(tree))


def save(path: str, tree, extra: dict | None = None) -> str:
    """Atomically write ``tree`` (+ JSON-able ``extra``) to ``path``.
    Returns the normalized path written (``.npz`` appended when missing)."""
    path = _norm_path(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = tree_arrays(tree)
    meta = {"format": FORMAT_VERSION, "keys": sorted(arrays.keys()),
            "checksum": _checksum(arrays), "extra": extra or {}}
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)                  # atomic publish
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load(path: str):
    """-> (arrays dict read into memory, meta dict). Every failure mode maps
    to a clear :class:`CheckpointError`."""
    path = _norm_path(path)
    if not os.path.exists(path):
        raise CheckpointError(f"no checkpoint at {path!r} (path is "
                              f"normalized to the .npz suffix)")
    try:
        with np.load(path, allow_pickle=False) as data:
            arrays = {k: data[k] for k in data.files if k != "__meta__"}
            meta = (json.loads(str(data["__meta__"]))
                    if "__meta__" in data.files else {})
    except Exception as e:   # BadZipFile / ValueError / EOFError / OSError
        raise CheckpointError(
            f"checkpoint {path!r} is truncated or corrupt and cannot be "
            f"read ({type(e).__name__}: {e}); was the writing process "
            f"killed mid-save without the atomic rename?") from e
    if meta.get("checksum"):
        got = _checksum(arrays)
        if got != meta["checksum"]:
            raise CheckpointError(
                f"checkpoint {path!r} failed its content checksum "
                f"(stored {meta['checksum']}, recomputed {got}): the file "
                f"was corrupted after it was written")
    return arrays, meta


def _checked(path: str, arrays: dict, like):
    """``like`` with each leaf replaced by the file's array of its key
    (numpy, the stored dtype), after checking key, shape and dtype."""
    def pick(key, leaf):
        if key not in arrays:
            have = ", ".join(sorted(arrays)) or "<empty>"
            raise CheckpointError(
                f"checkpoint {_norm_path(path)!r} has no entry for "
                f"{key!r} required by the template (file has: {have})")
        arr = arrays[key]
        want_shape = tuple(np.shape(leaf))
        if tuple(arr.shape) != want_shape:
            raise CheckpointError(
                f"checkpoint entry {key!r} has shape {tuple(arr.shape)} "
                f"but the template expects {want_shape}")
        want_dtype = _stored_dtype(leaf)
        if arr.dtype != want_dtype:
            raise CheckpointError(
                f"checkpoint entry {key!r} has dtype {arr.dtype} but the "
                f"template expects {want_dtype} (bf16 leaves are stored "
                f"as f32)")
        return arr
    return _map(pick, like)


def _as_like(arr: np.ndarray, leaf):
    """The stored array as a value of the template leaf's kind."""
    if torch.is_tensor(leaf):
        return torch.from_numpy(np.array(arr)).to(leaf.device, leaf.dtype)
    if isinstance(leaf, np.ndarray) or np.isscalar(leaf):
        return np.asarray(arr, dtype=np.asarray(leaf).dtype)
    return arr


def _stored_checksum(path: str) -> Optional[str]:
    """The content checksum a file's ``__meta__`` records (only that member
    is read)."""
    path = _norm_path(path)
    try:
        with np.load(path, allow_pickle=False) as data:
            return json.loads(str(data["__meta__"])).get("checksum")
    except Exception as e:   # missing, BadZipFile, KeyError, ValueError
        raise CheckpointError(f"checkpoint {path!r} cannot be validated "
                              f"({type(e).__name__}: {e})") from e


def restore(path: str, like):
    """Restore into the structure of ``like`` (a template tree of tensors
    or arrays): new leaves of the template's dtype and device. Every leaf is
    verified first: a missing key, shape or dtype mismatch raises
    :class:`CheckpointError` naming the key. Keys in the file but not in
    the template are ignored (forward compatibility)."""
    return restore_extra(path, like)[0]


def restore_extra(path: str, like):
    """``(restore(path, like), load_extra(path))`` from one read of the
    file."""
    arrays, meta = _load(path)
    got = _checked(path, arrays, like)
    flat = dict(_leaves(got))
    return (_map(lambda key, leaf: _as_like(flat[key], leaf), like),
            meta.get("extra", {}))


def load_extra(path: str) -> dict:
    _, meta = _load(path)
    return meta.get("extra", {})


# -- parameter layouts -------------------------------------------------------
@dataclass(frozen=True)
class Layout:
    """How a flat list of tensors in parameter order (the params, or a rule
    state aligned with them) is named in the JAX tree. ``to_tree(tensors)``
    -> the JAX tree with numpy f32/int leaves; ``from_tree(tree)`` -> the
    list of arrays or tensors, in parameter order."""
    to_tree: Callable[[list], Any]
    from_tree: Callable[[Any], list]


def _host_f32(t) -> torch.Tensor:
    t = t.detach().cpu()
    return t.float() if t.dtype == torch.bfloat16 else t


def named_layout(names) -> Layout:
    """A dict ``{name: leaf}`` (e.g. ``["w", "b"]`` for the JAX
    ``{"w": ..., "b": ...}``)."""
    names = list(names)
    return Layout(
        to_tree=lambda ts: {n: _numpy(t) for n, t in zip(names, ts)},
        from_tree=lambda tree: [tree[n] for n in names])


def layout_for(module) -> Layout:
    """The layout of ``list(module.parameters())``: a ``models.cnn.CNN``'s
    through ``convert.cnn_to_jax``/``cnn_from_jax``, a zoo or architecture
    ``Transformer``'s through ``convert.params_to_jax``/``params_from_jax``
    with its ``module.cfg``."""
    from repro_torch import convert
    from repro_torch.models.cnn import CNN
    names = [n for n, _ in module.named_parameters()]

    def named(ts):
        return {n: _host_f32(t) for n, t in zip(names, ts)}

    if isinstance(module, CNN):
        return Layout(
            to_tree=lambda ts: convert.cnn_to_jax(named(ts)),
            from_tree=lambda tree: [convert.cnn_from_jax(tree)[n]
                                    for n in names])
    def from_tree(tree):
        sd = convert.params_from_jax(tree, module.cfg)
        return [sd[n] for n in names]

    return Layout(
        to_tree=lambda ts: convert.params_to_jax(named(ts), module.cfg),
        from_tree=from_tree)


def _is_param_list(node, n: int) -> bool:
    return (isinstance(node, list) and len(node) == n
            and all(torch.is_tensor(t) for t in node))


def _base_tree(base, layout: Layout, n: int):
    """A rule state as the JAX tree: each list aligned with the params
    through ``layout``; tuples kept; tensors as leaves."""
    if _is_param_list(base, n):
        return layout.to_tree(base)
    if isinstance(base, (list, tuple)):
        return type(base)(_base_tree(b, layout, n) for b in base)
    return _numpy(base)


def _assign_base(base, tree, layout: Layout, n: int):
    """Copy a rule state's JAX tree into ``base`` (the live tensors)."""
    if _is_param_list(base, n):
        _copy_into(base, layout.from_tree(tree))
    elif isinstance(base, (list, tuple)):
        for b, t in zip(base, tree):
            _assign_base(b, t, layout, n)
    else:
        _copy_into([base], [tree])


@torch.no_grad()
def _copy_into(dst: list, src: list) -> None:
    for d, s in zip(dst, src):
        s = s if torch.is_tensor(s) else torch.from_numpy(np.array(s))
        d.copy_(s.to(d.device, d.dtype))


def _i32(x) -> np.ndarray:
    return np.asarray(_numpy(x) if torch.is_tensor(x) else x, np.int32)


# -- full-engine checkpoints -------------------------------------------------
class EngineCheckpoint(NamedTuple):
    """One restored full-engine checkpoint (see ``restore_engine``)."""
    params: Any               # the run's param list, restored in place
    state: Any                # its ISGDState / DeviceISGDState, restored
    sched_state: Any          # its repro_torch.sched policy state, or None
    step: int                 # global step cursor (FCPR: batch = step mod n_b)
    server: Optional[dict]    # async-PS: {"version": int, "pushed": {wid: n}}


def pack_engine_state(*, params, state, step: int, layout: Layout,
                      sched_state=None, server: dict | None = None):
    """-> ``(tree, extra)``: everything a killed engine needs to resume bit
    for bit, in the reference's tree — the params, the ISGD state (rule
    state, ψ queue, iteration and acceleration counters; not the device
    form's Alg. 2 scratch), the policy state, the step cursor and, where
    given, an async-PS server's version and push clocks."""
    n = len(params)
    q = state.queue
    tree = {"params": layout.to_tree(params),
            "state": ISGDState(
                base=_base_tree(state.base, layout, n),
                queue=type(q)(buf=_numpy(q.buf), total=_numpy(q.total),
                              total_sq=_numpy(q.total_sq),
                              count=_numpy(q.count), idx=_numpy(q.idx)),
                iter=_i32(state.iter), accel_count=_i32(state.accel_count),
                sub_iters=_i32(state.sub_iters))}
    if sched_state is not None:
        tree["sched_state"] = {k: _numpy(v) for k, v in sched_state.items()}
    extra = {"kind": "engine", "step": int(step)}
    if server is not None:
        extra["server"] = {
            "version": int(server["version"]),
            "pushed": {str(w): int(n)
                       for w, n in server.get("pushed", {}).items()}}
    return tree, extra


def save_engine(path: str, *, params, state, step: int, layout: Layout,
                sched_state=None, server: dict | None = None) -> str:
    tree, extra = pack_engine_state(params=params, state=state, step=step,
                                    layout=layout, sched_state=sched_state,
                                    server=server)
    return save(path, tree, extra=extra)


def _server(extra: dict) -> Optional[dict]:
    server = extra.get("server")
    if server is None:
        return None
    return {"version": int(server["version"]),
            "pushed": {int(w): int(n)
                       for w, n in server.get("pushed", {}).items()}}


def unpack_engine_state(tree: dict, extra: dict, *, params_like, state_like,
                        layout: Layout, sched_like=None) -> EngineCheckpoint:
    """Copy an already-restored engine tree (``pack_engine_state``'s
    structure, numpy leaves) into the run's tensors, in place. A per-step
    ``ISGDState``'s counters are Python ints: they come back in the
    returned ``state``; a ``DeviceISGDState``'s are copied into."""
    n = len(params_like)
    _copy_into(params_like, layout.from_tree(tree["params"]))
    st = tree["state"]
    _assign_base(state_like.base, st.base, layout, n)
    _copy_into(list(state_like.queue), list(st.queue))
    counters = {f: int(getattr(st, f))
                for f in ("iter", "accel_count", "sub_iters")}
    if isinstance(state_like, DeviceISGDState):
        for f, v in counters.items():
            getattr(state_like, f).fill_(v)
        state = state_like
    else:
        state = state_like._replace(**counters)
    if sched_like is not None:
        assign_(sched_like, {k: torch.from_numpy(np.array(v)).to(
            sched_like[k].device) for k, v in tree["sched_state"].items()})
    return EngineCheckpoint(params=params_like, state=state,
                            sched_state=sched_like, step=int(extra["step"]),
                            server=_server(extra))


def restore_engine(path: str, *, params_like, state_like, layout: Layout,
                   sched_like=None, recorder=None) -> EngineCheckpoint:
    """Restore a full-engine checkpoint into the resuming run's own params,
    ISGD state and policy state (the templates), in place; returns them
    with the step cursor. Keys, shapes and dtypes are checked against the
    templates first (a JAX-written file restores as well)."""
    t0 = time.perf_counter()
    arrays, meta = _load(path)
    extra = meta.get("extra", {})
    if extra.get("kind") != "engine":
        raise CheckpointError(
            f"{_norm_path(path)!r} is not a full-engine checkpoint "
            f"(extra: {extra!r}); use restore() for plain trees")
    like, _ = pack_engine_state(params=params_like, state=state_like, step=0,
                                layout=layout, sched_state=sched_like)
    tree = _checked(path, arrays, like)
    ckpt = unpack_engine_state(tree, extra, params_like=params_like,
                               state_like=state_like, layout=layout,
                               sched_like=sched_like)
    if recorder is not None:
        recorder.event("checkpoint.restore", step=ckpt.step,
                       path=_norm_path(path),
                       seconds=time.perf_counter() - t0,
                       bytes=os.path.getsize(_norm_path(path)))
    return ckpt


_CKPT_RE = re.compile(r"^ckpt_(\d+)\.npz$")


class Checkpointer:
    """Periodic engine checkpoints in a directory (``ckpt_<step>.npz``).

    ``maybe_save(step, ...)`` writes whenever the run crosses an ``every``
    boundary since the last save; chunked engines call it at chunk
    boundaries, so with ``every`` not a multiple of the chunk size the save
    lands on the first boundary past the mark. ``latest()`` finds the
    newest complete checkpoint for ``--resume`` (atomic saves guarantee any
    file it finds is complete). ``keep`` newest files are kept (0: all).
    ``recorder`` (a ``repro_torch.obs.MetricsRecorder``) gets a
    ``checkpoint.save`` event and a ``checkpoint/saves`` count a save.

    ``pointer=True`` also publishes a ``LATEST`` pointer file (atomic
    replace) naming the newest checkpoint after every save: the
    publish-directory protocol a serving ``SnapshotWatcher`` polls
    (``repro_torch.serve.snapshot``). Pruning keeps the ``keep`` newest
    files, so the pointed-to checkpoint always survives.

    **Multi-process runs: process 0 writes, all validate.** Params and
    ISGD state are replicated across the ranks of a data-parallel run
    (``repro_torch.distributed``), so one file is enough. ``role`` picks
    the behaviour: ``"write"`` (the default on rank 0 and in a process
    without a group) does everything above and then waits at a barrier over
    the group; ``"validate"`` (the default elsewhere) never writes, but at
    every save point checksums *its own replica* of the engine state, waits
    at the same barrier (the writer's atomic publish is done after it), and
    raises :class:`CheckpointError` when the written file's content
    checksum differs: a replica that diverged fails at the next checkpoint
    instead of poisoning a later ``--resume``. The cadence is a pure
    function of (step, every, last save), so every rank reaches the barrier
    at the same save points. Validation reads the writer's directory (the
    same machine or a shared file system)."""

    def __init__(self, directory: str, every: int = 0, keep: int = 3,
                 pointer: bool = False, role: Optional[str] = None,
                 recorder=None, *, layout: Layout):
        if role is None:
            from repro_torch.obs.console import process_index
            role = "write" if process_index() == 0 else "validate"
        if role not in ("write", "validate"):
            raise ValueError(f"Checkpointer role {role!r}: write or validate")
        self.directory = directory
        self.every = every
        self.keep = keep
        self.pointer = pointer
        self.role = role
        self.recorder = recorder   # save events, write role only
        self.layout = layout
        self._last = 0
        if role == "write":
            os.makedirs(directory, exist_ok=True)

    @staticmethod
    def _barrier() -> None:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            dist.barrier()

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.npz")

    def mark(self, step: int) -> None:
        """Tell the checkpointer a resumed run starts at ``step`` so
        ``maybe_save`` measures boundaries from there."""
        self._last = int(step)

    def save(self, step: int, **engine_kwargs) -> str:
        out = self.path(step)
        self._last = int(step)
        if self.role == "validate":
            tree, _ = pack_engine_state(step=step, layout=self.layout,
                                        **engine_kwargs)
            local = tree_checksum(tree)
            self._barrier()                    # the writer's publish is done
            stored = _stored_checksum(out)
            if stored != local:
                raise CheckpointError(
                    f"process replica diverged at step {step}: its engine "
                    f"state checksums {local} but the written checkpoint "
                    f"{out!r} has {stored}; the replicated params/state are "
                    f"no longer identical across the multi-process run")
            return out
        t0 = time.perf_counter()
        out = save_engine(out, step=step, layout=self.layout,
                          **engine_kwargs)
        if self.recorder is not None:
            self.recorder.counter("checkpoint/saves")
            self.recorder.event("checkpoint.save", step=int(step), path=out,
                                seconds=time.perf_counter() - t0,
                                bytes=os.path.getsize(out))
        self._barrier()                        # validators read after this
        if self.pointer:
            from repro_torch.serve.snapshot import publish_pointer
            publish_pointer(self.directory, out)
        self._prune()
        return out

    def maybe_save(self, step: int, **engine_kwargs) -> Optional[str]:
        if not self.every or int(step) // self.every <= self._last // self.every:
            return None
        return self.save(step, **engine_kwargs)

    def steps(self) -> list[int]:
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(m.group(1)) for n in names
                      if (m := _CKPT_RE.match(n)))

    def latest(self) -> Optional[str]:
        steps = self.steps()
        return self.path(steps[-1]) if steps else None

    def _prune(self) -> None:
        if not self.keep:
            return                             # keep=0: never delete
        for s in self.steps()[:-self.keep]:
            try:
                os.remove(self.path(s))
            except OSError:
                pass
