"""Fault-tolerant checkpointing: atomic, sharded, async-capable, as
``repro.checkpoint.checkpointer``, with the same files on disk.

Layout (one directory per step)::

    <root>/step_000123/
        manifest.json          # treedef, shapes, dtypes, shard layout, step
        shard_00000.npz        # flat-index -> array chunks for host 0
        ...
        COMMITTED              # written LAST via atomic rename

Guarantees:
  * atomicity — a step directory without COMMITTED is ignored (and GC'd),
    so a host dying mid-save can never corrupt restore;
  * multi-host — each host writes only its own shard file; host 0 writes
    the manifest and the commit marker after a barrier (here: thread join);
  * async — ``save`` can run in a background thread (training continues;
    the previous async save is joined first, bounding staleness to one);
  * keep-N GC of old committed steps;
  * integrity — each shard's crc32 is recorded in the manifest at save;
    ``latest_step`` cheaply skips committed steps whose files are missing
    or empty (a torn write that still managed to commit), and ``restore``
    verifies checksums before trusting any byte: a corrupt step is
    *quarantined* (renamed ``step_*.quarantined_*`` so no later scan
    picks it up) and restore falls back to the previous committed step —
    a bad checkpoint costs one interval of rework, never the job.

Leaves, in the reference's order.  ``_flatten`` walks a tree as
``jax.tree_util.tree_flatten`` does: a NamedTuple (``TrainState``,
``AdamWState``) field by field, dict keys sorted, lists in order, ``None``
no leaf.  So ``n_leaves`` and the leaf order of a manifest are the
reference's for the same state, and a checkpoint of one package's params
restores in the other's.  Three leaves need a form numpy can hold:

  * a ``torch.Generator`` (``TrainState.rng``) is saved as its
    ``get_state()`` bytes (uint8) and restored as a generator on the
    proto's device with that state;
  * a bf16 tensor is saved as its uint16 bit view with ``"bfloat16"`` in
    ``dtypes`` (numpy has no bf16) and restored bit for bit;
  * every other tensor is copied to the host when ``save`` is called (a CPU
    tensor too, whose ``.numpy()`` would share its memory), so an async
    save writes the values of that moment whatever the caller then does.

``restore(like)`` puts each leaf on its proto's device and dtype;
``restore(like, shardings=...)`` then lays each leaf out on its mesh
(``distributed.sharding.place``: each rank keeps its slice of the full
array it read; a mesh of one device keeps the tensor local).
``checkpoint/elastic.restore_on_mesh`` derives the shardings from logical
specs.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

COMMIT_MARKER = "COMMITTED"
BF16 = "bfloat16"


class CheckpointCorruptionError(RuntimeError):
    """A committed checkpoint failed integrity verification."""


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:09d}")


def _step_of(name: str) -> Optional[int]:
    """Step number of a live ``step_NNN`` directory name; None for
    anything else (tmp dirs, quarantined steps, strays)."""
    if not name.startswith("step_"):
        return None
    tail = name[len("step_"):]
    return int(tail) if tail.isdigit() else None


def _crc32_of(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                return crc
            crc = zlib.crc32(buf, crc)


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any) -> Tuple[List[Any], str]:
    """(leaves, structure) in ``jax.tree_util.tree_flatten``'s order."""
    if tree is None:
        return [], "None"
    if _is_namedtuple(tree):
        parts = [_flatten(v) for v in tree]
        return ([x for p in parts for x in p[0]],
                f"{type(tree).__name__}(" + ", ".join(
                    f"{f}={p[1]}" for f, p in zip(tree._fields, parts)) + ")")
    if isinstance(tree, dict):
        parts = {k: _flatten(tree[k]) for k in sorted(tree)}
        return ([x for p in parts.values() for x in p[0]],
                "{" + ", ".join(f"{k!r}: {p[1]}"
                                for k, p in parts.items()) + "}")
    if type(tree) in (list, tuple):
        parts = [_flatten(v) for v in tree]
        opening, closing = ("[", "]") if type(tree) is list else ("(", ")")
        return ([x for p in parts for x in p[0]],
                opening + ", ".join(p[1] for p in parts) + closing)
    return [tree], "*"


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in ``_flatten``'s
    order."""
    it = iter(leaves)

    def take(node):
        if node is None:
            return None
        if _is_namedtuple(node):
            return type(node)(*(take(v) for v in node))
        if isinstance(node, dict):
            vals = {k: take(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if type(node) in (list, tuple):
            return type(node)(take(v) for v in node)
        return next(it)

    return take(like)


def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array of its own and its dtype's name."""
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy().copy(), "uint8"
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if hasattr(t, "full_tensor"):        # a DTensor: the whole array
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).to("cpu", copy=True).numpy()
                    .view(np.uint16), BF16)
        a = t.to("cpu", copy=True).numpy()
        return a, str(a.dtype)
    a = np.array(leaf)
    return a, str(a.dtype)


def _from_host(arr: np.ndarray, dtype: str, proto: Any) -> Any:
    """The saved array as a leaf like ``proto``: a generator with its state,
    a tensor on the proto's device and dtype (a DTensor proto: laid out as
    it is, each rank keeping its slice), or (any other proto) a CPU
    tensor."""
    if isinstance(proto, torch.Generator):
        gen = torch.Generator(device=proto.device)
        gen.set_state(torch.from_numpy(arr))
        return gen
    t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
         if dtype == BF16 else torch.from_numpy(arr))
    if not isinstance(proto, torch.Tensor):
        return t
    t = t.to(device=proto.device, dtype=proto.dtype)
    if hasattr(proto, "full_tensor"):        # a DTensor: laid out as it is
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, proto.device_mesh, proto.placements,
                                 src_data_rank=None)
    return t


class Checkpointer:
    def __init__(self, root: str, keep: int = 3, n_hosts: int = 1,
                 host_id: int = 0):
        self.root = root
        self.keep = keep
        self.n_hosts = n_hosts
        self.host_id = host_id
        self._async_thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    # ---- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, async_: bool = False) -> str:
        """Snapshot ``tree`` at ``step``.  Arrays are host-fetched NOW (so
        training may mutate state immediately); writing happens inline or in
        a background thread."""
        leaves, treedef = _flatten(tree)
        host = [_to_host(l) for l in leaves]
        host_leaves = [a for a, _ in host]
        meta = {
            "step": step,
            # restore() rebuilds structure from the caller's `like` tree;
            # the manifest records leaf metadata only
            "treedef": treedef,
            "n_leaves": len(leaves),
            "shapes": [list(a.shape) for a in host_leaves],
            "dtypes": [d for _, d in host],
            "n_hosts": self.n_hosts,
        }
        if async_:
            self.wait()
            self._async_thread = threading.Thread(
                target=self._write, args=(step, host_leaves, meta), daemon=True)
            self._async_thread.start()
        else:
            self._write(step, host_leaves, meta)
        return _step_dir(self.root, step)

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _write(self, step: int, host_leaves: List[np.ndarray],
               meta: Dict) -> None:
        d = _step_dir(self.root, step)
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        # each host owns a contiguous slice of the leaf list
        per = (len(host_leaves) + self.n_hosts - 1) // max(self.n_hosts, 1)
        lo, hi = self.host_id * per, min((self.host_id + 1) * per,
                                         len(host_leaves))
        shard_name = f"shard_{self.host_id:05d}.npz"
        np.savez(os.path.join(tmp, shard_name),
                 **{str(i): host_leaves[i] for i in range(lo, hi)})
        # crc32 over the written file: restore refuses to trust any byte
        # that does not hash back (bitrot, torn writes, tampering).  In a
        # multi-host job each host would publish its own checksum before
        # the barrier; single-process, host 0 owns every shard.
        meta["checksums"] = {
            shard_name: _crc32_of(os.path.join(tmp, shard_name))}
        if self.host_id == 0:
            # In a multi-host job a barrier precedes the commit (every host
            # has written its shard file by barrier entry); in one process
            # host 0 owns all leaves, so the commit is immediate.
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
            if os.path.isdir(d):
                shutil.rmtree(d)
            os.replace(tmp, d)
            with open(os.path.join(d, COMMIT_MARKER), "w") as f:
                f.write(str(time.time()))
            self._gc()

    # ---- restore --------------------------------------------------------------
    def _quick_ok(self, d: str) -> bool:
        """Cheap structural check: a committed step must still have its
        manifest and at least one non-empty shard file (catches zero-length
        truncation without hashing anything)."""
        if not os.path.exists(os.path.join(d, "manifest.json")):
            return False
        shards = [n for n in os.listdir(d)
                  if n.startswith("shard_") and n.endswith(".npz")]
        return bool(shards) and all(
            os.path.getsize(os.path.join(d, n)) > 0 for n in shards)

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.root):
            d = os.path.join(self.root, name)
            if (_step_of(name) is not None
                    and os.path.exists(os.path.join(d, COMMIT_MARKER))
                    and self._quick_ok(d)):
                steps.append(_step_of(name))
        return max(steps) if steps else None

    def _quarantine(self, step: int) -> str:
        """Move a corrupt step aside so no scan trusts it again (kept on
        disk, not deleted — the bytes are evidence)."""
        d = _step_dir(self.root, step)
        q = f"{d}.quarantined_{int(time.time() * 1e3)}"
        os.replace(d, q)
        return q

    def _verify(self, d: str) -> Dict:
        """Checksum every shard against the manifest; raises
        CheckpointCorruptionError on any mismatch.  Manifests predating
        checksums (older checkpoints) skip hash verification.  Returns the
        manifest."""
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptionError(f"{d}: unreadable manifest: {e}")
        for name, want in (meta.get("checksums") or {}).items():
            path = os.path.join(d, name)
            if not os.path.exists(path):
                raise CheckpointCorruptionError(f"{d}: missing shard {name}")
            got = _crc32_of(path)
            if got != want:
                raise CheckpointCorruptionError(
                    f"{d}: shard {name} crc32 {got:#010x} != "
                    f"manifest {want:#010x}")
        return meta

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None) -> Tuple[Any, int]:
        """Rebuild the tree of ``like``'s structure, each leaf on its
        proto's device and dtype.

        With ``step=None`` (the auto-resume path), a step that fails
        checksum verification is quarantined and restore falls back to the
        previous committed step until one verifies.  An explicitly
        requested ``step`` is also verified, but corruption raises (the
        caller asked for those exact bytes — silently substituting older
        ones would be worse than failing).

        ``shardings``: a tree of ``like``'s structure whose leaves are
        ``distributed.sharding.NamedSharding`` (or None: the leaf stays as
        restored); each restored leaf is laid out on its mesh."""
        if step is None:
            while True:
                step = self.latest_step()
                if step is None:
                    raise FileNotFoundError(
                        f"no committed checkpoint in {self.root}")
                try:
                    tree = self._restore_step(like, step)
                    break
                except CheckpointCorruptionError:
                    self._quarantine(step)
        else:
            tree = self._restore_step(like, step)
        if shardings is not None:
            from repro_torch.distributed.sharding import place_tree
            tree = place_tree(tree, shardings)
        return tree, step

    def _restore_step(self, like: Any, step: int) -> Any:
        d = _step_dir(self.root, step)
        if not os.path.exists(os.path.join(d, COMMIT_MARKER)):
            raise FileNotFoundError(f"checkpoint {d} not committed")
        meta = self._verify(d)
        arrays: Dict[int, np.ndarray] = {}
        try:
            for name in sorted(os.listdir(d)):
                if name.startswith("shard_") and name.endswith(".npz"):
                    with np.load(os.path.join(d, name)) as z:
                        for k in z.files:
                            arrays[int(k)] = z[k]
        except (OSError, ValueError, KeyError) as e:
            # unreadable zip/npz (e.g. truncated mid-write): same corruption
            # class as a checksum mismatch, same quarantine-and-fall-back
            raise CheckpointCorruptionError(f"{d}: unreadable shard: {e}")
        leaves_like, _ = _flatten(like)
        if len(arrays) != len(leaves_like):
            raise ValueError(f"checkpoint has {len(arrays)} leaves, expected "
                             f"{len(leaves_like)}")
        return _unflatten(like, [_from_host(arrays[i], meta["dtypes"][i], proto)
                                 for i, proto in enumerate(leaves_like)])

    # ---- GC --------------------------------------------------------------------
    def _gc(self) -> None:
        steps = sorted(
            _step_of(n) for n in os.listdir(self.root)
            if _step_of(n) is not None and os.path.exists(
                os.path.join(self.root, n, COMMIT_MARKER)))
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(_step_dir(self.root, s), ignore_errors=True)
        # drop orphaned tmp dirs from crashed saves
        for n in os.listdir(self.root):
            if n.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.root, n), ignore_errors=True)
