"""Autumn delta-checkpoint store over torch pytrees, in the device store.

Counterpart of ``repro.checkpoint.store``:

  * every leaf of a pytree (nested dicts, lists and tuples of tensors) is
    cut into ``CHUNK_BYTES`` values under *sequential* u64 ids (a registry
    in insertion order), so a full restore is one range read per leaf;
  * a save writes only the chunks whose content hash changed (delta
    checkpoints); chunk slots are overwritten in place, so the latest
    durable checkpoint is always exactly restorable, and older manifests
    only for the chunks unchanged since;
  * the manifest (step -> chunk ids and leaf metadata) is written last, and
    a restore goes through it, so a crash mid-save never exposes a partial
    checkpoint;
  * one leaf restores by point reads, one per chunk.

Leaves are flattened in JAX's order (dict keys sorted, then lists and
tuples by index; ``None`` is an empty subtree) and named by
``jax.tree_util.keystr``'s path strings (``['layer']['w']``, ``[0]``), and
a leaf's bytes and dtype name are numpy's, so for equal leaf bytes this
store writes the reference's keys and values.  The store is
``core.make_store``'s, on its device (``cuda:0`` unless the caller names
another); :meth:`CheckpointStore.restore` returns tensors on that device.

``AsyncCheckpointer`` moves the serialization and the store writes off the
training thread, with a bounded queue for back-pressure.
"""
from __future__ import annotations

import hashlib
import json
import queue
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core import LSMConfig, make_store

Pytree = Any

CHUNK_BYTES = 1 << 16
_MANIFEST_KEY_BASE = 1 << 62        # the manifests' id space


def _leaf_paths(tree: Pytree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) in JAX's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaf_paths(sub, f"{path}[{i}]")
    else:
        yield path, tree


def _unflatten(like: Pytree, leaves: Iterator[Any]) -> Pytree:
    """``like``'s structure with its leaves taken in flattening order."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(sub, leaves) for sub in like)
    return next(leaves)


def _host_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().contiguous().cpu()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(leaf)))


def _dtype_of(leaf) -> torch.dtype:
    return leaf.dtype if isinstance(leaf, torch.Tensor) \
        else _host_tensor(leaf).dtype


def _dtype_name(t: torch.Tensor) -> str:
    """numpy's name for the dtype (``float32``, ``bfloat16``, ``bool``)."""
    return str(t.dtype).split(".")[-1]


def _leaf_bytes(leaf) -> Tuple[bytes, str, List[int]]:
    t = _host_tensor(leaf)
    data = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return data, _dtype_name(t), list(t.shape)


def _tensor_of(data: bytes, dtype: str, shape: List[int],
               device: torch.device) -> torch.Tensor:
    dt = getattr(torch, dtype)
    if not data:
        return torch.empty(shape, dtype=dt, device=device)
    flat = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    return flat.view(dt).reshape(shape).to(device)


def store_config() -> LSMConfig:
    """The reference's checkpoint store configuration: Garnering, Monkey
    blooms at 10 bits a key, a 1 MiB write buffer and a 4 MiB base level."""
    return LSMConfig(policy="garnering", T=2.0, c=0.8,
                     memtable_bytes=1 << 20, base_level_bytes=4 << 20,
                     bits_per_key=10, bloom_allocation="monkey")


class CheckpointStore:
    def __init__(self, lsm_config: Optional[LSMConfig] = None, device=None):
        # make_store: LSMConfig.shards > 1 range-partitions the chunk ids
        # behind the same API
        self.db = make_store(lsm_config or store_config(), device=device)
        # path -> first chunk id; ids in insertion order, so restores scan
        self._registry: Dict[str, int] = {}
        self._chunk_counts: Dict[str, int] = {}
        self._next_id = 1
        self._hashes: Dict[int, bytes] = {}   # chunk id -> content hash
        self.stats_deltas_skipped = 0
        self.stats_chunks_written = 0

    @property
    def device(self) -> torch.device:
        return self.db.device

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Pytree) -> Dict[str, Any]:
        entries = []
        for path, leaf in _leaf_paths(tree):
            data, dtype, shape = _leaf_bytes(leaf)
            n_chunks = max(1, -(-len(data) // CHUNK_BYTES))
            if path not in self._registry:
                self._registry[path] = self._next_id
                self._chunk_counts[path] = n_chunks
                self._next_id += n_chunks
            assert self._chunk_counts[path] == n_chunks, \
                f"{path}: chunk count changed (elastic reshape not per-leaf)"
            base = self._registry[path]
            cids, chunks = [], []
            for ci in range(n_chunks):
                chunk = data[ci * CHUNK_BYTES:(ci + 1) * CHUNK_BYTES]
                h = hashlib.blake2b(chunk, digest_size=16).digest()
                cid = base + ci
                if self._hashes.get(cid) == h:
                    self.stats_deltas_skipped += 1
                    continue
                self._hashes[cid] = h
                cids.append(cid)
                chunks.append(chunk)
            if cids:
                # the put loop's store state (WAL bytes, sequence numbers,
                # flush points), with the WAL's host CRC taken over a
                # write buffer's records at a time instead of one by one
                self.db.put_batch(cids, chunks)
                self.stats_chunks_written += len(cids)
            entries.append({"path": path, "base": base, "chunks": n_chunks,
                            "dtype": dtype, "shape": shape})
        manifest = {"step": step, "entries": entries}
        self.db.put(_MANIFEST_KEY_BASE + step,
                    json.dumps(manifest).encode())
        self.db.flush()
        self.db.fsync_wal()
        return manifest

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        res = self.db.scan(_MANIFEST_KEY_BASE, count=1 << 20)
        steps = [k - _MANIFEST_KEY_BASE for k, _ in res]
        return max(steps) if steps else None

    def _manifest(self, step: int) -> Optional[dict]:
        raw = self.db.get(_MANIFEST_KEY_BASE + step)
        return None if raw is None else json.loads(raw.decode())

    def restore(self, step: Optional[int] = None
                ) -> Optional[Dict[str, torch.Tensor]]:
        """Every leaf of ``step`` (the latest when None), by path, on the
        store's device: one range read over each leaf's chunk ids."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        manifest = self._manifest(step)
        if manifest is None:
            return None
        out: Dict[str, torch.Tensor] = {}
        for e in manifest["entries"]:
            rows = self.db.scan(e["base"], count=e["chunks"])
            data = b"".join(v for _, v in rows[:e["chunks"]])
            out[e["path"]] = _tensor_of(data, e["dtype"], e["shape"],
                                        self.device)
        return out

    def restore_leaf(self, step: int, path: str) -> Optional[torch.Tensor]:
        """One leaf by point reads (bloom-filtered), on the store's
        device."""
        manifest = self._manifest(step)
        if manifest is None:
            return None
        for e in manifest["entries"]:
            if e["path"] == path:
                chunks = self.db.multi_get(
                    [e["base"] + i for i in range(e["chunks"])])
                if any(c is None for c in chunks):
                    return None
                return _tensor_of(b"".join(chunks), e["dtype"], e["shape"],
                                  self.device)
        return None

    def restore_tree(self, step: Optional[int], like: Pytree
                     ) -> Optional[Pytree]:
        """``like``'s structure rebuilt from ``step``, each leaf in the
        dtype of ``like``'s, on the store's device."""
        flat = self.restore(step)
        if flat is None:
            return None
        leaves = iter([flat[path].to(_dtype_of(leaf))
                       for path, leaf in _leaf_paths(like)])
        return _unflatten(like, leaves)

    # ------------------------------------------------------------- recovery
    def crash(self):
        self.db.crash()
        self.db.recover()
        # the delta hashes were process memory: rebuilt conservatively
        self._hashes.clear()


class AsyncCheckpointer:
    """Background writer thread: serialization and store writes off the
    training thread."""

    def __init__(self, store: CheckpointStore, max_pending: int = 2):
        self.store = store
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        dev = self.store.device
        if dev.type == "cuda":
            torch.cuda.set_device(dev)   # the current device is per thread
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree = item
            try:
                self.store.save(step, tree)
            except BaseException as e:   # surfaced on next submit/close
                self._err = e

    def submit(self, step: int, tree: Pytree):
        if self._err:
            raise self._err
        # a host copy before the enqueue: later in-place updates of the
        # caller's tensors must not reach the checkpoint
        host = _unflatten(tree, iter([
            leaf.detach().to("cpu", copy=True)
            if isinstance(leaf, torch.Tensor) else _host_tensor(leaf).clone()
            for _, leaf in _leaf_paths(tree)]))
        self._q.put((step, host))

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._err:
            raise self._err
