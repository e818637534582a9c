"""Checkpoints of trees of arrays on the host.

- A tree is nested dicts, lists, tuples and named tuples (a training
  state) of arrays (numpy arrays, or tensors, which are copied to the
  host; a bfloat16 tensor is saved as its 16-bit pattern and its dtype
  named in the manifest).  Each leaf is saved as one
  ``.npy`` file named by its path in the tree (``"cols/energy_overhead"``,
  ``"layers/0/w"``); a JSON manifest holds the step, each leaf's file,
  dtype and shape, and the caller's ``extra``.
- Object arrays (the Study's string and tuple columns) are pickled by
  numpy and loaded back with ``allow_pickle`` only where the manifest
  says so.
- A save writes ``<dir>.tmp`` and renames it over ``<dir>``, so a reader
  sees the old checkpoint or the new one, never half of one.
- ``CheckpointManager`` keeps the newest ``keep`` steps and can hand the
  write to a thread.
- A restore may re-place the tree onto another device layout than the
  one it was saved from (``shardings=``: a matching tree of devices), as
  the reference's ``device_put`` with a new sharding does.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.optim import tree_map, tree_unflatten

def _flatten(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """``(path, leaf)`` pairs in the tree's order: dict keys and sequence
    indices joined by ``/``."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}/{k}" if prefix else k)
    return out


def _unflatten(template, leaves: Dict[str, object]):
    """``template``'s structure (a named tuple rebuilt field by field)
    holding the leaves saved under its paths."""
    return tree_unflatten(template, [leaves[p] for p, _ in
                                     _flatten(template)])


class _BF16(np.ndarray):
    """A bfloat16 tensor's bits on the host, as uint16 (numpy has no
    bfloat16): saved as such, its dtype named ``bfloat16``."""


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16).view(_BF16)
        return leaf.numpy()
    return np.asanyarray(leaf)


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    if dtype == "bfloat16":
        return t.view(torch.int16).view(torch.bfloat16)
    return t


def save_pytree(directory: str, tree, step: int,
                extra: Optional[Dict] = None) -> str:
    """Save ``tree`` to ``directory`` (replaced atomically)."""
    tmp = directory + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {},
                "time": time.time()}
    for key, leaf in _flatten(tree):
        arr = _host(leaf)
        fn = key.replace("/", "__") + ".npy"
        dtype = "bfloat16" if isinstance(arr, _BF16) else str(arr.dtype)
        np.save(os.path.join(tmp, fn), np.asarray(arr))
        manifest["leaves"][key] = {"file": fn, "dtype": dtype,
                                   "shape": list(arr.shape),
                                   "object": bool(arr.dtype == object)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.replace(tmp, directory)
    return directory


def load_pytree_numpy(directory: str):
    """Every leaf of a saved tree as host numpy, keyed by its path:
    ``(leaves, manifest)``."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    for key, meta in manifest["leaves"].items():
        leaves[key] = np.load(os.path.join(directory, meta["file"]),
                              allow_pickle=meta.get("object", False))
    return leaves, manifest


def restore_pytree(directory: str, template, shardings=None):
    """The saved tree in the structure of ``template``: ``(tree,
    manifest)``, numeric leaves as tensors and object leaves as numpy
    arrays (host-only payloads, such as the Study's string columns).

    ``shardings`` is None (every numeric leaf on the CPU) or a tree of
    the template's structure whose leaves are devices (``torch.device``
    or a name; None keeps that leaf on the CPU): each numeric leaf is put
    on its device, whatever devices it was saved from."""
    leaves, manifest = load_pytree_numpy(directory)
    placed = dict(_flatten(shardings)) if shardings is not None else {}
    for path in placed:
        if path not in leaves:
            raise KeyError(f"shardings names {path!r}, which the checkpoint "
                           f"in {directory} does not hold")
    out = {}
    for k, a in leaves.items():
        if a.dtype == object:
            out[k] = a
            continue
        t = _tensor(a, manifest["leaves"][k]["dtype"])
        dev = placed.get(k)
        out[k] = t if dev is None else t.to(torch.device(dev))
    return _unflatten(template, out), manifest


class CheckpointManager:
    """Steps under ``root/step_<n>``: retention of the newest ``keep``, an
    optional writer thread, and the latest step's restore."""

    def __init__(self, root: str, keep: int = 3, async_save: bool = False):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:010d}")

    def steps(self) -> List[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.root)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        # copy to the host before the thread starts, so the caller may
        # overwrite its tensors at once
        host_tree = tree_map(_host, tree)

        def commit():
            save_pytree(self._dir(step), host_tree, step, extra)
            self._gc()

        if self.async_save:
            self.wait()
            self._thread = threading.Thread(target=commit, daemon=True)
            self._thread.start()
        else:
            commit()

    def restore_latest(self, template, shardings=None):
        steps = self.steps()
        if not steps:
            return None, None
        return restore_pytree(self._dir(steps[-1]), template, shardings)

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._dir(s), ignore_errors=True)
