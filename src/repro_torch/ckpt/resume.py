"""Resumable Study streams: per-chunk checkpoints of the columnar
``StudyResult`` through ``ckpt/checkpoint.py``.

``run_rows(..., resume=dir)`` threads a ``SweepCheckpoint`` through the
streaming loop.  Between chunks the primary process saves that chunk's
slice of the record columns (``save_chunk``); on restart the contiguous
prefix of valid chunk checkpoints is scattered back into the columns
(``restore_call``) and ``engine.stream_batches(skip_rows=...)`` never
dispatches the covered chunks.  Because per-row values do not depend on
how rows are chunked (``core/engine.py``), a resumed run is bit-identical
to an uninterrupted one.

Identity is a two-level fingerprint in ``sweep.json``:

* ``config_sig`` — digest of everything row-independent (waveform
  config, hardware, spec names + limits, padding mode, sample_chips).
* ``rows_digest`` — a *rolling* sha256 chain over per-row signatures
  (workload content, fleet, mitigation config content, seed, PRNG key
  bytes).  Storing the chain value at ``n_rows`` means a finished sweep
  can be **extended**: a longer row list whose prefix chain matches is
  the same sweep plus new rows, so old chunks restore and only new rows
  compute.  Any other change breaks the chain and fails loudly.

Corruption never degrades to a silently-wrong merged result: a
truncated/unreadable chunk, a fingerprint mismatch, or a chunk-size
mismatch each raise ``ResumeError`` with the offending path and the fix.

``validate_or_init(write=False)`` checks without writing (a process that
is not the one that saves).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.ckpt.checkpoint import load_pytree_numpy, save_pytree

VERSION = 2  # v2: spec metrics stored as numeric "metrics:<name>" columns


class ResumeError(RuntimeError):
    """A resume directory that cannot safely continue this sweep."""


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------

def _update(h, obj) -> None:
    """Feed ``obj`` into hash ``h`` structurally: dataclasses by field,
    arrays by dtype/shape/bytes — no reliance on ``repr`` truncation."""
    if obj is None:
        h.update(b"\x00N")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        h.update(type(obj).__name__.encode())
        for f in dataclasses.fields(obj):
            h.update(f.name.encode())
            _update(h, getattr(obj, f.name))
    elif isinstance(obj, Mapping):
        for k in obj:
            h.update(str(k).encode())
            _update(h, obj[k])
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _update(h, v)
    elif isinstance(obj, bytes):
        h.update(obj)
    elif isinstance(obj, str):
        h.update(obj.encode())
    elif isinstance(obj, (bool, int, float, np.bool_, np.integer,
                          np.floating)):
        h.update(repr(obj).encode() if not isinstance(obj, float)
                 else np.float64(obj).tobytes())
    elif hasattr(obj, "__array__"):
        a = np.asarray(obj)
        h.update(str(a.dtype).encode() + str(a.shape).encode() + a.tobytes())
    else:
        h.update(repr(obj).encode())


def digest(obj) -> str:
    h = hashlib.sha256()
    _update(h, obj)
    return h.hexdigest()


def config_signature(*, cfg, hw, specs, mode: str,
                     sample_chips: int) -> str:
    """Digest of the row-independent sweep identity.  The spec list is
    part of it because spec order fixes record positions."""
    h = hashlib.sha256()
    _update(h, ("v", VERSION, cfg, hw, mode, sample_chips))
    for name, sp in specs:
        _update(h, (name, sp))
    return h.hexdigest()


def key_bytes(key) -> bytes:
    """A key's two uint32 words as bytes (a key tensor, or the words)."""
    if hasattr(key, "detach"):
        key = key.detach().cpu().numpy()
    return np.asarray(key).astype(np.uint32).tobytes()


def rows_chain(workloads, rows, keys, at: Sequence[int]) -> Dict[int, str]:
    """Rolling sha256 over per-row signatures; returns the chain value at
    each requested prefix length (one pass, ``h.copy()`` snapshots).
    A match at prefix ``n`` proves the first ``n`` rows are the same
    sweep — the extension check."""
    want = set(at)
    wl = {w: digest(workloads[w]) for w in {r[0] for r in rows}}
    cfg_cache: Dict[int, str] = {}
    h = hashlib.sha256()
    out: Dict[int, str] = {}
    if 0 in want:
        out[0] = h.hexdigest()
    for r, (w, n, config, seed) in enumerate(rows):
        cd = cfg_cache.get(id(config))
        if cd is None:
            cd = cfg_cache[id(config)] = digest(config)
        h.update(f"{w}|{wl[w]}|{n}|{cd}|{seed}|".encode())
        if keys is None or keys[r] is None:
            h.update(b"nokey")
        else:
            h.update(key_bytes(keys[r]))
        if r + 1 in want:
            out[r + 1] = h.hexdigest()
    return out


# ---------------------------------------------------------------------------
# record-position helpers
# ---------------------------------------------------------------------------

def record_positions(rows_global: np.ndarray, n_specs: int) -> np.ndarray:
    """Columnar positions of the given pipeline rows: record position =
    row * n_specs + spec index (the ``_fill_chunk`` layout)."""
    rows_global = np.asarray(rows_global, np.int64)
    return (np.repeat(rows_global * n_specs, n_specs)
            + np.tile(np.arange(n_specs, dtype=np.int64), len(rows_global)))


# ---------------------------------------------------------------------------
# the sweep checkpoint
# ---------------------------------------------------------------------------

class SweepCheckpoint:
    """Layout::

        <dir>/sweep.json                      fingerprint manifest
        <dir>/chunks/<call>/chunk_<lo>/       one save_pytree dir per chunk

    ``call`` is the call-stream key (structure group x length bucket) and
    ``lo`` the chunk's start offset inside that call's row-index list.
    """

    def __init__(self, directory: str):
        self.dir = directory
        self.manifest_path = os.path.join(directory, "sweep.json")

    def _chunk_dir(self, call: str, lo: int) -> str:
        return os.path.join(self.dir, "chunks", call, f"chunk_{lo:08d}")

    # -- fingerprint validation ---------------------------------------------

    def validate_or_init(self, *, workloads, rows, specs, keys, cfg, hw,
                         mode: str, sample_chips: int, chunk_size: int,
                         write: bool = True) -> None:
        """Check this directory continues the given sweep (raising
        ``ResumeError`` otherwise) and bring ``sweep.json`` up to date
        with the current row count (``write=False`` on non-primary
        processes)."""
        csig = config_signature(cfg=cfg, hw=hw, specs=specs, mode=mode,
                                sample_chips=sample_chips)
        old = None
        if os.path.exists(self.manifest_path):
            try:
                with open(self.manifest_path) as fh:
                    old = json.load(fh)
            except (json.JSONDecodeError, OSError) as e:
                raise ResumeError(
                    f"unreadable sweep manifest {self.manifest_path}: {e}; "
                    "delete the resume dir to start over") from e
        at = [len(rows)] + ([old["n_rows"]] if old else [])
        chain = rows_chain(workloads, rows, keys, at)
        if old is not None:
            if old.get("version") != VERSION:
                raise ResumeError(
                    f"{self.manifest_path}: version {old.get('version')} != "
                    f"{VERSION}; delete the resume dir to start over")
            if old["chunk_size"] != chunk_size:
                raise ResumeError(
                    f"resume dir {self.dir} was written with "
                    f"stream={old['chunk_size']} but this run uses "
                    f"stream={chunk_size}; chunk boundaries would not line "
                    f"up — rerun with stream={old['chunk_size']} or use a "
                    "fresh resume dir")
            if old["config_sig"] != csig:
                raise ResumeError(
                    f"resume dir {self.dir} fingerprint mismatch: waveform "
                    "config / hardware / specs / padding changed since the "
                    "checkpointed sweep — results would not be comparable; "
                    "use a fresh resume dir")
            if old["n_rows"] > len(rows):
                raise ResumeError(
                    f"resume dir {self.dir} checkpointed {old['n_rows']} "
                    f"pipeline rows but this run declares only {len(rows)}; "
                    "a sweep can be extended, not shrunk — use a fresh "
                    "resume dir")
            if chain[old["n_rows"]] != old["rows_digest"]:
                raise ResumeError(
                    f"resume dir {self.dir} fingerprint mismatch: the first "
                    f"{old['n_rows']} scenario rows differ from the "
                    "checkpointed grid (workload, fleet, config, seed, or "
                    "key change) — extending a sweep may only append rows; "
                    "use a fresh resume dir")
        if write and (old is None or old["n_rows"] != len(rows)):
            os.makedirs(self.dir, exist_ok=True)
            tmp = self.manifest_path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump({"version": VERSION, "config_sig": csig,
                           "chunk_size": chunk_size, "n_rows": len(rows),
                           "n_specs": len(specs),
                           "rows_digest": chain[len(rows)]}, fh)
            os.replace(tmp, self.manifest_path)

    # -- per-chunk save / restore -------------------------------------------

    def save_chunk(self, call: str, idx: List[int], lo: int, hi: int,
                   cols: Dict[str, np.ndarray], n_specs: int) -> None:
        """Checkpoint rows ``idx[lo:hi]``'s records out of the columnar
        store (called right after ``_fill_chunk`` wrote them)."""
        rows_global = np.asarray(idx[lo:hi], np.int64)
        pos = record_positions(rows_global, n_specs)
        tree = {"rows": rows_global,
                "cols": {k: np.copy(v[pos]) for k, v in cols.items()
                         if k != "index"}}
        save_pytree(self._chunk_dir(call, lo), tree, step=lo,
                    extra={"call": call, "lo": lo, "hi": hi})

    def restore_call(self, call: str, idx: List[int], chunk_size: int,
                     cols: Dict[str, np.ndarray], n_specs: int) -> int:
        """Scatter the contiguous prefix of valid chunk checkpoints of
        this call stream back into ``cols``; returns the number of rows
        covered (the ``skip_rows`` for ``stream_batches``).

        A chunk checkpoint is valid iff its saved global row ids equal
        ``idx[lo:hi]`` for the current chunk boundaries — after an
        extension, a formerly-partial tail chunk that gained rows simply
        stops the prefix and is recomputed.  An unreadable chunk under a
        matching manifest raises ``ResumeError`` (never a silent hole).
        """
        covered = 0
        for lo in range(0, len(idx), chunk_size):
            hi = min(lo + chunk_size, len(idx))
            d = self._chunk_dir(call, lo)
            if not os.path.isdir(d):
                break
            try:
                leaves, _ = load_pytree_numpy(d)
            except Exception as e:
                raise ResumeError(
                    f"corrupt chunk checkpoint {d}: {e}; delete that "
                    "chunk directory to recompute it") from e
            saved_rows = leaves.get("rows")
            if saved_rows is None or not np.array_equal(
                    saved_rows, np.asarray(idx[lo:hi], np.int64)):
                # stale boundary (extended call stream) — recompute from here
                break
            pos = record_positions(saved_rows, n_specs)
            for k in cols:
                if k != "index" and f"cols/{k}" not in leaves:
                    raise ResumeError(
                        f"chunk checkpoint {d} is missing column {k!r}; "
                        "delete that chunk directory to recompute it")
            n = len(cols["index"])
            for path, leaf in leaves.items():
                if not path.startswith("cols/"):
                    continue
                k = path[len("cols/"):]
                v = cols.get(k)
                if v is None:
                    # side columns (e.g. "metrics:<name>") are created
                    # lazily by the fill path; a restore that runs first
                    # creates them here with the same NaN/empty default
                    v = cols[k] = (np.empty(n, dtype=object)
                                   if leaf.dtype == object
                                   else np.full(n, np.nan, dtype=leaf.dtype))
                v[pos] = leaf
            covered = hi
        return covered
