"""Cross-process collectives: the scenario mesh's merge of per-row results,
and an int8 error-feedback all-reduce.

``host_allgather`` is the merge step of the scenario mesh
(``parallel/distributed.py``): after a chunk ran, each process holds the
per-row metrics of its own rows only; one object all-gather over gloo
brings every process's rows to every process, in global row order, and
``take`` drops the shard padding.  The payloads are pickled, so the merged
arrays carry the same bits the computing process had.  In one process it
is the plain host pull the engine always did, so the code path is shared.

``compressed_allreduce_mean`` quantizes a tensor to int8 with a scale per
block of ``BLOCK`` elements before the mean over a process group, and
carries the quantization residual as error-feedback state so the bias
vanishes over steps (the 1-bit-Adam family).  Its wire format is 8.25
bits an element against 32 (``compressed_bytes``).  The reference's
``axis_name`` under ``shard_map`` is a ``torch.distributed`` process group
here.  These are elementwise operations and a library all-reduce; there is
no kernel of the reference's behind them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

F32 = torch.float32
BLOCK = 256


# ---------------------------------------------------------------------------
# the scenario mesh's merge
# ---------------------------------------------------------------------------

def tree_map(fn, tree):
    """``fn`` on every leaf of nested dicts, lists and tuples (None stays
    None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def concat_trees(trees):
    """Leaf-wise concatenation along the leading (row) axis of trees of
    one structure (a None leaf stays None, and a leaf with no row axis is
    the first tree's); one tree is returned as it is, uncopied."""
    if len(trees) == 1:
        return trees[0]
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: concat_trees([t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(concat_trees([t[i] for t in trees])
                        for i in range(len(t0)))
    if not isinstance(t0, (np.ndarray, torch.Tensor)) or t0.ndim == 0:
        return t0
    return np.concatenate([_host(t) for t in trees])


def gather_parts(parts, plan=None, *, group=None) -> list:
    """This process's list of host objects followed by every other
    process's, in rank order: one ``all_gather_object`` over ``group``
    (None: the default group, whose object collectives run on gloo) when
    ``plan`` spans processes, else the list itself."""
    parts = list(parts)
    if plan is None or plan.n_processes <= 1:
        return parts
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, parts, group=group)
    return [p for rank_parts in out for p in rank_parts]


def host_allgather(tree, plan=None, *, take: Optional[int] = None,
                   group=None):
    """A tree of per-row results (tensors or numpy arrays, rows leading)
    as host numpy on every process, the rows of every process in rank
    order (global row order under a ``ScenarioShardPlan``), cut to the
    first ``take`` rows.

    ``plan`` is the plan the rows ran under (or None).  In one process
    this is a plain host pull; across processes, one object all-gather
    (``gather_parts``)."""
    local = tree_map(_host, tree)
    if plan is not None and plan.n_processes > 1:
        local = concat_trees(gather_parts([local], plan, group=group))
    if take is None:
        return local
    return tree_map(lambda a: a[:take], local)


def gather_rows(x, idx, plan=None, *, length: Optional[int] = None):
    """``x[idx][:, :length]``: rows of a batch this process holds.  Under
    the port's plan a process holds only its own rows, so the gather is
    local whatever the plan: ``plan`` is taken only to keep the
    reference's signature, and is not read."""
    cols = slice(None) if length is None else slice(0, length)
    if isinstance(x, torch.Tensor):
        return x[torch.as_tensor(np.asarray(idx), device=x.device), cols]
    return np.asarray(x)[np.asarray(idx), cols]


# ---------------------------------------------------------------------------
# int8 error-feedback all-reduce
# ---------------------------------------------------------------------------

def _quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with one scale per block: ``x`` flat
    ``[N]`` float32, ``N % BLOCK == 0``."""
    xb = x.reshape(-1, BLOCK)
    scale = xb.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale.to(F32)


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.to(F32) * scale).reshape(-1)


def _flat_padded(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1).to(F32)
    pad = (-flat.numel()) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)) if pad else flat


def quantize_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """``dequantize(quantize(x))`` with the block padding dropped."""
    q, s = _quantize_int8(_flat_padded(x))
    return _dequantize_int8(q, s)[:x.numel()].reshape(x.shape)


def compressed_allreduce_mean(x: torch.Tensor, err: torch.Tensor,
                              group=None) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Error-feedback int8 all-reduce-mean over ``group`` (None: the
    default group; without a job, this process alone).

    ``x`` is this rank's tensor and ``err`` the residual carried from the
    previous step (same shape).  Returns ``(mean estimate, new residual)``
    in ``x``'s dtype.  The sum runs over the dequantized payload with
    ``torch.distributed.all_reduce``."""
    n = x.numel()
    flat = _flat_padded(x.to(F32) + err.to(F32))
    q, scale = _quantize_int8(flat)
    local_deq = _dequantize_int8(q, scale)
    new_err = (flat - local_deq)[:n].reshape(x.shape)
    summed, size = local_deq.clone(), 1
    if dist.is_available() and dist.is_initialized():
        size = dist.get_world_size(group)
        if size > 1:
            dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    mean = summed / torch.tensor(float(size), dtype=F32, device=x.device)
    return mean[:n].reshape(x.shape).to(x.dtype), new_err.to(x.dtype)


def compressed_bytes(n_elements: int) -> int:
    """Wire bytes of one rank's payload (int8 values and float32 block
    scales)."""
    blocks = (n_elements + BLOCK - 1) // BLOCK
    return n_elements + 4 * blocks
