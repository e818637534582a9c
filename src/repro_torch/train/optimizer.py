"""AdamW with decoupled weight decay, global-norm clipping and a warmup +
cosine schedule (reference: ``repro/train/optimizer.py``).  Moments are
stored in ``moment_dtype`` with float32 update math.

The moment math and norm clipping are ``core/optim.py``'s (shared with
the design's gradient loop); this module keeps the training pieces: the
schedule, the moment storage, and the weight-decay mask by leaf name.
The mask is the reference's verbatim, substring match included: a leaf
whose name contains any of ``_DECAY_EXEMPT`` is not decayed, so besides
the norms ``w_gate``, ``w_out``, ``router``, ``wuk`` and ``wuv`` are
exempt (they hold ``"gate"`` or ``"u"``).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import math

import numpy as np
import torch

from repro_torch.core.optim import (adam_leaf, clip_by_global_norm,
                                    global_norm, tree_leaves, tree_map,
                                    tree_unflatten)

__all__ = ["init_opt_state", "lr_schedule", "global_norm",
           "clip_by_global_norm", "adamw_update"]

F32 = torch.float32


def init_opt_state(params, moment_dtype="float32"):
    """Zero moments in ``moment_dtype`` on each leaf's device, and the
    step count as an int32 0-d tensor."""
    mdt = getattr(torch, moment_dtype)
    first = tree_leaves(params)[0]
    return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
            "count": torch.zeros((), dtype=torch.int32, device=first.device)}


_LIBM = None


def _cosf(x: np.float32) -> np.float32:
    """The C library's single-precision ``cosf``: what XLA's CPU backend
    computes for the reference's float32 ``jnp.cos``."""
    global _LIBM
    if _LIBM is None:
        _LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
        _LIBM.cosf.restype = ctypes.c_float
        _LIBM.cosf.argtypes = [ctypes.c_float]
    return np.float32(_LIBM.cosf(float(x)))


def lr_schedule(step, tcfg) -> torch.Tensor:
    """The learning rate at ``step`` (0-indexed: an int or a 0-d tensor)
    as a float32 0-d tensor on the CPU: linear warmup to
    ``learning_rate``, then a cosine to a tenth of it.

    Host float32 arithmetic in the reference's order of operations, with
    the C library's ``cosf``, so the schedule equals the reference's bit
    for bit and is the same whatever device trains."""
    f = np.float32
    step = f(int(step)) + f(1.0)  # step 0 trains at lr/warmup
    warm = min(step / f(max(tcfg.warmup_steps, 1)), f(1.0))
    prog = (step - f(tcfg.warmup_steps)) / f(
        max(tcfg.total_steps - tcfg.warmup_steps, 1))
    prog = min(max(prog, f(0.0)), f(1.0))
    cos = f(0.5) * (f(1.0) + _cosf(f(math.pi) * prog))
    lr = f(tcfg.learning_rate) * warm * (f(0.1) + f(0.9) * cos)
    return torch.tensor(lr, dtype=F32)


_DECAY_EXEMPT = ("norm", "bias", "gate", "mu", "w0", "u", "dt_bias", "gn_",
                 "A_log", "D")


def _decay_mask(path_names) -> bool:
    name = path_names[-1]
    return not any(t in name for t in _DECAY_EXEMPT)


def _paths(tree, prefix=()):
    """Each leaf's path of names (dict keys, sequence indices as str)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [prefix]
    return [p for k, v in items for p in _paths(v, prefix + (str(k),))]


def adamw_update(params, grads, opt_state, tcfg, lr):
    """One AdamW step: ``(new_params, new_opt_state)``; ``lr`` a float32
    0-d tensor (``lr_schedule``)."""
    count = opt_state["count"] + 1
    c = count.to(F32)
    out = [adam_leaf(p, g, m, v, c, lr=lr, b1=tcfg.b1, b2=tcfg.b2,
                     eps=tcfg.eps,
                     weight_decay=tcfg.weight_decay if _decay_mask(path)
                     else 0.0)
           for path, p, g, m, v in zip(
               _paths(params), *(tree_leaves(t) for t in (
                   params, grads, opt_state["m"], opt_state["v"])))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out])
                           for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "count": count}
