"""The regression train step of the warm-start predictor (reference:
``repro/train/trainer.py``, ``make_regression_train_step``).

The step is the reference's: the batch MSE, its gradient by autograd,
``clip_by_global_norm`` and ``adam_update`` of ``core/optim.py`` (the
reference's Adam core, float32 moments), all on one device.  The model
zoo's training step is not ported yet.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.optim import (adam_update, clip_by_global_norm,
                                    tree_leaves, tree_map)
from repro_torch.device import resolve_device


def make_regression_train_step(forward: Callable, *, lr: float = 1e-3,
                               grad_clip: float = 10.0,
                               weight_decay: float = 0.0, device=None):
    """``train_step(params, opt_state, x, y) -> (params, opt_state,
    metrics)``: one Adam step on the batch MSE of ``forward(params, x)``
    (``[B, F] -> [B, T]``) against ``y``, with the gradient clipped to
    global norm ``grad_clip``; ``metrics`` holds the ``loss`` before the
    step and the ``grad_norm`` before clipping, as 0-d tensors.  ``params``
    is a dict of tensors (dicts may nest) on ``device`` (None: the card),
    ``opt_state`` comes from ``core.optim.adam_init``; ``x`` and ``y`` are
    moved to ``device`` as float32."""
    dev = resolve_device(device)

    def train_step(params, opt_state, x, y):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        y = torch.as_tensor(y, dtype=torch.float32, device=dev)
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        pred = forward(live, x)
        loss = torch.mean(torch.square(pred - y))
        grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(
                tree_map(lambda _: next(grads), live), grad_clip)
            params, opt_state = adam_update(params, grads, opt_state, lr,
                                            weight_decay=weight_decay)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step
