"""Train steps (reference: ``repro/train/trainer.py``): the model zoo's
step (autograd + microbatch accumulation + AdamW, with the paper's
in-step ballast hook), its int8 error-feedback data-parallel form, and
the warm-start predictor's regression step.

``train_step(state, batch)`` is functional, as the reference's is: it
returns a new ``TrainState`` and leaves the given one as it was, so a
step can be taken twice from one state.  The batch (numpy arrays or
tensors) is moved to the state's device.  The learning rate is computed
on the host from the step count (``lr_schedule``), so each step reads
the count back once, at its start.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.ballast_inject import attach_ballast
from repro_torch.core.optim import (adam_update, clip_by_global_norm,
                                    global_norm, tree_leaves, tree_map,
                                    tree_unflatten)
from repro_torch.device import resolve_device
from repro_torch.models.model import Ctx, init_params, loss_fn
from repro_torch.train.optimizer import (adamw_update, init_opt_state,
                                         lr_schedule)

F32 = torch.float32


def _plan_not_ported():
    return NotImplementedError(
        "a model sharding plan (the reference's parallel/ Plan) is not "
        "ported yet: ROADMAP queue A, sharding the model across cards")


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor  # int32 0-d, on the params' device


def init_train_state(key, cfg: ModelConfig, tcfg: TrainConfig,
                     device=None) -> TrainState:
    """Random params from ``key`` (an int seed or a ``torch.Generator``),
    zero moments and step 0, on ``device`` (None: the card)."""
    dev = resolve_device(device)
    params = init_params(key, cfg, dev)
    opt = init_opt_state(params, tcfg.moment_dtype)
    return TrainState(params, opt,
                      torch.zeros((), dtype=torch.int32, device=dev))


def _rows(batch, n):
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split into {n}")
    return rows // n


def _split_microbatches(batch, n):
    per = _rows(batch, n)
    return tree_map(lambda x: x.reshape(n, per, *x.shape[1:]), batch)


def _on(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_value_and_grad(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """``grad_fn(params, batch) -> ((loss, metrics), grads)``, the
    reference's ``jax.value_and_grad(loss_for_grad, has_aux=True)``: the
    loss under ``Ctx(remat=tcfg.remat)``, with the ballast attached when
    ``tcfg.ballast`` and ``tcfg.ballast_gflops > 0``.
    ``grads`` has the params' structure and dtypes (zeros where a leaf is
    not used); the loss and metrics are detached 0-d tensors."""
    def grad_fn(params, batch):
        live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        loss, metrics = loss_fn(tree_unflatten(params, live), cfg, batch,
                                Ctx(cfg=cfg, remat=tcfg.remat))
        if tcfg.ballast and tcfg.ballast_gflops > 0:
            loss = attach_ballast(loss, tcfg.ballast_gflops)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, live)]
        return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
                tree_unflatten(params, grads))
    return grad_fn


def _clip_(grads, max_norm):
    """``clip_by_global_norm`` in place: each leaf ``(g.f32 * scale)``
    cast back to its dtype, as the reference's; returns the norm before
    the scaling."""
    g = global_norm(grads)
    scale = torch.minimum(torch.ones_like(g),
                          max_norm / torch.clamp(g, min=1e-9))
    for x in tree_leaves(grads):
        if x.dtype == F32:
            x.mul_(scale)
        else:
            x.copy_(x.to(F32) * scale)
    return g


def _apply(state: TrainState, grads, tcfg: TrainConfig, lr):
    """Clip, AdamW, and the step count plus one (``grads`` is consumed)."""
    gnorm = _clip_(grads, tcfg.grad_clip)
    new_params, new_opt = adamw_update(state.params, grads, state.opt, tcfg,
                                       lr)
    return TrainState(new_params, new_opt, state.step + 1), gnorm


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, plan=None,
                    unroll: bool = False):
    """``train_step(state, batch) -> (state, metrics)``.

    With ``tcfg.microbatches`` n > 1 the batch's rows split into n
    microbatches whose gradients are summed in f32 in microbatch order and
    divided by n, and the metrics are the reference's for that case
    (``ce`` the mean loss, ``moe_aux`` zero); then clipping to
    ``tcfg.grad_clip``, the scheduled learning rate and AdamW.  Metrics
    add ``loss``, ``grad_norm`` (before clipping) and ``lr``.  ``unroll``
    steers only the reference's XLA scan and is accepted for its
    signature."""
    if plan is not None:
        raise _plan_not_ported()
    del unroll
    grad_fn = make_value_and_grad(cfg, tcfg)

    def train_step(state: TrainState, batch):
        dev = state.step.device
        lr = lr_schedule(state.step, tcfg).to(dev)
        batch = _on(batch, dev)
        n = tcfg.microbatches
        if n > 1:
            mbs = _split_microbatches(batch, n)
            tot = torch.zeros((), dtype=F32, device=dev)
            acc = [torch.zeros(p.shape, dtype=F32, device=p.device)
                   for p in tree_leaves(state.params)]
            for i in range(n):
                (l, _), g = grad_fn(state.params,
                                    {k: v[i] for k, v in mbs.items()})
                for a, b in zip(acc, tree_leaves(g)):
                    a.add_(b.to(F32))
                del g
                tot = tot + l
            loss = tot / n
            for a in acc:
                a.div_(n)
            grads = tree_unflatten(state.params, acc)
            metrics = {"ce": loss, "moe_aux": torch.zeros((), dtype=F32,
                                                          device=dev)}
        else:
            (loss, metrics), grads = grad_fn(state.params, batch)
        out, gnorm = _apply(state, grads, tcfg, lr)
        return out, dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)

    return train_step


# ---------------------------------------------------------------------------
# Small-model regression step (the serve path's warm-start predictor)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Compressed-gradient data-parallel step
# ---------------------------------------------------------------------------

def _group_shape(group):
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def make_dp_compressed_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                                  group=None):
    """Data-parallel train step with an int8 error-feedback gradient mean
    over the process group ``group`` (None: the default group; without a
    job, this process alone): ``(train_step, init_err)``.

    ``train_step(state, err, batch) -> (state, err, metrics)``: the params
    are replicated; rank r takes rows ``[r B/P, (r+1) B/P)`` of the global
    batch (the reference's ``P(axis)``), takes its gradients, and each
    leaf's mean over the ranks comes from
    ``parallel.collectives.compressed_allreduce_mean`` with the leaf's
    residual in ``err`` (float32); then clipping, AdamW and the loss
    averaged over the ranks.  As in the reference, this step attaches no
    ballast and takes no microbatches.  ``init_err(params)`` is the zero
    residual."""
    from repro_torch.parallel.collectives import compressed_allreduce_mean
    grad_fn = make_value_and_grad(cfg, dataclasses.replace(tcfg,
                                                           ballast=False))

    def init_err(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                              device=p.device), params)

    def train_step(state: TrainState, err, batch):
        dev = state.step.device
        lr = lr_schedule(state.step, tcfg).to(dev)
        rank, size = _group_shape(group)
        batch = _on(batch, dev)
        per = _rows(batch, size)
        lo = rank * per
        (loss, _), grads = grad_fn(state.params,
                                   {k: v[lo:lo + per]
                                    for k, v in batch.items()})
        reduced, new_err = [], []
        for g, e in zip(tree_leaves(grads), tree_leaves(err)):
            r, ne = compressed_allreduce_mean(g, e, group)
            reduced.append(r)
            new_err.append(ne.to(F32))
        del grads
        out, gnorm = _apply(state, tree_unflatten(state.params, reduced),
                            tcfg, lr)
        if size > 1:
            loss = loss.clone()
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
            loss = loss / size
        return (out, tree_unflatten(state.params, new_err),
                {"loss": loss, "grad_norm": gnorm, "lr": lr})

    return train_step, init_err


# ---------------------------------------------------------------------------
# sharding trees
# ---------------------------------------------------------------------------

def in_out_shardings(cfg: ModelConfig, plan, state_shape, batch_shape):
    """The reference's pjit sharding trees from a model ``Plan``: not
    ported with the plan."""
    raise _plan_not_ported()
