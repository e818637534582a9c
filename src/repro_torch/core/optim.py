"""Adam on small trees of tensors (dicts of name -> tensor), the optimizer
of the gradient design (``core/engine.py`` ``design_gradient``).

Functional, like the reference's ``core/optim.py``: every call returns new
tensors, and the update math runs in float32 with the results cast back to
the parameter dtypes.  A tree is a tensor or a dict, list or tuple (a
named tuple too) of trees: the warm-start predictor's params
(``serve/warmstart.py``), or a model's params and the training state
(``train/``).
A tree's leaves may carry a leading batch axis of independent problems (the design's starts); ``global_norm`` and
``clip_by_global_norm`` then reduce over every axis but ``batch_dims``
leading ones, so one start's norm never sees another's gradient.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

F32 = torch.float32


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a tree, in its order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _rebuild(like, items):
    """A list or tuple of ``like``'s type (a named tuple field by field)."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*items)
    return type(like)(items)


def tree_map(fn, tree, *rest):
    """``fn`` on each leaf of ``tree`` and the leaves of the same place in
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(tree)])
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def global_norm(tree: Dict[str, torch.Tensor], batch_dims: int = 0
                ) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, per leading batch index
    (a scalar with ``batch_dims=0``)."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.square(x.to(F32))
        sq = sq.reshape(*sq.shape[:batch_dims], -1).sum(-1)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                        batch_dims: int = 0
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``grads`` scaled so that their global norm is at most ``max_norm``
    (per batch index), and the norm before the scaling."""
    g = global_norm(grads, batch_dims)
    scale = torch.minimum(torch.ones_like(g),
                          max_norm / torch.clamp(g, min=1e-9))

    def scaled(x):
        s = scale.reshape(*scale.shape, *([1] * (x.dim() - scale.dim())))
        return (x.to(F32) * s).to(x.dtype)

    return tree_map(scaled, grads), g


def adam_leaf(p, g, m, v, count_f32, *, lr, b1, b2, eps,
              weight_decay: float = 0.0):
    """One Adam(W) moment update on one leaf: ``(new_param, new_m,
    new_v)``.  ``count_f32`` is the 1-indexed step as a float32 tensor;
    ``weight_decay=0.0`` skips the decoupled decay term."""
    gf = g.to(F32)
    m2 = b1 * m.to(F32) + (1 - b1) * gf
    v2 = b2 * v.to(F32) + (1 - b2) * gf * gf
    mh = m2 / (1.0 - torch.pow(torch.tensor(b1, dtype=F32), count_f32))
    vh = v2 / (1.0 - torch.pow(torch.tensor(b2, dtype=F32), count_f32))
    step = mh / (torch.sqrt(vh) + eps)
    if weight_decay != 0.0:
        step = step + weight_decay * p.to(F32)
    p2 = p.to(F32) - lr * step
    return p2.to(p.dtype), m2.to(m.dtype), v2.to(v.dtype)


def adam_init(params: Dict[str, torch.Tensor]) -> Dict:
    """State for ``adam_update``: float32 moments and a step count."""
    def zeros(p):
        return torch.zeros_like(p, dtype=F32)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": 0}


def adam_update(params: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor], state: Dict, lr, *,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0) -> Tuple[Dict, Dict]:
    """One Adam step on every leaf: ``(new_params, new_state)``."""
    count = state["count"] + 1
    c = torch.tensor(float(count), dtype=F32)
    out = [adam_leaf(p, g, m, v, c.to(p.device), lr=lr, b1=b1, b2=b2,
                     eps=eps, weight_decay=weight_decay)
           for p, g, m, v in zip(*(tree_leaves(t) for t in (
               params, grads, state["m"], state["v"])))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out])
                           for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "count": count}
