"""Dense feed-forward variants: SwiGLU, squared-ReLU (Nemotron), GELU
(reference: ``repro/models/mlp.py``).  Weights are cast to x's dtype at
use, as there."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def init_mlp(gen, d_model: int, d_ff: int, kind: str, dtype):
    p = {"w_in": dense_init(gen, d_model, d_ff, dtype),
         "w_out": dense_init(gen, d_ff, d_model, dtype)}
    if kind == "swiglu":
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def mlp_forward(p, x, kind: str, ctx=None):
    h = x @ p["w_in"].to(x.dtype)
    if kind == "swiglu":
        g = x @ p["w_gate"].to(x.dtype)
        h = F.silu(g) * h
    elif kind == "sq_relu":
        h = torch.square(F.relu(h))
    elif kind == "gelu":
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    else:
        raise ValueError(kind)
    return h @ p["w_out"].to(x.dtype)
