"""Temperature-parameterized smooth relaxations of discrete mitigation
semantics, for gradient-based design (``core/engine.py``
``design_gradient``).

Every mitigation carries a static ``smooth_tau`` field:

  tau == 0   the exact hard semantics, the only path the Study, the
             control loop and every other forward caller runs;
  tau  > 0   the design-time relaxation: hard gates become sigmoids and
             hard switches tanh blends at temperature ``tau``, so autograd
             sees a useful loss landscape instead of the zero-measure
             subgradients of step functions.

``tau`` is dimensionless; each call site scales it by the natural scale of
its comparison (TDP for power gates, a counter horizon for timers).

Where the forward is physically discrete (the Firefly ballast quantizer,
the backstop's escalation), the forward stays hard and only the backward
is relaxed: the straight-through ``ste_ceil``, or the identity
``hard + (soft - soft.detach()) * surrogate``.
"""
from __future__ import annotations

import torch


def sigmoid_gate(x: torch.Tensor, tau: float, scale) -> torch.Tensor:
    """Smooth 0/1 gate ``sigmoid(x / (tau * scale))``: ``(x > 0)`` as
    ``tau -> 0``.  ``scale`` is the natural magnitude of ``x``."""
    return torch.sigmoid(x / (tau * scale))


def soft_sign(x: torch.Tensor, tau: float, scale) -> torch.Tensor:
    """Smooth sign: ``tanh(x / (tau * scale))``."""
    return torch.tanh(x / (tau * scale))


def smooth_max(a: torch.Tensor, b: torch.Tensor, tau: float,
               scale) -> torch.Tensor:
    """Smooth elementwise maximum, ``t * logaddexp(a / t, b / t)`` at
    ``t = tau * scale``; above the hard max by at most ``t * log 2``."""
    t = tau * scale
    return t * torch.logaddexp(a / t, b / t)


class _SteCeil(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.ceil(x - 1e-9)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_ceil(x: torch.Tensor) -> torch.Tensor:
    """``ceil(x - 1e-9)`` forward, identity backward (a straight-through
    quantizer: the Firefly ballast's intensity steps are physically
    discrete, so the relaxation lives only in the backward)."""
    return _SteCeil.apply(x)


def per_sample(params: torch.Tensor, n: int):
    """``n`` per-sample copies of ``params`` ``[B, C]``, equal to it, for a
    step loop over ``n`` samples (the port's own; the reference's scans sum
    in float32).  Autograd sums their gradients over the samples in
    float64, as kernels J and K do, and not in the float32 running sum that
    one tensor used by every sample gets: over 90 000 samples that sum
    drifts by up to 1e-4 of a column."""
    return params.to(torch.float64)[..., None].expand(
        *params.shape, n).to(params.dtype).unbind(-1)


# kernels J and K (scans/csrc/chain_walk.cuh): a row in chunks of
# CHAIN_CHUNK samples, a warp a chunk; each (row, chunk) keeps
# CHAIN_SLOT 8-byte scratch words (five mailboxes of two words and eleven
# float64 partial sums), after one word for the blocks' ticket
CHAIN_CHUNK = 1024
CHAIN_SLOT = 21


def chain_chunks(n: int) -> int:
    """Chunks of a row of ``n`` samples in kernels J and K."""
    return -(-int(n) // CHAIN_CHUNK)


def chain_scratch(rows: int, n: int, device) -> torch.Tensor:
    """The scratch words (int64, uninitialized: each entry zeroes them
    before its launch) of one call of kernel J's or K's forward or
    adjoint on ``rows`` rows of ``n`` samples."""
    return torch.empty(1 + rows * chain_chunks(n) * CHAIN_SLOT,
                       dtype=torch.int64, device=device)
