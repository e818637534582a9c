"""The port's counterpart of ``jax.random``'s default generator: threefry-2x32
keys, ``fold_in``, 32-bit random bits and standard normals, in plain torch
on the key tensor's device, equal to JAX's draws.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words (the words
``jax.random.key_data`` gives for a JAX key); a batch of keys is
``[B, 2]`` and every function works row-wise on it.  The words live in
int64 so that sums and left shifts of values below 2^32 stay exact; each
add and rotate is masked back to 32 bits.

``random_bits`` follows JAX's partitionable layout
(``jax_threefry_partitionable=True``, jax's default; the tests assert
it): sample ``i`` is the xor of the two output words of ``threefry(key,
i >> 32, i & 0xFFFFFFFF)``.  ``normal`` follows ``jax.random.normal`` in
float32: a uniform on ``[nextafter(-1, +inf), 1)`` from the top 23 bits,
then ``sqrt(2) * erfinv`` with XLA's single-precision erfinv polynomial
(not ``torch.erfinv``, which rounds differently), so a draw is within a
few float32 ulps of JAX's and most are equal (``erfinv32``).
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# XLA's ErfInv32 coefficients (Giles, single precision), Horner order
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 2.1858087e-04, -1.25372503e-03,
               -4.17768164e-03, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-2.00214257e-04, 1.00950558e-04, 1.34934322e-03,
               -3.67342844e-03, 5.73950773e-03, -7.6224613e-03,
               9.43887047e-03, 1.00167406, 2.83297682)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under the
    key words ``(k0, k1)``; all int64 holding uint32 values, broadcast
    together.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s words ``[0, seed mod 2^32]`` as an
    int64 ``[2]`` tensor, for any seed JAX takes (a 64-bit signed int)."""
    seed = int(seed)
    if not -2 ** 63 <= seed < 2 ** 63:
        raise OverflowError(f"seed {seed} does not fit a 64-bit integer")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def as_key(key, device=None) -> torch.Tensor:
    """A key tensor from an int seed, a key tensor or the two uint32 words
    of a key (a numpy array or sequence ``[..., 2]``)."""
    if isinstance(key, (int, np.integer)):
        return prng_key(int(key), device)
    if isinstance(key, torch.Tensor):
        t = key.to(torch.int64)
    else:
        t = torch.as_tensor(np.asarray(key, dtype=np.uint32).astype(np.int64))
    if t.shape[-1:] != (2,) or bool(((t < 0) | (t > MASK)).any()):
        raise ValueError("a key is two uint32 words [..., 2]")
    return t if device is None else t.to(device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key ``threefry(key, 0, data)``, row-wise
    on keys ``[..., 2]``; ``data`` is an int in ``[0, 2^32)`` or an int
    tensor broadcasting against the keys' leading shape."""
    if isinstance(data, int):
        if not 0 <= data <= MASK:
            raise ValueError(f"fold_in data {data} is not a uint32")
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data & MASK)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` (uint32, partitionable layout) as
    int64 ``[..., n]`` for keys ``[..., 2]``."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    k0, k1 = key[..., 0, None], key[..., 1, None]
    y0, y1 = threefry2x32(k0, k1, i >> 32, i & MASK)
    return y0 ^ y1


def erfinv32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erfinv polynomial.  XLA contracts each Horner step
    into a fused multiply-add; here each step is taken in float64 (the
    product of two float32 values is exact there) and rounded once.
    ``log1p`` is taken in float64 and rounded once, so the card and the
    CPU give the same value."""
    w = (-torch.log1p(-(x * x).to(torch.float64))).to(torch.float32)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).to(torch.float64)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(torch.float64)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, a, b).to(torch.float64)
        p = (c + p * w).to(torch.float32).to(torch.float64)
    return torch.where(x.abs() == 1.0, x * float("inf"),
                       p.to(torch.float32) * x)


def uniform_pm1(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform`` on ``[nextafter(-1, +inf), 1)`` in float32 from
    32-bit words (int64 holding uint32)."""
    one = (bits >> 9) | 0x3F800000
    f = one.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(np.nextafter(np.float32(-1), np.float32(0)),
                      device=bits.device)
    scale = torch.tensor(1.0, device=bits.device) - lo
    return torch.maximum(lo, f * scale + lo)


def normal(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.normal(key, (n,), float32)`` as ``[..., n]`` for keys
    ``[..., 2]``."""
    u = uniform_pm1(random_bits(key, n))
    return np.float32(np.sqrt(2)).item() * erfinv32(u)
