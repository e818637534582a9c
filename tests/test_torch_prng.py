"""The port's threefry stream (``repro_torch.core.prng``) against
``jax.random``: key words of ``PRNGKey`` and ``fold_in`` chains equal
``jax.random.key_data``, ``random_bits`` equals ``jax.random.bits`` bit
for bit, and ``normal`` is within 4 float32 ulps of ``jax.random.normal``
with at least 95% of draws equal.  The batched ``[B, 2]`` form equals the
row-by-row form.

Run as a script, it prints the normals' largest ulp gap and equal share.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_prng.py
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import key_from_reference  # noqa: E402
from repro_torch.core import prng  # noqa: E402

SEEDS = (0, 7, 2 ** 31 - 1, -1, 2 ** 40 + 3)
ULPS = 4
EQUAL_FRAC = 0.95


def _words(key):
    return np.asarray(jax.random.key_data(key))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_jax_threefry_is_partitionable():
    """The port follows the partitionable layout, jax's default;
    a change of that default fails here by name."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_words(seed):
    assert np.array_equal(prng.prng_key(seed).numpy(),
                          _words(jax.random.PRNGKey(seed)))


def test_prng_key_rejects_what_jax_rejects():
    with pytest.raises(OverflowError):
        prng.prng_key(2 ** 64)
    with pytest.raises(OverflowError):
        jax.random.PRNGKey(2 ** 64)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_fold_in_chains(depth):
    data = (3, 0, 2 ** 32 - 1)[:depth]
    for seed in SEEDS:
        jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
        for d in data:
            jk, tk = jax.random.fold_in(jk, d), prng.fold_in(tk, d)
        assert np.array_equal(tk.numpy(), _words(jk)), (seed, data)


@pytest.mark.parametrize("n", [1, 7, 4096, 90_001])
def test_random_bits_equal_jax(n):
    for seed in SEEDS[:3]:
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
        got = prng.random_bits(key_from_reference(_words(jk)), n)
        want = np.asarray(jax.random.bits(jk, (n,)))
        assert got.shape == (n,)
        assert np.array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("n", [1, 7, 4096, 90_001])
def test_normal_within_ulps_of_jax(n):
    for seed in SEEDS[:3]:
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
        got = prng.normal(key_from_reference(_words(jk)), n).numpy()
        want = np.asarray(jax.random.normal(jk, (n,)))
        assert got.dtype == np.float32
        u = _ulps(got, want)
        assert u.max() <= ULPS, (seed, n, u.max())
        assert (u == 0).mean() >= EQUAL_FRAC, (seed, n, (u == 0).mean())


def test_erfinv32_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999], dtype=torch.float32)
    got = prng.erfinv32(x)
    assert got[0] == -float("inf") and got[1] == float("inf")
    assert got[2] == 0.0
    want = np.asarray(jax.lax.erf_inv(x.numpy()))
    assert _ulps(got[2:].numpy(), want[2:]).max() <= ULPS


def test_batched_keys_equal_row_by_row():
    keys = prng.fold_in(prng.prng_key(0), torch.arange(6))
    assert keys.shape == (6, 2)
    for r in range(6):
        assert torch.equal(keys[r], prng.fold_in(prng.prng_key(0), r))
    assert torch.equal(prng.fold_in(keys, 1),
                       torch.stack([prng.fold_in(k, 1) for k in keys]))
    bits = prng.random_bits(keys, 333)
    z = prng.normal(keys, 333)
    assert bits.shape == z.shape == (6, 333)
    for r in range(6):
        assert torch.equal(bits[r], prng.random_bits(keys[r], 333))
        assert torch.equal(z[r], prng.normal(keys[r], 333))


def test_as_key_forms():
    words = _words(jax.random.fold_in(jax.random.PRNGKey(3), 9))
    k = prng.as_key(words)
    assert k.dtype == torch.int64 and np.array_equal(k.numpy(), words)
    assert torch.equal(prng.as_key(k), k)
    assert torch.equal(prng.as_key(3), prng.prng_key(3))
    with pytest.raises(ValueError):
        prng.as_key(torch.tensor([1, 2, 3]))
    with pytest.raises(ValueError):
        prng.fold_in(k, -1)


if __name__ == "__main__":
    # the readings behind ROADMAP queue C: the normals' largest ulp gap to
    # jax.random.normal and the share of draws that are equal
    for n in (4096, 90_001):
        for seed in SEEDS:
            jk = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
            u = _ulps(prng.normal(key_from_reference(_words(jk)), n).numpy(),
                      np.asarray(jax.random.normal(jk, (n,))))
            print(f"n {n:6d} seed {seed:14d}: max {u.max()} ulps, "
                  f"{100 * (u == 0).mean():.2f}% equal")
