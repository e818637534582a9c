"""The geometry of kernels E and I (``sliding.sliding_route``,
``segment_groups``, ``store_slices``) at every shape ``chip_smoke.py``
gives them, and their plain versions against the JAX reference at a
geometry no other test reaches (K 9, win not a multiple of 4).

At each shape: the resident or general choice and the cluster size, the
shared memory within a block's 227 KB, the cluster's store slices
partitioning [0, win) exactly (each starting at a multiple of 4
positions, which in one round are the samples), every store unit a run
of consecutive samples, and the segment groups covering each (row,
segment) exactly once for any number of resident clusters.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.goertzel import ops as jops  # noqa: E402
from repro.kernels.goertzel.goertzel import (  # noqa: E402
    sliding_goertzel_pallas)
from repro_torch.kernels.goertzel import ops as tops  # noqa: E402
from repro_torch.kernels.goertzel import sliding as tsl  # noqa: E402
from repro_torch.kernels.goertzel import sliding_v1 as tv1  # noqa: E402

BLOCK_SMEM = 232_448   # 227 KB: what a block may opt into on an H100

# [B, S, win, K] -> (resident, cluster): the loop's and the replay's
# counterfactual calls, A's Study shape (the witness), A's four variants
# (4-byte copies, rounds, several bins a block) and kernel I's call
SHAPES = {
    "loop": ((1, 12, 2000, 7), (True, 7)),
    "replay": ((1, 150, 4000, 7), (True, 7)),
    "study": ((240, 12, 8000, 4), (True, 4)),
    "variant_1001": ((2, 3, 1001, 3), (True, 3)),
    "variant_12000": ((1, 3, 12000, 4), (False, 4)),
    "variant_600": ((2, 2, 600, 11), (False, 8)),
    "variant_20000": ((1, 3, 20000, 10), (False, 8)),
    "v1": ((1, 150, 4000, 7), (True, 7)),
}


@pytest.mark.parametrize("tag", list(SHAPES))
def test_route_choice_and_shared_memory(tag):
    (B, S, win, K), (resident, cluster) = SHAPES[tag]
    r = tsl.sliding_route(win, K)
    assert (r.resident, r.cluster) == (resident, cluster)
    assert r.nbins == -(-K // cluster) and r.chunk == -(-win // 256)
    assert r.smem_bytes + tsl.STATIC_ROOM <= BLOCK_SMEM
    assert r.Q % 8 == 4 and r.Q >= r.J and r.J % 4 == 0
    assert r.rounds == -(-r.chunk // r.J)
    if resident:
        assert r.rounds == 1 and r.J == (r.chunk + 3) & ~3
    else:
        # the widest rounds that fit: four more columns would not
        wider = tsl.walk_bytes(False, r.J + 4, r.nbins, K)
        assert r.J >= r.chunk or wider + tsl.STATIC_ROOM > BLOCK_SMEM


@pytest.mark.parametrize("tag", list(SHAPES))
def test_store_slices_partition_the_window(tag):
    (_, _, win, K), _ = SHAPES[tag]
    r = tsl.sliding_route(win, K)
    rounds = tsl.store_slices(win, r)
    assert len(rounds) == r.rounds
    stored = []
    for rnd in rounds:
        assert len(rnd) == r.cluster
        for e_lo, samples in rnd:
            assert e_lo % 4 == 0
            if r.rounds == 1 and samples:
                assert samples[0] == e_lo
            stored += samples
    assert sorted(stored) == list(range(win))


@pytest.mark.parametrize("tag", list(SHAPES))
def test_store_units_are_runs_of_consecutive_samples(tag):
    """The kernel's units (up to 32 positions of one run of consecutive
    samples, ``store_round``) store contiguous [sample, bin] runs."""
    (_, _, win, K), _ = SHAPES[tag]
    r = tsl.sliding_route(win, K)
    for rnd_i, rnd in enumerate(tsl.store_slices(win, r)):
        c0 = rnd_i * r.J
        jr = min(r.J, r.chunk - c0)
        E = win if jr == r.chunk else 256 * jr
        span = E if jr == r.chunk else jr
        E4 = -(-E // 4)
        for c in range(r.cluster):
            e_lo, e_hi = 4 * (E4 * c // r.cluster), min(
                E, 4 * (E4 * (c + 1) // r.cluster))
            units = []
            p = e_lo // span
            while p * span < e_hi:
                a, z = max(e_lo, p * span), min(e_hi, (p + 1) * span)
                units += [range(e0, min(e0 + 32, z))
                          for e0 in range(a, z, 32)]
                p += 1
            got = []
            for u in units:
                gi = [(e // jr) * r.chunk + c0 + e % jr for e in u]
                gi = [g for g in gi if g < win]
                if gi:
                    assert gi == list(range(gi[0], gi[0] + len(gi)))
                got += gi
            assert got == rnd[c][1]


@pytest.mark.parametrize("tag", list(SHAPES))
@pytest.mark.parametrize("active", [1, 7, 16, 33, 132])
def test_segment_groups_cover_each_row_segment_once(tag, active):
    (B, S, _, _), _ = SHAPES[tag]
    group, groups = tsl.segment_groups(B, S, active)
    assert 1 <= group <= S and groups == -(-S // group)
    seen = [(b, s) for b in range(B) for g in range(groups)
            for s in range(g * group, min(S, (g + 1) * group))]
    assert sorted(seen) == [(b, s) for b in range(B) for s in range(S)]


def test_segment_groups_take_the_fewest_waves():
    # one row of 150 segments on 16 resident clusters: 15 groups of 10,
    # one wave of 11 segment passes (10 and the predecessor's table)
    assert tsl.segment_groups(1, 150, 16) == (10, 15)
    # one segment: no predecessor to build
    assert tsl.segment_groups(4, 1, 2) == (1, 1)


def test_route_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        tsl.sliding_route(4000, 400)
    with pytest.raises(ValueError):
        tsl.sliding_route(0, 7)


# ---------------------------------------------------------------------------
# the plain versions against the reference at K 9, win 301
# ---------------------------------------------------------------------------

FREQS9 = (0.15, 0.3, 0.55, 0.8, 1.0, 1.4, 2.0, 2.9, 4.1)
DT = 0.01
WIN = 301


def _ac(n, seed):
    """A zero-mean trace: a 1 Hz burst over a 2.9 Hz tone and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) * DT
    x = (2e4 * np.sin(2 * np.pi * 1.0 * t) * (t > 4.0)
         + 5e3 * np.sin(2 * np.pi * 2.9 * t + 0.3)
         + 1e3 * rng.standard_normal(n))
    return (x - x.mean()).astype(np.float32)


def test_kernel_e_plain_matches_reference_at_k9_odd_window():
    x = _ac(4 * WIN + 77, seed=9)
    xc = tops.centre(torch.as_tensor(x)[None])[0].numpy()
    got = tops.sliding_bin_power(torch.as_tensor(x), DT, FREQS9, win=WIN)
    ref = np.asarray(jops.sliding_bin_power(jnp.asarray(xc), DT, FREQS9,
                                            win=WIN, interpret=True))
    assert got.shape == ref.shape == (len(x), len(FREQS9))
    assert np.abs(got.numpy() - ref).max() <= 1e-4 * float(np.abs(xc).max())


def test_kernel_i_plain_matches_reference_at_k9_odd_window():
    x = _ac(3 * WIN + 5, seed=10)
    xseg = tops.segments(tops.centre(torch.as_tensor(x)[None]), WIN)[0]
    cosp, sinp, rot = (torch.from_numpy(t)
                       for t in tops.phase_tables_v1(FREQS9, DT, WIN))
    got = tv1.sliding_goertzel_v1(xseg, cosp, sinp, rot)
    want = np.asarray(sliding_goertzel_pallas(
        jnp.asarray(xseg.numpy()), *(jnp.asarray(t.numpy())
                                     for t in (cosp, sinp, rot)),
        interpret=True))
    assert tuple(got.shape) == want.shape == (4, WIN, len(FREQS9))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * float(
        xseg.abs().max())
