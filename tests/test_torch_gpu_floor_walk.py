"""Kernel B's design (``kernels/scans/csrc/gpu_floor.cu``) emulated in
numpy float32 and held to its plain version, ``gpu_floor_scan_plain``,
bit for bit (``torch.equal``).

The kernel takes the idle counter and the target off the serial chain
and walks the chain of outputs o in segments:

(a) the f32 counter ``idle + 1`` counts exact integers and sticks at 2^24,
    so it equals ``min(i - last_active(i), 2^24)`` (``last_active`` -1
    before the first active sample), the closed form the kernel takes
    (and, stepped, a saturating int32 counter), also across the 2^24
    edge;
(b) the targets, every sample at once from (a), equal the plain loop's;
(c) the segmented walk: tiles of 32 lanes x 64 samples, each lane walking
    its segment from its own first target, then rounds in which a lane
    whose start changed walks again from its predecessor's end until the
    last output of a tested group of 4 (every fourth, and its last) equals
    the one it holds bit for bit.  It
    equals the plain version on the GPU-floor rows ``test_torch_scans.py``
    builds, on seeded random rows, on rows of every length around the
    tile's edges, and on a row where no segment merges (which takes a
    round for every lane of a tile: the worst case).

The emulation follows the kernel's order of operations; it runs on the
CPU, the kernel only on the card (``chip_smoke.py`` holds the two there).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import waveform as jwf  # noqa: E402
from repro.core.phases import synthetic_timeline  # noqa: E402
from repro.core.smoothing import GpuPowerSmoothing  # noqa: E402
from repro_torch.convert import from_reference_fields  # noqa: E402
from repro_torch.core.smoothing import gpu_floor  # noqa: E402
from repro_torch.core.smoothing.base import apply_mitigation  # noqa: E402

SEG, LANES = 64, 32        # gpu_floor.cu kSeg, kLanes
TILE = SEG * LANES
STUCK = 2 ** 24            # gpu_floor.cu kIdleStuck
F32 = np.float32


def _step(o, t, ru, rd):
    return np.minimum(np.maximum(t, o - rd), o + ru)


def _target(v, idle, mpf, stop_n, cap):
    floor = np.where(idle.astype(F32) <= stop_n, mpf, F32(0.0))
    return np.minimum(np.maximum(v, floor), cap)


MEET_GROUPS = 4            # gpu_floor.cu kMeetGroups


def _meet_walk(t, held, start, walking, ru, rd, groups):
    """One round's walks, all lanes at once: from ``start``, lanes in
    ``walking``, over their groups of 4, writing into ``held``.  The
    kernel tests every ``MEET_GROUPS``-th group (and a lane's last): a
    lane stops after a tested group whose last output equals the one held
    there bit for bit.  Returns (met, last output, steps taken)."""
    o = start.copy()
    going = walking.copy()
    met = np.zeros_like(walking)
    steps = 0
    for g in range(SEG // 4):
        going &= g < groups
        if not going.any():
            break
        steps += 4
        v = np.empty((LANES, 4), F32)
        cur = o
        for j in range(4):
            cur = _step(cur, t[:, 4 * g + j], ru, rd)
            v[:, j] = cur
        last_held = held[:, 4 * g + 3].copy()
        held[going, 4 * g:4 * g + 4] = v[going]
        o = np.where(going, cur, o)
        tested = (g % MEET_GROUPS == MEET_GROUPS - 1) | (g == groups - 1)
        now = going & tested & (v[:, 3].view(np.uint32)
                                == last_held.view(np.uint32))
        met |= now
        going &= ~now
    return met, o, steps


def kernel_walk(x, params, stats=None):
    """Kernel B's steps on one row ``x`` (f32) with ``params`` in
    ``PARAM_COLUMNS`` order; ``stats`` (a list) gets each tile's rounds
    and dependent steps (speculative walk plus each round's longest)."""
    mpf, thresh, ru, rd, stop_n, cap = (F32(v) for v in params)
    x = np.asarray(x, F32)
    n = len(x)
    out = np.empty(n, F32)
    carry_o, carry_last = x[0], -1
    lanes = np.arange(LANES)
    for base in range(0, n, TILE):
        length = min(TILE, n - base)
        seg_len = np.clip(length - lanes * SEG, 0, SEG)
        groups = (seg_len + 3) // 4
        xs = np.zeros((LANES, SEG), F32)   # the zeros past the row
        flat = xs.reshape(-1)
        flat[:length] = x[base:base + length]
        live = np.arange(SEG)[None, :] < 4 * groups[:, None]
        # the last active sample before each segment: a max-scan
        pos = lanes[:, None] * SEG + np.arange(SEG)[None, :]
        last = np.where((xs > thresh) & live, pos, -1).max(axis=1)
        incl = np.maximum.accumulate(last)
        excl = np.concatenate([[-1], incl[:-1]])
        before = np.where(excl >= 0, base + excl, carry_last)
        if incl[-1] >= 0:
            carry_last = base + int(incl[-1])
        # targets from the counter's closed form, min(p - last, 2^24),
        # last the latest active position in the tile's coordinates, then
        # the speculative walk
        last = np.maximum(before - base, -STUCK - 1)
        t = np.empty_like(xs)
        for m in range(SEG):
            p = lanes * SEG + m
            last = np.where(xs[:, m] > thresh, p, last)
            t[:, m] = _target(xs[:, m], np.minimum(p - last, STUCK), mpf,
                              stop_n, cap)
        held = np.empty_like(xs)
        o = t[:, 0].copy()
        for m in range(SEG):
            o = _step(o, t[:, m], ru, rd)
            held[:, m] = o
        end = np.where(groups > 0, held[lanes, np.maximum(4 * groups - 1, 0)],
                       F32(0.0))
        # rounds
        redo = seg_len > 0
        rounds, steps = 0, SEG
        while True:
            start = np.concatenate([[carry_o], end[:-1]]).astype(F32)
            met, last_o, walked = _meet_walk(t, held, start, redo, ru, rd,
                                             groups)
            rounds += 1
            steps += walked
            changed = redo & ~met
            end = np.where(changed, last_o, end)
            if not changed[:-1].any():
                break
            redo = np.concatenate([[False], changed[:-1]]) & (seg_len > 0)
        carry_o = end[-1]
        out[base:base + length] = held.reshape(-1)[:length]
        if stats is not None:
            stats.append({"rounds": rounds, "steps": steps})
    return out


def _plain(rows, params):
    return gpu_floor.gpu_floor_scan_plain(
        torch.as_tensor(np.asarray(rows, F32)),
        torch.as_tensor(np.asarray(params, F32)))


def _emulated(rows, params, stats=None):
    return torch.as_tensor(np.stack([kernel_walk(r, p, stats)
                                     for r, p in zip(rows, params)]))


# ---------------------------------------------------------------------------
# (a) the counter, (b) the targets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start", [0, 1000, STUCK - 40, STUCK - 1, STUCK])
def test_saturating_counter_equals_the_f32_recurrence(start):
    """From idle = ``start`` (exact in f32), 70 samples, two of them active:
    the f32 ``idle + 1`` recurrence and the kernel's saturating int32
    counter agree at every sample, across 2^24 where it is reached."""
    active = np.zeros(70, bool)
    active[[50, 51]] = True
    f, i = F32(start), start
    seen = []
    for a in active:
        f = F32(0.0) if a else f + F32(1.0)
        i = 0 if a else min(i + 1, STUCK)
        seen.append((float(f), i))
    assert all(a == b for a, b in seen)
    if start >= STUCK - 40:
        assert seen[49][0] == STUCK          # stuck before the activity
    assert F32(STUCK) + F32(1.0) == F32(STUCK)


def test_closed_form_counter_across_the_edge():
    """A row active only at sample 0: the f32 recurrence, started at its
    exact value 2^24 - 3 at sample 2^24 - 3, against min(i - 0, 2^24) up
    to sample 2^24 + 50."""
    f = F32(STUCK - 3)
    for i in range(STUCK - 2, STUCK + 51):
        f = f + F32(1.0)
        assert float(f) == min(i - 0, STUCK)


def test_parallel_targets_equal_the_plain_loop():
    rng = np.random.default_rng(3)
    n = 5000
    x = rng.choice(F32([0.0, 100.0, 349.0, 350.0, 351.0, 800.0]), n)
    for params in ([700, 350, 5, 3, 40.5, 950], [700, 350, 5, 3, 0, 650],
                   [700, -1, 5, 3, 7.25, 950]):
        mpf, thresh, _, _, stop_n, cap = (F32(v) for v in params)
        idle, want = F32(0.0), []
        for v in x:
            idle = F32(0.0) if v > thresh else idle + F32(1.0)
            floor = mpf if idle <= stop_n else F32(0.0)
            want.append(min(max(v, floor), cap))
        idx = np.arange(n)
        last = np.maximum.accumulate(np.where(x > thresh, idx, -1))
        got = _target(x, np.minimum(idx - last, STUCK), mpf, stop_n, cap)
        assert np.array_equal(got.view(np.uint32),
                              np.asarray(want, F32).view(np.uint32))


# ---------------------------------------------------------------------------
# (c) the segmented walk
# ---------------------------------------------------------------------------

def _floor_rows():
    """The GPU-floor rows of ``test_torch_scans.py``'s ``_floor_pair``, and
    the parameter rows the port hands its kernel for them."""
    dt = 0.005
    cfg = jwf.WaveformConfig(dt=dt, steps=8, jitter_s=0.02)
    tl = synthetic_timeline(1.0, 0.25, moe_notch=True)
    chip = np.asarray(jwf.chip_waveform_jax(jwf.phase_levels(tl, cfg), dt))
    mits = [GpuPowerSmoothing(mpf_frac=m, ramp_up_w_per_s=ru,
                              ramp_down_w_per_s=rd, stop_delay_s=sd,
                              edp_cap_frac=cap)
            for m, ru, rd, sd, cap in [(0.5, 2000, 1500, 0.2, 1.0),
                                       (0.7, 1000, 1000, 2.0, 1.1),
                                       (0.9, 3000, 500, 0.05, 0.95)]]
    port = [from_reference_fields(type(m).__name__, dataclasses.asdict(m))
            for m in mits]
    seen = []
    real = gpu_floor.gpu_floor_scan

    def spy(w, params):
        seen.append((w.clone(), params.clone()))
        return real(w, params)
    gpu_floor.gpu_floor_scan = spy
    try:
        apply_mitigation(port, torch.as_tensor(np.stack([chip] * 3)), dt)
    finally:
        gpu_floor.gpu_floor_scan = real
    (w, params), = seen
    assert jnp.asarray(chip).shape[0] == w.shape[1]
    return w.numpy(), params.numpy()


def test_walk_equals_plain_on_the_scans_tests_rows():
    rows, params = _floor_rows()
    stats = []
    got = _emulated(rows, params, stats)
    assert torch.equal(got, _plain(rows, params))
    assert max(s["rounds"] for s in stats) < LANES


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walk_equals_plain_on_seeded_rows(seed):
    rng = np.random.default_rng(seed)
    n = 5000 + 37 * seed
    rows = [rng.uniform(0.0, 1000.0, n),
            np.repeat(rng.uniform(0.0, 1000.0, n // 50 + 1), 50)[:n],
            np.where(rng.random(n) < 0.1, 0.0, 900.0)]
    params = [[700, 350, 5, 3, 40.5, 950], [600, 300, 20, 2, 100, 1000],
              [500, 450, 40, 40, 3.5, 880]]
    stats = []
    got = _emulated(rows, params, stats)
    assert torch.equal(got, _plain(rows, params))
    assert len(stats) == 3 * -(-n // TILE)


@pytest.mark.parametrize("n", [1, 3, 4, 63, 64, 65, 2047, 2048, 2049, 4099])
def test_walk_equals_plain_at_every_tile_edge(n):
    rng = np.random.default_rng(n)
    rows = [rng.uniform(0.0, 1000.0, n), rng.uniform(-50.0, 50.0, n)]
    params = [[700, 350, 5, 3, 40.5, 950], [10, -1, 0.5, 0.25, 2.5, 20]]
    assert torch.equal(_emulated(rows, params), _plain(rows, params))


def _no_merge_row(n, seed=0):
    """A square wave between 200 and 1400 W against ramps of 3 mW a step:
    no walk reaches its target, so no two walks meet."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    x = np.where((i // 997) % 2 == 0, 1400.0, 200.0) + rng.uniform(-5, 5, n)
    return x, [700.0, 350.0, 0.003, 0.003, 20.5, 1500.0]


def test_walk_equals_plain_where_no_segment_merges():
    """The worst case: a full tile takes a round for each of its lanes,
    and its dependent steps are the tile's serial walk plus one segment."""
    x, p = _no_merge_row(3 * TILE + 5)
    stats = []
    assert torch.equal(_emulated([x], [p], stats), _plain([x], [p]))
    # in the first tile lane 0's own first target is its true start
    assert stats[0]["rounds"] == LANES - 1
    assert all(s["rounds"] == LANES for s in stats[1:3])
    assert all(s["steps"] == TILE + SEG for s in stats[1:3])


def test_walk_equals_plain_at_ties_and_zero_ramps():
    """Samples on the threshold exactly (not active), a fractional stop
    delay, a cap below the floor, ramps of 0: every output is the row's
    first sample, and no speculative walk (held at its first target)
    meets the true one."""
    rng = np.random.default_rng(7)
    x = rng.choice(F32([100.0, 350.0, 600.0, 900.0]), 2 * TILE + 11)
    x[::7] = 350.0
    p = [700.0, 350.0, 0.0, 0.0, 12.75, 650.0]
    got = _emulated([x], [p])
    assert torch.equal(got, _plain([x], [p]))
    assert torch.equal(got[0], torch.full_like(got[0], float(x[0])))
