"""Kernel H's geometry (``windows.windows_route``) at every shape
``chip_smoke.py`` and ``tests/test_torch_bin_power.py`` give it, a numpy
emulation of the kernel's index walk (``csrc/windows.cu``), and the
"day" operands of ``chip_smoke.py``'s phase 15 built at a small size.

At each shape: the route ("chain" where one window a warp fits one warp a
scheduler, else "packed"), at most 1024 threads and 227 KB of shared
memory a block, a geometry the kernel's launcher takes, and the lanes of
all tasks covering every (window, bin) exactly once.  The emulation
follows the kernel's copies into its ring of stages and its reads in
``walk_row``, and shows that each lane's chain steps over its own
window's samples in order, each exactly once, every read inside its
staged row; it covers win not a multiple of 4 or of a stage, W not a
multiple of the packing, K = 1, 7, 11 and K > 32, on both routes.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.control import synthesize_ramp  # noqa: E402
from repro_torch.core.spectrum import GRID_CRITICAL_HZ  # noqa: E402
from repro_torch.kernels.goertzel import windows as tw  # noqa: E402

BLOCK_SMEM = 232_448   # 227 KB: what a block may opt into on an H100
CHUNK = 16             # samples a register buffer holds (windows.cu)
K7 = len(GRID_CRITICAL_HZ)

# [W, win, K] -> route: phase 15's four calls (W padded to block_w 8) and
# the calls of tests/test_torch_bin_power.py
SHAPES = {
    "600s": ((152, 4000, K7), "chain"),
    "600s_tail": ((152, 4000, K7), "chain"),
    "ramp48": ((16, 2000, K7), "chain"),
    "day": ((21600, 4000, K7), "packed"),
    **{f"plain_{win}_K{k}": ((16, win, k), "chain")
       for win in (256, 1000, 1024) for k in (1, 3, 4)},
    **{f"bin_power_{win}_K{k}": ((16, win, k), "chain")
       for win in (256, 1000, 1024) for k in (1, 3, 4)},
    "known_amplitude": ((8, 1000, 3), "chain"),
    "integer_bins": ((8, 1000, 3), "chain"),
    "block_padding": ((8, 256, 1), "chain"),
    "partial_window": ((8, 1000, 1), "chain"),
}


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launcher_takes(r, W, win, K):
    """``windows_launch``'s own checks (windows.cu) on a route."""
    bins = min(K, tw.LANES)
    smem = 4 * r.warps * tw.STAGES * r.per_warp * (r.stage + tw.PAD)
    return (r.stage >= 2 * CHUNK and r.stage % (2 * CHUNK) == 0
            and 1 <= r.warps <= tw.MAX_WARPS and r.blocks >= 1
            and r.per_warp * bins <= tw.LANES and smem <= tw.BLOCK_SMEM
            and smem == r.smem_bytes)


def lane_cover(W, K, r):
    """(window, bin) of each active lane of every task, as the kernel maps
    them: task -> window group and bin group, lane -> (j, kk)."""
    lane = np.arange(tw.LANES)
    j, kk = lane // r.bins, lane % r.bins
    tasks = -(-W // r.per_warp) * r.groups
    task = np.arange(tasks)[:, None]
    w = task // r.groups * r.per_warp + j[None, :]
    k = task % r.groups * tw.LANES + kk[None, :]
    rows = np.minimum(r.per_warp, W - task // r.groups * r.per_warp)
    active = (j[None, :] < rows) & (k < K)
    return w[active], k[active]


@pytest.mark.parametrize("tag", list(SHAPES))
def test_route_at_every_shape(tag):
    (W, win, K), route = SHAPES[tag]
    r = tw.windows_route(W, win, K)
    assert r.route == route
    assert r.warps * tw.LANES <= 1024 and r.smem_bytes <= BLOCK_SMEM
    assert launcher_takes(r, W, win, K)
    # rows 20 (mod 32) floats apart: 8 rows at one offset, 8 bank groups
    assert len({(r.stage + tw.PAD) * i % 32 for i in range(8)}) == 8
    assert r.stages == -(-win // r.stage) and r.blocks * r.warps >= (
        -(-W // r.per_warp) * r.groups)
    w, k = lane_cover(W, K, r)
    pairs = w.astype(np.int64) * K + k
    assert len(pairs) == W * K and np.array_equal(np.sort(pairs),
                                                  np.arange(W * K))


def test_chain_and_packed_at_phase15_and_day():
    """The three traces walk one window a warp, the whole window in flight
    (4 stages of 1024 or 512 samples); "day" packs 4 windows a warp, 28 of
    32 lanes walking, 4 warps a block."""
    r = tw.windows_route(152, 4000, K7)
    assert (r.per_warp, r.warps, r.stage, r.stages, r.blocks) == (
        1, 1, 1024, 4, 152)
    r = tw.windows_route(16, 2000, K7)
    assert (r.stage, r.stages, r.blocks) == (512, 4, 16)
    r = tw.windows_route(21600, 4000, K7)
    assert (r.per_warp, r.bins, r.warps, r.stage, r.blocks) == (
        4, 7, 4, 128, 1350)
    assert r.per_warp * r.bins == 28


def walk_row(p, n, row_end):
    """``walk_row`` in windows.cu: the ring offsets the chain steps over,
    in order, from a staged row at p; asserts each 16-sample read stays
    below ``row_end``."""
    reads, steps = [p], []
    a = p
    while n >= 2 * CHUNK:
        b = p + CHUNK
        reads.append(b)
        steps += range(a, a + CHUNK)
        a = p + 2 * CHUNK
        reads.append(a)
        steps += range(b, b + CHUNK)
        n -= 2 * CHUNK
        p += 2 * CHUNK
    if n > 0:
        steps += range(a, a + min(n, CHUNK))
        if n > CHUNK:
            reads.append(p + CHUNK)
            steps += range(p + CHUNK, p + n)
    assert all(r + CHUNK <= row_end for r in reads)
    return steps


def emulate(W, win, K, r, vec):
    """Kernel H's walk in numpy: for each (window, bin) the flat index into
    ``windows`` of every sample its lane's chain steps over, in order."""
    x = np.arange(W * win).reshape(W, win)
    assert CHUNK <= tw.PAD   # a row's last read stays in its padding
    stride = r.stage + tw.PAD
    slot_f = r.per_warp * stride
    out = {}
    for task in range(-(-W // r.per_warp) * r.groups):
        wg, grp = divmod(task, r.groups)
        w0 = wg * r.per_warp
        rows = min(r.per_warp, W - w0)
        ring = np.full(tw.STAGES * slot_f, -1)

        def load_stage(s):
            if s >= r.stages:
                return
            t0 = s * r.stage
            n = min(r.stage, win - t0)
            slot = s % tw.STAGES * slot_f
            dst = []
            for lane in range(tw.LANES):
                for rr in range(rows):
                    if vec:
                        for c in range(4 * lane, n, 4 * tw.LANES):
                            dst += [(slot + rr * stride + c + e, rr,
                                     t0 + c + e) for e in range(4)]
                    else:
                        for c in range(lane, n, tw.LANES):
                            dst.append((slot + rr * stride + c, rr, t0 + c))
            # every sample of the stage's rows once, each inside its row
            assert len({d for d, _, _ in dst}) == len(dst) == rows * n
            for d, rr, t in dst:
                assert slot + rr * stride <= d < slot + rr * stride + n
                ring[d] = x[w0 + rr, t]

        for s in range(tw.STAGES):
            load_stage(s)
        chains = [[] for _ in range(tw.LANES)]
        for s in range(r.stages):
            n = min(r.stage, win - s * r.stage)
            for lane in range(tw.LANES):
                j = lane // r.bins
                row = s % tw.STAGES * slot_f + (j if j < r.per_warp else 0
                                                ) * stride
                chains[lane] += [ring[o] for o in walk_row(
                    row, n, row + r.stage + CHUNK)]
            load_stage(s + tw.STAGES)
        for lane in range(tw.LANES):
            j, kk = divmod(lane, r.bins)
            k = grp * tw.LANES + kk
            if j < rows and k < K:
                assert (w0 + j, k) not in out
                out[(w0 + j, k)] = chains[lane]
    return x, out


@pytest.mark.parametrize("route", ["chain", "packed"])
@pytest.mark.parametrize("W,win,K", [
    (3, 1001, 7),      # win odd: 4-byte copies, a partial last chunk
    (9, 600, 1),       # W not a multiple of the packing (32 a warp)
    (10, 259, 11),     # two windows a warp, win past a stage of 128
    (2, 300, 40),      # two bin groups, the second of 8 bins
    (5, 4000, 7),      # the traces' window, W not a multiple of 4
    (1, 9000, 3),      # the ring refilled (more than 4 stages)
    (6, 37, 7),        # a window shorter than one stage
])
def test_index_walk_reads_each_sample_once_in_order(W, win, K, route):
    r = tw.windows_route(W, win, K, route=route)
    assert launcher_takes(r, W, win, K)
    x, out = emulate(W, win, K, r, vec=win % 4 == 0)
    assert set(out) == {(w, k) for w in range(W) for k in range(K)}
    for (w, _), seq in out.items():
        assert seq == list(x[w])


def test_index_walk_with_4_byte_copies_of_aligned_rows():
    """A misaligned base takes the 4-byte copies at any win."""
    r = tw.windows_route(5, 512, 7, route="packed")
    x, out = emulate(5, 512, 7, r, vec=False)
    assert all(seq == list(x[w]) for (w, _), seq in out.items())


@pytest.mark.parametrize("W,win,K", [
    (1, 1, 1), (8, 3, 1024), (1024, 5, 1), (64, 100000, 2),
    (1, 70000, 33), (4096, 4000, 31), (100000, 64, 16)])
def test_every_accepted_shape_has_a_geometry(W, win, K):
    """The wrapper takes any W, win >= 1 and K <= 1024 (block_w x K <=
    1024): the route's geometry passes the launcher's checks and covers
    every (window, bin) once."""
    r = tw.windows_route(W, win, K)
    assert launcher_takes(r, W, win, K)
    w, k = lane_cover(W, K, r)
    assert len(w) == W * K
    assert len(np.unique(w.astype(np.int64) * K + k)) == W * K


def test_wrapper_raises_where_it_raised():
    wnd = torch.zeros((8, 16))
    coef = torch.zeros(3)
    with pytest.raises(ValueError, match="divide into blocks"):
        tw.goertzel_windows(wnd, coef, block_w=3)
    with pytest.raises(ValueError, match="float32"):
        tw.goertzel_windows(wnd.double(), coef)
    with pytest.raises(ValueError, match=r"\[W, win\]"):
        tw.goertzel_windows(wnd[0], coef)
    with pytest.raises(ValueError, match="no route"):
        tw.windows_route(8, 16, 3, route="wide")
    with pytest.raises(ValueError, match=">= 1"):
        tw.windows_route(8, 0, 3)
    # on the CPU the plain version takes what the kernel's wrapper takes
    assert tw.goertzel_windows(wnd, coef, block_w=8).shape == (8, 3)


def test_day_operands_as_chip_smoke_builds_them(monkeypatch):
    """"day" at a small size: a 4-window trace tiled 4 times is whole
    windows of it; bin_power's day windows are the base windows tiled, the
    kernel's CPU path on them equals the base output tiled, and
    ``day_case`` passes its gates."""
    cs = chip_smoke()
    base = synthesize_ramp(duration_s=16.0, dt=0.001, ramp_start_s=2.0,
                           ramp_end_s=12.0)
    day = cs.day_trace(base, tiles=4)
    assert len(day) == 4 * len(base) and np.array_equal(day[:16000], base)
    assert np.array_equal(day.reshape(-1, 4000)[4:8],
                          base.reshape(-1, 4000))
    traces = {"600s": (base, 0.001, 4000), "day": (day, 0.001, 4000)}
    from repro_torch.kernels.goertzel import ops
    monkeypatch.setattr(ops, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    amps, calls = cs.bin_power_calls(traces)
    assert [tuple(c[0].shape) for c in calls] == [(8, 4000), (16, 4000)]
    row = cs.day_case(torch, traces, amps, calls)
    assert row["tiled_bitwise"] and row["max_abs_err"] == 0.0
    assert row["shape"] == [16, 4000, K7]
    with pytest.raises(ValueError, match="whole windows"):
        cs.day_trace(base[:-1])
    # the full day's call goes to the packed route
    assert tw.windows_route(len(cs.day_trace(np.zeros(600_000))) // 4000,
                            4000, K7).route == "packed"
