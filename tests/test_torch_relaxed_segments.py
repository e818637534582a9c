"""CPU models of kernels J's and K's schemes (``kernels/scans/csrc/
chain_walk.cuh``), held against the plain versions at [3 x 2000].

The kernels run only on the card; these models check the algorithm
before chip time is spent, as ``test_torch_gpu_floor_walk.py`` does for
kernel B.  Each is small Python, here and not in the package:

* ``walk_model``: a row cut into chunks of ``lanes`` segments of ``seg``
  samples; every segment walks from its guess; two rounds walk again, all
  segments at once, from each one's predecessor's end; then, once the
  chunk's start (the previous chunk's end) is in, the first segment whose
  start changed walks again, one at a time, until the state meets the
  kept output bit for bit at a tested step (every 8th in a whole
  segment).  Its outputs
  must equal the plain versions' bit for bit: the forwards' recurrences
  (J's idle counter and output, K's target, hold and SoC) with every other
  term computed by the plain version's own torch ops, sample by sample.
* ``affine_model``: a reverse recurrence carry_{i-1} = a_i carry_i + b_i
  as the adjoints run it: each segment's maps composed in float64, a
  doubling scan over a chunk's segments, chunks handing their carry on.
  The adjoint models (J's two carries, K's three and the mode's) give
  d/dw and every parameter column within 1e-5 of each field's own max
  |plain| (the plain versions' autograd sums in f32 along the chains).

The data hold rows whose walks merge in every segment (J's output under a
fast ramp; K's hold without a switch latency), nearly every one (a
battery that clips at 0 or its capacity every few samples) and none (J's
ramp-limited output; a large battery that never reaches a bound), and the
models' merge counts say so.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.hardware import DEFAULT_HW
from repro_torch.core.smoothing import battery as tb
from repro_torch.core.smoothing import gpu_floor as tg
from repro_torch.core.smoothing.relax import (sigmoid_gate, smooth_max,
                                             soft_sign)

f32 = np.float32
TDP = DEFAULT_HW.chip.tdp_w
TAU = 0.05
DT = 0.002
N = 2000
SEG, LANES = 8, 4                 # a chunk of 32 samples: 63 chunks a row
ADJ_TOL = 1e-5                    # of each field's max |plain|
KDT = 2.0 ** -9                   # K's sample step, about 2 ms


def same(a, b):
    return np.float32(a).view(np.uint32) == np.float32(b).view(np.uint32)


def walk_model(step, n, s_first, guess, seg=SEG, lanes=LANES, settle=2):
    """The segmented walks with the exact merge test over one row:
    ``step(s, i)`` the recurrence at sample ``i``, ``s_first`` the row's
    start, ``guess(i)`` a segment's guess from its first sample.  Returns
    the outputs and, a chunk, (segments walked again once its start came
    in, those of them that did not merge)."""
    out = np.empty(n, f32)
    chunk = seg * lanes
    tallies = []
    s_in = f32(s_first)

    def rewalk(a, b, s):
        """Walk [a, b) from s over the kept outputs: (merged, end)."""
        whole = b - a == seg and seg % 8 == 0
        for i in range(a, b):
            old = out[i]
            s = step(s, i)
            out[i] = s
            tested = (i - a) % 8 == 7 if whole else True
            if tested and same(s, old):
                return True, s
        return False, s

    for i0 in range(0, n, chunk):
        segs = [(a, min(a + seg, n)) for a in range(i0, min(i0 + chunk, n),
                                                    seg)]
        have, end = [], []
        for a, b in segs:                       # each from its guess
            s = f32(guess(a))
            have.append(s)
            for i in range(a, b):
                s = step(s, i)
                out[i] = s
            end.append(s)
        for _ in range(settle):                 # all segments at once
            starts = [have[0]] + end[:-1]
            redo = [not same(st, hv) for st, hv in zip(starts, have)]
            if not any(redo):
                break
            for k, (a, b) in enumerate(segs):
                if redo[k]:
                    met, e = rewalk(a, b, starts[k])
                    have[k] = starts[k]
                    if not met:
                        end[k] = e
        walks = unmerged = 0                    # then one at a time
        while True:
            starts = [s_in] + end[:-1]
            mis = [k for k in range(len(segs))
                   if not same(starts[k], have[k])]
            if not mis:
                break
            k = mis[0]
            met, e = rewalk(*segs[k], starts[k])
            have[k] = starts[k]
            if not met:
                end[k] = e
            walks += 1
            unmerged += not met
        tallies.append((walks, unmerged))
        s_in = end[-1]
    return out, tallies


def affine_model(a, b, seg=SEG, lanes=LANES):
    """carry_{i-1} = a_i carry_i + b_i from carry_{n-1} = 0, in float64 as
    the adjoints compose it; returns (carry_i for every i, carry_{-1})."""
    n = len(a)
    carry = np.empty(n)
    chunk = seg * lanes
    c_in = 0.0
    for i0 in reversed(range(0, n, chunk)):
        segs = [(s, min(s + seg, n)) for s in range(i0, min(i0 + chunk, n),
                                                    seg)]
        maps = []
        for s, e in segs:
            A, B = 1.0, 0.0
            for i in reversed(range(s, e)):
                A, B = a[i] * A, a[i] * B + b[i]
            maps.append((A, B))
        L = len(maps)
        inc = list(maps)                        # doubling: lanes k .. L-1
        o = 1
        while o < L:
            inc = [(inc[k][0] * inc[k + o][0],
                    inc[k][0] * inc[k + o][1] + inc[k][1])
                   if k + o < L else inc[k] for k in range(L)]
            o *= 2
        for k, (s, e) in enumerate(segs):
            A, B = inc[k + 1] if k + 1 < L else (1.0, 0.0)
            c = A * c_in + B
            for i in reversed(range(s, e)):
                carry[i] = c
                c = a[i] * c + b[i]
        c_in = inc[0][0] * c_in + inc[0][1]
    return carry, c_in


def sigm(x):
    return (f32(1) / (f32(1) + np.exp(-x))).astype(f32)


def wmax(a, b):
    return np.where(a > b, f32(1), np.where(a == b, f32(0.5), f32(0)))


def wmin(a, b):
    return np.where(a < b, f32(1), np.where(a == b, f32(0.5), f32(0)))


def logaddexp(a, b):
    return (np.maximum(a, b) + np.log1p(np.exp(-np.abs(a - b)))).astype(f32)


def fields_close(name, got, ref):
    scale = float(np.abs(ref).max())
    err = float(np.abs(np.asarray(got, np.float64) - ref).max())
    assert err <= ADJ_TOL * scale or (scale == 0 and err == 0), \
        (name, err, scale)


# ---------------------------------------------------------------------------
# kernel J
# ---------------------------------------------------------------------------

def floor_rows():
    """Three rows of one square-wave trace (compute at TDP, comm at 0.3,
    idle gaps): a fast ramp (o meets its target: every walk merges), a
    ramp-limited one (o never meets it) and one between."""
    t = np.arange(N) * DT
    x = np.where((t % 0.8) < 0.5, TDP, 0.3 * TDP) * (
        1.0 + 0.02 * np.sin(t * 40.0))
    x[700:900] = 0.05 * TDP                    # the counter climbs
    w = torch.tensor(np.stack([x] * 3).astype(f32))
    params = torch.tensor([
        [0.7 * TDP, 0.35 * TDP, 1e4, 1e4, 50.0, 0.98 * TDP],
        [0.7 * TDP, 0.35 * TDP, 1e-3, 1e-3, 50.0, 0.98 * TDP],
        [0.5 * TDP, 0.35 * TDP, 2.0, 1.5, 150.0, 0.9 * TDP]],
        dtype=torch.float32)
    return w, params


def floor_forward_model(w, params):
    """J's forward as the kernel runs it: 1 - a_i per sample, the idle
    counter's walks (guess 0), the targets per sample, the output's walks
    (guess: the segment's first target); torch ops as the plain version's
    for every term off the chains."""
    B, n = w.shape
    mpf, thresh, ru, rd, stop_n, cap = params.unbind(-1)
    cols = w.unbind(-1)
    c = torch.stack([1.0 - sigmoid_gate(p - thresh, TAU, TDP) for p in cols],
                    -1).numpy()
    idle = np.stack([walk_model(lambda s, i: c[r, i] * (s + f32(1)), n,
                                0.0, lambda i: 0.0)[0] for r in range(B)])
    ts = []
    for i, p in enumerate(cols):
        idle_i = torch.from_numpy(idle[:, i].copy())
        floor = mpf * sigmoid_gate(stop_n - idle_i, TAU, stop_n + 1.0)
        tg_ = smooth_max(p, floor, TAU, TDP)
        ts.append(-smooth_max(-tg_, -cap, TAU, TDP))
    t = torch.stack(ts, -1).numpy()
    rdn, run = rd.numpy(), ru.numpy()
    out, tallies = [], []
    for r in range(B):
        o, tal = walk_model(
            lambda s, i: np.minimum(np.maximum(t[r, i], s - rdn[r]),
                                    s + run[r]),
            n, w[r, 0].item(), lambda i: t[r, i])
        out.append(o)
        tallies.append(tal)
    return np.stack(out), idle, tallies


def floor_adjoint_model(w, params, out, idle, g):
    """J's adjoint as the kernel runs it: per-sample terms recomputed from
    (x_i, o_{i-1}, idle_{i-1}) in f32, the two carries as float64 affine
    scans, the parameter sums in float64.  Returns (d/dw, d/dparams)."""
    x = w.numpy()
    P = params.numpy()
    B, n = x.shape
    gw = np.empty((B, n), f32)
    gp = np.zeros((B, 6))
    T = f32(TAU * TDP)
    for r in range(B):
        mpf, thresh, ru, rd, stop_n, cap = P[r]
        S = f32(TAU) * (stop_n + f32(1))
        xr = x[r]
        o_prev = np.concatenate([[xr[0]], out[r, :-1]]).astype(f32)
        i_prev = np.concatenate([[0.0], idle[r, :-1]]).astype(f32)
        a = sigm((xr - thresh) / T)
        ip1 = i_prev + f32(1)
        idl = (f32(1) - a) * ip1
        v = (stop_n - idl) / S
        gs = sigm(v)
        fl = mpf * gs
        x1, x2 = xr / T, fl / T
        t1 = T * logaddexp(x1, x2)
        y1, y2 = -t1 / T, -cap / T
        t2 = -(T * logaddexp(y1, y2))
        lo, hi = o_prev - rd, o_prev + ru
        m = np.maximum(t2, lo)
        wm, wt = wmin(m, hi), wmax(t2, lo)
        wgt = wm.astype(np.float64) * (1.0 - wt) + (1.0 - wm)
        gr = g[r].astype(np.float64)
        carry, go = affine_model(wgt, wgt * gr)
        got = (gr + carry).astype(f32)
        dm, dhi = got * wm, got * (f32(1) - wm)
        dt2, dlo = dm * wt, dm * (f32(1) - wt)
        dt1 = dt2 / (f32(1) + np.exp(y2 - y1))
        dcap = dt2 / (f32(1) + np.exp(y1 - y2))
        dx = dt1 / (f32(1) + np.exp(x2 - x1))
        dfl = dt1 / (f32(1) + np.exp(x1 - x2))
        dv = dfl * mpf * gs * (f32(1) - gs)
        dN = dv / S
        k = (f32(1) - a).astype(np.float64)
        carry, _ = affine_model(k, -k * dN)
        didle = (carry - dN).astype(f32)
        du = -didle * ip1 * a * (f32(1) - a)
        gw[r] = dx + du / T
        gw[r, 0] += f32(go)
        gp[r] = [np.sum(dfl * gs, dtype=np.float64),
                 -np.sum(du / T, dtype=np.float64),
                 np.sum(dhi, dtype=np.float64),
                 -np.sum(dlo, dtype=np.float64),
                 np.sum(dN - f32(TAU) * dv * v / S, dtype=np.float64),
                 np.sum(dcap, dtype=np.float64)]
    return gw, gp


def test_floor_forward_model_equals_plain_bitwise():
    w, params = floor_rows()
    with torch.no_grad():
        plain = tg.gpu_floor_relaxed_plain(w, params, TAU, TDP).numpy()
    out, _, tallies = floor_forward_model(w, params)
    assert np.array_equal(out.view(np.uint32), plain.view(np.uint32))
    # row 0 merges in every segment, row 1 in none (ramp-limited)
    assert all(u == 0 for _, u in tallies[0])
    assert sum(u for _, u in tallies[1]) >= 0.9 * LANES * len(tallies[1])


def test_floor_adjoint_model_matches_plain():
    w, params = floor_rows()
    g = np.random.default_rng(4).normal(size=w.shape).astype(f32)
    wq = w.clone().requires_grad_(True)
    pq = params.clone().requires_grad_(True)
    (tg.gpu_floor_relaxed_plain(wq, pq, TAU, TDP) * torch.tensor(g)
     ).sum().backward()
    out, idle, _ = floor_forward_model(w, params)
    gw, gp = floor_adjoint_model(w, params, out, idle, g)
    fields_close("d_w", gw, wq.grad.numpy().astype(np.float64))
    for i, col in enumerate(tg.PARAM_COLUMNS):
        fields_close("d_" + col, gp[:, i], pq.grad[:, i].numpy().astype(
            np.float64))


# ---------------------------------------------------------------------------
# kernel K
# ---------------------------------------------------------------------------

def battery_rows(clipping=True):
    """Three rows behind one noisy load: a small battery with narrow tapers
    that clips at 0 or its capacity every few samples (its SoC forgets its
    past there), a large one that never reaches a bound (its SoC never
    forgets), and one with a switch latency of three samples.  Without
    ``clipping`` the first row keeps the design's taper floor and
    efficiency (the plain version's gradient is not finite where the narrow
    tapers land the SoC on a bound exactly)."""
    rng = np.random.default_rng(7)
    lv = np.repeat(rng.uniform(0.3, 1.0, N // 50 + 1), 50)[:N]
    x = (5e6 * lv + 1e5 * rng.normal(size=N)).astype(f32)
    w = torch.tensor(np.stack([x] * 3))
    mean = float(x.astype(np.float64).mean())

    def row(cap, mx, lat, soc_frac, eff=0.95, taper=None):
        w_lo = taper or max(0.1 * cap, 2.0 * mx * KDT / eff)
        w_hi = taper or max(0.1 * cap, 2.0 * mx * KDT * eff)
        return [KDT / 0.5, lat, cap, w_lo, w_hi, mx, mx, eff,
                soc_frac * cap, mean, mx]
    # the first row's tapers are narrower than the design's floor (two
    # power-limit samples of energy) and its efficiency is 1, so that a
    # full discharge or charge lands on 0 or cap exactly (dt is a power of
    # two): its SoC is clipped, and forgets its past, every few samples
    first = (row(2e3, 4e6, 0.0, 0.5, eff=1.0, taper=1.0) if clipping
             else row(2e3, 4e6, 0.0, 0.5))
    params = torch.tensor([first,
                           row(1e8, 4e6, 0.0, 0.5),
                           row(5e5, 2e6, 3.0, 0.3)], dtype=torch.float32)
    return w, params


def battery_forward_model(w, params, tau=TAU):
    """K's forward as the kernel runs it: the target's walks, want, the mode
    and the switch per sample, the hold's walks (guess 0), the open gate
    per sample, the SoC's walks (guess soc0), the grid per sample from the
    SoC before it; the plain version's torch ops off the chains."""
    B, n = w.shape
    x = w.numpy()
    P = params.numpy()
    dt = f32(KDT)
    tgt = np.stack([walk_model(
        lambda s, i, r=r: s + P[r, 0] * (x[r, i] - s), n, P[r, 9],
        lambda i, r=r: P[r, 9])[0] for r in range(B)])
    want = (x - tgt).astype(f32)
    zero = torch.zeros(B)
    one = torch.ones(B)
    lat = params[:, 1]
    mode = zero
    sw = []
    for i in range(n):
        nm = soft_sign(torch.from_numpy(want[:, i].copy()), tau,
                       params[:, 10])
        sw.append(torch.minimum(torch.maximum(-(nm * mode), zero), one))
        mode = nm
    sw = torch.stack(sw, -1).numpy()
    holds = [walk_model(
        lambda s, i, r=r: sw[r, i] * P[r, 1] + (f32(1) - sw[r, i])
        * np.maximum(s - f32(1), f32(0)), n, 0.0, lambda i: 0.0)
        for r in range(B)]
    hold = np.stack([h for h, _ in holds])
    of = torch.stack([sigmoid_gate(0.5 - torch.from_numpy(hold[:, i].copy()),
                                   tau, lat + 1.0) for i in range(n)],
                     -1).numpy()

    def flows(r, soc, i):
        _, _, cap, w_lo, w_hi, mxd, mxc, eff = P[r, :8]
        tlo = np.minimum(np.maximum(soc / w_lo, f32(0)), f32(1))
        thi = np.minimum(np.maximum((cap - soc) / w_hi, f32(0)), f32(1))
        dis = np.minimum(np.maximum(want[r, i], f32(0)), mxd * tlo)
        dis = np.minimum(dis, soc * eff / dt)
        chg = np.minimum(np.maximum(-want[r, i], f32(0)), mxc * thi)
        chg = np.minimum(chg, (cap - soc) / eff / dt)
        return of[r, i] * dis, of[r, i] * chg

    def soc_step(r, soc, i):
        dis, chg = flows(r, soc, i)
        eff = P[r, 7]
        s1 = soc - dis * dt / eff + chg * dt * eff
        return np.minimum(np.maximum(s1, f32(0)), P[r, 2])

    socs, grid, tallies = [], [], []
    for r in range(B):
        s, tal = walk_model(lambda s_, i, r=r: soc_step(r, s_, i), n,
                            P[r, 8], lambda i, r=r: P[r, 8])
        sp = np.concatenate([[P[r, 8]], s[:-1]]).astype(f32)
        gr = np.empty(n, f32)
        for i in range(n):
            dis, chg = flows(r, sp[i], i)
            gr[i] = x[r, i] - dis + chg
        socs.append(s)
        grid.append(gr)
        tallies.append({"soc": tal, "hold": holds[r][1]})
    return np.stack(grid), np.stack(socs), tgt, hold, tallies


def battery_adjoint_model(w, params, soc, tgt, hold, g_grid, g_soc,
                          tau=TAU):
    """K's adjoint as the kernel runs it: per-sample terms recomputed from
    the saved carries in f32, the SoC's, the hold's and the target's
    carries as float64 affine scans in that order, the mode's from the next
    sample's, the parameter sums in float64."""
    x = w.numpy()
    P = params.numpy()
    B, n = x.shape
    dt = f32(KDT)
    gw = np.empty((B, n), f32)
    gp = np.zeros((B, 11))
    for r in range(B):
        (alpha, lat, cap, w_lo, w_hi, mxd, mxc, eff, soc0, tgt0,
         ps) = P[r]
        Z, Y = f32(tau) * ps, f32(tau) * (lat + f32(1))
        xr = x[r]
        sp = np.concatenate([[soc0], soc[r, :-1]]).astype(f32)
        tp = np.concatenate([[tgt0], tgt[r, :-1]]).astype(f32)
        hp = np.concatenate([[0.0], hold[r, :-1]]).astype(f32)
        tg_ = tp + alpha * (xr - tp)
        want = xr - tg_
        z = want / Z
        nm = np.tanh(z).astype(f32)
        mp = np.concatenate([[0.0], nm[:-1]]).astype(f32)
        q = -(nm * mp)
        rr = np.maximum(q, f32(0))
        sw = np.minimum(rr, f32(1))
        hm1 = hp - f32(1)
        hm = np.maximum(hm1, f32(0))
        hd = sw * lat + (f32(1) - sw) * hm
        of = sigm((f32(0.5) - hd) / Y)
        # the SoC step's terms
        a1 = sp / w_lo
        b1 = np.maximum(a1, f32(0))
        tlo = np.minimum(b1, f32(1))
        a2 = (cap - sp) / w_hi
        b2 = np.maximum(a2, f32(0))
        thi = np.minimum(b2, f32(1))
        c1 = np.maximum(want, f32(0))
        h1 = mxd * tlo
        d1 = np.minimum(c1, h1)
        h2 = sp * eff / dt
        d2 = np.minimum(d1, h2)
        c2 = np.maximum(-want, f32(0))
        h3 = mxc * thi
        e1 = np.minimum(c2, h3)
        h4 = (cap - sp) / eff / dt
        e2 = np.minimum(e1, h4)
        dis, chg = of * d2, of * e2
        s1 = sp - dis * dt / eff + chg * dt * eff
        ws, wsl = wmin(np.maximum(s1, f32(0)), cap), wmax(s1, f32(0))
        w1, w2, w3, w4 = wmin(c1, h1), wmin(d1, h2), wmin(c2, h3), \
            wmin(e1, h4)

        def soc_adj(asoc, gg):
            ds1 = asoc * ws * wsl
            o = {"dcap": asoc * (f32(1) - ws), "dsoc": ds1}
            ddis = -ds1 * dt / eff - gg
            dchg = ds1 * dt * eff + gg
            o["deff"] = ds1 * (dis * dt / (eff * eff) + chg * dt)
            o["dof"] = ddis * d2 + dchg * e2
            dd2, de2 = ddis * of, dchg * of
            de1, dh4 = de2 * w4, de2 * (f32(1) - w4)
            o["dcap"] = o["dcap"] + dh4 / eff / dt
            o["dsoc"] = o["dsoc"] - dh4 / eff / dt
            o["deff"] = o["deff"] - dh4 * h4 / eff
            dc2, dh3 = de1 * w3, de1 * (f32(1) - w3)
            o["dmax_chg"] = dh3 * thi
            dthi = dh3 * mxc
            o["dwant"] = -dc2 * wmax(-want, f32(0))
            dd1, dh2 = dd2 * w2, dd2 * (f32(1) - w2)
            o["dsoc"] = o["dsoc"] + dh2 * eff / dt
            o["deff"] = o["deff"] + dh2 * sp / dt
            dc1, dh1 = dd1 * w1, dd1 * (f32(1) - w1)
            o["dmax_dis"] = dh1 * tlo
            dtlo = dh1 * mxd
            o["dwant"] = o["dwant"] + dc1 * wmax(want, f32(0))
            da2 = dthi * wmin(b2, f32(1)) * wmax(a2, f32(0))
            o["dcap"] = o["dcap"] + da2 / w_hi
            o["dsoc"] = o["dsoc"] - da2 / w_hi
            o["dw_hi"] = -da2 * a2 / w_hi
            da1 = dtlo * wmin(b1, f32(1)) * wmax(a1, f32(0))
            o["dsoc"] = o["dsoc"] + da1 / w_lo
            o["dw_lo"] = -da1 * a1 / w_lo
            return o

        gg, gs = g_grid[r].astype(f32), g_soc[r].astype(f32)
        A = soc_adj(np.ones(n, f32), np.zeros(n, f32))["dsoc"].astype(
            np.float64)
        Bc = soc_adj(np.zeros(n, f32), gg)["dsoc"].astype(np.float64)
        carry, asoc = affine_model(A, A * gs + Bc)
        tot = (carry + gs).astype(f32)
        sg = soc_adj(tot, gg)
        dq_in = (sg["dof"] * of * (f32(1) - of)) / Y
        kh = (f32(1) - sw).astype(np.float64) * wmax(hm1, f32(0))
        carry, _ = affine_model(kh, -kh * dq_in)
        dhold = (carry - dq_in).astype(f32)
        dq = dhold * (lat - hm) * wmin(rr, f32(1)) * wmax(q, f32(0))
        am = np.concatenate([-dq[1:] * nm[1:], [0.0]]).astype(f32)
        dz = (am - dq * mp) * (f32(1) - nm * nm)
        dwant = sg["dwant"] + dz / Z
        ka = 1.0 - float(alpha)
        carry, atgt = affine_model(np.full(n, ka), -ka * dwant)
        dtgt = (carry - dwant).astype(f32)
        gw[r] = gg + dwant + dtgt * alpha
        s64 = lambda v: np.sum(v, dtype=np.float64)  # noqa: E731
        gp[r] = [s64(dtgt * (xr - tp)), 0.0, s64(sg["dcap"]),
                 s64(sg["dw_lo"]), s64(sg["dw_hi"]), s64(sg["dmax_dis"]),
                 s64(sg["dmax_chg"]), s64(sg["deff"]), asoc, atgt,
                 s64(-dz * z / Z * f32(tau))]
    return gw, gp


def test_battery_forward_model_equals_plain_bitwise():
    w, params = battery_rows()
    with torch.no_grad():
        grid, soc = tb.battery_relaxed_plain(w, params, KDT, TAU)
    g_, s_, _, _, tallies = battery_forward_model(w, params)
    assert np.array_equal(g_.view(np.uint32), grid.numpy().view(np.uint32))
    assert np.array_equal(s_.view(np.uint32), soc.numpy().view(np.uint32))
    # without a switch latency the hold is 0 from any start: it merges in
    # every segment; the clipping battery's SoC in most (a walk from the
    # guess that drains or fills slowly may not reach the bound within its
    # segment); the large battery's in none
    assert all(u == 0 for _, u in tallies[0]["hold"] + tallies[1]["hold"])
    soc0 = tallies[0]["soc"]
    assert sum(u for _, u in soc0) <= 0.25 * LANES * len(soc0)
    assert all(u == LANES for _, u in tallies[1]["soc"][1:-1])


def test_battery_adjoint_model_matches_plain():
    w, params = battery_rows(clipping=False)
    rng = np.random.default_rng(5)
    g_grid = rng.normal(size=w.shape).astype(f32)
    g_soc = (1e-3 * rng.normal(size=w.shape)).astype(f32)
    wq = w.clone().requires_grad_(True)
    pq = params.clone().requires_grad_(True)
    grid, soc = tb.battery_relaxed_plain(wq, pq, KDT, TAU)
    ((grid * torch.tensor(g_grid)).sum() + (soc * torch.tensor(g_soc)).sum()
     ).backward()
    _, s_, tgt, hold, _ = battery_forward_model(w, params)
    gw, gp = battery_adjoint_model(w, params, s_, tgt, hold, g_grid, g_soc)
    fields_close("d_w", gw, wq.grad.numpy().astype(np.float64))
    for i, col in enumerate(tb.RELAXED_COLUMNS):
        fields_close("d_" + col, gp[:, i], pq.grad[:, i].numpy().astype(
            np.float64))


@pytest.mark.parametrize("n", [1, 5, 33, 64, 65])
def test_affine_model_equals_the_serial_recurrence(n):
    """The chunked float64 scan is the serial recurrence (to rounding) at
    lengths that leave partial segments and chunks."""
    rng = np.random.default_rng(n)
    a, b = rng.uniform(-1.2, 1.2, n), rng.normal(size=n)
    got, last = affine_model(a, b)
    c = 0.0
    want = np.empty(n)
    for i in reversed(range(n)):
        want[i] = c
        c = a[i] * c + b[i]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert last == pytest.approx(c, rel=1e-12, abs=1e-12)


def test_chain_scratch_matches_the_kernels_layout():
    """The wrapper's scratch (relax.chain_scratch) holds what
    chain_walk.cuh's scratch_words asks: one ticket word and a 21-word slot
    (five mailboxes of two words, eleven sums) a (row, chunk) of 1024."""
    from repro_torch.core.smoothing.relax import chain_chunks, chain_scratch
    assert chain_chunks(90_000) == 88 and chain_chunks(1024) == 1
    assert chain_scratch(10, 90_000, "cpu").numel() == 1 + 10 * 88 * 21
    src = (tg.__file__.rsplit("/core/", 1)[0]
           + "/kernels/scans/csrc/chain_walk.cuh")
    text = open(src).read()
    for line in ("constexpr int kSeg = 32;", "constexpr int kBoxes = 5;",
                 "constexpr int kSums = 11;"):
        assert line in text
