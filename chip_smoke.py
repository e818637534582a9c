#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``,
holds each kernel against its plain PyTorch version at the shapes the
main path gives it, runs a full-size ``Study.run()`` on the card (counting
every kernel's launches), re-runs a subset of it on the CPU, and prints:

  * the card's name and power limit (``nvidia-smi``);
  * build times and ``ptxas`` register and spill lines;
  * per kernel: error against its plain version (and, for the monitor,
    the float64 oracle and chunked state-in/out calls), ``ms``,
    ``plain_ms``, ``bound_ms``/``bound_by`` and launches per Study;
  * the Study's wall times, rows/s, verdicts, backstop levels, device busy
    share and top device operations;
  * one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line again,
    and, last, ``{"ok": true, "device": {...}}``.

Every phase raises on failure, so the script exits non-zero and prints
no result line.  It needs one card and exits non-zero without one, or
when ``src/repro_torch`` is not beside it.
"""
from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, and f32
# operations/s outside the tensor cores, used for every kernel here (their
# arithmetic is 32-bit scalar)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

MONITOR_TOL = 1e-4        # of the row's amplitude scale max |x - mean|
ORACLE_TOL = 1e-3         # of the amplitude scale, against float64
SCAN_TOL = 1e-5           # of max |w|, kernels B and C
STUDY_RTOL = 1e-4         # CPU-vs-card metrics

DT = 0.001
FLEETS = (8192, 32768)
SEEDS = (0, 1)
SPEC_NAMES = ("moderate", "tight")
JOB_MW = 6.0


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def import_port():
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        raise SystemExit("chip_smoke: src/repro_torch is not beside this "
                         "script")
    sys.path.insert(0, src)
    import repro_torch
    if not os.path.abspath(repro_torch.__file__).startswith(src):
        raise SystemExit(f"chip_smoke: imported {repro_torch.__file__}, "
                         f"not the port under {src}")


# ---------------------------------------------------------------------------
# the Study of the main path
# ---------------------------------------------------------------------------

def study_configs(api):
    """34 configurations: baseline, 3 MPF floors, 3 batteries, the 9
    MPF x battery pairs, 3 backstops alone, 6 battery+backstop stacks and
    9 MPF+battery+backstop stacks.  Backstop thresholds sit between the
    raw critical-bin amplitudes of the two fleets (about 0.45 MW and
    1.8 MW for the 1 s dense workload), so some rows escalate and some
    do not."""
    mpfs = {f"mpf{int(m * 100)}": api.GpuPowerSmoothing(
        mpf_frac=m, ramp_up_w_per_s=2000.0, ramp_down_w_per_s=2000.0)
        for m in (0.6, 0.75, 0.9)}
    bats = {
        "bat2MJ": api.RackBattery(capacity_j=2e6, max_discharge_w=1e6,
                                  max_charge_w=1e6),
        "bat8MJ": api.RackBattery(capacity_j=8e6, max_discharge_w=3e6,
                                  max_charge_w=3e6, switch_latency_s=0.01),
        "bat30MJ": api.RackBattery(capacity_j=3e7, max_discharge_w=6e6,
                                   max_charge_w=6e6),
    }
    backstops = {f"bs{t}": api.TelemetryBackstop(amp_threshold_w=t * 1e5)
                 for t in (3, 8, 15)}
    cfgs = {"none": None}
    cfgs.update({k: (m, None) for k, m in mpfs.items()})
    cfgs.update({k: (None, b) for k, b in bats.items()})
    cfgs.update({f"{km}+{kb}": (m, b) for km, m in mpfs.items()
                 for kb, b in bats.items()})
    cfgs.update({k: (None, s) for k, s in backstops.items()})
    cfgs.update({f"{kb}+{ks}": (None, api.Stack((b, s)))
                 for kb, b in bats.items()
                 for ks, s in list(backstops.items())[:2]})
    cfgs.update({f"{km}+{kb}+{ks}": (m, api.Stack((b, s)))
                 for km, m in mpfs.items() for kb, b in bats.items()
                 for ks, s in list(backstops.items())[1:2]})
    return cfgs


def build_study(api, workloads=None, fleets=FLEETS, configs=None,
                device="cuda"):
    periods = {"dense_1s": (1.0, False), "dense_1p5s": (1.5, False),
               "moe_2s": (2.0, True), "dense_3s": (3.0, False)}
    all_wl = {k: api.synthetic_timeline(p, 0.25, moe_notch=moe)
              for k, (p, moe) in periods.items()}
    cfgs = study_configs(api)
    specs = api.example_specs(JOB_MW)
    return api.Study(
        {k: all_wl[k] for k in (workloads or all_wl)}, fleets=list(fleets),
        configs={k: cfgs[k] for k in (configs or cfgs)},
        specs=[specs[n] for n in SPEC_NAMES], seeds=list(SEEDS),
        wave_cfg=api.WaveformConfig(dt=DT, steps=30, jitter_s=0.002),
        sample_chips=64, device=device)


class Capture:
    """Wrap each kernel wrapper where the main path looks it up, keeping
    copies of the arguments of its largest call and the escalation
    levels of every backstop row."""

    def __init__(self, torch):
        from repro_torch.core.smoothing import battery, gpu_floor
        from repro_torch.kernels.goertzel import ops
        self.torch = torch
        self.sites = [(gpu_floor, "gpu_floor_scan", "gpu_floor"),
                      (battery, "battery_scan", "battery"),
                      (ops, "sliding_monitor", "monitor"),
                      (ops, "escalation_scan", "escalation")]
        self.args = {}
        self.max_levels = []

    def __enter__(self):
        self.saved = [(mod, attr, getattr(mod, attr))
                      for mod, attr, _ in self.sites]
        for mod, attr, name in self.sites:
            setattr(mod, attr, self._wrap(getattr(mod, attr), name))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)

    def _wrap(self, fn, name):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            rows = args[0].shape[0]
            if name not in self.args or rows > self.args[name][0]:
                keep = tuple(a.clone() if isinstance(a, self.torch.Tensor)
                             else a for a in args)
                self.args[name] = (rows, keep, dict(kw))
            if name == "escalation":
                self.max_levels += out[1].amax(-1).tolist()
            return out
        return wrapped


# ---------------------------------------------------------------------------
# kernel checks and timings
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, repeat):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeat):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeat


def timed_once(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(nbytes_, nops):
    t_bytes = nbytes_ / PEAK_BYTES_S * 1e3
    t_ops = nops / PEAK_OPS_S * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_monitor(torch, cap, launches, freqs):
    import numpy as np
    from repro_torch.kernels.goertzel import monitor
    from repro_torch.kernels.goertzel.ref import sliding_bin_power_ref
    _, args, _ = cap.args["monitor"]
    xseg, cosp, sinp, rot, thr, rel, n, seg0, re0, im0 = args
    B, S, win = xseg.shape
    K = cosp.shape[0]
    got = monitor.sliding_monitor(*args)
    torch.cuda.synchronize()
    plain, plain_ms = timed_once(
        torch, lambda: monitor.sliding_monitor_plain(*args))
    scale = xseg.abs().amax(dim=(1, 2))                       # [B]
    err = ((got[0] - plain[0]).abs() / scale[:, None, None]).max().item()
    err_w = (got[0] - plain[0]).abs().max().item()
    peak_err = ((got[2] - plain[2]).abs()
                / scale[:, None, None]).max().item()
    tol = MONITOR_TOL * scale[:, None, None]
    near = (((plain[0] - thr[:, None, None]).abs() <= tol)
            | ((plain[0] - rel[:, None, None]).abs() <= tol))
    mismatch = got[1] != plain[1]
    off_band = int((mismatch & ~near).sum())
    log(f"monitor [{B} rows x {S} segments x {win}, K={K}]: max |worst - "
        f"plain| {err_w:.4g} W ({err:.3g} of the amplitude scale, tol "
        f"{MONITOR_TOL}); peaks {peak_err:.3g}; class mismatches off the "
        f"threshold band {off_band}, on it {int((mismatch & near).sum())}"
        f" (samples within tol of a threshold: {int(near.sum())})")
    if err > MONITOR_TOL or peak_err > MONITOR_TOL or off_band:
        raise AssertionError("monitor kernel disagrees with its plain "
                             "version")
    # chunked calls that pass the state on equal one call
    parts, re, im = [], re0, im0
    cuts = [0, S // 3, S // 3 + 1, S]
    for lo, hi in zip(cuts, cuts[1:]):
        out = monitor.sliding_monitor(
            xseg[:, lo:hi].contiguous(), cosp, sinp, rot, thr, rel, n,
            seg0 + lo, re, im)
        parts.append(out[:3])
        re, im = out[3], out[4]
    chunk_err = max(
        ((torch.cat([p[0] for p in parts], 1) - got[0]).abs()
         / scale[:, None, None]).max().item(),
        ((torch.cat([p[2] for p in parts], 1) - got[2]).abs()
         / scale[:, None, None]).max().item())
    bitwise = all(torch.equal(torch.cat([p[i] for p in parts], 1), got[i])
                  for i in range(3))
    log(f"monitor chunked state in/out ({len(cuts) - 1} calls) vs one "
        f"call: {chunk_err:.3g} of the amplitude scale, bitwise {bitwise}")
    if chunk_err > MONITOR_TOL:
        raise AssertionError("chunked monitor calls differ from one call")
    # against the float64 oracle, on two rows (the worst over bins)
    worst_oracle = 0.0
    for r in (0, B - 1):
        x = xseg[r].reshape(-1)[: int(n[r])].double().cpu().numpy()
        ref = sliding_bin_power_ref(x, DT, freqs, win)
        d = np.abs(got[0][r].reshape(-1)[: int(n[r])].cpu().numpy()
                   - ref.max(1)).max() / float(scale[r])
        worst_oracle = max(worst_oracle, d)
    log(f"monitor vs float64 oracle on 2 rows: {worst_oracle:.3g} of the "
        f"amplitude scale (tol {ORACLE_TOL})")
    if worst_oracle > ORACLE_TOL:
        raise AssertionError("monitor kernel disagrees with the float64 "
                             "oracle")
    ms = cuda_ms(torch, lambda: monitor.sliding_monitor(*args), 20)
    inputs = nbytes(xseg, cosp, sinp, rot, thr, rel, n, seg0, re0, im0)
    outputs = nbytes(*got)
    b_ms, b_by = bound(inputs + outputs, 21 * B * S * win * K)
    return {"name": "sliding_monitor", "route": "cuda",
            "source": "src/repro_torch/kernels/goertzel/csrc/monitor.cu",
            "replaces": "src/repro/kernels/goertzel/goertzel.py:340",
            "launches": launches["monitor"], "max_abs_err": err_w,
            "tolerance": f"{MONITOR_TOL} x amplitude scale",
            "class_mismatches_off_band": off_band,
            "near_threshold_samples": int(near.sum()),
            "chunked_bitwise": bitwise, "oracle_err": worst_oracle,
            "shape": [B, S, win, K], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library_note": "no single PyTorch call computes a sliding "
                            "windowed DFT reduced to a worst bin"}


def check_scan(torch, cap, launches, name):
    from repro_torch.core.smoothing import battery, gpu_floor
    from repro_torch.core import telemetry
    _, args, kw = cap.args[name]
    if name == "gpu_floor":
        kern, plain = gpu_floor.gpu_floor_scan, gpu_floor.gpu_floor_scan_plain
        w, params = args
        B, n = w.shape
        ops_per = 11
        src, rep = "gpu_floor.cu", "src/repro/core/smoothing/gpu_floor.py:85"
        tname = "gpu_floor_scan"
    elif name == "battery":
        kern, plain = battery.battery_scan, battery.battery_scan_plain
        w, params, _dt = args
        B, n = w.shape
        ops_per = 32
        src, rep = "battery.cu", "src/repro/core/smoothing/battery.py:96"
        tname = "battery_scan"
    else:
        kern = telemetry.escalation_scan
        plain = telemetry.escalation_scan_plain
        B, n = args[0].shape
        ops_per = 14
        src, rep = "escalation.cu", "src/repro/core/telemetry.py:212"
        tname = "escalation_scan"
    got = kern(*args, **kw)
    torch.cuda.synchronize()
    ref, plain_ms = timed_once(torch, lambda: plain(*args, **kw))
    if name == "escalation":
        mism = int((got[1] != ref[1]).sum()) + int((got[0] != ref[0]).sum())
        err, ok = float(mism), mism == 0
        tol = "exact"
        log(f"escalation [{B} rows x {n}]: level/carry mismatches {mism}; "
            f"rows escalating {int((got[1].amax(-1) > 0).sum())}/{B}")
    else:
        scale = args[0].abs().max().item()
        err = max((g - r).abs().max().item() for g, r in
                  zip(got if isinstance(got, tuple) else (got,),
                      ref if isinstance(ref, tuple) else (ref,)))
        ok = err <= SCAN_TOL * scale
        tol = f"{SCAN_TOL} x max|w| = {SCAN_TOL * scale:.4g} W"
        log(f"{name} [{B} rows x {n}]: max |kernel - plain| {err:.4g} "
            f"(tol {tol})")
    if not ok:
        raise AssertionError(f"{name} kernel disagrees with its plain "
                             "version")
    ms = cuda_ms(torch, lambda: kern(*args, **kw), 3)
    inputs = nbytes(*(a for a in args if isinstance(a, torch.Tensor)))
    outputs = nbytes(*(got if isinstance(got, tuple) else (got,)))
    b_ms, b_by = bound(inputs + outputs, ops_per * B * n)
    return {"name": tname, "route": "cuda",
            "source": f"src/repro_torch/kernels/scans/csrc/{src}",
            "replaces": rep, "launches": launches[name],
            "max_abs_err": err, "tolerance": tol, "shape": [B, n],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by,
            "limited_by": f"serial chain: {n} dependent steps per row",
            "library_ms": None,
            "library_note": "no single PyTorch call computes this "
                            "recurrence"}


# ---------------------------------------------------------------------------
# the Study, profiled, and its CPU subset
# ---------------------------------------------------------------------------

def profile_study(torch, study):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        study.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    if not events:
        events = list(prof.key_averages())

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, attr, None)
            if v is not None:
                return float(v)
        return 0.0

    events = [e for e in events if dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:12]
    return wall, busy, [(dev_us(e) / 1e3, e.count, e.key) for e in top]


def compare_cpu_subset(api, gpu_res):
    key = ("workload", "n_chips", "config", "seed", "spec")
    gpu = {tuple(r[k] for k in key): r for r in gpu_res}
    sub = build_study(api, workloads=["dense_1s", "dense_3s"],
                      fleets=(32768,),
                      configs=["none", "mpf75+bat8MJ", "bs8",
                               "mpf75+bat8MJ+bs8"], device="cpu")
    t0 = time.perf_counter()
    cpu_res = sub.run()
    secs = time.perf_counter() - t0
    specs = dict(zip(SPEC_NAMES, (s for _, s in sub.specs)))
    limit_of = {"max_ramp_up_w_per_s": "ramp_up_w_per_s",
                "max_ramp_down_w_per_s": "ramp_down_w_per_s",
                "dynamic_range_w": "dynamic_range_w",
                "band_energy_fraction": "max_energy_fraction",
                "ac_rms_frac": "min_ac_rms_frac"}
    worst, near, equal = 0.0, 0, 0
    for c in cpu_res:
        g = gpu[tuple(c[k] for k in key)]
        vals = [(k, c[k], g[k]) for k in (
            "mean_mw", "swing_mw", "swing_mitigated_mw", "energy_overhead",
            "paper_band_frac")]
        vals += [(k, v, g["metrics"][k]) for k, v in c["metrics"].items()]
        for k, a, b in vals:
            # means, sums and the ramp box are float64 on both devices and
            # the scans bitwise equal: no absolute allowance but the energy's
            atol = 1e-6 if k == "energy_overhead" else 0.0
            if abs(a - b) > STUDY_RTOL * abs(b) + atol:
                raise AssertionError(f"cpu vs card: {k} {a} vs {b} in {c}")
            worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
        lim = specs[c["spec"]].limits()
        if any(abs(v - lim[limit_of[k]]) <= STUDY_RTOL * abs(lim[limit_of[k]])
               for k, v in g["metrics"].items() if k in limit_of):
            near += 1
            continue
        if (c["spec_ok"], tuple(c["violations"])) != (
                g["spec_ok"], tuple(g["violations"])):
            raise AssertionError(f"cpu vs card verdicts differ: {c} {g}")
        equal += 1
    log(f"cpu re-run of {sub.n_rows} rows: {secs:.1f} s; verdicts equal on "
        f"{equal} records, {near} near-limit records not compared; worst "
        f"metric rel diff {worst:.3g} (rtol {STUDY_RTOL}, energy_overhead "
        "abs 1e-6)")


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import_port()
    from repro_torch import api
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {name} x "
        f"{torch.cuda.device_count()}")
    log(smi)

    # 1. build every kernel, one nvcc per source, all started together
    secs = build.build_all()
    log("kernel build seconds: " + json.dumps(secs))
    for k in build.KERNELS:
        lines = [ln.strip() for ln in k.ptxas_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"ptxas {k.name}: " + " | ".join(lines))

    # 2. the main path: a full-size Study on the card, launch counts from 0
    study = build_study(api)
    log(study.describe() + ", device=cuda")
    cap = Capture(torch)
    build.reset_launch_counts()
    with cap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = study.run()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
    counts = build.launch_counts()
    launches = {"monitor": counts["monitor"], "gpu_floor": counts["gpu_floor"],
                "battery": counts["battery"],
                "escalation": counts["escalation"]}
    log("launches in the Study run: " + json.dumps(launches))
    if min(launches.values()) <= 0:
        raise AssertionError("a kernel of the main path was not launched")

    # 3-4. each kernel against its plain version at the main path's shapes
    kernels = [check_monitor(torch, cap, launches,
                             api.TelemetryBackstop().critical_hz)]
    for nm in ("gpu_floor", "battery", "escalation"):
        kernels.append(check_scan(torch, cap, launches, nm))
    for k in kernels:
        log(f"{k['name']}: {k['ms']:.4g} ms (plain {k['plain_ms']:.4g} ms, "
            f"bound {k['bound_ms']:.4g} ms by {k['bound_by']}), "
            f"{k['launches']} launches per Study")

    # 5. the Study's results, warm time and device profile
    t0 = time.perf_counter()
    res_warm = study.run()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    rows = study.n_rows
    log(f"study: cold {cold:.3f} s (argument captures included), warm "
        f"{warm:.3f} s wall, "
        f"{rows / warm:.2f} rows/s, {len(res) / warm:.2f} records/s")
    verdicts = {sp: collections.Counter(
        "pass" if r["spec_ok"] else "fail" for r in res.filter(spec=sp))
        for sp in SPEC_NAMES}
    log("verdicts: " + json.dumps(verdicts))
    hist = collections.Counter(int(v) for v in cap.max_levels)
    log("backstop max_level histogram (rows): "
        + json.dumps(dict(sorted(hist.items()))))
    if not (hist.get(0, 0) and sum(v for k, v in hist.items() if k > 0)):
        raise AssertionError("the backstop should escalate on some rows "
                             "and not on others")
    if any(a["spec_ok"] != b["spec_ok"] for a, b in zip(res, res_warm)):
        raise AssertionError("the warm run's verdicts differ from the cold")
    wall, busy, top = profile_study(torch, study)
    log(f"profiled run {wall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}% of the traced wall)")
    for ms, cnt, key in top:
        log(f"  {ms:10.3f} ms {cnt:6d}x {key[:110]}")
    for r in res:
        vals = [r["mean_mw"], r["swing_mitigated_mw"], r["energy_overhead"]]
        vals += list(r["metrics"].values())
        if not all(v == v and abs(v) != float("inf") for v in vals):
            raise AssertionError(f"non-finite metric in {r}")

    # 6. a subset of the same Study on the CPU (the plain versions)
    compare_cpu_subset(api, res)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
