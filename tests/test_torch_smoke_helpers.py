"""Helpers of ``chip_smoke.py`` that need no card: the ``ptxas -v``
summary it prints for kernels F and C."""
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(SPEC)
SPEC.loader.exec_module(chip_smoke)

LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN11flash_wgmma18flash_wgmma_kernelILi2ELi128EEEv14CUtensorMap_stS1_PK13__nv_bfloat16PS2_iiiiiiifii' for 'sm_90a'
ptxas info    : Function properties for _ZN11flash_wgmma18flash_wgmma_kernelILi2ELi128EEEv14CUtensorMap_stS1_PK13__nv_bfloat16PS2_iiiiiiifii
    88 bytes stack frame, 184 bytes spill stores, 156 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 88 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114battery_kernelEPKfS1_fPfS2_S2_x' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114battery_kernelEPKfS1_fPfS2_S2_x
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 0 barriers, 8192 bytes smem
"""


class _Kernel:
    ptxas_log = LOG


def test_ptxas_summary_reads_registers_shared_memory_and_spills():
    out = chip_smoke.ptxas_summary(_Kernel())
    assert list(out) == [
        "_ZN11flash_wgmma18flash_wgmma_kernelILi2ELi128EEEv14CUtensorMap_stS1_"
        "PK13__nv_bfloat16PS2_iiiiiiifii",
        "_ZN12_GLOBAL__N_114battery_kernelEPKfS1_fPfS2_S2_x"]
    f, c = out.values()
    assert f == {"registers": 168, "smem_static": 0, "spill_stores": 184,
                 "spill_loads": 156}
    assert c == {"registers": 72, "smem_static": 8192, "spill_stores": 0,
                 "spill_loads": 0}


def test_ptxas_summary_of_an_empty_log_is_empty():
    class Empty:
        ptxas_log = ""
    assert chip_smoke.ptxas_summary(Empty()) == {}


def test_sass_opcode_counts_reads_opcodes_past_predicates():
    sass = """
        /*0a70*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4].tnspB, RZ, !UPT ;
        /*0a80*/                   UTMALDG.4D [UR8], [UR16] ;
        /*1a090*/              @P0  SYNCS.ARRIVE.TRANS64.RED.A1T0 RZ, [UR6], RZ ;
        /*1a0a0*/             @!UP1 HGMMA.64x64x16.F32.BF16 R56, R8, gdesc[UR12], R56 ;
        /*1a0b0*/                   MOV R1, c[0x0][0x28] ;
    """
    assert chip_smoke.sass_opcode_counts(
        sass, ("HGMMA", "UTMALDG", "SYNCS", "LDGSTS")) == {
            "HGMMA": 2, "UTMALDG": 1, "SYNCS": 1, "LDGSTS": 0}


class _Event:
    def __init__(self, key, us, count, attr="self_device_time_total"):
        self.key, self.count = key, count
        setattr(self, attr, us)


def test_kernel_device_ms_sums_the_named_kernels_over_their_launches():
    events = [
        _Event("void (anonymous namespace)::monitor_kernel(float const*)",
               300.0, 20),
        _Event("(anonymous namespace)::escalation_kernel(signed char*)",
               90.0, 10, attr="self_cuda_time_total"),
        _Event("aten::copy_", 50.0, 4),
        _Event("monitor_kernel_idle", 0.0, 3)]
    assert chip_smoke.kernel_device_ms(events, "monitor_kernel") == 0.015
    assert chip_smoke.kernel_device_ms(events, "escalation_kernel") == 0.009
    assert chip_smoke.kernel_device_ms(events, "sliding_kernel") is None


def test_chain_step_and_floor_arithmetic():
    cyc, ns = chip_smoke.chain_step(2_048_000, 1.0, 204_800)
    assert (cyc, ns) == (10.0, 1e6 / 204_800)
    floors = chip_smoke.chain_floor_ms(10.0, {"study": [240, 90000],
                                              "tick": [1, 250]})
    assert floors == {"study": 0.9, "tick": 0.0025}


def _plain_pair(seed=0, B=2, n=900, win=256, K=3):
    """Kernel A's and E's plain outputs on the same seeded operands."""
    import numpy as np
    import torch
    from repro_torch.kernels.goertzel import monitor, ops, sliding
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((B, n)).astype(np.float32))
    xseg = ops.segments(x, win)
    cosp, sinp, rot = (torch.as_tensor(t) for t in
                       ops.phase_tables((0.5, 1.0, 2.0)[:K], 0.01, win))
    zeros = torch.zeros((B, K, win))
    seg0 = torch.tensor([0, 2])[:B]
    n_live = seg0 * win + n
    thr = torch.full((B,), 0.5)
    a = monitor.sliding_monitor(xseg, cosp, sinp, rot, thr, thr, n_live,
                                seg0, zeros, zeros)
    e = sliding.sliding_bin_power_v2(xseg, cosp, sinp, rot, seg0, zeros,
                                     zeros)
    return a, e, n_live, seg0


def test_witness_compare_holds_on_the_plain_versions():
    import torch
    a, e, n_live, seg0 = _plain_pair()
    gaps, equal = chip_smoke.witness_compare(torch, a, e, n_live, seg0)
    assert equal and gaps == {"worst": 0.0, "peaks": 0.0, "nre": 0.0,
                              "nim": 0.0}


@pytest.mark.parametrize("out", [0, 2, 3, 4])
def test_witness_compare_sees_one_ulp_in_each_output(out):
    """One float32 ulp moved in A's worst, peaks, nre or nim breaks the
    bitwise verdict, and the gap names that output."""
    import torch
    a, e, n_live, seg0 = _plain_pair()
    a = list(a)
    t = a[out].clone().reshape(-1)
    i = int(t.abs().argmax())
    t[i] = torch.nextafter(t[i], torch.tensor(float("inf")))
    a[out] = t.reshape(a[out].shape)
    gaps, equal = chip_smoke.witness_compare(torch, a, e, n_live, seg0)
    name = {0: "worst", 2: "peaks", 3: "nre", 4: "nim"}[out]
    assert not equal and gaps[name] > 0
    assert all(v == 0.0 for k, v in gaps.items() if k != name)


@pytest.mark.parametrize("recorded_on,want", [(0, 0.015), (2, 0.015),
                                              (4, 0.015), (None, None)])
def test_device_ms_profiles_again_then_reports_not_measured(
        monkeypatch, recorded_on, want):
    """A profile that records no launch of the kernel is taken again (from
    the third time on with device activity alone), five times in all;
    when none records one, the device time is None, not a failure."""
    import torch
    profiles = []

    class FakeProfile:
        def __init__(self, activities):
            self.activities = activities
            profiles.append(self)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            if len(profiles) - 1 == recorded_on:
                return [_Event("(anonymous namespace)::monitor_kernel()",
                               300.0, 20)]
            return [_Event("aten::copy_", 50.0, 4)]

    class FakeTorch:
        class cuda:
            @staticmethod
            def synchronize():
                pass

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    calls = []
    got = chip_smoke.device_ms(FakeTorch, lambda: calls.append(1),
                               "monitor_kernel", repeat=20)
    assert got == want
    assert len(profiles) == (5 if recorded_on is None else recorded_on + 1)
    assert len(calls) == 1 + 20 * len(profiles)
    for p in profiles[2:]:
        assert p.activities == [torch.profiler.ProfilerActivity.CUDA]


def test_kernel_device_total_sums_time_and_launches():
    events = [
        _Event("(anonymous namespace)::gpu_floor_kernel(float const*)",
               600.0, 30),
        _Event("void (anonymous namespace)::ballast_cluster_kernel<256, 2>",
               900.0, 3),
        _Event("ballast_kernel<float, float>", 300.0, 1),
        _Event("gpu_floor_kernel_idle", 0.0, 2)]
    assert chip_smoke.kernel_device_total(events, "gpu_floor_kernel") == (
        0.6, 30)
    assert chip_smoke.kernel_device_total(events, "ballast") == (1.2, 4)
    assert chip_smoke.kernel_device_total(events, "sliding") == (0.0, 0)


def test_shape_counts_keeps_first_call_order():
    import torch
    calls = [(torch.zeros(24, 8), None), (torch.zeros(1, 5), None),
             (torch.zeros(24, 8), None)]
    assert chip_smoke.shape_counts(calls) == {"24 x 8": 2, "1 x 5": 1}


def _floor_params(rows, params):
    import torch
    return torch.tensor([params] * rows, dtype=torch.float32)


def test_floor_targets_equal_the_plain_loops_targets():
    """The closed-form counter's targets against the f32 recurrence of the
    plain step, on samples with ties at the threshold and a fractional
    stop delay."""
    import numpy as np
    import torch
    rng = np.random.default_rng(4)
    w = torch.as_tensor(rng.choice(np.float32([0, 100, 350, 351, 900]),
                                   (3, 700)))
    p = _floor_params(3, [700.0, 350.0, 5.0, 3.0, 12.5, 800.0])
    got = chip_smoke.floor_targets(torch, w, p)
    idle = torch.zeros(3)
    for i in range(w.shape[1]):
        v = w[:, i]
        idle = torch.where(v > 350.0, torch.zeros(3), idle + 1.0)
        floor = torch.where(idle <= 12.5, torch.full((3,), 700.0),
                            torch.zeros(3))
        want = torch.minimum(torch.maximum(v, floor), torch.tensor(800.0))
        assert torch.equal(got[:, i], want)


def test_merge_profile_counts_meets_and_misses():
    """A constant row at its own target merges every segment at its first
    step; a row whose ramps never reach the target (ramps of 0) merges
    none but the first segment, whose own first target is its true
    start."""
    import torch
    from repro_torch.core.smoothing.gpu_floor import gpu_floor_scan_plain
    w = torch.full((2, 300), 500.0)
    p = _floor_params(2, [0.0, 350.0, 5.0, 3.0, 10.0, 900.0])
    out = gpu_floor_scan_plain(w, p)
    assert chip_smoke.merge_profile(torch, w, p, out) == {
        "segments": 10, "merged_at_0": 10, "longest_merge": 0,
        "unmerged": 0}
    w = torch.arange(300, dtype=torch.float32)[None] * 3.0
    p = _floor_params(1, [0.0, 1e9, 0.0, 0.0, 0.0, 1e9])
    out = gpu_floor_scan_plain(w, p)
    got = chip_smoke.merge_profile(torch, w, p, out)
    assert got == {"segments": 5, "merged_at_0": 1, "longest_merge": 0,
                   "unmerged": 4}


def test_merge_profile_finds_a_late_merge():
    """Ramps of 1 W a step from 0 to a target of 10: a speculative walk
    started at the target meets the true one 9 steps in."""
    import torch
    from repro_torch.core.smoothing.gpu_floor import gpu_floor_scan_plain
    w = torch.cat([torch.zeros(64), torch.full((64,), 10.0)])[None]
    p = _floor_params(1, [0.0, 1e9, 1.0, 1.0, 0.0, 1e9])
    out = gpu_floor_scan_plain(w, p)
    got = chip_smoke.merge_profile(torch, w, p, out)
    assert got == {"segments": 2, "merged_at_0": 1, "longest_merge": 9,
                   "unmerged": 0}


def test_floor_floors_arithmetic():
    merges = {"segments": 10, "merged_at_0": 9, "longest_merge": 7,
              "unmerged": 0}
    serial, seg = chip_smoke.floor_floors(10.0, 90000, merges)
    assert serial == 0.9
    assert seg == 10.0 * 44 * (64 + 8) / 1e6
    assert chip_smoke.floor_floors(10.0, 4000, dict(merges, unmerged=1)) == (
        0.04, None)


@pytest.mark.parametrize("kind", ["no_merge", "edges"])
def test_floor_rows_are_seeded_and_do_what_they_say(monkeypatch, kind):
    import torch
    from repro_torch.core.smoothing.gpu_floor import gpu_floor_scan_plain
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    w, p = chip_smoke.floor_rows(torch, kind, 3000, 22)
    w2, p2 = chip_smoke.floor_rows(torch, kind, 3000, 22)
    assert torch.equal(w, w2) and torch.equal(p, p2)
    assert w.shape == (1, 3000) and p.shape == (1, 6)
    out = gpu_floor_scan_plain(w, p)
    merges = chip_smoke.merge_profile(torch, w, p, out)
    assert merges["unmerged"] >= merges["segments"] - 1
    if kind == "edges":
        assert (w == 350.0).sum() >= 3000 // 7       # ties at the threshold
        assert float(p[0, 4]) % 1 and float(p[0, 5]) < float(p[0, 0])
        assert torch.equal(out, torch.full_like(out, float(w[0, 0])))


def test_floor_plain_runs_where_asked():
    import torch
    w = torch.rand(2, 50) * 1000
    p = _floor_params(2, [700.0, 350.0, 5.0, 3.0, 10.0, 900.0])
    ref, ms = chip_smoke.floor_plain(torch, w, p, on_cpu=True)
    from repro_torch.core.smoothing.gpu_floor import gpu_floor_scan_plain
    assert torch.equal(ref, gpu_floor_scan_plain(w, p)) and ms >= 0


def test_floor_calls_in_captures_the_canonical_loops_calls():
    """The canonical 48 s loop on the CPU: kernel B's four design calls,
    [24 x 4000] each, cloned as they were made."""
    import torch
    from repro_torch import api, control
    w, dt = chip_smoke.control_trace(control)
    calls = chip_smoke.floor_calls_in(torch, control, api, w, dt,
                                      device="cpu")
    assert chip_smoke.shape_counts(calls) == {"24 x 4000": 4}
    assert all(p.shape == (24, 6) and p.dtype == torch.float32
               for _, p in calls)


def test_dense_multiplier_is_orthogonal_times_0999(monkeypatch):
    import torch
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    b = chip_smoke.dense_multiplier(torch, 64, 3)
    eye = (b.double().T @ b.double()) / 0.999 ** 2
    assert torch.allclose(eye, torch.eye(64, dtype=torch.float64),
                          atol=1e-5)
    assert torch.equal(b, chip_smoke.dense_multiplier(torch, 64, 3))


def test_loop_summary_reads_dispatches_and_lead():
    class Log:
        def __init__(self, lats, lead):
            self.lats, self.lead = lats, lead

        def dispatch_latencies(self):
            return self.lats

        def summary(self):
            return {"detection_lead_s": self.lead}

    got = chip_smoke.loop_summary(Log([0.004, 0.002, 0.010], 24.0))
    assert got == {"dispatches": 3, "dispatch_p50_ms": 4.0,
                   "dispatch_max_ms": 10.0, "detection_lead_s": 24.0}
    assert chip_smoke.loop_summary(Log([], None)) == {
        "dispatches": 0, "dispatch_p50_ms": None, "dispatch_max_ms": None,
        "detection_lead_s": None}


def test_call_device_ms_sums_every_kernel_per_call(monkeypatch):
    """Every device kernel a call launches counts, each by its mean over
    its recorded launches (a dropped launch moves no mean); host events
    (marked CPU) do not, even with a device time."""
    import torch

    class Dev:
        def __init__(self, key, us, count, device_type):
            self.key, self.count = key, count
            self.self_device_time_total = us
            self.device_type = device_type

    class FakeProfile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [Dev("transpose_tables(float const*)", 40.0, 20,
                        "DeviceType.CUDA"),
                    Dev("sliding_v1_kernel(float const*)", 234.0, 18,
                        "DeviceType.CUDA"),
                    Dev("aten::empty", 300.0, 20, "DeviceType.CPU")]

    class FakeTorch:
        class cuda:
            @staticmethod
            def synchronize():
                pass

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    got = chip_smoke.call_device_ms(FakeTorch, lambda: None, "kernel I",
                                    repeat=20)
    assert got == pytest.approx(0.015)


def test_e_operands_take_a_monitor_calls_operands():
    import torch
    a = chip_smoke.variant_operands(torch, 2, 3, 101, 3, dev="cpu")
    e = chip_smoke.e_operands(a)
    xseg, cosp, sinp, rot, thr, rel, n, seg0, re0, im0 = a
    assert all(x is y for x, y in zip(e, (xseg, cosp, sinp, rot, seg0, re0,
                                          im0)))
    assert torch.equal(rel, thr * 0.6) and int(seg0[0]) == 0
    # seeded: the same operands again
    b = chip_smoke.variant_operands(torch, 2, 3, 101, 3, dev="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _trace(n, seed=3):
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(n) * 0.002
    return (5e8 + 4e7 * np.sin(2 * np.pi * 2.0 * t)
            + 1e5 * rng.standard_normal(n)).astype(np.float32)


def test_sliding_args_are_the_offline_calls_operands():
    """Kernel E on ``sliding_args`` is ``ops.sliding_bin_power`` on the
    trace, bit for bit (the plain versions here)."""
    import torch
    from repro_torch.core.spectrum import GRID_CRITICAL_HZ
    from repro_torch.kernels.goertzel import ops, sliding
    w = _trace(4500)
    args = chip_smoke.sliding_args(torch, w, 0.002, device="cpu")
    assert tuple(args[0].shape) == (1, 3, 2000)
    amps = sliding.sliding_bin_power_v2(*args)[0].reshape(-1, 7)[:len(w)]
    want = ops.sliding_bin_power(torch.as_tensor(w), 0.002,
                                 GRID_CRITICAL_HZ, win=2000)
    assert torch.equal(amps, want)


def test_v1_operands_times_the_scale_equal_kernel_e(monkeypatch):
    """Kernel I on phase 15's operands, warm-up scaled, equals kernel E on
    the same trace bit for bit: the CPU side of the bitwise gate."""
    import torch
    from repro_torch.core.telemetry import warmup_scale
    from repro_torch.kernels.goertzel import sliding, sliding_v1
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    w = _trace(9000, seed=4)
    xseg, tabs = chip_smoke.v1_operands(torch, w, 0.001)
    S, win = xseg.shape
    assert (S, win) == (3, 4000) and tabs[0].shape == (4000, 7)
    v1 = sliding_v1.sliding_goertzel_v1(xseg, *tabs)
    e = sliding.sliding_bin_power_v2(
        *chip_smoke.sliding_args(torch, w, 0.001, device="cpu"))[0][0]
    scaled = v1 * warmup_scale(torch.arange(S * win), win).reshape(S, win, 1)
    assert torch.equal(scaled, e)


def test_sliding_geometry_is_the_route():
    from repro_torch.kernels.goertzel import sliding
    got = chip_smoke.sliding_geometry(4000, 7)
    assert got == sliding.sliding_route(4000, 7)._asdict()
    assert got["resident"] and got["cluster"] == 7


def test_bin_power_calls_keep_each_windows_call(monkeypatch):
    import torch
    from repro_torch.kernels.goertzel import ops
    monkeypatch.setattr(ops, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    w = _trace(8000, seed=5)
    traces = chip_smoke.phase15_traces(w, 0.002, w, 0.002)
    assert len(traces["day"][0]) == 144 * 8000
    traces = {k: (x[:4100], d, 1000) for k, (x, d, _) in traces.items()}
    amps, calls = chip_smoke.bin_power_calls(traces)
    assert list(amps) == ["600s", "600s_tail", "ramp48", "day"]
    assert len(calls) == 4
    for (wnd, coef, block_w, raw), got in zip(calls, amps.values()):
        assert wnd.shape == (8, 1000) and coef.shape == (7,) and block_w == 8
        assert raw.shape == (8, 7) and got.shape == (5, 7)
    assert ops.goertzel_windows.__name__ == "goertzel_windows"


def test_keyed_study_shape_and_structure_groups():
    """Phase 16's Study: eight configs, 128 rows and 256 records, four
    call streams (the noise-free Firefly rows and the baseline share one
    with the Firefly + battery rows), and the CPU subset's 16 rows."""
    from repro_torch import api
    from repro_torch.core.study import _structure_groups
    study = chip_smoke.build_keyed_study(api, device="cpu")
    assert len(study.configs) == 8 and study.n_rows == 128
    assert len(study) == 256 and study.key is not None
    assert len(_structure_groups(study.rows())) == 4
    sel = [r for r, (w, n, c, s) in enumerate(study.rows())
           if w in chip_smoke.KEYED_CPU_ROWS["workloads"]
           and n in chip_smoke.KEYED_CPU_ROWS["fleets"]
           and c.name in chip_smoke.KEYED_CPU_ROWS["configs"]]
    assert len(sel) == 16
    assert chip_smoke.build_keyed_study(api, key=None,
                                        device="cpu").scenario_key(0) is None


def test_columns_equal_is_bitwise_with_nan():
    import numpy as np
    from repro_torch.core.study import StudyResult

    def result(x, name="a"):
        return StudyResult({"index": np.arange(2), "v": np.asarray(x),
                            "config": np.asarray([name, "b"], object)})
    assert chip_smoke.columns_equal(result([1.0, np.nan]),
                                    result([1.0, np.nan])) == []
    assert chip_smoke.columns_equal(result([1.0, np.nan]),
                                    result([1.0, 2.0])) == ["v"]
    assert chip_smoke.columns_equal(result([0.0, 1.0]),
                                    result([-0.0, 1.0])) == []
    assert chip_smoke.columns_equal(result([1.0, 1.0]),
                                    result([1.0, 1.0], "c")) == ["config"]


# ---------------------------------------------------------------------------
# phases 17 and 18: the serial reference and the design path
# ---------------------------------------------------------------------------

def test_near_limit_reads_each_metric_against_its_limit():
    from repro_torch import api
    spec = api.example_specs(1.0)["moderate"]
    lim = spec.limits()
    assert chip_smoke.near_limit(
        spec, {"max_ramp_up_w_per_s": lim["ramp_up_w_per_s"] * (1 + 5e-5)})
    assert not chip_smoke.near_limit(
        spec, {"max_ramp_up_w_per_s": lim["ramp_up_w_per_s"] * 1.01,
               "band_bin_amplitude_w": 1.0})
    assert chip_smoke.near_limit(spec, {"ac_rms_frac": 0.005})


def test_study_rows_of_the_serial_phase_exist_and_the_longest_is_unpadded():
    from repro_torch import api
    study = chip_smoke.build_study(api, device="cpu")
    assert chip_smoke.study_max_len(study) == 90_000
    seen = set()
    for key in chip_smoke.SERIAL_ROWS:
        r = chip_smoke.study_row_index(study, key)
        w, n, c, s = study.rows()[r]
        assert (w, n, c.name, s) == key
        seen.add(r)
    assert len(seen) == len(chip_smoke.SERIAL_ROWS)
    longest = max(study.workloads, key=lambda k: study.workloads[k].period_s)
    assert longest == chip_smoke.DESIGN_WORKLOAD == "dense_3s"
    assert chip_smoke.build_study(api, device="cpu",
                                  keep_waveforms=True).keep_waveforms


def test_relaxed_capture_keeps_the_first_call_and_times_descents():
    """``Capture`` keeps J's first and last calls with the most rows, times
    ``_design_descend`` and copies the gradients that reach
    ``clip_by_global_norm``; it puts every wrapped function back."""
    import torch
    from repro_torch.core import engine
    from repro_torch.core.smoothing import gpu_floor
    cap = chip_smoke.Capture(torch)
    w = torch.rand(2, 50) * 700
    params = torch.tensor([[350.0, 245.0, 2.0, 2.0, 100.0, 700.0]] * 3)
    saved = {a: getattr(m, a) for m, a, _ in cap.sites}
    with cap:
        a = gpu_floor.gpu_floor_relaxed(w, params[:2], 0.05, 700.0)
        gpu_floor.gpu_floor_relaxed(torch.cat([w, w]) [:3] * 2, params,
                                    0.05, 700.0)
        gpu_floor.gpu_floor_relaxed(w[:1], params[:1], 0.05, 700.0)
        gpu_floor.gpu_floor_relaxed(torch.cat([w, w])[:3] * 3, params,
                                    0.05, 700.0)
        assert engine._design_descend is not saved["_design_descend"]
        g = {"mpf": torch.tensor([3.0, 0.0]), "cap": torch.tensor([4.0, 1.0])}
        clipped, _ = engine.clip_by_global_norm(g, 1.0, batch_dims=1)
        g["mpf"] += 1.0
    for m, attr, _ in cap.sites:
        assert getattr(m, attr) is saved[attr]
    rows, got, _ = cap.args["gpu_floor_relaxed"]
    assert rows == 3 and torch.equal(got[0], torch.cat([w, w])[:3] * 2)
    assert got[2:] == (0.05, 700.0)
    rows, got, _ = cap.last["gpu_floor_relaxed"]
    assert rows == 3 and torch.equal(got[0], torch.cat([w, w])[:3] * 3)
    assert [list(x) for x in cap.grads] == [["mpf", "cap"]]
    assert cap.grads[0]["mpf"].tolist() == [3.0, 0.0]
    assert torch.allclose(clipped["mpf"], torch.tensor([0.6, 0.0]))
    assert torch.equal(a, gpu_floor.gpu_floor_relaxed_plain(
        w, params[:2], 0.05, 700.0))


def _jk_args(torch, name, rows=3, n=40):
    gen = torch.Generator().manual_seed(5)
    w = 500.0 + 300.0 * torch.rand(rows, n, generator=gen)
    if name == "gpu_floor_relaxed":
        params = torch.tensor([[350.0, 245.0, 2.0, 2.0, 100.0, 700.0]] * rows)
        return (w, params, 0.05, 700.0)
    params = torch.tensor([[0.01, 2.0, 1e3, 100.0, 100.0, 300.0, 250.0,
                            0.95, 500.0, 650.0, 275.0]] * rows)
    return (w, params, 0.01, 0.05)


@pytest.mark.parametrize("name", ["gpu_floor_relaxed", "battery_relaxed"])
def test_jk_fields_gate_each_parameter_column_on_its_own_scale(
        name, monkeypatch):
    """A column 1e-5 of the largest gradient that is wholly wrong fails the
    gate, though a gate on the whole gradient's max would pass it (2e-5
    of that max, under ``JK_TOL``); a zero column must stay exactly
    zero."""
    import torch
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    args = _jk_args(torch, name)
    grads = chip_smoke.jk_grads(torch, name, args[0].shape)
    ref = chip_smoke.jk_pass(torch, name, args, grads, True)
    cols = chip_smoke.jk_columns(name)
    fields = chip_smoke.jk_fields(torch, name, ref[:3], ref[:3])
    assert set(fields) == ({"out"} if name == "gpu_floor_relaxed" else
                           {"grid", "soc"}) | {"d_w"} | {f"d_{c}"
                                                        for c in cols}
    assert all(f["abs"] == 0.0 and f["rel"] == 0.0 for f in fields.values())
    chip_smoke.jk_gate(name, fields, "here")
    top = float(ref[2].abs().max())
    small = torch.zeros_like(ref[2])
    small[:, 1] = top * 1e-5       # the second column: small, all wrong
    for c in range(ref[2].shape[1]):
        if c != 1:
            small[:, c] = ref[2][:, c]
    bad = (ref[0], ref[1], small)
    wrong = (ref[0], ref[1], small.clone())
    wrong[2][:, 1] = -wrong[2][:, 1]
    f = chip_smoke.jk_fields(torch, name, wrong, bad)
    assert f[f"d_{cols[1]}"]["rel"] == 2.0
    assert chip_smoke.jk_summary(f)["worst_grad"] == f"d_{cols[1]}"
    whole = float((wrong[2] - bad[2]).abs().max()) / float(
        bad[2].abs().max())
    assert whole < chip_smoke.JK_TOL   # a whole-gradient gate passes it
    with pytest.raises(AssertionError, match=f"d_{cols[1]}"):
        chip_smoke.jk_gate(name, f, "here")
    zero = (ref[0], ref[1], small.clone())
    zero[2][:, 1] = 0.0
    tiny = (ref[0], ref[1], zero[2].clone())
    tiny[2][0, 1] = 1e-30
    f = chip_smoke.jk_fields(torch, name, tiny, zero)
    assert f[f"d_{cols[1]}"]["rel"] == float("inf")
    with pytest.raises(AssertionError):
        chip_smoke.jk_gate(name, f, "here")


def test_jk_bound_counts_inputs_and_outputs_only():
    """J moves 8 bytes a sample forward and 12 back, K 12 and 16, each
    plus the parameters (read, and written back by the adjoint); the
    carries the forward saves are reported apart."""
    B, n = 6, 90_000
    for name, per, cols in (("gpu_floor_relaxed", 8, 6),
                            ("gpu_floor_relaxed_adjoint", 12, 6),
                            ("battery_relaxed", 12, 11),
                            ("battery_relaxed_adjoint", 16, 11)):
        moves = 2 if name.endswith("_adjoint") else 1
        assert chip_smoke.jk_bound(name, B, n, cols) == chip_smoke.bound(
            per * B * n + 4 * moves * B * cols,
            chip_smoke.JK_OPS[name] * B * n)
        assert chip_smoke.JK_SAVED_BYTES[name] > 0


@pytest.mark.parametrize("name", ["gpu_floor_relaxed", "battery_relaxed"])
def test_jk_full_checks_run_the_plain_version_in_a_worker(name, tmp_path):
    """``jk_full_start`` saves a call's inputs and starts ``chip_smoke.py
    --jk-plain`` on them; ``jk_full_finish`` gates its result field by
    field and leaves no process running.  On CPU tensors both sides are
    the plain version, so they agree exactly."""
    import torch
    old = chip_smoke.DEVICE
    chip_smoke.DEVICE = "cpu"
    try:
        args = _jk_args(torch, name, rows=2, n=30)
        jobs = chip_smoke.jk_full_start(torch, {(name, "first"): args},
                                        str(tmp_path))
        out = chip_smoke.jk_full_finish(torch, jobs, wait_s=120.0)
    finally:
        chip_smoke.DEVICE = old
    assert all(j["proc"].poll() is not None for j in jobs)
    c = out[(name, "first")]
    assert c["shape"] == [2, 30] and c["out_abs"] == c["grad_abs"] == 0.0
    assert c["plain_cpu_fwd_ms"] > 0 and c["plain_cpu_bwd_ms"] > 0
    assert c["worst_grad"].startswith("d_")


def test_jk_full_finish_reports_a_failed_worker(tmp_path):
    import torch
    old = chip_smoke.DEVICE
    chip_smoke.DEVICE = "cpu"
    try:
        args = _jk_args(torch, "gpu_floor_relaxed", rows=2, n=10)
        jobs = chip_smoke.jk_full_start(
            torch, {("gpu_floor_relaxed", "first"): args}, str(tmp_path))
        jobs[0]["proc"].wait()
        (tmp_path / "gpu_floor_relaxed_first.out.pt").unlink()
        jobs[0]["stem"] = str(tmp_path / "missing")
        with pytest.raises(Exception):
            chip_smoke.jk_full_finish(torch, jobs, wait_s=60.0)
    finally:
        chip_smoke.DEVICE = old
    assert jobs[0]["proc"].poll() is not None


@pytest.mark.parametrize("name", ["gpu_floor_relaxed", "battery_relaxed"])
def test_jk_check_on_the_cpu_compares_the_plain_version_with_itself(name):
    """On CPU tensors the wrapper takes the plain version, so the check's
    two sides agree exactly; its cut, shapes and fields are the ones the
    card's run reports."""
    import torch
    old = chip_smoke.DEVICE
    chip_smoke.DEVICE = "cpu"
    try:
        w = 500.0 + 300.0 * torch.rand(3, 40)
        if name == "gpu_floor_relaxed":
            params = torch.tensor([[350.0, 245.0, 2.0, 2.0, 100.0,
                                    700.0]] * 3)
            args = (w, params, 0.05, 700.0)
        else:
            params = torch.tensor([[0.01, 0.0, 1e3, 100.0, 100.0, 300.0,
                                    250.0, 0.95, 500.0, 650.0, 275.0]] * 3)
            args = (w, params, 0.01, 0.05)
        got = chip_smoke.jk_check(torch, name, args)
    finally:
        chip_smoke.DEVICE = old
    assert got["shape"] == [3, 40]
    assert got["out_abs"] == got["grad_abs"] == 0.0
    assert got["plain_fwd_ms"] > 0 and got["plain_bwd_ms"] > 0


def test_jk_rows_carry_every_key_of_the_kernels_line():
    chain = {"o": {"cycles_per_step": 55.0, "ns_per_step": 27.8,
                   "readings": [55.0] * 5}}
    timing = {"ms": 1.0, "device_ms": 0.9, "chain": chain,
              "sm_clock_ghz": 1.98, "chain_floor_ms": 2.7,
              "chain_floors_ms": {"o": 2.7}}
    merges = {"first": {"o": {"segments": 16_896, "walked_again": 30,
                              "unmerged": 2, "merged_share": 0.99,
                              "serial_steps_max_row": 1000}}}
    check = {"shape": [6, 3000], "out_abs": 1e-3, "out_rel": 1e-7,
             "grad_abs": 2e-3, "grad_rel": 2e-7, "plain_fwd_ms": 100.0,
             "plain_bwd_ms": 300.0, "worst_grad": "d_w"}
    full = {"first": dict(check, shape=[6, 90_000], out_abs=4e-3,
                          grad_rel=3e-6, worst_grad="d_cap",
                          plain_cpu_fwd_ms=9e3, plain_cpu_bwd_ms=3e4),
            "last": dict(check, shape=[6, 90_000], grad_abs=5e-3,
                         plain_cpu_fwd_ms=8e3, plain_cpu_bwd_ms=2e4)}
    design = {"jk": {nm: {"shape": [6, 90_000], "check": check,
                          "full": full, "merges": merges,
                          "timing": {"forward": timing, "adjoint": timing}}
                     for nm in ("gpu_floor_relaxed", "battery_relaxed")},
              "launches": {nm: 120 for nm in chip_smoke.RELAXED}}
    paths = {"study": {nm: 0 for nm in chip_smoke.RELAXED},
             "design": design["launches"]}
    rows = chip_smoke.jk_rows(design, paths)
    assert [r["name"] for r in rows] == ["gpu_floor_relaxed",
                                         "gpu_floor_relaxed_adjoint",
                                         "battery_relaxed",
                                         "battery_relaxed_adjoint"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for r in rows:
        assert keys <= set(r) and r["route"] == "cuda"
        assert r["library_ms"] is None and r["launches"] == 120
        assert r["launches_by_path"] == {"study": 0, "design": 120}
        assert (Path(__file__).resolve().parents[1] / r["source"]).exists()
        # bytes bind: 8-16 bytes a sample against 43-205 operations
        cols = len(chip_smoke.jk_columns(r["name"].replace("_adjoint", "")))
        b_ms, b_by = chip_smoke.jk_bound(r["name"], 6, 90_000, cols)
        assert (r["bound_ms"], r["bound_by"]) == (b_ms, b_by) and \
            b_by == "bytes"
        assert r["chain"] == chain and r["chain_floor_ms"] == 2.7
        assert ("merges" in r) == (not r["name"].endswith("_adjoint"))
    # the errors are the full-shape checks' worst; the card's cut beside
    assert rows[0]["max_abs_err"] == 4e-3 and rows[1]["max_abs_err"] == 5e-3
    assert rows[1]["rel_err"] == 3e-6 and rows[1]["worst_column"] == "d_cap"
    assert rows[1]["card_check"]["grad_abs"] == 2e-3
    assert rows[1]["plain_ms"] == 300.0
    assert rows[1]["plain_cpu_ms"] == {"first": 3e4, "last": 2e4}


def _answer(**kw):
    a = {"compliant": True, "recommended": "bat1x", "n_configs": 20,
         "mean_mw": 1.6368, "raw_swing_mw": 1.3199,
         "passing": [{"config": "bat1x", "energy_overhead": 0.004,
                      "swing_mitigated_mw": 0.01}]}
    a.update(kw)
    return a


def test_phase20_same_answer_holds_verdicts_exactly_and_numbers_by_rtol():
    ref = _answer()
    close = _answer(passing=[{"config": "bat1x",
                              "energy_overhead": 0.004 * (1 + 1e-5),
                              "swing_mitigated_mw": 0.01 * (1 - 1e-5)}])
    assert chip_smoke.same_answer(close, ref, "t") == pytest.approx(
        1e-5, rel=1e-3)
    for bad in (_answer(recommended="mpf50"), _answer(compliant=False),
                _answer(passing=[{"config": "bat1x",
                                  "energy_overhead": 0.004,
                                  "swing_mitigated_mw": 0.0101}]),
                _answer(passing=[])):
        with pytest.raises(AssertionError):
            chip_smoke.same_answer(bad, ref, "t")


def test_phase20_timeline_key_drops_latency_amplitude_and_margin():
    a = (" tick     t[s]  bin[Hz]       amp[W]    margin[W] lvl  lat[ms]  "
         "action\n   42    21.50        9      4.5e+07   -2.503e+06   1   "
         "104.11  dispatch:redesign")
    b = a.replace("104.11", "955.24").replace("4.5e+07", "4.501e+07")
    assert chip_smoke.timeline_key(a) == chip_smoke.timeline_key(b)
    assert chip_smoke.timeline_key(a)[1] == ["42", "21.50", "9", "1",
                                             "dispatch:redesign"]
    assert chip_smoke.timeline_key(a) != chip_smoke.timeline_key(
        a.replace("  1   104", "  2   104"))


def _mesh_reports(primary, other):
    return [{"calls": {"grid": primary}}, {"calls": {"grid": other}}]


def test_phase21_progress_gate_wants_process_zero_alone_to_the_end():
    ok = [[16, 128], [64, 128], [128, 128]]
    chip_smoke.mesh_progress_gate(_mesh_reports(ok, []), "grid", 128)
    chip_smoke.mesh_progress_gate(_mesh_reports(ok, []), "grid", 128,
                                  first=16)
    with pytest.raises(AssertionError, match="non-primary"):
        chip_smoke.mesh_progress_gate(_mesh_reports(ok, [[16, 128]]),
                                      "grid", 128)
    with pytest.raises(AssertionError, match="does not end"):
        chip_smoke.mesh_progress_gate(_mesh_reports(ok[:2], []), "grid",
                                      128)
    with pytest.raises(AssertionError, match="does not end"):
        chip_smoke.mesh_progress_gate(
            _mesh_reports([[16, 100], [128, 128]], []), "grid", 128)
    with pytest.raises(AssertionError, match="restored"):
        chip_smoke.mesh_progress_gate(_mesh_reports(ok, []), "grid", 128,
                                      first=32)


def test_phase21_records_travel_through_a_pickle_bit_for_bit(tmp_path):
    import numpy as np
    from repro_torch import api
    res = api.StudyResult({"index": np.arange(2), "x": np.array([np.nan,
                                                                1.5]),
                           "violations": np.array([(), ("a",)], object)})
    path = tmp_path / "cols.pkl"
    chip_smoke.save_columns(res, str(path))
    got = chip_smoke.load_result(api, str(path))
    assert chip_smoke.columns_equal(got, res) == []


def test_phase21_worker_mode_is_wired_into_main():
    import inspect
    src = inspect.getsource(chip_smoke.main)
    assert '"--mesh-worker"' in src and "mesh_phase(" in src
    assert chip_smoke.MESH_PREFIX < 128 and chip_smoke.MESH_PROCESSES == 2
    assert chip_smoke.MESH_ELEMENTS % 256 == 0


def _moe_cfg(capacity_factor):
    import dataclasses
    from repro_torch import configs
    cfg = configs.reduced(configs.get_config("deepseek-v2-lite-16b"))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))


def test_routing_keeps_what_the_dispatch_keeps():
    """Phase 22's ``routing`` marks dropped slots as the sort-based
    dispatch of ``moe_forward`` drops them (capacity 0.7: many drops)."""
    import torch
    from repro_torch.models import moe
    cfg = _moe_cfg(0.7)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, cfg, torch.float32)
    N, k = 300, cfg.moe.top_k
    x = torch.randn((1, N, cfg.d_model), generator=gen)
    idx_sorted, kept, margin = chip_smoke.routing(torch, cfg, p, x, False)
    _, _, idx = moe.route(x.reshape(N, -1), p["router"], k)
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=cfg.moe.n_experts)
    rank = torch.arange(N * k) - (torch.cumsum(counts, 0) - counts)[
        flat[order]]
    keep = torch.empty(N * k, dtype=torch.bool)
    keep[order] = rank < moe.capacity(cfg, N, False)
    assert torch.equal(kept, torch.where(keep.view(N, k), idx, -1).sort(
        1).values)
    assert torch.equal(idx_sorted, idx.sort(1).values)
    assert (kept < 0).sum() > 0 and (margin >= 0).all()
    # dropless: every slot kept
    assert (chip_smoke.routing(torch, cfg, p, x, True)[1] >= 0).all()


def test_routes_compare_sets_apart_ties_flips_and_moved_edges():
    import torch
    idx = torch.tensor([[0, 1], [0, 2], [1, 3]])
    a = (idx, torch.tensor([[0, 1], [0, 2], [1, 3]]),
         torch.tensor([1e-6, 0.1, 0.1]))
    b = (torch.tensor([[0, 1], [0, 3], [1, 3]]),
         torch.tensor([[0, 1], [0, 3], [-1, 3]]),
         torch.tensor([0.2, 0.1, 0.1]))
    near, flip, moved, margin = chip_smoke.routes_compare(torch, a, b)
    assert near.tolist() == [True, False, False]
    assert flip.tolist() == [False, True, False]
    assert moved.tolist() == [False, False, True]
    assert margin.tolist() == pytest.approx([1e-6, 0.1, 0.1])


def test_decode_bound_counts_the_experts_a_step_uses():
    """The bound's bytes grow by one expert's three matrices for each
    expert a step's tokens use, in each MoE layer; with RecordRoutes the
    step records one routing per MoE layer and moe_forward is restored."""
    import torch
    from repro_torch.models import init_cache, init_params, moe
    cfg = _moe_cfg(8.0)
    params = init_params(0, cfg, device="cpu")
    cache = init_cache(cfg, 2, 16, torch.float32, "cpu")
    n_moe = cfg.n_repeats  # the prefix layer is dense
    _, _, none = chip_smoke.decode_bound(torch, cfg, params, cache, 3,
                                         [0] * n_moe, 2)
    _, _, two = chip_smoke.decode_bound(torch, cfg, params, cache, 3,
                                        [2] * n_moe, 2)
    per = 3 * cfg.d_model * cfg.moe.d_ff_expert * 4
    assert two - none == 2 * per * n_moe
    _, _, later = chip_smoke.decode_bound(torch, cfg, params, cache, 4,
                                          [0] * n_moe, 2)
    m = cfg.mla
    per_pos = 2 * (m.kv_lora_rank + m.qk_rope_head_dim) * 4
    assert later - none == per_pos * cfg.n_layers
    orig = moe.moe_forward
    out = chip_smoke.zoo_decode_bound(
        torch, cfg, params, cache, 3, torch.zeros((2, 1), dtype=torch.long))
    assert moe.moe_forward is orig
    assert len(out["experts_used"]) == n_moe
    assert all(1 <= u <= 2 * cfg.moe.top_k for u in out["experts_used"])
