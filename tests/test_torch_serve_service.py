"""The port's compliance service (``serve/power.py``) against the
reference on the CPU, and the reference's behaviour tests of the service
(``tests/test_serve_service.py``) on the port: the true-LRU answer cache,
single-flight of identical concurrent misses, ``query_many`` equal to
serial queries, the JSON boundary, the memos; ``load_cell`` and a cell
workload; ``watch``; and the CLI.  Sizes are the reference tests': a
1-MPF x 1-battery catalog at ``WaveformConfig(dt=0.01, steps=3,
jitter_s=0.01)``, ``stream_chunk=4``.

Tolerances: an answer's verdict, recommendation, passing configuration
names, catalog size, ``raw_swing_mw`` and ``mean_mw`` equal the
reference's (its float64 host waveform is copied); ``energy_overhead``
within 1e-5 relative or 1e-6 absolute (the reference sums energy in
float32, ROADMAP queue C: its rounding reaches some 1e-7 of an overhead
of 1e-4, and 1e-6 absolute is the port's other tests' bound for it); a
grid-designed fallback's MPF and capacity equal.  The closed loop
on the ramp gives the reference's actions at the same ticks with
amplitudes within 1e-4 relative, and the same timeline once the latency
column (a wall-clock reading) is dropped.  Within the port, coalesced
answers equal serial ones with ``==``.

The reference's ``test_no_retrace_across_fleets_and_spec_thresholds``
counts XLA executables; the port compiles nothing, so it has no
counterpart here.
"""
import io
import json
import threading
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import repro.core as core
from repro.serve.power import PowerComplianceService as RefService
from repro_torch import api
from repro_torch.core.phases import load_cell
from repro_torch.serve import power
from repro_torch.serve.power import PowerComplianceService

CFG = api.WaveformConfig(dt=0.01, steps=3, jitter_s=0.01)
REF_CFG = core.WaveformConfig(dt=0.01, steps=3, jitter_s=0.01)
OVERHEAD_RTOL = 1e-5
OVERHEAD_ATOL = 1e-6
AMP_RTOL = 1e-4


def _service(**kw):
    kw.setdefault("wave_cfg", CFG)
    kw.setdefault("mpf_grid", (0.8,))
    kw.setdefault("cap_fracs", (1.0,))
    kw.setdefault("stream_chunk", 4)
    kw.setdefault("device", "cpu")
    return PowerComplianceService(**kw)


def _ref_service(**kw):
    kw.setdefault("wave_cfg", REF_CFG)
    kw.setdefault("mpf_grid", (0.8,))
    kw.setdefault("cap_fracs", (1.0,))
    kw.setdefault("stream_chunk", 4)
    return RefService(**kw)


def _tl(period_s=1.0, comm_frac=0.25, moe=False):
    return api.synthetic_timeline(period_s=period_s, comm_frac=comm_frac,
                                  moe_notch=moe)


def _ref_tl(period_s=1.0, comm_frac=0.25, moe=False):
    return core.synthetic_timeline(period_s=period_s, comm_frac=comm_frac,
                                   moe_notch=moe)


def _same_answer(got, ref):
    for k in ("workload", "n_chips", "spec", "mean_mw", "raw_swing_mw",
              "n_configs", "n_scenarios", "compliant", "recommended"):
        assert got[k] == ref[k], k
    assert [p["config"] for p in got["passing"]] == [
        p["config"] for p in ref["passing"]]
    for a, b in zip(got["passing"], ref["passing"]):
        assert a["energy_overhead"] == pytest.approx(
            b["energy_overhead"], rel=OVERHEAD_RTOL, abs=OVERHEAD_ATOL)
    assert (got["designed"] is None) == (ref["designed"] is None)
    if got["designed"] is not None:
        for k in ("config", "mpf_frac", "battery_capacity_j",
                  "warmstart_path"):
            assert got["designed"].get(k) == ref["designed"].get(k), k


# -- against the reference ----------------------------------------------------

@pytest.mark.parametrize("period_s, moe, n_chips, spec", [
    (1.0, False, 512, "moderate"),
    (1.4, False, 1024, "tight"),
    (0.7, True, 2048, "lenient"),
])
def test_query_matches_reference(period_s, moe, n_chips, spec):
    got = _service().query(_tl(period_s, moe=moe), n_chips, spec)
    ref = _ref_service().query(_ref_tl(period_s, moe=moe), n_chips, spec)
    _same_answer(got, ref)


@pytest.mark.parametrize("period_s, n_chips", [(1.0, 512), (2.0, 4096)])
def test_grid_fallback_designs_what_the_reference_designs(period_s, n_chips):
    """A catalog that fails the tight spec everywhere: the grid designer's
    answer is the reference's."""
    kw = dict(mpf_grid=(0.5,), cap_fracs=(0.5,), design_method="grid")
    got = _service(**kw).query(_tl(period_s), n_chips, "tight")
    ref = _ref_service(**kw).query(_ref_tl(period_s), n_chips, "tight")
    assert got["designed"] is not None
    assert got["recommended"] == "designed[grid]"
    _same_answer(got, ref)
    assert got["designed"]["energy_overhead"] == pytest.approx(
        ref["designed"]["energy_overhead"], rel=OVERHEAD_RTOL,
        abs=OVERHEAD_ATOL)


def _cell_file(tmp_path):
    cell = {"arch": "dense-test", "n_chips": 512,
            "exact": {"flops": 3.2e18, "bytes": 4.0e15},
            "collectives": {"all-reduce": 6.0e9, "all-to-all": 2.0e9},
            "memory": {"state_bytes_per_device": 4e9}}
    path = tmp_path / "dense-test__small__single.json"
    path.write_text(json.dumps(cell))
    return cell, path


def test_load_cell_and_cell_workload_match_reference(tmp_path):
    from repro.core.phases import load_cell as ref_load_cell
    cell, path = _cell_file(tmp_path)
    assert load_cell(str(path)) == cell
    assert load_cell(str(tmp_path), "dense-test", "small") == cell
    assert load_cell(str(tmp_path), "dense-test", "small") == ref_load_cell(
        str(tmp_path), "dense-test", "small")
    req = {"workload": {"cell": str(path)}, "n_chips": 512, "spec": "tight"}
    got = _service().handle(req)
    ref = _ref_service().handle(req)
    assert got["workload"] == "dense-test"
    _same_answer(got, ref)
    assert "error" in _service().handle(
        {"workload": {"cell": str(tmp_path / "missing.json")},
         "n_chips": 512})


def _timeline_without_latency(text):
    # the columns are tick, t, bin, amp, margin, level, latency, action
    return [ln.split()[:6] + ln.split()[7:] for ln in text.splitlines()]


def test_watch_matches_reference():
    from repro.control import synthesize_ramp as ref_ramp
    # the ramp's first escalation and redesign are at tick 42
    kw = dict(n_chips=512, spec="moderate", max_ticks=44)
    got = _service(design_method="grid").watch(
        replay=api.synthesize_ramp(dt=0.002), dt=0.002, **kw)
    ref = _ref_service(design_method="grid").watch(
        replay=ref_ramp(dt=0.002), dt=0.002, **kw)
    assert _timeline_without_latency(got["timeline"]) == \
        _timeline_without_latency(ref["timeline"])
    assert [(r["tick"], r["action"], r["level"], r["bin_hz"])
            for r in got["records"]] == [
        (r["tick"], r["action"], r["level"], r["bin_hz"])
        for r in ref["records"]]
    assert any(r["action"].startswith("dispatch") for r in got["records"])
    for a, b in zip(got["records"], ref["records"]):
        assert a["amplitude_w"] == pytest.approx(b["amplitude_w"],
                                                 rel=AMP_RTOL)
    for k in ("spec", "n_chips", "dt", "tick_s", "window_s",
              "design_method"):
        assert got[k] == ref[k]
    assert got["summary"]["n_ticks"] == ref["summary"]["n_ticks"] == 44
    json.dumps(got)


@pytest.mark.parametrize("argv", [
    ["--n-chips", "512", "--spec", "moderate", "--period-s", "1.0"],
    ["watch", "--replay", "ramp", "--max-ticks", "4"],
])
def test_cli_prints_json(monkeypatch, argv):
    # the CLI's service at the test's small waveform
    monkeypatch.setattr(power, "PowerComplianceService",
                        lambda **kw: _service(**kw))
    out = io.StringIO()
    with redirect_stdout(out):
        power.main(argv + ["--device", "cpu"])
    answer = json.loads(out.getvalue())
    assert "error" not in answer
    assert answer["n_chips"] == 512


# -- the LRU ----------------------------------------------------------------

def test_lru_caps_resident_entries_and_evicts_oldest():
    svc = _service(cache_size=2)
    a, b, c = _tl(1.0), _tl(1.4), _tl(0.7)
    svc.query(a, 512)
    svc.query(b, 512)
    svc.query(a, 512)              # refresh a: b is now the oldest entry
    svc.query(c, 512)              # evicts b, not a
    assert svc.cache_len() == 2
    assert svc.stats["evictions"] == 1
    runs = svc.stats["study_runs"]
    svc.query(a, 512)              # still cached
    assert svc.stats["study_runs"] == runs
    svc.query(b, 512)              # evicted: runs again
    assert svc.stats["study_runs"] == runs + 1


def test_cache_hit_is_same_answer_without_rerun():
    svc = _service()
    first = svc.query(_tl(), 512)
    again = svc.query(_tl(), 512)
    assert again == first
    assert svc.stats == dict(svc.stats, hits=1, misses=1, study_runs=1)


# -- single-flight -------------------------------------------------------------

def test_concurrent_identical_queries_run_study_once():
    svc = _service()
    n, results, errs = 8, [None] * 8, []

    def hammer(i):
        try:
            results[i] = svc.query(_tl(), 512)
        except Exception as e:      # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    assert svc.stats["study_runs"] == 1
    assert svc.stats["misses"] == 1
    assert all(r == results[0] for r in results)
    assert svc.query(_tl(), 512) == results[0]


# -- coalescing -------------------------------------------------------------

def test_query_many_coalesces_and_matches_serial():
    serial = _service()
    ans = [serial.query(_tl(1.0), 512, "moderate"),
           serial.query(_tl(1.4), 1024, "lenient"),
           serial.query(_tl(0.7, moe=True), 2048, "tight")]
    assert serial.stats["study_runs"] == 3

    co = _service()
    got = co.query_many([
        {"workload": _tl(1.0), "n_chips": 512, "spec": "moderate"},
        {"workload": _tl(1.4), "n_chips": 1024, "spec": "lenient"},
        {"workload": _tl(0.7, moe=True), "n_chips": 2048, "spec": "tight"},
    ])
    assert co.stats["study_runs"] == 1
    assert got == ans


def test_query_many_duplicates_and_hits():
    svc = _service()
    first = svc.query(_tl(1.0), 512)
    got = svc.query_many([
        {"workload": _tl(1.0), "n_chips": 512},    # cache hit
        {"workload": _tl(1.4), "n_chips": 512},    # miss (leads)
        {"workload": _tl(1.4), "n_chips": 512},    # duplicate of the miss
    ])
    assert got[0] == first
    assert got[1] == got[2]
    assert svc.stats["study_runs"] == 2            # first + one coalesced


def test_handle_many_json_boundary():
    svc = _service()
    out = svc.handle_many([
        {"workload": {"period_s": 1.0, "comm_frac": 0.25}, "n_chips": 256},
        {"workload": "garbage", "n_chips": 1},
        {"workload": {"period_s": 1.3, "comm_frac": 0.3}, "n_chips": 128},
    ])
    assert "error" in out[1]
    assert out[0]["n_chips"] == 256 and out[2]["n_chips"] == 128
    assert out[0] == svc.handle(
        {"workload": {"period_s": 1.0, "comm_frac": 0.25}, "n_chips": 256})


# -- the memos ----------------------------------------------------------------

def test_feature_memo_skips_recompute():
    svc = _service()
    tl = _tl()
    spec = api.example_specs(job_mw=1.0)["moderate"]
    f1 = svc._features(tl, 512, spec)
    f2 = svc._features(tl, 512, spec)
    assert svc.stats["feature_misses"] == 1
    assert svc.stats["feature_hits"] == 1
    np.testing.assert_array_equal(f1, f2)
    svc._features(tl, 1024, spec)      # another fleet: another fingerprint
    assert svc.stats["feature_misses"] == 2


def test_workload_memo_reuses_synthesis():
    svc = _service()
    tl = _tl()
    assert svc._workload_state(tl) is svc._workload_state(tl)
    assert svc._fleet_state(tl, 512) is svc._fleet_state(tl, 512)


def test_default_catalog_matches_reference():
    from repro.serve.power import default_catalog as ref_catalog
    got = power.default_catalog(2.5e6)
    ref = ref_catalog(2.5e6)
    assert [c.name for c in got] == [c.name for c in ref]
    assert len(got) == 20
    for a, b in zip(got, ref):
        for port_stage, ref_stage in ((a.device, b.device), (a.rack, b.rack)):
            assert (port_stage is None) == (ref_stage is None)
            if port_stage is not None:
                pa, rb = vars(port_stage), vars(ref_stage)
                assert {k: v for k, v in pa.items() if k != "hw"} == {
                    k: v for k, v in rb.items() if k != "hw"}


def test_thread_launch_counts_and_builds_are_locked(monkeypatch, tmp_path):
    """A kernel reached from eight threads at once, cold, builds and loads
    its library once and counts every launch."""
    from repro_torch.kernels import build
    kernel = build.CudaKernel("scans/csrc/battery.cu", "battery_scan", [],
                              name="lock_probe")
    build.KERNELS.remove(kernel)
    builds = []
    gate = threading.Barrier(8)

    def start_build(self=kernel):
        builds.append(threading.get_ident())
        return "proc"

    monkeypatch.setattr(kernel, "start_build", start_build)
    monkeypatch.setattr(kernel, "finish_build", lambda proc: None)
    def entry(*_args):
        return 0

    monkeypatch.setattr(build.ctypes, "CDLL",
                        lambda path: types.SimpleNamespace(
                            battery_scan=entry))

    def hammer():
        gate.wait(timeout=30)
        for _ in range(100):
            kernel.launch()

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1
    assert kernel.launches == 800
    assert kernel._tmp_path() != kernel.library_path()
