"""Chunked streaming, resume and result export in the port.

* The cases of ``tests/test_resume.py`` on the port's Study: a run
  stopped after a chunk and resumed, a complete restore that computes
  nothing, an extended grid that computes only its new rows (each equal
  to an uninterrupted run), and the loud failures: a truncated chunk, a
  changed grid or chunk size, an unreadable manifest, ``resume`` without
  ``stream``; ``rows_chain`` prefixes (keys included), ``record_positions``
  and an object-dtype checkpoint round trip, and ``CheckpointManager``.
* Chunked runs (``stream=1, 3, 5, True``) equal the one-shot run bit for
  bit in every column, in pad and bucket mode, on a Study with noisy
  Firefly, ``CombinedMitigation`` and a battery + backstop stack.
* ``to_json``, ``to_csv``, ``best``, ``unique``, ``failing`` and
  ``passing_configs`` against the reference's on the same Study.
"""
import csv
import glob
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.ckpt import (CheckpointManager, ResumeError,  # noqa: E402
                              load_pytree_numpy, restore_pytree, save_pytree)
from repro_torch.ckpt.resume import record_positions, rows_chain  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from test_torch_study_keys import (_acceptance_study,  # noqa: E402
                                   acceptance, port_study)

STREAM = 4


def _study(extra_workload=False, seeds=(0, 1), key=0):
    wl = {"w": api.synthetic_timeline(1.0, 0.3),
          "w2": api.synthetic_timeline(2.0, 0.25, moe_notch=True)}
    if extra_workload:
        wl["w3"] = api.synthetic_timeline(1.5, 0.2)

    def gpu(m):
        return api.GpuPowerSmoothing(mpf_frac=m, ramp_up_w_per_s=2000,
                                     ramp_down_w_per_s=2000,
                                     stop_delay_s=1.0)

    return api.Study(
        wl, fleets=[128],
        configs={"none": None, "a": (gpu(0.8), None), "b": (gpu(0.65), None)},
        specs=api.example_specs(job_mw=0.05)["moderate"],
        wave_cfg=api.WaveformConfig(dt=0.01, steps=3, jitter_s=0.02),
        key=key, seeds=list(seeds), device="cpu")


@pytest.fixture(scope="module")
def ref():
    return _study().run(stream=STREAM).to_records()


@pytest.fixture(scope="module")
def ref_ext():
    return _study(extra_workload=True).run(stream=STREAM).to_records()


class Kill(Exception):
    """A stop at a chunk boundary."""


def _chunks(d):
    return glob.glob(os.path.join(d, "chunks", "*", "chunk_*"))


def test_fresh_run_with_resume_dir_matches_plain(tmp_path, ref):
    d = str(tmp_path / "ck")
    got = _study().run(stream=STREAM, resume=d)
    assert got.to_records() == ref
    assert _study().run().to_records() == ref
    assert os.path.exists(os.path.join(d, "sweep.json"))
    assert _chunks(d)


def test_kill_mid_stream_then_resume_is_bit_identical(tmp_path, ref):
    d = str(tmp_path / "ck")

    def die_after_two(done, total, elapsed):
        if done >= 2 * STREAM:
            raise Kill

    with pytest.raises(Kill):
        _study().run(stream=STREAM, resume=d, on_chunk=die_after_two)
    assert _chunks(d), "stopped before any checkpoint was written"
    calls = []
    got = _study().run(stream=STREAM, resume=d,
                       on_chunk=lambda dn, t, e: calls.append((dn, t)))
    assert got.to_records() == ref
    # the first call reports the restored prefix in one jump
    assert calls[0][0] >= 2 * STREAM and calls[0][1] == calls[-1][0] == 12


def test_complete_restore_recomputes_nothing(tmp_path, ref):
    d = str(tmp_path / "ck")
    _study().run(stream=STREAM, resume=d)
    saved = {p: os.path.getmtime(p) for p in _chunks(d)}
    calls = []
    got = _study().run(stream=STREAM, resume=d,
                       on_chunk=lambda dn, t, e: calls.append((dn, t)))
    assert got.to_records() == ref
    assert calls == [(12, 12)]
    assert {p: os.path.getmtime(p) for p in saved} == saved


def test_extension_computes_only_new_rows(tmp_path, ref_ext):
    d = str(tmp_path / "ck")
    _study().run(stream=STREAM, resume=d)
    n_old = len(_chunks(d))
    calls = []
    got = _study(extra_workload=True).run(
        stream=STREAM, resume=d,
        on_chunk=lambda dn, t, e: calls.append((dn, t)))
    assert got.to_records() == ref_ext
    # the old 12 rows arrive as one restored prefix; only w3's 6 rows run
    assert calls[0] == (12, 18)
    assert len(calls) == 1 + (6 + STREAM - 1) // STREAM
    assert len(_chunks(d)) > n_old


def test_truncated_checkpoint_fails_loudly(tmp_path):
    d = str(tmp_path / "ck")
    _study().run(stream=STREAM, resume=d)
    victim = sorted(glob.glob(os.path.join(d, "chunks", "*", "chunk_*",
                                           "*.npy")))[0]
    with open(victim, "r+b") as fh:
        fh.truncate(8)
    with pytest.raises(ResumeError, match="corrupt chunk checkpoint"):
        _study().run(stream=STREAM, resume=d)


def test_grid_fingerprint_mismatch_fails_loudly(tmp_path):
    d = str(tmp_path / "ck")
    _study().run(stream=STREAM, resume=d)
    with pytest.raises(ResumeError, match="fingerprint mismatch"):
        _study(seeds=(5, 6)).run(stream=STREAM, resume=d)
    # another root key changes every row's key bytes
    with pytest.raises(ResumeError, match="fingerprint mismatch"):
        _study(key=1).run(stream=STREAM, resume=d)
    with pytest.raises(ResumeError, match="extended, not shrunk"):
        _study(seeds=(0,)).run(stream=STREAM, resume=d)


def test_chunk_size_mismatch_fails_loudly(tmp_path):
    d = str(tmp_path / "ck")
    _study().run(stream=STREAM, resume=d)
    with pytest.raises(ResumeError, match=f"stream={STREAM}"):
        _study().run(stream=STREAM + 2, resume=d)


def test_resume_requires_streaming(tmp_path):
    d = str(tmp_path / "ck")
    with pytest.raises(ValueError, match="requires streaming"):
        _study().run(resume=d)
    with pytest.raises(ValueError, match="chunk size must be >= 1"):
        _study().run(stream=0)
    assert not os.path.exists(d)


def test_unreadable_sweep_manifest_fails_loudly(tmp_path):
    d = str(tmp_path / "ck")
    _study().run(stream=STREAM, resume=d)
    with open(os.path.join(d, "sweep.json"), "w") as fh:
        fh.write("{not json")
    with pytest.raises(ResumeError, match="unreadable sweep manifest"):
        _study().run(stream=STREAM, resume=d)


def test_rows_chain_prefix_semantics():
    wl = {"w": api.synthetic_timeline(1.0, 0.3)}
    cfgs = api.MitigationConfig("none")
    rows = [("w", 128, cfgs, s) for s in range(5)]
    full = rows_chain(wl, rows, None, at=[3, 5])
    pre = rows_chain(wl, rows[:3], None, at=[3])
    assert full[3] == pre[3]
    assert full[5] != full[3]
    other = rows_chain(wl, rows[:2] + [("w", 256, cfgs, 2)] + rows[3:],
                       None, at=[3])
    assert other[3] != full[3]
    # a row's key is hashed as its two uint32 words
    keys = list(prng.fold_in(prng.prng_key(0), torch.arange(5)))
    keyed = rows_chain(wl, rows, keys, at=[3])
    words = rows_chain(wl, rows, [k.numpy().astype(np.uint32)
                                  for k in keys], at=[3])
    assert keyed[3] == words[3] != full[3]


def test_record_positions_interleave():
    assert list(record_positions(np.asarray([2, 5]), 3)) \
        == [6, 7, 8, 15, 16, 17]


def test_object_dtype_checkpoint_roundtrip(tmp_path):
    cols = np.empty(3, dtype=object)
    cols[0], cols[1], cols[2] = {"a": 1.5}, ("x", "y"), None
    tree = {"cols": {"metrics": cols}, "rows": np.arange(3)}
    d = str(tmp_path / "step")
    save_pytree(d, tree, step=0)
    leaves, manifest = load_pytree_numpy(d)
    assert manifest["leaves"]["cols/metrics"]["object"] is True
    got = leaves["cols/metrics"]
    assert got[0] == {"a": 1.5} and got[1] == ("x", "y") and got[2] is None
    assert np.array_equal(leaves["rows"], np.arange(3))
    back, _ = restore_pytree(d, tree)
    assert torch.equal(back["rows"], torch.arange(3))
    assert back["cols"]["metrics"][1] == ("x", "y")


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "run"), keep=2, async_save=True)
    for step in range(4):
        mgr.save(step, {"w": torch.full((3,), float(step)),
                        "layers": [np.arange(step + 1)]})
    mgr.wait()
    assert mgr.steps() == [2, 3]
    tree, manifest = mgr.restore_latest({"w": None, "layers": [None]})
    assert manifest["step"] == 3
    assert torch.equal(tree["w"], torch.full((3,), 3.0))
    assert torch.equal(tree["layers"][0], torch.arange(4))


# ---------------------------------------------------------------------------
# chunked runs equal the one-shot run
# ---------------------------------------------------------------------------

def _mixed_study():
    """Noisy Firefly rows (their own structure group), GPU floor +
    battery, ``CombinedMitigation`` and a battery + backstop stack, two
    lengths, key 0: 20 pipeline rows."""
    cfg = api.WaveformConfig(dt=0.01, steps=4, jitter_s=0.02)
    bat = api.RackBattery(capacity_j=4e4, max_discharge_w=4e4,
                          max_charge_w=4e4, target_tau_s=5.0)
    gpu = api.GpuPowerSmoothing(mpf_frac=0.75, ramp_up_w_per_s=2000,
                                ramp_down_w_per_s=2000, stop_delay_s=0.3)
    bs = api.TelemetryBackstop(critical_hz=(0.5, 1.0), window_s=1.0,
                               amp_threshold_w=4e3, sustain_s=0.2,
                               cooldown_s=0.3)
    ff = api.Firefly(telemetry=api.TelemetrySource(
        period_s=0.02, latency_s=0.02, noise_w=20.0))
    return api.Study(
        {"short": api.synthetic_timeline(1.0, 0.3),
         "long": api.synthetic_timeline(2.0, 0.3, moe_notch=True)},
        fleets=[64],
        configs={"none": None, "ff": (ff, None), "ff+bat": (ff, bat),
                 "comb": (None, api.CombinedMitigation(gpu, bat, 64)),
                 "bat+bs": (None, api.Stack((bat, bs)))},
        specs=api.example_specs(job_mw=0.03), seeds=[0, 1], wave_cfg=cfg,
        key=0, device="cpu")


def assert_columns_equal(a, b):
    ca, cb = a.columns, b.columns
    assert list(ca) == list(cb)
    for k in ca:
        if ca[k].dtype == object:
            assert list(ca[k]) == list(cb[k]), k
        else:
            assert np.array_equal(ca[k], cb[k], equal_nan=True), k


@pytest.fixture(scope="module")
def one_shot():
    study = _mixed_study()
    return study, {p: study.run(padding=p) for p in ("pad", "bucket")}


@pytest.mark.parametrize("padding", ["pad", "bucket"])
@pytest.mark.parametrize("stream", [1, 3, 5, True])
def test_chunked_run_equals_one_shot(one_shot, padding, stream):
    study, base = one_shot
    seen = []
    got = study.run(padding=padding, stream=stream,
                    on_chunk=lambda d, t, e: seen.append((d, t)))
    assert_columns_equal(got, base[padding])
    assert seen[-1] == (study.n_rows, study.n_rows)
    assert [d for d, _ in seen] == sorted(d for d, _ in seen)


def test_one_shot_run_has_every_stage(one_shot):
    _, base = one_shot
    res = base["pad"]
    cfg, eo = res.columns["config"], res.columns["energy_overhead"]
    assert (eo[cfg == "none"] == 0).all()
    assert (eo[cfg == "ff"] > 0).all()
    assert len(set(eo[cfg == "ff"])) > 1          # per-row noise
    assert np.isfinite(res.columns["metrics:ac_rms_frac"]).all()


# ---------------------------------------------------------------------------
# result export against the reference
# ---------------------------------------------------------------------------

def test_result_export_matches_reference(acceptance, tmp_path):
    ref_study, port = acceptance
    ref = ref_study.run()
    got = port.run()
    rj = json.loads(ref.to_json())
    pj = json.loads(got.to_json(str(tmp_path / "r.json")))
    with open(tmp_path / "r.json") as fh:
        assert json.load(fh) == pj
    assert len(pj) == len(rj) == len(got)
    for a, b in zip(rj, pj):
        assert list(a) == list(b)
        assert isinstance(b["violations"], list)
        for k in ("index", "row", "workload", "n_chips", "config", "spec",
                  "seed", "n_samples", "designed", "spec_ok", "violations"):
            assert a[k] == b[k], k
        assert set(a["metrics"]) == set(b["metrics"])
    rc = list(csv.reader(io.StringIO(ref.to_csv())))
    pc = list(csv.reader(io.StringIO(got.to_csv(str(tmp_path / "r.csv")))))
    assert rc[0] == pc[0] and len(rc) == len(pc) == len(got) + 1
    col = {k: i for i, k in enumerate(pc[0])}
    for a, b in zip(rc[1:], pc[1:]):
        for k in ("workload", "config", "spec", "spec_ok", "violations"):
            assert a[col[k]] == b[col[k]], k
    assert got.unique("config") == ref.unique("config")
    assert got.unique("workload") == ref.unique("workload")
    assert [r["index"] for r in got.failing()] == [
        r["index"] for r in ref.failing()]
    assert len(got.passing()) + len(got.failing()) == len(got)
    assert got.passing_configs() == ref.passing_configs()
    assert got.passing_configs(workload="long") == ref.passing_configs(
        workload="long")
    for among in (True, False):
        a, b = ref.best(among_passing=among), got.best(among_passing=among)
        assert (a is None) == (b is None)
        if a is not None:
            assert a["index"] == b["index"]
    assert got.filter(config="none").best() is None


def test_export_study_is_the_reference_acceptance_study():
    """The Study these exports run is the one test_torch_study_keys.py
    holds to the reference."""
    assert _acceptance_study().n_rows == port_study(
        _acceptance_study()).n_rows == 16
