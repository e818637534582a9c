"""The scenario mesh across processes (``repro_torch.parallel.distributed``)
on the CPU with gloo, after the reference's ``tests/test_distributed.py``:
the ``REPRO_DIST_*`` contract, the launch helpers and their failures, and
one 2-process job whose workers run the smoke Study (records equal to the
one-process run's, ``on_chunk`` on process 0 only), resume a prefix that
one process checkpointed and checkpoint a prefix that one process resumes
(both equal to an uninterrupted run), merge rows in rank order and run the
compressed all-reduce.  The one-process smoke Study is held to the
reference's at ``tests/test_torch_study.py``'s tolerances.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_distributed.py
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import prng  # noqa: E402
from repro_torch.core.study import run_rows  # noqa: E402
from repro_torch.parallel import collectives, distributed  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM = 5
PREFIX = 10         # rows the prefix grid checkpoints: two whole chunks
LAUNCH_TIMEOUT = 300


def _rows_and_keys(study):
    rows = study.rows()
    keys = list(prng.fold_in(study.key, torch.arange(len(rows))))
    return rows, keys


def _run(study, n, **kw):
    rows, keys = _rows_and_keys(study)
    return run_rows(study.workloads, rows[:n], study.specs,
                    wave_cfg=study.wave_cfg, hw=study.hw, keys=keys[:n],
                    stream=STREAM, sample_chips=study.sample_chips,
                    device="cpu", **kw)


# ---------------------------------------------------------------------------
# the contract and the launch helpers
# ---------------------------------------------------------------------------

@pytest.fixture
def no_contract(monkeypatch):
    for var in (distributed.ENV_COORD, distributed.ENV_NPROCS,
                distributed.ENV_PID):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def test_initialize_is_noop_without_contract(no_contract):
    assert distributed.initialize() is False
    assert distributed.is_primary()
    assert (distributed.process_index(), distributed.process_count()) == (0,
                                                                          1)


def test_initialize_is_noop_for_one_process(no_contract):
    assert distributed.initialize("localhost:1", 1, 0) is False


@pytest.mark.parametrize("given", [("NPROCS",), ("PID",), ("NPROCS", "PID"),
                                   ("COORD",), ("COORD", "PID")])
def test_incomplete_contract_raises(no_contract, given):
    for name in given:
        no_contract.setenv(getattr(distributed, "ENV_" + name),
                           "localhost:1" if name == "COORD" else "2")
    with pytest.raises(KeyError):
        distributed.initialize(device="cpu")


def test_a_rank_without_a_card_raises_unless_cpu_is_asked(no_contract):
    no_contract.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize("localhost:1", 2, 1)
    with pytest.raises(ValueError, match="not a rank"):
        distributed.initialize("localhost:1", 2, 2, device="cpu")


def test_backend_follows_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distributed._backend(2, 1, None) == ("cpu:gloo,cuda:nccl",
                                                torch.device("cuda", 1))
    assert distributed._backend(3, 2, "cuda") == ("gloo",
                                                  torch.device("cuda", 0))
    assert distributed._backend(2, 1, "cpu") == ("gloo", torch.device("cpu"))


def test_a_group_that_cannot_form_raises():
    """Rank 1 of a job whose rank 0 never comes: the store times out."""
    code = ("from repro_torch.parallel import distributed as D\n"
            "D.TIMEOUT_S = 2.0\n"
            f"D.initialize('localhost:{distributed.free_port()}', 2, 1, "
            "device='cpu')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(ROOT, "src")))
    assert r.returncode != 0
    assert "Error" in r.stderr


def test_worker_env_contract():
    env = distributed.worker_env({"PYTHONPATH": "/elsewhere"},
                                 coordinator="localhost:12345",
                                 num_processes=2, process_id=1)
    assert env[distributed.ENV_COORD] == "localhost:12345"
    assert env[distributed.ENV_NPROCS] == "2"
    assert env[distributed.ENV_PID] == "1"
    src = env["PYTHONPATH"].split(os.pathsep)[0]
    assert os.path.isdir(os.path.join(src, "repro_torch"))
    assert "/elsewhere" in env["PYTHONPATH"]


def test_free_port_is_bindable():
    import socket
    port = distributed.free_port()
    with socket.socket() as s:
        s.bind(("localhost", port))


def test_launch_workers_surfaces_worker_failure():
    with pytest.raises(RuntimeError, match=r"(?s)worker .* exited .*boom"):
        distributed.launch_workers(
            [sys.executable, "-c", "import sys; sys.exit('boom')"],
            num_processes=2, timeout=60)


def test_launch_workers_stops_the_others_when_one_fails():
    """Rank 1 fails while rank 0 would wait a minute: the launch raises
    at once with rank 1's stderr and kills rank 0."""
    code = ("import os, sys, time\n"
            "if os.environ['REPRO_DIST_PID'] == '1': sys.exit('rank one "
            "failed')\n"
            "time.sleep(60)\n")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"(?s)worker 1 exited .*rank one"):
        distributed.launch_workers([sys.executable, "-c", code],
                                   num_processes=2, timeout=120)
    assert time.monotonic() - t0 < 30


def test_launch_workers_times_out():
    with pytest.raises(subprocess.TimeoutExpired):
        distributed.launch_workers(
            [sys.executable, "-c", "import time; time.sleep(60)"],
            num_processes=2, timeout=2)


# ---------------------------------------------------------------------------
# one 2-process job on gloo
# ---------------------------------------------------------------------------

WORKER = """
import json, sys
import numpy as np
import torch
from repro_torch.core import prng
from repro_torch.core.study import run_rows
from repro_torch.parallel import collectives, distributed as D

out_dir, resume_in, resume_out = sys.argv[1:4]
assert D.initialize(device="cpu"), "REPRO_DIST_* contract missing"
rank = D.process_index()
plan = D.distributed_plan(device="cpu")
study = D._smoke_study("cpu")
study.plan = plan
rows = study.rows()
keys = list(prng.fold_in(study.key, torch.arange(len(rows))))
report = {"rank": rank, "world": D.process_count(),
          "plan": [str(d) for d in plan.devices], "ranks": list(plan.ranks)}

calls = []
res = study.run(stream=%(stream)d, on_chunk=lambda d, t, e: calls.append((d, t)))
report["calls"] = calls
if D.is_primary():
    res.to_json(out_dir + "/records.json")


def run(n, resume, on_chunk=None):
    return run_rows(study.workloads, rows[:n], study.specs,
                    wave_cfg=study.wave_cfg, hw=study.hw, keys=keys[:n],
                    stream=%(stream)d, sample_chips=study.sample_chips,
                    on_chunk=on_chunk, resume=resume, plan=plan,
                    device="cpu")


resumed_calls = []
resumed = run(len(rows), resume_in, lambda d, t, e: resumed_calls.append(d))
report["resumed_calls"] = resumed_calls
run(%(prefix)d, resume_out)
if D.is_primary():
    resumed.to_json(out_dir + "/resumed.json")

x = torch.from_numpy(np.random.default_rng(rank).normal(
    0, 1, (3, 700)).astype(np.float32))
mean, err = collectives.compressed_allreduce_mean(x, torch.zeros_like(x))
np.save(out_dir + "/allreduce_%%d.npy" %% rank, mean.numpy())
merged = collectives.host_allgather(
    {"r": np.full(rank + 1, rank), "t": torch.arange(2) + 10 * rank}, plan)
report["merged"] = {k: v.tolist() for k, v in merged.items()}
with open(out_dir + "/report_%%d.json" %% rank, "w") as fh:
    json.dump(report, fh)
D.shutdown()
print("DIST_WORKER_OK", rank, len(res), flush=True)
""" % {"stream": STREAM, "prefix": PREFIX}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The one-process runs and checkpoints, then one 2-process job."""
    d = tmp_path_factory.mktemp("job")
    study = distributed._smoke_study("cpu")
    ref = study.run(stream=STREAM)
    resume_in, resume_out = str(d / "resume_in"), str(d / "resume_out")
    _run(study, PREFIX, resume=resume_in)
    script = d / "worker.py"
    script.write_text(WORKER)
    t0 = time.monotonic()
    done = distributed.launch_workers(
        [sys.executable, str(script), str(d), resume_in, resume_out],
        num_processes=2, timeout=LAUNCH_TIMEOUT)
    reports = [json.loads((d / f"report_{r}.json").read_text())
               for r in range(2)]
    return {"dir": d, "study": study, "ref": ref, "done": done,
            "reports": reports, "resume_out": resume_out,
            "seconds": time.monotonic() - t0}


def test_two_process_run_equals_one_process_run(job):
    for r in job["done"]:
        assert "DIST_WORKER_OK" in r.stdout, r.stdout
    got = json.loads((job["dir"] / "records.json").read_text())
    assert got == job["ref"].to_records(), (
        "2-process StudyResult differs from the one-process run")


def test_progress_is_global_and_primary_only(job):
    n = job["study"].n_rows
    primary, other = job["reports"]
    assert primary["calls"], "process 0 saw no on_chunk call"
    assert primary["calls"][-1] == [n, n]
    assert all(t == n for _, t in primary["calls"])
    assert other["calls"] == [] and other["resumed_calls"] == []


def test_every_rank_sees_one_plan(job):
    for rank, rep in enumerate(job["reports"]):
        assert (rep["rank"], rep["world"]) == (rank, 2)
        assert rep["plan"] == ["cpu", "cpu"] and rep["ranks"] == [0, 1]


def test_two_processes_resume_what_one_process_checkpointed(job):
    got = json.loads((job["dir"] / "resumed.json").read_text())
    assert got == job["ref"].to_records()
    assert job["reports"][0]["resumed_calls"][0] == PREFIX


def test_one_process_resumes_what_two_processes_checkpointed(job):
    calls = []
    study = job["study"]
    res = _run(study, study.n_rows, resume=job["resume_out"],
               on_chunk=lambda d, t, e: calls.append(d))
    assert res.to_records() == job["ref"].to_records()
    assert calls[0] == PREFIX
    chunks = os.listdir(os.path.join(job["resume_out"], "chunks", "g0-pad"))
    assert len(chunks) == -(-study.n_rows // STREAM)


def test_host_allgather_merges_in_rank_order(job):
    for rep in job["reports"]:
        assert rep["merged"] == {"r": [0, 1, 1], "t": [0, 1, 10, 11]}


def test_compressed_allreduce_is_the_mean_of_both_payloads(job):
    got = [np.load(job["dir"] / f"allreduce_{r}.npy") for r in range(2)]
    deq = [collectives.quantize_roundtrip(torch.from_numpy(
        np.random.default_rng(r).normal(0, 1, (3, 700)).astype(np.float32)))
        for r in range(2)]
    want = ((deq[0] + deq[1]) / 2).numpy()
    assert np.array_equal(got[0], want) and np.array_equal(got[1], want)


def test_the_smoke_cli_runs_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.parallel.distributed", "--smoke",
         "--device", "cpu", "--stream", "4"],
        capture_output=True, text=True, timeout=LAUNCH_TIMEOUT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "DISTRIBUTED_SMOKE_OK: 2-process run equal" in r.stdout


# ---------------------------------------------------------------------------
# the one-process smoke Study against the reference's
# ---------------------------------------------------------------------------

def test_smoke_study_matches_the_reference(job):
    from repro.parallel import distributed as ref_distributed
    from test_torch_study import _compare
    ref = ref_distributed._smoke_study().run(stream=STREAM)
    port = job["ref"]
    assert len(ref) == len(port) == 12
    specs = [s for _, s in job["study"].specs]
    near = _compare(ref, port, specs)
    assert near == 0, near
