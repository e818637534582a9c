"""Several processes on the scenario mesh: ``torch.distributed`` set-up,
the launch helpers, and the 2-process smoke.

The streaming engine is embarrassingly parallel along its scenario axis;
``ScenarioShardPlan`` says which rows of each chunk a process computes.
This module forms the processes into one job:

* ``initialize()``: idempotent ``torch.distributed.init_process_group``
  from an explicit coordinator or the ``REPRO_DIST_*`` environment
  contract (``tcp://<coord>``, world size, rank).  Each rank's card is
  ``cuda:(rank % device_count)``; the backend is ``"cpu:gloo,cuda:nccl"``
  where every rank has a card of its own, and ``"gloo"`` on the CPU or
  where ranks share a card (NCCL refuses two ranks on one device).  The
  host merges of per-row metrics go through gloo either way.
* ``distributed_plan()``: the ``ScenarioShardPlan`` over every rank's
  device, the same on every process.
* ``launch_workers()`` / ``worker_env()`` / ``free_port()``: N worker
  subprocesses on this host, one job (the same contract drives several
  hosts).
* ``python -m repro_torch.parallel.distributed --smoke [--processes N]
  [--stream K] [--device cpu]``: runs a small Study in one process, again
  in N processes on the scenario mesh, and checks that the two record
  lists are equal.

Nothing falls back: an incomplete contract, a rank without a card (unless
the caller asked for the CPU), a group that cannot be formed, or a worker
that fails raises.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

ENV_COORD = "REPRO_DIST_COORD"
ENV_NPROCS = "REPRO_DIST_NPROCS"
ENV_PID = "REPRO_DIST_PID"

# how long a rank waits for the others: to form the group, and at each
# collective
TIMEOUT_S = 600.0

_initialized = False


def _backend(nproc: int, pid: int, device) -> tuple:
    """``(backend, this rank's device)`` for a job of ``nproc`` ranks on
    ``device`` (None: the card)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return "gloo", dev
    if dev.type != "cuda":
        raise ValueError(f"the scenario mesh runs on cuda or cpu, not {dev}")
    from repro_torch.parallel.sharding import rank_card
    card = rank_card(pid)
    if nproc <= torch.cuda.device_count():
        return "cpu:gloo,cuda:nccl", card
    return "gloo", card


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device=None) -> bool:
    """Join this process to the job, once.

    Arguments default to the ``REPRO_DIST_COORD`` / ``REPRO_DIST_NPROCS``
    / ``REPRO_DIST_PID`` contract (what ``launch_workers`` sets).  With
    neither arguments nor contract, or a job of one process, this is a
    no-op, so the same program runs alone unchanged; a contract with some
    of its variables missing raises ``KeyError``.  ``device`` is where
    this rank computes (None: its card).  Returns True when the job is
    (now) up."""
    global _initialized
    if _initialized:
        return True
    coord = coordinator_address or os.environ.get(ENV_COORD)
    if coord is None:
        given = [v for v in (ENV_NPROCS, ENV_PID) if v in os.environ]
        if given:
            raise KeyError(f"{ENV_COORD} is not set but {given} are: the "
                           f"REPRO_DIST_* contract is incomplete")
        return False
    nproc = int(num_processes if num_processes is not None
                else os.environ[ENV_NPROCS])
    pid = int(process_id if process_id is not None
              else os.environ[ENV_PID])
    if nproc <= 1:
        return False
    if not 0 <= pid < nproc:
        raise ValueError(f"process id {pid} is not a rank of {nproc}")
    backend, dev = _backend(nproc, pid, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coord}", world_size=nproc,
        rank=pid, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _initialized = True
    return True


def shutdown() -> None:
    """Leave the job (a no-op when this process never joined one)."""
    global _initialized
    if _initialized:
        dist.destroy_process_group()
        _initialized = False


def process_index() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_count() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def is_primary() -> bool:
    """True on the process that owns side effects (progress callbacks,
    checkpoint writes, result export).  Always True in one process."""
    return process_index() == 0


def distributed_plan(*, axis: str = "scenario", device=None):
    """The ``ScenarioShardPlan`` over every rank's device (``device``
    None: each rank's card; ``"cpu"``: the CPU of each rank): the same
    plan on every process."""
    from repro_torch.parallel.sharding import ScenarioShardPlan
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return ScenarioShardPlan.make([dev] * process_count(), axis=axis)
    return ScenarioShardPlan.make(axis=axis)


# ---------------------------------------------------------------------------
# worker subprocesses on this host
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker_env(base_env: Optional[Dict[str, str]] = None, *,
               coordinator: str, num_processes: int,
               process_id: int) -> Dict[str, str]:
    """The environment of one worker: the ``REPRO_DIST_*`` contract and
    this package's ``src/`` first on ``PYTHONPATH``."""
    env = dict(os.environ if base_env is None else base_env)
    env[ENV_COORD] = coordinator
    env[ENV_NPROCS] = str(num_processes)
    env[ENV_PID] = str(process_id)
    src = os.path.join(os.path.dirname(__file__), "..", "..")
    env["PYTHONPATH"] = (os.path.abspath(src) + os.pathsep
                         + env.get("PYTHONPATH", ""))
    return env


def launch_workers(argv: Sequence[str], num_processes: int = 2, *,
                   env: Optional[Dict[str, str]] = None,
                   timeout: float = 900.0
                   ) -> List[subprocess.CompletedProcess]:
    """Run ``num_processes`` copies of ``argv`` as one job (a fresh
    coordinator port, one rank each) and wait for all of them.  When a
    worker exits non-zero the others are killed and this raises
    ``RuntimeError`` with that worker's stderr tail; past ``timeout``
    seconds every worker is killed and this raises
    ``subprocess.TimeoutExpired``."""
    coord = f"localhost:{free_port()}"
    procs = [subprocess.Popen(
        list(argv), env=worker_env(env, coordinator=coord,
                                   num_processes=num_processes,
                                   process_id=pid),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(num_processes)]
    outs: List[Optional[tuple]] = [None] * num_processes

    def drain(pid: int) -> None:
        outs[pid] = procs[pid].communicate()

    readers = [threading.Thread(target=drain, args=(pid,), daemon=True)
               for pid in range(num_processes)]
    for t in readers:
        t.start()
    deadline = time.monotonic() + timeout
    failed = None
    while any(t.is_alive() for t in readers):
        failed = next((pid for pid, p in enumerate(procs)
                       if p.poll() not in (None, 0)), None)
        if failed is not None or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    if failed is not None or any(t.is_alive() for t in readers):
        for p in procs:
            if p.poll() is None:
                p.kill()
        for t in readers:
            t.join()
        if failed is None:
            raise subprocess.TimeoutExpired(list(argv), timeout)
    done = [subprocess.CompletedProcess(p.args, p.returncode, *outs[pid])
            for pid, p in enumerate(procs)]
    bad = next((r for r in done if r.returncode != 0), None)
    if failed is not None:
        bad = done[failed]
    if bad is not None:
        raise RuntimeError(
            f"distributed worker {done.index(bad)} exited {bad.returncode}:"
            f"\n{bad.stderr[-3000:]}")
    return done


# ---------------------------------------------------------------------------
# the smoke: N processes give the records of one
# ---------------------------------------------------------------------------

def _smoke_study(device=None):
    """Two workloads of two lengths, two fleets, three configs, keyed: 12
    pipeline rows, padded to one length."""
    from repro_torch import api as core
    tl = core.synthetic_timeline(1.0, 0.3)
    tl2 = core.synthetic_timeline(2.0, 0.25, moe_notch=True)
    cfg = core.WaveformConfig(dt=0.002, steps=3, jitter_s=0.002)

    def gpu(m):
        return core.GpuPowerSmoothing(
            mpf_frac=m, ramp_up_w_per_s=2000, ramp_down_w_per_s=2000,
            stop_delay_s=1.0)

    spec = core.example_specs(job_mw=0.05)["moderate"]
    return core.Study(
        {"w": tl, "w2": tl2}, fleets=[128, 256],
        configs={"none": None, "a": (gpu(0.8), None), "b": (gpu(0.65), None)},
        specs=spec, wave_cfg=cfg, key=0, device=device)


def _smoke_worker(out_path: str, stream: int, device=None) -> None:
    """One worker: join the job, run the smoke Study on the scenario mesh,
    write the records from process 0."""
    if not initialize(device=device):
        raise RuntimeError("worker launched without the REPRO_DIST_* "
                           "contract")
    try:
        study = _smoke_study(device)
        study.plan = distributed_plan(device=device)
        res = study.run(stream=stream)
        if is_primary():
            res.to_json(out_path)
        print(f"worker {process_index()}/{process_count()} done", flush=True)
    finally:
        shutdown()


def run_smoke(num_processes: int = 2, stream: int = 5, device=None,
              timeout: float = 300.0) -> None:
    """The smoke Study in one process, then in ``num_processes`` worker
    processes on the scenario mesh; raises unless their records are
    equal."""
    ref = _smoke_study(device).run(stream=stream)
    argv = [sys.executable, "-m", "repro_torch.parallel.distributed",
            "--smoke-worker", "--stream", str(stream)]
    if device is not None:
        argv += ["--device", str(device)]
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "dist_records.json")
        launch_workers(argv + ["--out", out], num_processes=num_processes,
                       timeout=timeout)
        with open(out) as fh:
            got = json.load(fh)
    want = ref.to_records()
    if got != want:
        raise AssertionError(
            f"{num_processes}-process records differ from one process's "
            f"({sum(a != b for a, b in zip(got, want))}/{len(want)} records)")
    print(f"DISTRIBUTED_SMOKE_OK: {num_processes}-process run equal to one "
          f"process's ({len(want)} records)", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="N processes on the scenario mesh against one: "
                         "records equal")
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--stream", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (the default: each rank's card)")
    ap.add_argument("--smoke-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.smoke_worker:
        _smoke_worker(args.out, args.stream, args.device)
        return
    if args.smoke:
        run_smoke(args.processes, args.stream, args.device)
        return
    ap.print_help()


if __name__ == "__main__":
    # run the package's module, not this file's second copy, so that the
    # job's state lives in one module
    from repro_torch.parallel import distributed as _module
    _module.main()
