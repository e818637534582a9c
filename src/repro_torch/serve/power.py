"""Spec-compliance query service: (workload, fleet, spec) -> the
mitigation configurations that keep a job inside the utility's spec
(reference: ``repro/serve/power.py``).

The operator's question behind the paper's evaluation matrix: before a
training job is dispatched, which transient mitigations keep it inside
the spec, and at what energy cost?  ``PowerComplianceService`` answers it
through the Study API: a query builds the candidate catalog (the
baseline, MPF floors, batteries and their pairings, sized off the job's
raw swing), runs its rows on the streaming executor (``run_rows``) and
returns the passing configurations ranked by their worst energy overhead
over seeds.  When no catalog configuration passes, the engine's design
solver (``design_method``: grid, gradient, hybrid or warmstart) designs
one for the query, returned under ``"designed"``.

Three levels of reuse:

* **Answer cache**: a true LRU of ``cache_size`` answers behind one
  lock.  Identical concurrent misses are single-flighted: one leader
  thread runs the Study, followers wait on its event and read the cached
  answer (``stats["study_runs"]`` counts executions).
* **Workload memos**: phase levels and the chip trace per workload, the
  aggregated fleet waveform and its swing per (workload, fleet), and the
  warm-start features per (workload, fleet, spec); all host numpy.
* **Coalescing**: ``query_many`` / ``handle_many`` run N distinct misses
  as one ``run_rows`` over the union of their rows, each row keyed by the
  PRNG key its query would draw alone (``prng.fold_in`` of the query's
  local row index), so the coalesced answers equal serial ones.

The service's host sizing (catalog, spec thresholds, the fallback's
waveform) uses the reference's float64 numpy waveform
(``chip_waveform_host``, ``aggregate_host``), so those numbers are the
reference's bits.  The heavy work (synthesis, the Study, design) runs
outside the lock; it runs on ``device`` (None: the card), and the cache
and memos hold host data only.

``handle`` / ``handle_many`` are the JSON boundary; the module is also a
CLI (installed as ``repro-torch-serve``):

  PYTHONPATH=src python -m repro_torch.serve.power \\
      --period-s 2.0 --comm-frac 0.25 --n-chips 512 --spec moderate

``watch()`` / ``... watch`` closes the grid-interactive control loop
(``control.watch_trace``) over a replayed or synthesized stream, with
this service's design path as the ladder's first rung:

  PYTHONPATH=src python -m repro_torch.serve.power watch --replay ramp \\
      --timeline

Both take ``--device cpu`` to run the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.ckpt.resume import digest
from repro_torch.core import prng
from repro_torch.core.engine import design
from repro_torch.core.hardware import DEFAULT_HW, Hardware
from repro_torch.core.phases import (IterationTimeline, from_dryrun_cell,
                                     load_cell, synthetic_timeline)
from repro_torch.core.smoothing.battery import RackBattery
from repro_torch.core.smoothing.gpu_floor import GpuPowerSmoothing
from repro_torch.core.spec import UtilitySpec, example_specs
from repro_torch.core.study import MitigationConfig, StudyResult, run_rows
from repro_torch.core.waveform import (WaveformConfig, aggregate_host,
                                       chip_waveform_host, phase_levels)
from repro_torch.device import resolve_device


def default_catalog(swing_w: float, *,
                    mpf_grid: Sequence[float] = (0.5, 0.65, 0.8, 0.9),
                    cap_fracs: Sequence[float] = (0.5, 1.0, 2.0),
                    ramp_w_per_s: float = 2000.0,
                    stop_delay_s: float = 1.0,
                    target_tau_s: float = 10.0,
                    hw: Hardware = DEFAULT_HW) -> List[MitigationConfig]:
    """The candidate catalog for a job whose raw datacenter swing is
    ``swing_w``: the unmitigated baseline, each MPF floor alone, each
    battery sizing alone, and every pairing."""
    gpus = {f"mpf{int(m * 100)}": GpuPowerSmoothing(
        mpf_frac=m, hw=hw, ramp_up_w_per_s=ramp_w_per_s,
        ramp_down_w_per_s=ramp_w_per_s, stop_delay_s=stop_delay_s)
        for m in mpf_grid}
    bats = {f"bat{f:g}x": RackBattery(
        capacity_j=f * swing_w, max_discharge_w=swing_w,
        max_charge_w=swing_w, target_tau_s=target_tau_s)
        for f in cap_fracs}
    catalog = [MitigationConfig("none")]
    catalog += [MitigationConfig(n, device=g) for n, g in gpus.items()]
    catalog += [MitigationConfig(n, rack=b) for n, b in bats.items()]
    catalog += [MitigationConfig(f"{gn}+{bn}", device=g, rack=b)
                for gn, g in gpus.items() for bn, b in bats.items()]
    return catalog


class PowerComplianceService:
    """Compliance queries over a mitigation catalog, on ``device`` (None:
    the card; without one the constructor raises unless ``device="cpu"``).

    One instance holds the waveform configuration, the catalog knobs, the
    PRNG root, the answer LRU and the workload memos; ``query`` takes the
    (workload, fleet, spec) triple.  The instance is thread-safe: its
    caches sit behind one lock, and identical concurrent misses are
    single-flighted.

    ``design_method="warmstart"`` sends the fallback through the learned
    warm start (``warmstart=`` takes a ``WarmStartPredictor`` or a
    checkpoint directory, loaded onto ``device``); every such answer is
    still re-validated under the hard semantics by the engine.
    """

    def __init__(self, *, wave_cfg: Optional[WaveformConfig] = None,
                 hw: Hardware = DEFAULT_HW,
                 mpf_grid: Sequence[float] = (0.5, 0.65, 0.8, 0.9),
                 cap_fracs: Sequence[float] = (0.5, 1.0, 2.0),
                 seeds: Sequence[int] = (0,),
                 key: Optional[int] = 0,
                 cache_size: int = 128,
                 design_fallback: bool = True,
                 design_method: str = "hybrid",
                 warmstart=None,
                 stream_chunk: int = 256,
                 memo_size: int = 32,
                 resume_dir: Optional[str] = None,
                 device=None):
        self.device = resolve_device(device)
        self.wave_cfg = wave_cfg or WaveformConfig(dt=0.002, steps=10,
                                                   jitter_s=0.002)
        self.hw = hw
        self.mpf_grid = tuple(mpf_grid)
        self.cap_fracs = tuple(cap_fracs)
        self.seeds = tuple(seeds)
        self.key = key
        self.cache_size = int(cache_size)
        self.design_fallback = design_fallback
        self.design_method = design_method
        if isinstance(warmstart, str):
            from repro_torch.serve.warmstart import WarmStartPredictor
            warmstart = WarmStartPredictor.load(warmstart,
                                                device=self.device)
        self.warmstart = warmstart
        if design_method == "warmstart" and warmstart is None:
            raise ValueError("design_method='warmstart' needs a warmstart= "
                             "predictor (object or checkpoint directory)")
        self.stream_chunk = int(stream_chunk)
        self.memo_size = int(memo_size)
        # each union execution checkpoints its chunks under a directory
        # named by its query set, so a query set asked again after a
        # restart finishes from where it stopped
        self.resume_dir = resume_dir
        self.last_result: Optional[StudyResult] = None
        # the mutable state below is guarded by _lock; the heavy work runs
        # outside it
        self._lock = threading.Lock()
        self._cache: "OrderedDict[Tuple, Dict]" = OrderedDict()
        self._inflight: Dict[Tuple, threading.Event] = {}
        self._wl_memo: "OrderedDict[Tuple, Dict]" = OrderedDict()
        self._agg_memo: "OrderedDict[Tuple, Dict]" = OrderedDict()
        self._feat_memo: "OrderedDict[Tuple, object]" = OrderedDict()
        self.stats = {"hits": 0, "misses": 0, "study_runs": 0,
                      "evictions": 0, "singleflight_waits": 0,
                      "feature_hits": 0, "feature_misses": 0}

    # -- caches -------------------------------------------------------------

    def _workload_key(self, workload) -> Union[int, str]:
        try:
            return hash(workload)
        except TypeError:
            return repr(workload)

    def _cache_key(self, workload, n_chips, spec, padding) -> Tuple:
        wk = self._workload_key(workload)
        sk = spec if isinstance(spec, str) else (spec.name, repr(spec))
        return (wk, int(n_chips), sk, padding, self.wave_cfg, self.seeds)

    @staticmethod
    def _memo_get(memo: OrderedDict, key):
        hit = memo.get(key)
        if hit is not None:
            memo.move_to_end(key)
        return hit

    def _memo_put(self, memo: OrderedDict, key, value) -> None:
        memo[key] = value
        memo.move_to_end(key)
        while len(memo) > self.memo_size:
            memo.popitem(last=False)

    def _workload_state(self, workload) -> Dict:
        """Per-workload memo: phase levels and one chip's trace."""
        wk = self._workload_key(workload)
        with self._lock:
            hit = self._memo_get(self._wl_memo, wk)
        if hit is not None:
            return hit
        cfg, hw = self.wave_cfg, self.hw
        state = {"levels": phase_levels(workload, cfg, hw),
                 "chip_w": chip_waveform_host(workload, cfg, hw)}
        with self._lock:
            self._memo_put(self._wl_memo, wk, state)
        return state

    def _fleet_state(self, workload, n_chips: int) -> Dict:
        """Per-(workload, fleet) memo: the aggregated datacenter waveform
        under the first seed's jitter (the waveform the fallback designs
        on and the catalog is sized from) and its swing and mean."""
        wk = (self._workload_key(workload), int(n_chips), self.seeds[0])
        with self._lock:
            hit = self._memo_get(self._agg_memo, wk)
        if hit is not None:
            return hit
        w = aggregate_host(self._workload_state(workload)["chip_w"], n_chips,
                           self.wave_cfg, self.hw, seed=self.seeds[0])
        state = {"w": w, "swing": float(w.max() - w.min()),
                 "mean_mw": float(w.mean()) / 1e6}
        with self._lock:
            self._memo_put(self._agg_memo, wk, state)
        return state

    def _features(self, workload, n_chips: int, spec: UtilitySpec):
        """The warm-start feature vector, memoized per (workload, fleet,
        spec)."""
        fk = (self._workload_key(workload), int(n_chips),
              spec.name, repr(spec))
        with self._lock:
            hit = self._memo_get(self._feat_memo, fk)
            if hit is not None:
                self.stats["feature_hits"] += 1
                return hit
            self.stats["feature_misses"] += 1
        from repro_torch.serve.warmstart import extract_features
        f = extract_features(spec, self._fleet_state(workload, n_chips)["w"],
                             self.wave_cfg.dt, n_chips)
        with self._lock:
            self._memo_put(self._feat_memo, fk, f)
        return f

    def cache_len(self) -> int:
        with self._lock:
            return len(self._cache)

    # -- single-flight answer cache -----------------------------------------

    def _lookup_or_lead(self, key: Tuple):
        """``("hit", answer)`` for a cached key; ``("lead", None)`` after
        claiming a miss.  A follower of an identical query in flight waits
        for the leader's event and looks again: after the leader's success
        the answer is cached, after its failure one follower leads."""
        while True:
            with self._lock:
                hit = self._cache.get(key)
                if hit is not None:
                    self._cache.move_to_end(key)
                    self.stats["hits"] += 1
                    return "hit", hit
                ev = self._inflight.get(key)
                if ev is None:
                    self._inflight[key] = threading.Event()
                    self.stats["misses"] += 1
                    return "lead", None
                self.stats["singleflight_waits"] += 1
            ev.wait()

    def _finish(self, key: Tuple, answer: Optional[Dict]) -> None:
        """The leader's epilogue: cache the answer (None on failure),
        release the in-flight slot, wake the followers."""
        with self._lock:
            if answer is not None:
                self._cache[key] = answer
                self._cache.move_to_end(key)
                while len(self._cache) > self.cache_size:
                    self._cache.popitem(last=False)
                    self.stats["evictions"] += 1
            ev = self._inflight.pop(key, None)
        if ev is not None:
            ev.set()

    # -- the query ----------------------------------------------------------

    def query(self, workload: IterationTimeline, n_chips: int,
              spec: Union[str, UtilitySpec] = "moderate", *,
              workload_name: str = "workload",
              padding: str = "auto",
              on_chunk=None) -> Dict:
        """(workload, fleet, spec) -> which catalog configurations pass,
        ranked by worst (over seeds) energy overhead.  ``on_chunk(done,
        total, elapsed_s)`` reports the streaming run's progress (hits and
        followers answer without it)."""
        key = self._cache_key(workload, n_chips, spec, padding)
        state, hit = self._lookup_or_lead(key)
        if state == "hit":
            return hit
        answer = None
        try:
            answer = self._execute(
                [(workload, int(n_chips), spec, workload_name, padding)],
                on_chunk=on_chunk)[0]
        finally:
            self._finish(key, answer)
        return answer

    def query_many(self, queries: Sequence[Dict], *, on_chunk=None
                   ) -> List[Dict]:
        """Answer N queries, every cache miss in ONE streaming execution
        over the union of their rows.

        Each query is a dict with ``workload`` and ``n_chips`` and
        optionally ``spec``, ``workload_name`` and ``padding`` (``query``'s
        arguments).  Hits come from the LRU, duplicate misses (in the
        batch or in flight on another thread) are single-flighted, and
        the distinct misses run as one ``run_rows``; the answers equal N
        serial ``query`` calls."""
        norm = []
        for q in queries:
            norm.append((q["workload"], int(q["n_chips"]),
                         q.get("spec", "moderate"),
                         q.get("workload_name", "workload"),
                         q.get("padding", "auto")))
        keys = [self._cache_key(w, n, s, p) for w, n, s, _, p in norm]

        answers: List[Optional[Dict]] = [None] * len(norm)
        lead_idx: List[int] = []
        follow_idx: List[int] = []
        claimed: Dict[Tuple, int] = {}
        for i, key in enumerate(keys):
            if key in claimed:          # a duplicate within this batch
                follow_idx.append(i)
                continue
            state, hit = self._lookup_or_lead(key)
            if state == "hit":
                answers[i] = hit
            else:
                claimed[key] = i
                lead_idx.append(i)

        if lead_idx:
            got: Optional[List[Dict]] = None
            try:
                got = self._execute([norm[i] for i in lead_idx],
                                    on_chunk=on_chunk)
            finally:
                for j, i in enumerate(lead_idx):
                    ans = None if got is None else got[j]
                    answers[i] = ans
                    self._finish(keys[i], ans)

        for i in follow_idx:
            # the leader (in this batch or on another thread) has cached
            # the answer, unless it failed and this one inherits the lead
            state, hit = self._lookup_or_lead(keys[i])
            if state == "hit":
                answers[i] = hit
            else:
                try:
                    answers[i] = self._execute([norm[i]])[0]
                finally:
                    self._finish(keys[i], answers[i])
        return answers

    # -- execution (misses only, outside the lock) ---------------------------

    def _execute(self, queries: Sequence[Tuple], *, on_chunk=None
                 ) -> List[Dict]:
        """Run N missed queries as ONE ``run_rows`` and build their
        answers.  Workload names are prefixed ``q{j}:`` and spec names
        ``s{j}:`` so each query's records filter back out; each row's key
        is folded from the query's local row index, so the union run
        equals running each query alone."""
        cfg, hw = self.wave_cfg, self.hw
        workloads: Dict[str, IterationTimeline] = {}
        rows: List[Tuple[str, int, MitigationConfig, int]] = []
        keys = [] if self.key is not None else None
        specs: List[Tuple[str, UtilitySpec]] = []
        resolved = []
        if self.key is not None:
            root = prng.as_key(self.key)

        for j, (workload, n_chips, spec, name, _padding) in enumerate(queries):
            fs = self._fleet_state(workload, n_chips)
            if isinstance(spec, str):
                spec = example_specs(job_mw=fs["mean_mw"])[spec]
            qname, sname = f"q{j}:{name}", f"s{j}:{spec.name}"
            workloads[qname] = workload
            catalog = default_catalog(fs["swing"], mpf_grid=self.mpf_grid,
                                      cap_fracs=self.cap_fracs, hw=hw)
            local = 0
            for c in catalog:
                for s in self.seeds:
                    rows.append((qname, n_chips, c, s))
                    if keys is not None:
                        keys.append(prng.fold_in(root, local))
                    local += 1
            specs.append((sname, spec))
            resolved.append((qname, sname, spec, catalog, fs))

        with self._lock:
            self.stats["study_runs"] += 1
        # bucket, not pad, when coalescing: a padded call's reductions
        # would differ from the serial query's, and the coalesced answers
        # must equal serial ones
        mode = queries[0][4] if len(queries) == 1 else "bucket"
        resume = None
        if self.resume_dir is not None:
            # one directory a query set, named by repr (str hashes change
            # from process to process); the checkpoint's own fingerprint
            # still catches a mismatch
            qsig = digest([(repr(q[0]), int(q[1]),
                            q[2] if isinstance(q[2], str) else repr(q[2]),
                            q[3], q[4]) for q in queries])
            resume = os.path.join(self.resume_dir, qsig[:32])
        result = run_rows(workloads, rows, specs, wave_cfg=cfg, hw=hw,
                          keys=keys, padding=mode,
                          stream=self.stream_chunk,
                          on_chunk=on_chunk, resume=resume,
                          device=self.device)
        self.last_result = result

        answers = []
        for j, (workload, n_chips, _spec, name, _padding) in enumerate(
                queries):
            qname, sname, spec, catalog, fs = resolved[j]
            sub = result.filter(workload=qname, spec=sname)
            answers.append(self._build_answer(
                workload, n_chips, spec, name, catalog, fs, sub))
        return answers

    def _build_answer(self, workload, n_chips: int, spec: UtilitySpec,
                      name: str, catalog, fs: Dict,
                      sub: StudyResult) -> Dict:
        passing_names = sub.passing_configs()
        by_config = {c: sub.filter(config=c) for c in passing_names}
        passing = [{
            "config": c,
            "energy_overhead":
                max(r["energy_overhead"] for r in by_config[c]),
            "swing_mitigated_mw":
                max(r["swing_mitigated_mw"] for r in by_config[c]),
        } for c in passing_names]
        designed = None
        if not passing and self.design_fallback:
            # no catalog configuration passes: design one for this query's
            # waveform (warmstart reads the memoized features; the engine
            # re-validates whatever it returns under the hard semantics)
            kwargs: Dict = {}
            if self.design_method == "warmstart":
                kwargs["warmstart"] = self.warmstart
                kwargs["features"] = self._features(workload, n_chips, spec)
            sol = design(spec, fs["w"], self.wave_cfg.dt, n_chips,
                         method=self.design_method, hw=self.hw,
                         device=self.device, **kwargs)
            if sol is not None:
                mit = sol["mitigated"]
                designed = {
                    "config": f"designed[{sol['method']}]",
                    "mpf_frac": sol["mpf_frac"],
                    "battery_capacity_j": sol["battery_capacity_j"],
                    "energy_overhead": sol["energy_overhead"],
                    "swing_mitigated_mw":
                        round(float(mit.max() - mit.min()) / 1e6, 4),
                    "alternatives": sol["alternatives"],
                    "designed": True,
                }
                if "warmstart_path" in sol.get("aux", {}):
                    designed["warmstart_path"] = sol["aux"]["warmstart_path"]
                passing = [designed]
        return {
            "workload": name,
            "n_chips": int(n_chips),
            "spec": spec.name,
            "mean_mw": round(fs["mean_mw"], 4),
            "raw_swing_mw": round(fs["swing"] / 1e6, 4),
            "n_configs": len(catalog),
            "n_scenarios": len(catalog) * len(self.seeds),
            "compliant": bool(passing),
            "recommended": passing[0]["config"] if passing else None,
            "passing": passing,
            "designed": designed,
        }

    # -- the control plane --------------------------------------------------

    def watch(self, workload: Optional[IterationTimeline] = None,
              n_chips: int = 512,
              spec: Union[str, UtilitySpec] = "moderate", *,
              replay=None, dt: Optional[float] = None,
              freqs: Optional[Sequence[float]] = None,
              tick_s: float = 0.5, window_s: float = 4.0,
              breach_w: Optional[float] = None, trigger_frac: float = 0.85,
              release_frac: float = 0.60, lead_s: float = 2.0,
              sustain_ticks: int = 2, release_ticks: int = 4,
              dispatch_ticks: int = 1, history_s: float = 8.0,
              max_ticks: Optional[int] = None) -> Dict:
        """Close the grid-interactive control loop over one stream, on the
        service's device.

        ``replay`` is a power trace sampled at ``dt`` (default: the
        service's dt); without it the stream is the service's own fleet
        waveform for ``workload``.  The loop runs the online
        sliding-Goertzel detector, the per-bin hysteresis and slope
        controller, and the intervention ladder whose first rung is this
        service's design path.  Returns a JSON-safe dict: the loop's
        configuration, its timeline and the whole ``ControlLog``.
        """
        from repro_torch.control import watch_trace
        dt = float(dt if dt is not None else self.wave_cfg.dt)
        if replay is not None:
            w = np.asarray(replay, np.float32)
        else:
            if workload is None:
                raise ValueError("watch() needs a workload or a replay=")
            w = self._fleet_state(workload, n_chips)["w"]
        if isinstance(spec, str):
            spec = example_specs(job_mw=float(w.mean()) / 1e6)[spec]
        log = watch_trace(
            w, dt, spec=spec, n_chips=int(n_chips), freqs=freqs,
            window_s=window_s, tick_s=tick_s, breach_w=breach_w,
            trigger_frac=trigger_frac, release_frac=release_frac,
            lead_s=lead_s, sustain_ticks=sustain_ticks,
            release_ticks=release_ticks, dispatch_ticks=dispatch_ticks,
            design_method=self.design_method, warmstart=self.warmstart,
            hw=self.hw, history_s=history_s, max_ticks=max_ticks,
            device=self.device)
        out = {"spec": spec.name, "n_chips": int(n_chips), "dt": dt,
               "tick_s": tick_s, "window_s": window_s,
               "design_method": self.design_method,
               "timeline": log.timeline()}
        out.update(log.to_json())
        return json.loads(json.dumps(out, default=float))

    # -- JSON boundary ------------------------------------------------------

    def _parse_workload(self, wl) -> Tuple[IterationTimeline, str]:
        if isinstance(wl, dict) and "cell" in wl:
            cell = load_cell(wl["cell"])
            return from_dryrun_cell(cell, self.hw), f"{cell.get('arch', 'cell')}"
        if isinstance(wl, dict):
            tl = synthetic_timeline(
                period_s=float(wl.get("period_s", 1.0)),
                comm_frac=float(wl.get("comm_frac", 0.25)),
                moe_notch=bool(wl.get("moe_notch", False)))
            return tl, wl.get("name", "synthetic")
        raise TypeError(f"unsupported workload request: {wl!r}")

    def handle(self, request: Dict, *, on_chunk=None) -> Dict:
        """One request dict -> one JSON-safe answer dict:

        ``{"workload": {"period_s": 2.0, "comm_frac": 0.25,
                        "moe_notch": false} | {"cell": "<dry-run json>"},
           "n_chips": 512, "spec": "lenient|moderate|tight"}``

        A request that cannot be parsed or read comes back as ``{"error":
        ...}``.  ``on_chunk`` is the host's progress callback (the CLI's
        ``--progress``), not part of the JSON boundary.
        """
        try:
            tl, name = self._parse_workload(request["workload"])
            answer = self.query(tl, int(request["n_chips"]),
                                request.get("spec", "moderate"),
                                workload_name=name, on_chunk=on_chunk)
            return json.loads(json.dumps(answer, default=float))
        except (KeyError, TypeError, ValueError, OSError) as e:
            return {"error": f"{type(e).__name__}: {e}"}

    def handle_many(self, requests: Sequence[Dict], *, on_chunk=None
                    ) -> List[Dict]:
        """N request dicts -> N JSON-safe answers, in order.  Requests that
        cannot be parsed come back as ``{"error": ...}`` in place; the rest
        go to ``query_many`` as one batch."""
        parsed: List[Optional[Dict]] = []
        out: List[Optional[Dict]] = [None] * len(requests)
        for i, req in enumerate(requests):
            try:
                tl, name = self._parse_workload(req["workload"])
                parsed.append({"workload": tl,
                               "n_chips": int(req["n_chips"]),
                               "spec": req.get("spec", "moderate"),
                               "workload_name": name})
            except (KeyError, TypeError, ValueError, OSError) as e:
                out[i] = {"error": f"{type(e).__name__}: {e}"}
                parsed.append(None)
        live = [i for i, p in enumerate(parsed) if p is not None]
        answers = self.query_many([parsed[i] for i in live],
                                  on_chunk=on_chunk) if live else []
        for i, ans in zip(live, answers):
            out[i] = json.loads(json.dumps(ans, default=float))
        return out


def _load_replay(arg: str, dt: float) -> np.ndarray:
    """``--replay``: "ramp" (the canonical 9 Hz amplitude ramp), a .npy
    array, or a JSON list of watts."""
    if arg == "ramp":
        from repro_torch.control import synthesize_ramp
        return synthesize_ramp(dt=dt)
    if arg.endswith(".npy"):
        return np.load(arg).astype(np.float32)
    with open(arg) as f:
        return np.asarray(json.load(f), np.float32)


def _device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")


def _watch_main(argv: Sequence[str]) -> None:
    ap = argparse.ArgumentParser(
        prog="repro-torch-serve watch",
        description="grid-interactive control loop over a replayed stream")
    ap.add_argument("--replay", default="ramp",
                    help="'ramp' | trace.npy | trace.json (watts)")
    ap.add_argument("--dt", type=float, default=0.002)
    ap.add_argument("--tick-s", type=float, default=0.5)
    ap.add_argument("--window-s", type=float, default=4.0)
    ap.add_argument("--n-chips", type=int, default=512)
    ap.add_argument("--spec", default="moderate",
                    choices=("lenient", "moderate", "tight"))
    ap.add_argument("--design-method", default="grid",
                    choices=("grid", "gradient", "hybrid", "warmstart"))
    ap.add_argument("--warmstart", default=None,
                    help="WarmStartPredictor checkpoint directory")
    ap.add_argument("--dispatch-ticks", type=int, default=1)
    ap.add_argument("--max-ticks", type=int, default=None)
    ap.add_argument("--timeline", action="store_true",
                    help="print the decision timeline instead of JSON")
    _device_arg(ap)
    args = ap.parse_args(argv)

    service = PowerComplianceService(design_method=args.design_method,
                                     warmstart=args.warmstart,
                                     device=args.device)
    answer = service.watch(
        n_chips=args.n_chips, spec=args.spec,
        replay=_load_replay(args.replay, args.dt), dt=args.dt,
        tick_s=args.tick_s, window_s=args.window_s,
        dispatch_ticks=args.dispatch_ticks, max_ticks=args.max_ticks)
    if args.timeline:
        print(answer["timeline"])
        print(json.dumps(answer["summary"], indent=2))
    else:
        answer.pop("timeline", None)
        print(json.dumps(answer, indent=2))


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "watch":
        return _watch_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="repro-torch-serve",
        description="power-spec compliance query (the Study API's serve "
                    "path); the subcommand 'watch' runs the grid-interactive "
                    "control loop over a replayed stream")
    ap.add_argument("--period-s", type=float, default=2.0)
    ap.add_argument("--comm-frac", type=float, default=0.25)
    ap.add_argument("--moe-notch", action="store_true")
    ap.add_argument("--cell", default=None,
                    help="dry-run cell JSON (overrides the synthetic "
                         "workload flags)")
    ap.add_argument("--n-chips", type=int, default=512)
    ap.add_argument("--spec", default="moderate",
                    choices=("lenient", "moderate", "tight"))
    ap.add_argument("--design-method", default="hybrid",
                    choices=("grid", "gradient", "hybrid", "warmstart"),
                    help="fallback solver when no catalog config passes")
    ap.add_argument("--warmstart", default=None,
                    help="WarmStartPredictor checkpoint directory "
                         "(required for --design-method warmstart)")
    ap.add_argument("--progress", action="store_true",
                    help="report the streaming run's progress on stderr")
    _device_arg(ap)
    args = ap.parse_args(argv)

    workload: Dict = ({"cell": args.cell} if args.cell else
                      {"period_s": args.period_s, "comm_frac": args.comm_frac,
                       "moe_notch": args.moe_notch})
    on_chunk = None
    if args.progress:
        def on_chunk(done: int, total: int, elapsed: float) -> None:
            print(f"# {done}/{total} scenarios in {elapsed:.1f}s",
                  file=sys.stderr)
    service = PowerComplianceService(design_method=args.design_method,
                                     warmstart=args.warmstart,
                                     device=args.device)
    answer = service.handle({"workload": workload, "n_chips": args.n_chips,
                             "spec": args.spec}, on_chunk=on_chunk)
    print(json.dumps(answer, indent=2))
    if "error" in answer:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
