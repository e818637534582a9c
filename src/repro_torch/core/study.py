"""Declarative Study API: declare scenario axes once, run the grid as a
few whole-batch passes on the card, query the results.

  study = Study(
      workloads={"dense_2s": synthetic_timeline(2.0, 0.19),
                 "moe_3s": synthetic_timeline(3.0, 0.25, moe_notch=True)},
      fleets=[256, 512],
      configs={"none": None, "mpf90+bat": (gpu, battery)},
      specs=example_specs(job_mw=100.0),
      seeds=[0, 1],
      key=0)
  result = study.run()                      # or run(stream=512, resume=dir)
  result.passing().pivot("workload", "config", "energy_overhead")

Rows are grouped by mitigation *structure* (a disabled stage joins the
first concrete structure); ``padding="pad"`` runs each group's mixed
lengths as one padded batch, ``"bucket"`` one batch per length, and
``"auto"`` pads iff lengths mix.  Physics runs once per (workload, fleet,
config, seed) row; each spec then judges every row.  Results come back
as a columnar ``StudyResult`` with query and export helpers.

``key`` is the PRNG root of mitigation randomness (telemetry noise):
pipeline row ``r`` draws from ``fold_in(prng_key(key), r)``, the key JAX
would give the reference's row (``core/prng.py``); ``key=None`` gives
every row the shared ``prng_key(0)`` draw.  ``run(stream=N)`` runs each
call stream in chunks of ``N`` rows (``True``: ``DEFAULT_STREAM_CHUNK``),
equal to the one-shot run bit for bit, and ``resume=dir`` checkpoints
each chunk there (``ckpt/resume.py``) so that a stopped or extended run
computes only what is missing.

``Study(keep_waveforms=True)`` also brings every row's raw and mitigated
waveforms to the host (``StudyResult.sim_result``).  ``optimize()`` runs
the engine's ``design`` per (workload, fleet, spec) cell and returns the
solved configurations as ``designed=True`` records in the same schema.

``device=None`` means ``"cuda"``, and a run without a card raises unless
the caller asked for ``device="cpu"`` (the kernels' plain versions).

``Study(plan=ScenarioShardPlan...)`` (or ``shard_devices=True``: every
local card) shards the scenario axis across devices and processes
(``repro_torch.parallel``): each computes its rows of every chunk, the
per-row metrics are merged on the host, and every process ends with the
same ``StudyResult``, equal to a one-process run's.  Under a plan that
spans processes, ``on_chunk`` and checkpoint writes happen on process 0
only.
"""
from __future__ import annotations

import csv
import dataclasses
import io
import json
import time
from typing import (Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from repro_torch.ckpt.resume import ResumeError, SweepCheckpoint
from repro_torch.core import prng
from repro_torch.core.engine import (StreamChunk, _resolve_plan, design,
                                     stream_batches)
from repro_torch.core.hardware import DEFAULT_HW, Hardware
from repro_torch.core.phases import IterationTimeline
from repro_torch.core.smoothing.base import structure
from repro_torch.core.spec import UtilitySpec
from repro_torch.core.spectrum import critical_band_report
from repro_torch.core.stratosim import SimResult
from repro_torch.core.waveform import (WaveformConfig, job_waveform,
                                       phase_levels)
from repro_torch.device import resolve_device
from repro_torch.parallel import distributed
from repro_torch.parallel.collectives import gather_parts
from repro_torch.parallel.sharding import ScenarioShardPlan

PADDING_MODES = ("auto", "pad", "bucket")

# chunk size of Study.run(stream=True)
DEFAULT_STREAM_CHUNK = 512

# ---------------------------------------------------------------------------
# axis declarations
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MitigationConfig:
    """One named point on the mitigation axis.  Either stage may be None;
    the fully-disabled config is the unmitigated baseline."""
    name: str
    device: Optional[object] = None
    rack: Optional[object] = None

    @property
    def enabled(self) -> bool:
        return self.device is not None or self.rack is not None


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One cell of the study grid: records align by ``index``; ``row`` is
    the pipeline row, shared across the spec axis and the input to
    ``Study.scenario_key``."""
    index: int
    row: int
    workload: str
    n_chips: int
    config: MitigationConfig
    spec_name: Optional[str]
    spec: Optional[UtilitySpec]
    seed: int


def _one_config(name: str, entry) -> MitigationConfig:
    if entry is None:
        return MitigationConfig(name)
    if isinstance(entry, MitigationConfig):
        return entry if entry.name == name else dataclasses.replace(entry,
                                                                    name=name)
    if isinstance(entry, (tuple, list)) and len(entry) == 2:
        return MitigationConfig(name, device=entry[0], rack=entry[1])
    raise TypeError(
        f"config {name!r}: expected None, MitigationConfig, or a "
        f"(device_mitigation, rack_mitigation) pair, got {type(entry).__name__}"
        " (a bare mitigation is ambiguous between the per-chip device stage"
        " and the aggregate rack stage)")


def _as_configs(configs) -> List[MitigationConfig]:
    if configs is None:
        return [MitigationConfig("none")]
    if isinstance(configs, MitigationConfig):
        return [configs]
    if isinstance(configs, Mapping):
        return [_one_config(name, entry) for name, entry in configs.items()]
    out = []
    for i, entry in enumerate(configs):
        default = "none" if entry is None else f"config{i}"
        name = entry.name if isinstance(entry, MitigationConfig) else default
        out.append(_one_config(name, entry))
    return out


def _as_workloads(workloads) -> Dict[str, IterationTimeline]:
    if isinstance(workloads, IterationTimeline):
        return {"workload0": workloads}
    if isinstance(workloads, Mapping):
        return dict(workloads)
    return {f"workload{i}": tl for i, tl in enumerate(workloads)}


def _as_specs(specs) -> List[Tuple[Optional[str], Optional[UtilitySpec]]]:
    if specs is None:
        return [(None, None)]
    if isinstance(specs, UtilitySpec):
        return [(specs.name, specs)]
    if isinstance(specs, Mapping):
        return [(name, s) for name, s in specs.items()]
    return [(s.name, s) for s in specs]


def _as_seq(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


# ---------------------------------------------------------------------------
# row-level execution
# ---------------------------------------------------------------------------

def _is_primary() -> bool:
    """Process 0 owns side effects (progress callbacks, checkpoint
    writes); a run in one process is always primary."""
    return distributed.is_primary()


def _structure_groups(rows) -> List[List[int]]:
    """Row indices grouped by (device, rack) structure.  A None stage is a
    wildcard: it takes the first concrete structure of its stage."""
    def struct(m):
        return None if m is None else structure(m)

    dev_first = next((struct(c.device) for _, _, c, _ in rows
                      if c.device is not None), None)
    rack_first = next((struct(c.rack) for _, _, c, _ in rows
                       if c.rack is not None), None)
    groups: Dict[Tuple, List[int]] = {}
    for r, (_, _, c, _) in enumerate(rows):
        k = (struct(c.device) if c.device is not None else dev_first,
             struct(c.rack) if c.rack is not None else rack_first)
        groups.setdefault(k, []).append(r)
    return list(groups.values())


def _same_on_every_process(plan: Optional[ScenarioShardPlan], call: str,
                           skip: int) -> None:
    """Raise unless every process restored the same rows of a call
    stream from the resume directory."""
    if plan is None or plan.n_processes <= 1:
        return
    skips = gather_parts([skip], plan)
    if len(set(skips)) > 1:
        raise ResumeError(f"call stream {call}: the processes restored "
                          f"different row counts {skips} from the resume "
                          "directory")


def _chunk_size(stream) -> Optional[int]:
    """``Study.run``'s ``stream`` -> chunk size (None: one chunk)."""
    if stream is None or stream is False:
        return None
    if stream is True:
        return DEFAULT_STREAM_CHUNK
    chunk_size = int(stream)
    if chunk_size < 1:
        raise ValueError(f"stream chunk size must be >= 1, got {stream}")
    return chunk_size


def run_rows(workloads: Mapping[str, IterationTimeline],
             rows: Sequence[Tuple[str, int, MitigationConfig, int]],
             specs: Sequence[Tuple[Optional[str], Optional[UtilitySpec]]],
             *, wave_cfg: Optional[WaveformConfig] = None,
             hw: Hardware = DEFAULT_HW, keys: Optional[Sequence] = None,
             padding: str = "auto", stream: Union[None, bool, int] = None,
             sample_chips: int = 64,
             on_chunk: Optional[Callable[[int, int, float], None]] = None,
             resume: Optional[str] = None, keep_waveforms: bool = False,
             plan: Optional[ScenarioShardPlan] = None,
             shard_devices: bool = False, device=None) -> "StudyResult":
    """Run an explicit list of pipeline rows ``(workload_name, n_chips,
    MitigationConfig, seed)`` and return the columnar ``StudyResult``
    (record ``r * len(specs) + si`` is row ``r`` under spec ``si``).

    ``keys`` gives one PRNG key per row (None: the shared draw).
    ``stream`` picks the chunk size as in ``Study.run``.  ``on_chunk(done,
    total, elapsed_s)`` is called after every chunk with the pipeline rows
    finished so far.  ``resume=dir`` checkpoints every finished chunk into
    ``dir`` (``ckpt/resume.SweepCheckpoint``); a rerun with the same, or
    an append-extended, row list restores the finished chunks (reported
    in one leading ``on_chunk`` call per call stream) and computes only
    the rest, equal to an uninterrupted run.  A changed grid, chunk size
    or a corrupt checkpoint raises ``ResumeError``.  ``resume`` needs
    ``stream`` and excludes ``keep_waveforms`` (waveforms are not
    checkpointed), which keeps every row's waveforms for
    ``StudyResult.sim_result``.

    ``plan`` / ``shard_devices`` shard every chunk's rows across devices
    and processes (``engine.stream_batches``); every process calls this
    with the same rows and gets the same result.  Progress is global and
    primary-only: ``on_chunk`` counts the rows of the whole grid and runs
    on process 0 alone, which alone writes checkpoints; every process
    restores the same finished chunks (checked across processes)."""
    dev = resolve_device(device)
    plan = _resolve_plan(plan, shard_devices, dev)
    primary = _is_primary()
    cfg = wave_cfg or WaveformConfig()
    if padding not in PADDING_MODES:
        raise ValueError(f"padding must be one of {PADDING_MODES}")
    chunk_size = _chunk_size(stream)
    rows, specs = list(rows), list(specs)
    if keys is not None:
        keys = [prng.as_key(k) for k in keys]
        if len(keys) != len(rows):
            raise ValueError(f"keys: got {len(keys)}, expected {len(rows)}")
    levels = {w: phase_levels(workloads[w], cfg, hw)
              for w in {w for w, _, _, _ in rows}}
    row_len = [len(levels[w]) for w, _, _, _ in rows]
    mode = padding
    if mode == "auto":
        mode = "pad" if len(set(row_len)) > 1 else "bucket"
    ckpt = None
    if resume is not None:
        if chunk_size is None:
            raise ValueError(
                "resume= requires streaming (pass stream=True or stream=N): "
                "chunk boundaries are the checkpoint points")
        if keep_waveforms:
            raise ValueError(
                "resume= does not support keep_waveforms=True: waveforms "
                "are not checkpointed, so a resumed result would miss them")
        ckpt = SweepCheckpoint(resume)
        ckpt.validate_or_init(workloads=workloads, rows=rows, specs=specs,
                              keys=keys, cfg=cfg, hw=hw, mode=mode,
                              sample_chips=sample_chips,
                              chunk_size=chunk_size, write=primary)
    if not primary:
        on_chunk = None
    cols = _empty_columns(len(rows) * len(specs))
    waveforms = [None] * len(rows) if keep_waveforms else None
    total, done = len(rows), 0
    t0 = time.perf_counter()
    for gi, sg_rows in enumerate(_structure_groups(rows)):
        if mode == "pad":
            calls = [(f"g{gi}-pad", sg_rows)]
        else:
            by_len: Dict[int, List[int]] = {}
            for r in sg_rows:
                by_len.setdefault(row_len[r], []).append(r)
            calls = [(f"g{gi}-L{L}", idx)
                     for L, idx in sorted(by_len.items())]
        for call_key, idx in calls:
            lens = {row_len[r] for r in idx}
            cs = max(1, min(chunk_size or len(idx), len(idx)))
            skip = 0
            if ckpt is not None:
                skip = ckpt.restore_call(call_key, idx, cs, cols, len(specs))
                _same_on_every_process(plan, call_key, skip)
                if skip:
                    done += skip
                    if on_chunk is not None:
                        on_chunk(done, total, time.perf_counter() - t0)
                if skip >= len(idx):
                    continue
            for ch in stream_batches(
                    [workloads[rows[r][0]] for r in idx],
                    [rows[r][1] for r in idx], cfg,
                    device_mitigation=[rows[r][2].device for r in idx],
                    rack_mitigation=[rows[r][2].rack for r in idx],
                    specs=[sp for _, sp in specs], hw=hw,
                    seeds=[rows[r][3] for r in idx],
                    keys=(None if keys is None
                          else torch.stack([keys[r] for r in idx])),
                    sample_chips=sample_chips,
                    levels=[levels[rows[r][0]] for r in idx],
                    pad_to=max(lens) if len(lens) > 1 else None,
                    chunk_size=cs, bands=True, skip_rows=skip,
                    keep_waveforms=keep_waveforms, plan=plan, device=dev):
                _fill_chunk(cols, rows, row_len, idx, ch, specs=specs,
                            workloads=workloads)
                if waveforms is not None:
                    for j in range(len(ch)):
                        r, L = idx[ch.start + j], row_len[idx[ch.start + j]]
                        waveforms[r] = {
                            "t": np.arange(L) * cfg.dt,
                            "dc_raw": ch.dc_raw[j, :L],
                            "dc_mitigated": ch.dc_mitigated[j, :L]}
                if ckpt is not None and primary:
                    ckpt.save_chunk(call_key, idx, ch.start, ch.stop, cols,
                                    len(specs))
                done += len(ch)
                if on_chunk is not None:
                    on_chunk(done, total, time.perf_counter() - t0)
    return StudyResult(cols, waveforms)


def _fill_chunk(cols: Dict[str, np.ndarray], rows, row_len, idx: List[int],
                ch: StreamChunk, *, specs, workloads) -> None:
    """Write one ``StreamChunk``'s metrics into the columnar record
    store (record position = pipeline row * n_specs + spec index)."""
    S = len(specs)
    for j in range(len(ch)):
        r = idx[ch.start + j]
        wname, n_chips, config, seed = rows[r]
        base = {
            "row": r, "workload": wname, "n_chips": n_chips,
            "config": config.name, "seed": seed,
            "period_s": float(workloads[wname].period_s),
            "n_samples": row_len[r],
            "mean_mw": float(ch.swing["mean_w"][j]) / 1e6,
            "swing_mw": float(ch.swing["swing_w"][j]) / 1e6,
            "swing_mitigated_mw":
                float(ch.swing_mitigated["swing_w"][j]) / 1e6,
            "energy_overhead": float(ch.energy_overhead[j]),
            "paper_band_frac":
                float(ch.bands_mitigated["paper_band_0p2_3hz"][j]),
            "designed": False,
        }
        for si, (spec_name, spec) in enumerate(specs):
            p = r * S + si
            for k, v in base.items():
                cols[k][p] = v
            cols["spec"][p] = spec_name
            if spec is None:
                cols["spec_ok"][p] = None
                cols["violations"][p] = ()
                continue
            report = ch.report(si, j)
            cols["spec_ok"][p] = report.ok
            cols["violations"][p] = report.violations
            # spec metrics live in numeric side columns "metrics:<name>"
            # (NaN = not measured for this record), not per-record dicts,
            # made in name order (the reference's metric dicts are sorted)
            for mk, mv in sorted(report.metrics.items()):
                mc = cols.get("metrics:" + mk)
                if mc is None:
                    mc = cols["metrics:" + mk] = np.full(len(cols["index"]),
                                                         np.nan)
                mc[p] = mv


# ---------------------------------------------------------------------------
# the study
# ---------------------------------------------------------------------------

class Study:
    """A declared scenario grid; ``run()`` runs it on ``device``.

    Axes (each a singleton or a collection):
      workloads  name -> IterationTimeline (dict, sequence, or one timeline)
      fleets     chip counts
      configs    name -> None | MitigationConfig | (device, rack) pair
      specs      None | UtilitySpec | dict name -> spec | sequence
      seeds      jitter seeds (per-chip phase jitter draws)

    ``key`` is the PRNG root: an int seed, or a key (a tensor or array of
    two uint32 words, the port's form of a JAX key); pipeline row ``r``
    draws from ``fold_in(root, r)``.  ``None`` gives every row the shared
    draw.  ``plan`` (a ``ScenarioShardPlan``) or ``shard_devices=True``
    (every local card) shards the scenario axis (``run_rows``).
    """

    def __init__(self, workloads, *, fleets=(512,), configs=None,
                 specs=None, seeds=(0,),
                 wave_cfg: Optional[WaveformConfig] = None,
                 hw: Hardware = DEFAULT_HW, key=0, padding: str = "auto",
                 sample_chips: int = 64, keep_waveforms: bool = False,
                 device=None, plan: Optional[ScenarioShardPlan] = None,
                 shard_devices: bool = False):
        if padding not in PADDING_MODES:
            raise ValueError(f"padding must be one of {PADDING_MODES}")
        self.workloads = _as_workloads(workloads)
        self.fleets = [int(n) for n in _as_seq(fleets)]
        self.configs = _as_configs(configs)
        self.specs = _as_specs(specs)
        self.seeds = [int(s) for s in _as_seq(seeds)]
        self.wave_cfg = wave_cfg or WaveformConfig()
        self.hw = hw
        self.key = None if key is None else prng.as_key(key)
        self.padding = padding
        self.sample_chips = sample_chips
        self.keep_waveforms = keep_waveforms
        self.device = device
        self.plan = plan
        self.shard_devices = shard_devices
        names = [c.name for c in self.configs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate config names: {names}")

    @property
    def n_rows(self) -> int:
        """Pipeline rows: the grid without the (physics-free) spec axis."""
        return (len(self.workloads) * len(self.fleets) * len(self.configs)
                * len(self.seeds))

    def __len__(self) -> int:
        return self.n_rows * len(self.specs)

    def rows(self) -> List[Tuple[str, int, MitigationConfig, int]]:
        """Pipeline rows in study order: workload-major, then fleet,
        config, seed."""
        return [(w, n, c, s)
                for w in self.workloads for n in self.fleets
                for c in self.configs for s in self.seeds]

    def scenarios(self) -> List[Scenario]:
        out = []
        for r, (w, n, c, s) in enumerate(self.rows()):
            for sn, sp in self.specs:
                out.append(Scenario(index=len(out), row=r, workload=w,
                                    n_chips=n, config=c, spec_name=sn,
                                    spec=sp, seed=s))
        return out

    def scenario_key(self, row: int) -> Optional[torch.Tensor]:
        """The key pipeline row ``row`` draws mitigation randomness from:
        int64 ``[2]`` on the CPU, or None without a root key."""
        if self.key is None:
            return None
        return prng.fold_in(self.key, row)

    def describe(self) -> str:
        lens = sorted({len(phase_levels(tl, self.wave_cfg, self.hw))
                       for tl in self.workloads.values()})
        return (f"Study: {len(self.workloads)} workloads x "
                f"{len(self.fleets)} fleets x {len(self.configs)} configs x "
                f"{len(self.seeds)} seeds = {self.n_rows} scenarios "
                f"({len(self.specs)} specs -> {len(self)} records); "
                f"waveform lengths {lens}, padding={self.padding}")

    def run(self, *, padding: Optional[str] = None,
            stream: Union[None, bool, int] = None,
            on_chunk: Optional[Callable[[int, int, float], None]] = None,
            resume: Optional[str] = None) -> "StudyResult":
        """Run the grid on the study's device: one call stream per
        structure group (and per length in bucket mode), each in one chunk
        (``stream`` None or False), in chunks of ``DEFAULT_STREAM_CHUNK``
        rows (True) or of ``stream`` rows, the same records bit for bit
        either way, and under the study's plan too.  ``on_chunk`` and
        ``resume`` as in ``run_rows``."""
        rows = self.rows()
        keys = (None if self.key is None else
                list(prng.fold_in(self.key,
                                  torch.arange(len(rows), dtype=torch.int64))))
        return run_rows(self.workloads, rows, self.specs,
                        wave_cfg=self.wave_cfg, hw=self.hw, keys=keys,
                        padding=padding or self.padding, stream=stream,
                        sample_chips=self.sample_chips, on_chunk=on_chunk,
                        resume=resume, keep_waveforms=self.keep_waveforms,
                        plan=self.plan, shard_devices=self.shard_devices,
                        device=self.device)

    def optimize(self, *, method: str = "hybrid", seed: Optional[int] = None,
                 **design_kwargs) -> "StudyResult":
        """A mitigation *design* per (workload, fleet, spec) cell.

        Where ``run()`` judges the declared configs, ``optimize()`` asks
        ``engine.design`` (``method`` grid, gradient, hybrid or warmstart)
        for a minimal-overhead (MPF, battery) pair that passes each
        declared spec on the cell's trace (the study's first seed's jitter
        draw, or ``seed``'s), and returns one ``designed=True`` record per
        cell, in ``run()``'s schema plus the solved ``mpf_frac`` and
        ``battery_capacity_j``.  A cell with no feasible design comes back
        ``spec_ok=False`` with ``violations=("infeasible",)``.  Extra
        keywords go to ``design`` (``steps``, ``smooth_tau``, ``top_k``).
        """
        cfg, hw = self.wave_cfg, self.hw
        dev = resolve_device(self.device)
        seed = self.seeds[0] if seed is None else int(seed)
        records: List[Dict] = []
        for wname, tl in self.workloads.items():
            for n_chips in self.fleets:
                _, w = job_waveform(tl, n_chips, cfg, hw, seed=seed,
                                    sample_chips=self.sample_chips,
                                    device=dev)
                w64 = w.astype(np.float64)
                for spec_name, spec in self.specs:
                    if spec is None:
                        continue
                    sol = design(spec, w, cfg.dt, n_chips, method=method,
                                 hw=hw, device=dev, **design_kwargs)
                    rec = {
                        "index": len(records),
                        "row": -1,           # no pipeline row backs a design
                        "workload": wname, "n_chips": n_chips,
                        "config": f"designed[{method}]", "spec": spec_name,
                        "seed": seed, "period_s": float(tl.period_s),
                        "n_samples": len(w),
                        "mean_mw": float(np.mean(w64)) / 1e6,
                        "swing_mw": float(w64.max() - w64.min()) / 1e6,
                        "designed": True,
                    }
                    if sol is None:
                        rec.update({
                            "swing_mitigated_mw": rec["swing_mw"],
                            "energy_overhead": 0.0, "paper_band_frac": None,
                            "spec_ok": False, "violations": ("infeasible",),
                            "metrics": {}, "mpf_frac": None,
                            "battery_capacity_j": None})
                    else:
                        mit = np.asarray(sol["mitigated"])
                        band = critical_band_report(torch.as_tensor(
                            mit, device=dev)[None], cfg.dt)
                        rec.update({
                            "swing_mitigated_mw":
                                float(mit.max() - mit.min()) / 1e6,
                            "energy_overhead": float(sol["energy_overhead"]),
                            "paper_band_frac":
                                float(band["paper_band_0p2_3hz"][0]),
                            "spec_ok": sol["report"].ok,
                            "violations": sol["report"].violations,
                            "metrics": sol["report"].metrics,
                            "mpf_frac": sol["mpf_frac"],
                            "battery_capacity_j": sol["battery_capacity_j"],
                        })
                    records.append(rec)
        return StudyResult(records=records)


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------

# the columnar record schema (field order = record dict key order)
_COLUMN_DTYPES = (
    ("index", np.int64), ("row", np.int64), ("workload", object),
    ("n_chips", np.int64), ("config", object), ("spec", object),
    ("seed", np.int64), ("period_s", np.float64), ("n_samples", np.int64),
    ("mean_mw", np.float64), ("swing_mw", np.float64),
    ("swing_mitigated_mw", np.float64), ("energy_overhead", np.float64),
    ("paper_band_frac", np.float64), ("designed", np.bool_),
    ("spec_ok", object), ("violations", object),
)


def _empty_columns(n: int) -> Dict[str, np.ndarray]:
    cols = {k: np.empty(n, dtype=dt) for k, dt in _COLUMN_DTYPES}
    cols["index"] = np.arange(n, dtype=np.int64)
    return cols


def _to_py(v):
    """numpy scalar -> the python scalar a record holds."""
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


class StudyResult:
    """Flat scenario records with query helpers.

    Each record is one (workload, fleet, config, seed, spec) cell:
    identity fields, swing/overhead/band metrics and, when a spec was
    declared, ``spec_ok`` / ``violations`` / the spec's metric dict.  A
    run's records are stored columnar (``columns=``; the metrics as
    ``metrics:<name>`` side columns, NaN where a record's spec did not
    measure that key) and built on demand; ``records=`` keeps a list of
    dicts as given (``Study.optimize``'s, or concatenated results).
    ``waveforms`` holds each row's waveforms where the Study kept them.
    """

    def __init__(self, columns: Optional[Dict[str, np.ndarray]] = None,
                 waveforms: Optional[List[Dict]] = None, *,
                 records: Optional[List[Dict]] = None):
        if columns is not None and records is not None:
            raise ValueError("pass records= or columns=, not both")
        self._cols = columns
        self._rows = None if columns is not None else list(records or [])
        self._n = (len(columns["index"]) if columns is not None
                   else len(self._rows))
        self.waveforms = waveforms

    def _row(self, i: int) -> Dict:
        if self._rows is not None:
            return self._rows[i]
        rec = {k: _to_py(col[i]) for k, col in self._cols.items()
               if not k.startswith("metrics:")}
        rec["metrics"] = {k[8:]: _to_py(col[i])
                          for k, col in self._cols.items()
                          if k.startswith("metrics:")
                          and not np.isnan(col[i])}
        return rec

    @property
    def records(self) -> List[Dict]:
        if self._rows is not None:
            return self._rows
        return [self._row(i) for i in range(self._n)]

    @property
    def columns(self) -> Optional[Dict[str, np.ndarray]]:
        return self._cols

    def _field(self, name: str):
        if self._rows is not None:
            return [r.get(name) for r in self._rows]
        col = self._cols.get(name)
        return [None] * self._n if col is None else col

    def _subset(self, keep: Sequence[int]) -> "StudyResult":
        if self._rows is not None:
            return StudyResult(records=[self._rows[i] for i in keep],
                               waveforms=self.waveforms)
        idx = np.asarray(keep, dtype=np.int64)
        return StudyResult({k: col[idx] for k, col in self._cols.items()},
                           self.waveforms)

    def __len__(self) -> int:
        return self._n

    def __iter__(self) -> Iterator[Dict]:
        return (self._row(i) for i in range(self._n))

    def __getitem__(self, i: int) -> Dict:
        return self._row(i)

    def filter(self, **where) -> "StudyResult":
        """Records whose field equals the given value (or is contained in
        it, when a list/tuple/set is given): ``filter(workload="moe_3s",
        config=["none", "mpf90"])``."""
        fields = {k: self._field(k) for k in where}
        keep = []
        for i in range(self._n):
            for k, v in where.items():
                got = _to_py(fields[k][i])
                if isinstance(v, (list, tuple, set, frozenset)):
                    if got not in v:
                        break
                elif got != v:
                    break
            else:
                keep.append(i)
        return self._subset(keep)

    def passing(self) -> "StudyResult":
        ok = self._field("spec_ok")
        return self._subset([i for i in range(self._n) if ok[i]])

    def failing(self) -> "StudyResult":
        ok = self._field("spec_ok")
        return self._subset([i for i in range(self._n) if ok[i] is False])

    def unique(self, field: str) -> List:
        """A field's distinct values in first-seen order."""
        seen: Dict = {}
        for v in self._field(field):
            seen.setdefault(_to_py(v), None)
        return list(seen)

    def best(self, by: str = "energy_overhead",
             among_passing: bool = True) -> Optional[Dict]:
        """The record of least ``by`` (among spec-passing ones by
        default), or None."""
        pool = self.passing() if among_passing else self
        if not len(pool):
            return None
        vals = pool._field(by)
        return pool._row(int(np.argmin([_to_py(v) for v in vals])))

    def passing_configs(self, **where) -> List[str]:
        """Names of the configs every matching record of which passes its
        spec, ordered by worst-case energy overhead."""
        sub = self.filter(**where)
        configs, oks = sub._field("config"), sub._field("spec_ok")
        overheads = sub._field("energy_overhead")
        worst: Dict[str, float] = {}
        ok: Dict[str, bool] = {}
        for i in range(len(sub)):
            c = configs[i]
            ok[c] = ok.get(c, True) and bool(oks[i])
            worst[c] = max(worst.get(c, -np.inf), overheads[i])
        return sorted((c for c, good in ok.items() if good),
                      key=lambda c: worst[c])

    def pivot(self, index: str, columns: str,
              values: str = "spec_ok") -> Dict:
        """Nested dict table: ``pivot("workload", "config",
        "energy_overhead")[w][c]``.  Cells with several matching records
        keep the first."""
        idx_v, col_v = self._field(index), self._field(columns)
        val_v = self._field(values)
        out: Dict = {}
        for i in range(self._n):
            out.setdefault(_to_py(idx_v[i]), {}).setdefault(
                _to_py(col_v[i]), _to_py(val_v[i]))
        return out

    def table(self, columns: Optional[Sequence[str]] = None) -> str:
        """Records as a markdown table (spec verdicts rendered PASS/fail)."""
        if not self._n:
            return "(no records)"
        columns = list(columns or [
            "workload", "n_chips", "config", "spec", "seed", "swing_mw",
            "swing_mitigated_mw", "energy_overhead", "spec_ok"])

        def cell(r, c):
            v = r.get(c)
            if c == "spec_ok" and v is not None:
                return "PASS" if v else ",".join(r["violations"]) or "FAIL"
            if isinstance(v, float):
                return f"{v:.4g}"
            return str(v)

        lines = ["| " + " | ".join(columns) + " |",
                 "|" + "---|" * len(columns)]
        lines += ["| " + " | ".join(cell(r, c) for c in columns) + " |"
                  for r in self]
        return "\n".join(lines)

    def to_records(self) -> List[Dict]:
        """JSON-safe copies (tuples -> lists) of every record."""
        return json.loads(self.to_json())

    def to_json(self, path: Optional[str] = None) -> str:
        """Every record as a JSON list (written to ``path`` if given)."""
        text = json.dumps(self.records, indent=2, default=list)
        if path is not None:
            with open(path, "w") as fh:
                fh.write(text + "\n")
        return text

    def to_csv(self, path: Optional[str] = None) -> str:
        """Scalar record fields as CSV (violations joined by ``;``, the
        metric dict flattened under a ``metrics.`` prefix)."""
        rows = []
        for r in self.records:
            flat = {k: v for k, v in r.items()
                    if not isinstance(v, (dict, tuple, list))}
            flat["violations"] = ";".join(r.get("violations", ()))
            for k, v in r.get("metrics", {}).items():
                flat[f"metrics.{k}"] = v
            rows.append(flat)
        fields = list(dict.fromkeys(k for row in rows for k in row))
        buf = io.StringIO()
        writer = csv.DictWriter(buf, fieldnames=fields)
        writer.writeheader()
        writer.writerows(rows)
        text = buf.getvalue()
        if path is not None:
            with open(path, "w") as fh:
                fh.write(text)
        return text

    def sim_result(self, row: int) -> SimResult:
        """Pipeline row ``row``'s waveforms as a ``SimResult`` (the Study
        must have been run with ``keep_waveforms=True``)."""
        if self.waveforms is None:
            raise ValueError("run the Study with keep_waveforms=True")
        w = self.waveforms[row]
        rec = next(r for r in self.records if r["row"] == row)
        return SimResult(
            t=w["t"], dc_raw=w["dc_raw"], dc_mitigated=w["dc_mitigated"],
            chip_raw=None, chip_mitigated=None,
            energy_overhead=rec["energy_overhead"],
            swing={}, swing_mitigated={}, bands={}, bands_mitigated={},
            spec_report=None, aux={})
