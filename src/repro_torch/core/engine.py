"""Batched scenario engine: waveform -> mitigation -> spec for a batch of
scenario rows, as a handful of whole-batch tensor passes on one device.

  ``simulate_batch``  synthesis, aggregation and the device and rack
                      mitigation stages for rows of one mitigation
                      structure, with per-row swing and energy metrics.
  ``analyze_batch``   frequency reports and spec verdicts for same-length
                      waveforms.
  ``stream_batches``  the executor behind ``Study.run``: fixed-size chunks
                      of ``simulate_batch`` reduced to per-row metrics,
                      analysis grouped by true length.
  ``sweep``           cartesian (workload x fleet x config x seed) sweep,
                      one ``simulate_batch`` per waveform length, flat
                      records.
  ``apply_batch``     one waveform through B configs of one structure.
  ``validate_many``   spec verdicts and reports of B same-length waveforms.
  ``design``          the (MPF, battery capacity) design search on one
                      trace: ``method="grid"`` (``design_grid``) judges
                      every candidate of the coarse grid in one batch;
                      ``"gradient"`` (``design_gradient``) descends on the
                      relaxed (``smooth_tau > 0``) gpu -> battery stack by
                      Adam, every start a row of one batch, through kernels
                      J and K; ``"hybrid"`` (the default) seeds it with the
                      grid's best; ``"warmstart"`` (``design_warmstart``)
                      starts from a predictor's seeds.

Rows may mix enabled and disabled (None) stages: ``_normalize_mits``
returns the enabled rows and an on-mask, the stage runs on the enabled
rows only, and disabled rows keep the unmitigated waveform.  Per-row
PRNG keys ``[B, 2]`` (``core/prng.py``) reach the mitigations that draw
noise: row ``b``'s device stage draws from ``fold_in(key_b, 0)``, its
rack stage from ``fold_in(key_b, 1)``.  Mixed
lengths are edge-padded to one length and masked (``pad_to``): the valid
region is exact against an unpadded run, metrics are masked reductions,
and the rack stage sees the pad filled with the valid-region mean, as in
the reference; a padded row's monitor therefore counts the pad samples as
live.  The synthesis prefix (chip waveform and raw aggregate) runs once
per unique (workload, fleet, seed).

Per-row values do not depend on how rows are chunked: every operation
on the path is row-wise, the float64 sums are of float32 terms, and the
analysis runs on slices of a fixed row count (``ANALYSIS_ROWS``) in every
run, one-shot or chunked.  So the scenario axis shards across devices
and processes (``plan=``, ``shard_devices=``; ``repro_torch.parallel``):
each device computes its rows of every chunk, the per-row results are
merged on the host in global row order, and the records equal an
unsharded run's bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.hardware import DEFAULT_HW, Hardware
from repro_torch.core.optim import adam_init, adam_update, clip_by_global_norm
from repro_torch.core.smoothing.base import (apply_mitigation,
                                             energy_overhead, materialize_aux,
                                             structure)
from repro_torch.core.smoothing.battery import RackBattery
from repro_torch.core.smoothing.gpu_floor import GpuPowerSmoothing
from repro_torch.core.spec import SpecReport, UtilitySpec, report_from_arrays
from repro_torch.core.spectrum import critical_band_report
from repro_torch.core.stratosim import SimResult, row_scalars
from repro_torch.core.waveform import (WaveformConfig, aggregate,
                                       chip_waveform, jitter_shifts,
                                       phase_levels, swing_stats)
from repro_torch.device import resolve_device
from repro_torch.parallel.collectives import (concat_trees, gather_parts,
                                              gather_rows, host_allgather)
from repro_torch.parallel.sharding import ScenarioShardPlan, scenario_plan

# rows of one analysis call (tails repeat their last row): reductions on the
# card and on the CPU pick their order by the number of rows they reduce,
# so every row is analysed in a batch of this one size
ANALYSIS_ROWS = 32


def stack_mitigations(mitigations: Sequence) -> object:
    """Mitigations of one structure (``base.structure``) as one object of
    their class whose per-row fields are float32 tensors ``[B]`` (nested
    mitigations and ``Stack`` stages stacked the same way): the port's
    form of the reference's batched pytree."""
    mits = list(mitigations)
    if not mits:
        raise ValueError("empty mitigation list")
    if len({structure(m) for m in mits}) != 1:
        raise ValueError("stack_mitigations: the mitigations must share one "
                         "structure")
    m0 = mits[0]
    if hasattr(m0, "stages"):
        return dataclasses.replace(m0, stages=tuple(
            stack_mitigations([m.stages[i] for m in mits])
            for i in range(len(m0.stages))))
    cls = type(m0)
    fixed = set(cls.STATIC_FIELDS)
    nested = set(getattr(cls, "NESTED_FIELDS", ()))
    kw = {}
    for f in dataclasses.fields(m0):
        if f.name in nested:
            kw[f.name] = stack_mitigations([getattr(m, f.name) for m in mits])
        elif f.name not in fixed:
            kw[f.name] = torch.tensor([float(getattr(m, f.name))
                                       for m in mits], dtype=torch.float32)
    # the per-row values bypass the scalar checks of __post_init__
    out = object.__new__(cls)
    for f in dataclasses.fields(m0):
        object.__setattr__(out, f.name, kw.get(f.name, getattr(m0, f.name)))
    return out


def _tile(values, B: int, what: str) -> list:
    values = list(values)
    if len(values) == 1:
        return values * B
    if len(values) != B:
        raise ValueError(f"{what}: got {len(values)} entries, expected 1 or {B}")
    return values


def _as_list(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _normalize_mits(mits: Sequence, B: int, what: str
                    ) -> Tuple[List, Optional[torch.Tensor]]:
    """Per-row mitigations (None = disabled) -> ``(enabled mitigations,
    on-mask [B] bool)``; the mask is None when every row is enabled and
    the list empty when none is."""
    mits = _tile(mits, B, what)
    enabled = [m for m in mits if m is not None]
    if len({structure(m) for m in enabled}) > 1:
        raise ValueError(f"{what}: one batch needs one mitigation structure")
    if len(enabled) == len(mits):
        return enabled, None
    return enabled, torch.tensor([m is not None for m in mits])


def _normalize_keys(keys, B: int, device) -> Optional[torch.Tensor]:
    """None | one key | a sequence of keys | stacked ``[B, 2]`` -> int64
    ``[B, 2]`` keys on ``device`` (a key: ``prng.as_key``)."""
    if keys is None:
        return None
    if isinstance(keys, (list, tuple)):
        rows = [prng.as_key(k) for k in keys]
    else:
        k = prng.as_key(keys)
        rows = [k] if k.dim() == 1 else list(k)
    return torch.stack(_tile(rows, B, "keys")).to(device)


def _on_rows(on: Optional[torch.Tensor], B: int, device) -> torch.Tensor:
    """Indices of the enabled rows of a ``_normalize_mits`` on-mask."""
    return (torch.arange(B, device=device) if on is None
            else on.nonzero().squeeze(1).to(device))


def _mask_helpers(n: int, n_valid: torch.Tensor):
    """(fill_edge, fill_mean, mask) over rows with true lengths
    ``n_valid`` ``[B]`` inside a padded length ``n``."""
    mask = torch.arange(n, device=n_valid.device)[None, :] < n_valid[:, None]
    last = (n_valid - 1)[:, None]

    def fill_edge(w):
        return torch.where(mask, w, w.gather(-1, last))

    def fill_mean(w):
        mean = (torch.where(mask, w, 0.0).to(torch.float64).sum(-1, True)
                / n_valid[:, None]).to(w.dtype)
        return torch.where(mask, w, mean)

    return fill_edge, fill_mean, mask


def _prepare_rows(timelines, n_chips, seeds, device_mitigation,
                  rack_mitigation, levels, cfg: WaveformConfig, hw: Hardware):
    """Broadcast every batched argument to a common row count B and expand
    timelines to per-row ``phase_levels`` arrays (once per timeline)."""
    tls, chips, seed_list = (_as_list(timelines), _as_list(n_chips),
                             _as_list(seeds))
    dev_list, rack_list = (_as_list(device_mitigation),
                           _as_list(rack_mitigation))
    B = max(len(tls), len(chips), len(seed_list), len(dev_list),
            len(rack_list))
    tls = _tile(tls, B, "timelines")
    chips = _tile(chips, B, "n_chips")
    seed_list = _tile(seed_list, B, "seeds")
    dev_list = _tile(dev_list, B, "device_mitigation")
    rack_list = _tile(rack_list, B, "rack_mitigation")
    if levels is not None:
        level_rows = _tile(list(levels), B, "levels")
    else:
        cache: Dict[int, np.ndarray] = {}
        level_rows = [cache.setdefault(id(tl), phase_levels(tl, cfg, hw))
                      for tl in tls]
    return tls, chips, seed_list, dev_list, rack_list, level_rows, B


@dataclasses.dataclass
class BatchResult:
    """One row per scenario on the engine's device: waveforms ``[B, n]``
    (row ``i`` valid in its first ``n_valid[i]`` samples), metrics
    ``[B]``.  ``aux["device"]`` and ``aux["rack"]`` hold the enabled rows
    of their stage only (``dev_on``/``rack_on``, None when every row is
    enabled)."""
    dc_raw: torch.Tensor
    dc_mitigated: torch.Tensor
    n_valid: torch.Tensor
    energy_overhead: torch.Tensor
    swing: Dict[str, torch.Tensor]
    swing_mitigated: Dict[str, torch.Tensor]
    aux: Dict
    t: Optional[np.ndarray] = None
    chip_raw: Optional[torch.Tensor] = None
    chip_mitigated: Optional[torch.Tensor] = None
    bands: Optional[Dict[str, torch.Tensor]] = None
    bands_mitigated: Optional[Dict[str, torch.Tensor]] = None
    spec_ok: Optional[torch.Tensor] = None
    spec_flags: Optional[Dict[str, torch.Tensor]] = None
    spec_metrics: Optional[Dict[str, torch.Tensor]] = None
    dev_on: Optional[torch.Tensor] = None
    rack_on: Optional[torch.Tensor] = None

    def __len__(self) -> int:
        return self.dc_raw.shape[0]

    def length(self, i: int) -> int:
        return int(self.n_valid[i])

    def report(self, i: int) -> Optional[SpecReport]:
        if self.spec_ok is None:
            return None
        return report_from_arrays(
            self.spec_ok[i].item(),
            {k: v[i].item() for k, v in self.spec_flags.items()},
            {k: v[i].item() for k, v in self.spec_metrics.items()})

    def scenario(self, i: int) -> SimResult:
        """Row ``i`` as the serial reference's ``SimResult`` (host numpy,
        sliced to its true length); a disabled stage leaves no aux and no
        mitigated chip trace, as in ``stratosim.simulate``."""
        n = self.length(i)
        aux: Dict = {}
        for stage, on in (("device", self.dev_on), ("rack", self.rack_on)):
            if stage not in self.aux or (on is not None and not on[i]):
                continue
            pos = i if on is None else int(on[:i].sum())
            aux[stage] = materialize_aux(self.aux[stage], pos)
        on_dev = "device" in aux

        def host(x):
            return None if x is None else x[i, :n].cpu().numpy()

        return SimResult(
            t=self.t[:n], dc_raw=host(self.dc_raw),
            dc_mitigated=host(self.dc_mitigated),
            chip_raw=host(self.chip_raw),
            chip_mitigated=host(self.chip_mitigated) if on_dev else None,
            energy_overhead=float(self.energy_overhead[i]),
            swing=row_scalars(self.swing, i),
            swing_mitigated=row_scalars(self.swing_mitigated, i),
            bands=row_scalars(self.bands, i),
            bands_mitigated=row_scalars(self.bands_mitigated, i),
            spec_report=self.report(i), aux=aux)


def _resolve_plan(plan: Optional[ScenarioShardPlan], shard_devices: bool,
                  device) -> Optional[ScenarioShardPlan]:
    """An explicit plan wins; ``shard_devices=True`` is shorthand for the
    all-local-cards plan (``scenario_plan``).  A plan's devices must be of
    ``device``'s type."""
    if plan is None and shard_devices:
        plan = scenario_plan()
    if plan is not None:
        kind = torch.device(device).type
        if any(d.type != kind for d in plan.devices):
            raise ValueError(f"the plan's devices {plan.devices} are not "
                             f"all of the run's device type {kind!r}")
    return plan


def _device_scope(device: torch.device):
    """Make ``device`` current while its shard runs (a kernel launches on
    the current card)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _local_pieces(shard: Optional[ScenarioShardPlan], device, n: int,
                  n_real: int) -> List[Tuple[torch.device, List[int],
                                             List[int]]]:
    """This process's pieces of an ``n``-row batch whose positions from
    ``n_real`` on repeat row ``n_real - 1`` (a chunk's tail and, under a
    plan, the shard padding): ``[(device, rows, real)]``, each piece's
    batch rows and the piece positions that hold the batch's own rows (at
    least one, so that a piece of padding yields every field).  Without a
    plan the whole batch is one piece on ``device``."""
    if shard is None:
        parts, padded = [(device, slice(0, n))], n
    else:
        parts, padded = shard.local_shards(n)
    pieces = []
    for dev, s in parts:
        pos = range(padded)[s]
        pieces.append((dev, [min(p, n_real - 1) for p in pos],
                       [i for i, p in enumerate(pos) if p < n_real] or [0]))
    return pieces


def _merge_pieces(trees, shard: Optional[ScenarioShardPlan], take: int):
    """The per-row trees of this process's pieces, merged with every other
    process's in global row order as host numpy, cut to ``take`` rows."""
    return host_allgather(concat_trees(trees), shard, take=take)


def _simulate_sharded(shard: ScenarioShardPlan, timelines, n_chips, cfg,
                      *, device_mitigation, rack_mitigation, keys,
                      pad_to, seeds, levels, hw, chip_outputs,
                      device, **kw) -> BatchResult:
    """``simulate_batch`` with its rows cut into the plan's pieces
    (``_local_pieces``): each of this process's on its device, merged on
    the host in global row order (``_merge_pieces``), shard padding
    dropped.  The merged result is on the CPU."""
    (tls, chips, seed_list, dev_list, rack_list, level_rows,
     B) = _prepare_rows(timelines, n_chips, seeds, device_mitigation,
                        rack_mitigation, levels, cfg, hw)
    if pad_to is None and len({len(r) for r in level_rows}) > 1:
        raise ValueError(
            "all rows of one simulate_batch call must expand to the same "
            f"sample count (got {sorted({len(r) for r in level_rows})}): "
            "pass pad_to")
    keys_t = _normalize_keys(keys, B, "cpu")
    has_dev = any(m is not None for m in dev_list) and chip_outputs
    trees, auxes = [], []
    for dev, rows, _ in _local_pieces(shard, device, B, B):
        def sl(xs):
            return [xs[i] for i in rows]

        with _device_scope(dev):
            res = simulate_batch(
                sl(tls), sl(chips), cfg, device_mitigation=sl(dev_list),
                rack_mitigation=sl(rack_list), hw=hw, seeds=sl(seed_list),
                keys=None if keys_t is None else keys_t[rows],
                levels=sl(level_rows), pad_to=pad_to,
                chip_outputs=chip_outputs, device=dev, **kw)
        tree = {k: getattr(res, k) for k in (
            "dc_raw", "dc_mitigated", "n_valid", "energy_overhead", "swing",
            "swing_mitigated", "chip_raw", "bands", "bands_mitigated",
            "spec_ok", "spec_flags", "spec_metrics")}
        # a piece without device rows kept no mitigated chip trace: its
        # rows' are their raw traces; the stage masks are spelt out
        tree["chip_mitigated"] = (res.chip_raw if res.chip_mitigated is None
                                  and has_dev else res.chip_mitigated)
        for stage, on in (("dev_on", res.dev_on), ("rack_on", res.rack_on)):
            tree[stage] = torch.ones(len(rows), dtype=torch.bool) \
                if on is None else on
        trees.append(tree)
        auxes.append(res.aux)
    m = {k: (None if v is None else _map_tensor(v))
         for k, v in _merge_pieces(trees, shard, B).items()}
    off = ~m["rack_on"]
    if any(r is not None for r in rack_list) and bool(off.any()):
        # a batch with a rack stage fills its other rows' pad with their
        # valid mean; a piece without a rack row did not
        dc = m["dc_mitigated"]
        dc[off] = _mask_helpers(dc.shape[1], m["n_valid"][off])[1](dc[off])
    # each stage's aux holds its enabled rows only, in row order
    auxes = gather_parts([host_allgather(a) for a in auxes], shard)
    aux: Dict = {}
    for stage, key in (("device", "dev_on"), ("rack", "rack_on")):
        enabled = int(m[key].sum())
        got = [a[stage] for a in auxes if stage in a]
        if got and enabled:
            aux[stage] = _map_tensor(concat_trees(got), enabled)
        if bool(m[key].all()):
            m[key] = None
    return BatchResult(
        dc_raw=m["dc_raw"], dc_mitigated=m["dc_mitigated"],
        n_valid=m["n_valid"], energy_overhead=m["energy_overhead"],
        swing=m["swing"], swing_mitigated=m["swing_mitigated"], aux=aux,
        t=np.arange(m["dc_raw"].shape[1]) * cfg.dt, chip_raw=m["chip_raw"],
        chip_mitigated=m["chip_mitigated"] if has_dev else None,
        bands=m["bands"], bands_mitigated=m["bands_mitigated"],
        spec_ok=m["spec_ok"], spec_flags=m["spec_flags"],
        spec_metrics=m["spec_metrics"], dev_on=m["dev_on"],
        rack_on=m["rack_on"])


def _map_tensor(tree, take: Optional[int] = None):
    """A merged host tree's arrays (their first ``take`` rows) as CPU
    tensors."""
    if isinstance(tree, dict):
        return {k: _map_tensor(v, take) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.ndim:
        return torch.from_numpy(np.ascontiguousarray(tree[:take]))
    return tree


def simulate_batch(timelines, n_chips, wave_cfg: Optional[WaveformConfig]
                   = None, *, device_mitigation=None, rack_mitigation=None,
                   spec: Optional[UtilitySpec] = None,
                   hw: Hardware = DEFAULT_HW, seeds=0, keys=None,
                   sample_chips: int = 64,
                   levels: Optional[Sequence[np.ndarray]] = None,
                   pad_to: Optional[int] = None, spectra: bool = True,
                   chip_outputs: bool = True,
                   plan: Optional[ScenarioShardPlan] = None,
                   shard_devices: bool = False,
                   device="cuda") -> BatchResult:
    """Simulate a batch of scenario rows of one mitigation structure.

    Each batched argument is a singleton (broadcast) or a length-B
    sequence; mitigation rows may be None (disabled).  ``keys`` (one per
    row, or one for all) feed the mitigations that draw noise; without
    them such a mitigation draws from ``prng_key(0)`` on every row.
    Without ``pad_to`` every row must expand to the same sample count;
    with it, rows are edge-padded to ``pad_to`` and masked, and the
    frequency and spec analysis is left to ``analyze_batch`` on the sliced
    rows (``spec`` must be None and ``spectra`` False).  ``spectra`` adds
    the band reports of the raw and mitigated waveforms, ``spec`` its
    verdicts, and ``chip_outputs`` the per-chip traces.  ``plan`` (a
    ``ScenarioShardPlan``; ``shard_devices=True``: every local card) cuts
    the rows into shards, each on its device and process, and returns the
    merged rows on the CPU, equal to an unsharded run's.
    """
    cfg = wave_cfg or WaveformConfig()
    dt = cfg.dt
    device = torch.device(device)
    if pad_to is not None and (spec is not None or spectra):
        raise ValueError(
            "pad_to defers frequency/spec analysis to analyze_batch on the "
            "sliced rows: call with spec=None, spectra=False")
    shard = _resolve_plan(plan, shard_devices, device)
    if shard is not None:
        return _simulate_sharded(
            shard, timelines, n_chips, cfg,
            device_mitigation=device_mitigation,
            rack_mitigation=rack_mitigation, keys=keys, pad_to=pad_to,
            seeds=seeds, levels=levels, hw=hw, chip_outputs=chip_outputs,
            device=device, spec=spec, sample_chips=sample_chips,
            spectra=spectra)
    (_, chips, seed_list, dev_list, rack_list, level_rows,
     B) = _prepare_rows(timelines, n_chips, seeds, device_mitigation,
                        rack_mitigation, levels, cfg, hw)
    src_ids = [id(r) for r in level_rows]
    lens = [len(r) for r in level_rows]
    if pad_to is None:
        if len(set(lens)) > 1:
            raise ValueError(
                "all rows of one simulate_batch call must expand to the same "
                f"sample count (got {sorted(set(lens))}): pass pad_to")
        n = lens[0]
    else:
        if max(lens) > pad_to:
            raise ValueError(f"pad_to={pad_to} < longest workload {max(lens)}")
        n = pad_to
    n_valid = torch.tensor(lens, dtype=torch.int64, device=device)
    keys_t = _normalize_keys(keys, B, device)
    k_dev = k_rack = None
    if keys_t is not None:
        k_dev, k_rack = prng.fold_in(keys_t, 0), prng.fold_in(keys_t, 1)

    # -- synthesis prefix, once per unique (workload, fleet, seed)
    uniq: Dict[Tuple, int] = {}
    u_rows: List[int] = []
    u_idx: List[int] = []
    for i, key in enumerate(zip(src_ids, chips, seed_list)):
        if key not in uniq:
            uniq[key] = len(u_rows)
            u_rows.append(i)
        u_idx.append(uniq[key])
    u_idx_t = torch.tensor(u_idx, device=device)
    shifts = torch.tensor(np.stack(
        [jitter_shifts(cfg, s, sample_chips) for s in seed_list]),
        device=device)
    chips_t = torch.tensor(np.asarray(chips, np.float32), device=device)
    lv = np.stack([np.pad(level_rows[i], (0, n - lens[i]), mode="edge")
                   for i in u_rows])
    u_sel = torch.tensor(u_rows, device=device)
    fill_edge_u, _, _ = _mask_helpers(n, n_valid[u_sel])
    chip_u = fill_edge_u(chip_waveform(
        torch.as_tensor(lv, dtype=torch.float32, device=device), dt, hw,
        edp_spikes=cfg.edp_spikes, include_host=cfg.include_host))
    dcraw_u = aggregate(chip_u, chips_t[u_sel], shifts[u_sel], hw)

    _, fill_mean, mask = _mask_helpers(n, n_valid)
    dc_raw = dcraw_u[u_idx_t]
    dc = dc_raw
    aux: Dict = {}
    chip_raw = chip_u[u_idx_t] if chip_outputs else None
    chip_mit = None

    # -- device stage on the per-chip waveform, then re-aggregation
    devs, dev_on = _normalize_mits(dev_list, B, "device_mitigation")
    if devs:
        on = _on_rows(dev_on, B, device)
        chip_m, aux["device"] = apply_mitigation(
            devs, chip_u[u_idx_t[on]], dt,
            None if k_dev is None else k_dev[on])
        chip_m = _mask_helpers(n, n_valid[on])[0](chip_m)
        dc = dc.clone()
        dc[on] = aggregate(chip_m, chips_t[on], shifts[on], hw)
        if chip_outputs:
            chip_mit = chip_raw.clone()
            chip_mit[on] = chip_m

    # -- rack stage on the aggregate, pad filled with the valid mean
    racks, rack_on = _normalize_mits(rack_list, B, "rack_mitigation")
    if racks:
        dc = fill_mean(dc)
        on = _on_rows(rack_on, B, device)
        out, aux["rack"] = apply_mitigation(
            racks, dc[on], dt, None if k_rack is None else k_rack[on])
        dc[on] = out

    m = mask.to(torch.float64)
    e_in = (dc_raw.to(torch.float64) * m).sum(-1)
    e_out = (dc.to(torch.float64) * m).sum(-1)
    res = BatchResult(
        dc_raw=dc_raw, dc_mitigated=dc, n_valid=n_valid,
        energy_overhead=((e_out - e_in) / torch.clamp(e_in, min=1e-12)
                         ).to(torch.float32),
        swing=swing_stats(dc_raw, n_valid),
        swing_mitigated=swing_stats(dc, n_valid), aux=aux,
        t=np.arange(n) * dt, chip_raw=chip_raw, chip_mitigated=chip_mit,
        dev_on=dev_on, rack_on=rack_on)
    if spectra:
        res.bands = critical_band_report(dc_raw, dt)
        res.bands_mitigated = critical_band_report(dc, dt)
    if spec is not None:
        res.spec_ok, res.spec_flags, res.spec_metrics = spec.validate(dc, dt)
    return res


def analyze_batch(dc_mitigated: torch.Tensor, dt: float,
                  spec: Optional[UtilitySpec] = None, *, bands: bool = True
                  ) -> Dict:
    """Frequency report and spec verdicts for same-length waveforms
    ``[B, L]``: ``{"bands_mitigated": ..., "spec_ok", "spec_flags",
    "spec_metrics"}``, each a tensor or dict of tensors ``[B]``."""
    out: Dict = {}
    if bands:
        out["bands_mitigated"] = critical_band_report(dc_mitigated, dt)
    if spec is not None:
        ok, flags, metrics = spec.validate(dc_mitigated, dt)
        out["spec_ok"], out["spec_flags"] = ok, flags
        out["spec_metrics"] = metrics
    return out


@dataclasses.dataclass
class StreamChunk:
    """Per-row metrics (host numpy) of rows ``start:stop`` of a
    ``stream_batches`` run.  ``spec_*`` align with the stream's ``specs``
    (None entries for a None spec); ``spec_metrics`` holds one dict per
    row because the metric key set depends on the row's true length."""
    start: int
    stop: int
    n: int
    n_valid: np.ndarray
    energy_overhead: np.ndarray
    swing: Dict[str, np.ndarray]
    swing_mitigated: Dict[str, np.ndarray]
    bands_mitigated: Optional[Dict[str, np.ndarray]]
    spec_ok: List[Optional[np.ndarray]]
    spec_flags: List[Optional[Dict[str, np.ndarray]]]
    spec_metrics: List[Optional[List[Dict[str, float]]]]
    dc_raw: Optional[np.ndarray] = None      # [C, n] (keep_waveforms only)
    dc_mitigated: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.stop - self.start

    def length(self, i: int) -> int:
        return int(self.n_valid[i])

    def report(self, si: int, i: int) -> Optional[SpecReport]:
        if self.spec_ok[si] is None:
            return None
        flags = {k: v[i] for k, v in self.spec_flags[si].items()}
        return report_from_arrays(self.spec_ok[si][i], flags,
                                  self.spec_metrics[si][i])


def _to_host(tree):
    """Start the copy of a tree of device tensors to the host: pinned
    buffers and non-blocking copies on the card, so that the host can go
    on dispatching work; ``_numpy`` reads them once their event is done."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.to("cpu", non_blocking=tree.is_cuda)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def _analysis_slices(idx: List[int]) -> List[List[int]]:
    """``idx`` cut into slices of ``ANALYSIS_ROWS`` entries, the last padded
    by repeating its last entry, so that every row is analysed in a batch
    of one size whatever the chunk it came in."""
    out = [idx[i:i + ANALYSIS_ROWS] for i in range(0, len(idx),
                                                    ANALYSIS_ROWS)]
    out[-1] = out[-1] + [out[-1][-1]] * (ANALYSIS_ROWS - len(out[-1]))
    return out


def stream_batches(timelines, n_chips, wave_cfg: Optional[WaveformConfig]
                   = None, *, device_mitigation=None, rack_mitigation=None,
                   specs=None, hw: Hardware = DEFAULT_HW, seeds=0, keys=None,
                   sample_chips: int = 64,
                   levels: Optional[Sequence[np.ndarray]] = None,
                   pad_to: Optional[int] = None,
                   chunk_size: Optional[int] = None, bands: bool = True,
                   skip_rows: int = 0, keep_waveforms: bool = False,
                   plan: Optional[ScenarioShardPlan] = None,
                   shard_devices: bool = False, device="cuda"):
    """Yield the metrics of a scenario batch as one ``StreamChunk`` per
    chunk of ``chunk_size`` rows (None: the whole batch in one chunk).

    Each chunk runs ``simulate_batch`` (padding to the longest row of the
    whole batch when lengths mix) and reduces to metrics on the device:
    swing and energy per row, and, per group of rows of one true length,
    the frequency bands (for the first spec slot) and every spec's
    verdicts on the valid prefix, in slices of ``ANALYSIS_ROWS`` rows.
    Only per-row metrics reach the host.  Tail chunks are padded to
    ``chunk_size`` by repeating the last row (and its key) and sliced
    back.  Chunk ``k+1`` is dispatched before chunk ``k``'s metrics are
    read on the host, and those arrive by non-blocking copies, so the
    host dispatches while the card computes.  Per-row values do not
    depend on the chunking.

    ``plan`` (a ``ScenarioShardPlan``; ``shard_devices=True``: every local
    card) pads each chunk to a shard multiple and runs each of this
    process's shards on its device; the chunk's per-row metrics are then
    merged on the host across shards and processes
    (``parallel/collectives.host_allgather``), so every process yields
    the same chunks, equal to an unsharded run's.  Every process must
    call this with the same rows.

    ``skip_rows`` skips every chunk whose rows all lie below it without
    dispatching it (the resume path restores those from disk); it must
    fall on a chunk boundary.  ``keep_waveforms`` also brings each chunk's
    raw and mitigated waveforms ``[C, n]`` to the host.
    """
    cfg = wave_cfg or WaveformConfig()
    device = torch.device(device)
    shard = _resolve_plan(plan, shard_devices, device)
    (tls, chips, seed_list, dev_list, rack_list, level_rows,
     B) = _prepare_rows(timelines, n_chips, seeds, device_mitigation,
                        rack_mitigation, levels, cfg, hw)
    spec_list = list(specs) if isinstance(specs, (list, tuple)) else [specs]
    S = len(spec_list)
    keys_t = _normalize_keys(keys, B, "cpu")
    lens = [len(r) for r in level_rows]
    if pad_to is None and len(set(lens)) > 1:
        pad_to = max(lens)
    chunk_size = B if chunk_size is None else max(1, min(int(chunk_size), B))
    n_chunks = -(-B // chunk_size)
    if skip_rows % chunk_size and skip_rows < B:
        raise ValueError(f"skip_rows={skip_rows} is not a chunk boundary of "
                         f"chunk_size={chunk_size}")

    def run_piece(dev, rows, real):
        """Rows ``rows`` on ``dev``: the simulation, and the analysis of
        the piece positions ``real`` grouped by true length; host copies
        started."""
        def sl(xs):
            return [xs[r] for r in rows]

        res = simulate_batch(sl(tls), sl(chips), cfg,
                             device_mitigation=sl(dev_list),
                             rack_mitigation=sl(rack_list), hw=hw,
                             seeds=sl(seed_list),
                             keys=None if keys_t is None else keys_t[rows],
                             sample_chips=sample_chips,
                             levels=sl(level_rows), pad_to=pad_to,
                             spectra=False, chip_outputs=False, device=dev)
        groups: Dict[int, List[int]] = {}
        for i in real:
            groups.setdefault(lens[rows[i]], []).append(i)
        gres = []
        for L, g in sorted(groups.items()):
            for part in _analysis_slices(g):
                mit = gather_rows(res.dc_mitigated, part, shard, length=L)
                per_spec = []
                for si, sp in enumerate(spec_list):
                    do_bands = bands and si == 0
                    per_spec.append(
                        None if sp is None and not do_bands else _to_host(
                            analyze_batch(mit, cfg.dt, sp, bands=do_bands)))
                gres.append((part, per_spec))
        direct = {"eo": res.energy_overhead, "sw": res.swing,
                  "swm": res.swing_mitigated}
        if keep_waveforms:
            direct["raw"], direct["mit"] = res.dc_raw, res.dc_mitigated
        direct = _to_host(direct)
        done = None
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return len(rows), real, direct, gres, done

    def dispatch(lo: int, hi: int):
        C = hi - lo
        tail = chunk_size - C if n_chunks > 1 else 0
        pieces = []
        for dev, rows, real in _local_pieces(shard, device, C + tail, C):
            with _device_scope(dev):
                pieces.append(run_piece(dev, [lo + r for r in rows], real))
        return lo, hi, pieces

    def piece_tree(piece) -> Dict:
        """One piece's per-row metrics as host numpy, rows leading; rows
        not analysed (padding) take the last analysed row's values."""
        P, real, direct, gres, done = piece
        if done is not None:
            done.synchronize()
        tree = _numpy(direct)
        filled = np.zeros(P, bool)
        band_cols: Dict[str, np.ndarray] = {}
        slots: List[Optional[Dict]] = [None] * S
        for part, per_spec in gres:
            # a slice's padding repeats a row it already holds
            keep = [j for j, i in enumerate(part) if not filled[i]]
            g = [part[j] for j in keep]
            filled[g] = True
            for si, a in enumerate(per_spec):
                if a is None:
                    continue
                a = _numpy(a)
                for k, v in a.get("bands_mitigated", {}).items():
                    band_cols.setdefault(k, np.empty(P, v.dtype))[g] = v[keep]
                if spec_list[si] is None:
                    continue
                if slots[si] is None:
                    slots[si] = {
                        "ok": np.zeros(P, bool),
                        "flags": {k: np.zeros(P, bool)
                                  for k in a["spec_flags"]},
                        "metrics": np.empty(P, object)}
                slot = slots[si]
                slot["ok"][g] = a["spec_ok"][keep]
                for k, v in a["spec_flags"].items():
                    slot["flags"][k][g] = v[keep]
                for j, i in zip(keep, g):
                    slot["metrics"][i] = {
                        k: float(v[j]) for k, v in a["spec_metrics"].items()}
        pad = ~filled
        for leaf in [*band_cols.values()] + [
                a for s in slots if s is not None
                for a in (s["ok"], s["metrics"], *s["flags"].values())]:
            leaf[pad] = leaf[real[-1]]
        tree["bands"] = band_cols or None
        tree["specs"] = slots
        return tree

    def materialize(pending) -> StreamChunk:
        lo, hi, pieces = pending
        C = hi - lo
        m = _merge_pieces([piece_tree(p) for p in pieces], shard, C)
        slots = m["specs"]
        return StreamChunk(
            start=lo, stop=hi, n=pad_to or lens[0],
            n_valid=np.asarray(lens[lo:hi], np.int64),
            energy_overhead=m["eo"], swing=m["sw"], swing_mitigated=m["swm"],
            bands_mitigated=m["bands"],
            spec_ok=[None if s is None else s["ok"] for s in slots],
            spec_flags=[None if s is None else s["flags"] for s in slots],
            spec_metrics=[None if s is None else list(s["metrics"])
                          for s in slots],
            dc_raw=m.get("raw"), dc_mitigated=m.get("mit"))

    pending = None
    for lo in range(0, B, chunk_size):
        hi = min(lo + chunk_size, B)
        if hi <= skip_rows:
            continue
        cur = dispatch(lo, hi)
        if pending is not None:
            yield materialize(pending)
        pending = cur
    if pending is not None:
        yield materialize(pending)


# ---------------------------------------------------------------------------
# cartesian sweep, config batches, batched validation
# ---------------------------------------------------------------------------

def sweep(workloads, n_chips: Sequence[int], configs: Sequence[Tuple],
          wave_cfg: Optional[WaveformConfig] = None, *,
          spec: Optional[UtilitySpec] = None, hw: Hardware = DEFAULT_HW,
          seeds: Sequence[int] = (0,), sample_chips: int = 64,
          device=None) -> List[Dict]:
    """Cartesian (workload x fleet size x config x seed) sweep: one flat
    record per scenario, in that order.  ``workloads`` is a dict name ->
    timeline (or a sequence, named by index); each config a ``(device,
    rack)`` pair, either side None.  Rows are bucketed by sample count and
    each bucket runs as one ``simulate_batch`` on ``device`` (None: the
    card)."""
    dev = resolve_device(device)
    cfg = wave_cfg or WaveformConfig()
    if isinstance(workloads, dict):
        names, tls = list(workloads.keys()), list(workloads.values())
    else:
        tls = list(workloads)
        names = [f"workload{i}" for i in range(len(tls))]
    combos = [(ti, ni, ci, si) for ti in range(len(tls)) for ni in n_chips
              for ci in range(len(configs)) for si in seeds]
    tl_levels = [phase_levels(tl, cfg, hw) for tl in tls]
    buckets: Dict[int, List[Tuple[int, Tuple]]] = {}
    for pos, combo in enumerate(combos):
        buckets.setdefault(len(tl_levels[combo[0]]), []).append((pos, combo))
    records: List[Optional[Dict]] = [None] * len(combos)
    for _, items in sorted(buckets.items()):
        idxs = [combo for _, combo in items]
        res = simulate_batch(
            [tls[ti] for ti, _, _, _ in idxs], [ni for _, ni, _, _ in idxs],
            cfg, device_mitigation=[configs[ci][0] for _, _, ci, _ in idxs],
            rack_mitigation=[configs[ci][1] for _, _, ci, _ in idxs],
            spec=spec, hw=hw, seeds=[si for _, _, _, si in idxs],
            sample_chips=sample_chips,
            levels=[tl_levels[ti] for ti, _, _, _ in idxs],
            chip_outputs=False, device=dev)
        host = _numpy(_to_host({
            "mean": res.swing["mean_w"], "swing": res.swing["swing_w"],
            "swing_m": res.swing_mitigated["swing_w"],
            "eo": res.energy_overhead,
            "band": res.bands_mitigated["paper_band_0p2_3hz"]}))
        for b, (pos, (ti, ni, ci, si)) in enumerate(items):
            rec = {
                "workload": names[ti], "n_chips": ni, "config": ci,
                "seed": si, "period_s": tls[ti].period_s,
                "mean_mw": float(host["mean"][b]) / 1e6,
                "swing_mw": float(host["swing"][b]) / 1e6,
                "swing_mitigated_mw": float(host["swing_m"][b]) / 1e6,
                "energy_overhead": float(host["eo"][b]),
                "paper_band_frac": float(host["band"][b]),
            }
            if res.spec_ok is not None:
                report = res.report(b)
                rec["spec_ok"] = report.ok
                rec["violations"] = report.violations
            records[pos] = rec
    return records


def apply_batch(mitigations: Sequence, w, dt: float, device=None
                ) -> Tuple[np.ndarray, Dict]:
    """B configs of one structure applied to ONE waveform ``w`` ``[n]`` in
    one batch on ``device`` (None: the card): ``(outs [B, n], aux)``, aux
    values as host numpy arrays with a leading B axis."""
    mits = list(mitigations)
    dev = resolve_device(device)
    row = torch.as_tensor(np.asarray(w, np.float32), device=dev)
    outs, aux = apply_mitigation(mits, row[None].expand(len(mits), -1)
                                 .contiguous(), dt)
    return outs.detach().cpu().numpy(), _numpy(_to_host(aux))


def validate_many(ws, spec: UtilitySpec, dt: float, device=None
                  ) -> Tuple[np.ndarray, List[SpecReport]]:
    """Spec verdicts of B same-length waveforms ``ws`` ``[B, n]`` in one
    batch on ``device`` (None: the card): ``(ok [B], per-row
    SpecReports)``."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(ws, np.float32), device=dev)
    ok, flags, metrics = _numpy(_to_host(dict(zip(
        ("ok", "flags", "metrics"), spec.validate(x, dt))))).values()
    reports = [report_from_arrays(ok[i], {k: v[i] for k, v in flags.items()},
                                  {k: v[i] for k, v in metrics.items()})
               for i in range(len(ok))]
    return ok, reports


# ---------------------------------------------------------------------------
# batched (MPF x battery) design search
# ---------------------------------------------------------------------------

def _rank_feasible(ok: np.ndarray, overhead: np.ndarray,
                   candidates: Sequence[Tuple[float, float]]) -> np.ndarray:
    """Feasible candidate indices ranked by (energy overhead, capacity,
    MPF): minimal waste first, then minimal capacity.  The overhead is
    rounded to 6 decimals so float noise cannot outrank a smaller
    battery."""
    feasible = np.flatnonzero(np.asarray(ok))
    caps = np.asarray([candidates[i][1] for i in feasible])
    mpfs = np.asarray([candidates[i][0] for i in feasible])
    oh = np.round(np.asarray(overhead)[feasible], 6)
    return feasible[np.lexsort((mpfs, caps, oh))]


def _design_pair(spec: UtilitySpec, mpf: float, cap: float, n_chips: int,
                 swing: float, hw: Hardware,
                 target_tau_s: Optional[float] = None
                 ) -> Tuple[Optional[GpuPowerSmoothing],
                            Optional[RackBattery]]:
    """The (device, rack) mitigations a candidate stands for; an ``mpf``
    or ``cap`` of 0 turns its stage off.  ``target_tau_s`` overrides the
    battery's grid-target horizon (a warm-start predictor's third
    output)."""
    gpu = (GpuPowerSmoothing(
        mpf_frac=mpf, hw=hw,
        ramp_up_w_per_s=spec.time.ramp_up_w_per_s / n_chips,
        ramp_down_w_per_s=spec.time.ramp_down_w_per_s / n_chips)
        if mpf > 0 else None)
    tau_kw = {} if target_tau_s is None else {
        "target_tau_s": float(target_tau_s)}
    bat = (RackBattery(capacity_j=cap, max_discharge_w=swing,
                       max_charge_w=swing, **tau_kw) if cap > 0 else None)
    return gpu, bat


def _eval_candidates(spec: UtilitySpec, w: torch.Tensor, dt: float,
                     n_chips: int, candidates: Sequence[Tuple[float, float]],
                     *, swing: float, hw: Hardware,
                     target_tau_s: Optional[Sequence[Optional[float]]] = None):
    """Every ``(mpf, cap)`` candidate applied to the trace ``w`` ``[n]``
    and judged under the hard semantics, as one batch: ``(outs [B, n], ok
    [B], overhead [B], flags, metrics)`` on ``w``'s device.  The device
    stage runs on the per-chip trace (``w / n_chips``) and is multiplied
    back; the rack stage follows on the aggregate.  ``target_tau_s``
    carries one battery-horizon override per candidate (None: the
    default)."""
    B = len(candidates)
    taus = [None] * B if target_tau_s is None else list(target_tau_s)
    pairs = [_design_pair(spec, m, c, n_chips, swing, hw, target_tau_s=t)
             for (m, c), t in zip(candidates, taus)]
    outs = w[None].expand(B, -1).clone()
    gpus, gpu_on = _normalize_mits([g for g, _ in pairs], B,
                                   "design gpu candidates")
    if gpus:
        rows = _on_rows(gpu_on, B, w.device)
        chips = torch.tensor(float(n_chips), dtype=torch.float32,
                             device=w.device)
        out, _ = apply_mitigation(gpus, outs[rows] / chips, dt)
        outs[rows] = out * chips
    bats, bat_on = _normalize_mits([b for _, b in pairs], B,
                                   "design battery candidates")
    if bats:
        rows = _on_rows(bat_on, B, w.device)
        outs[rows], _ = apply_mitigation(bats, outs[rows], dt)
    ok, flags, metrics = spec.validate(outs, dt)
    overhead = energy_overhead(w[None].expand(B, -1), outs)
    return outs, ok, overhead, flags, metrics


def design_grid(spec: UtilitySpec, w, dt: float, n_chips: int,
                mpf_grid: Sequence[float], cap_grid: Sequence[float], *,
                swing: float, hw: Hardware = DEFAULT_HW, top_k: int = 1,
                device=None) -> Optional[Dict]:
    """Judge every (MPF, capacity) candidate in one batch and return the
    first passing one in grid order (MPF-major, ascending), or None.

    ``top_k`` > 1 also ranks the feasible candidates by energy overhead
    (``_rank_feasible``) and returns the best ``top_k`` under
    ``"alternatives"``; the winner stays the grid-order pick.  Runs on
    ``device`` (None: the card); the result is host data.
    """
    dev = resolve_device(device)
    candidates = [(m, c) for m in mpf_grid for c in cap_grid]
    outs, ok, overhead, flags, metrics = _eval_candidates(
        spec, torch.as_tensor(np.asarray(w, np.float32), device=dev), dt,
        n_chips, candidates, swing=swing, hw=hw)
    ok = ok.cpu().numpy()
    if not ok.any():
        return None
    overhead = overhead.cpu().numpy()
    sol = _solution(spec, candidates, outs, ok, overhead, flags, metrics,
                    int(np.argmax(ok)), _rank_feasible(ok, overhead,
                                                       candidates),
                    top_k, n_chips, swing, hw, "grid")
    sol["grid_ok"] = ok.reshape(len(mpf_grid), len(cap_grid))
    return sol


# ---------------------------------------------------------------------------
# gradient-based (MPF x battery) design
# ---------------------------------------------------------------------------

# below this fraction of mpf_max the relaxed device stage is (mostly)
# gated off and the hard re-validation snaps mpf to exactly 0 (stage off)
_GPU_GATE_PIVOT = 0.15


def _design_descend(x0: Dict[str, torch.Tensor], gpu_t: GpuPowerSmoothing,
                    bat_t: RackBattery, w: torch.Tensor, n_chips: float,
                    lo: Dict[str, float], hi: Dict[str, float],
                    hyper: Dict[str, float], spec: UtilitySpec,
                    limits: Dict[str, float], dt: float, steps: int
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Multi-start Adam descent on the smooth design objective, every
    start a row of one batch.

    ``x0`` is ``{"mpf": [S], "cap": [S]}`` (capacity in units of
    ``hyper["cap_scale"]`` joules, so both coordinates are O(1));
    ``gpu_t``/``bat_t`` are relaxed (``smooth_tau > 0``) templates whose
    ``mpf_frac``/``capacity_j`` take the iterate each step.  The objective
    is the spec's hinge loss (margin-shrunk limits) plus an energy-overhead
    and an L1 sizing regularizer; each row's gradient is clipped to norm
    100 over that row's {mpf, cap} alone, and each Adam step is followed by
    a projection onto the box ``[lo, hi]``.  A sigmoid on-gate driven by
    mpf (pivot ``_GPU_GATE_PIVOT`` of mpf_max) blends the device stage in,
    so the battery-only design lies inside the search space.  Returns the
    final iterates and the loss history ``[S, steps]``; nothing in the loss
    mixes rows.
    """
    mpf_max = gpu_t.hw.chip.mpf_max
    tau = gpu_t.smooth_tau
    S = x0["mpf"].shape[0]
    chips = torch.tensor(n_chips, dtype=torch.float32, device=w.device)
    per_chip = (w / chips)[None].expand(S, -1)
    w_rows = w[None].expand(S, -1)
    zero = torch.zeros(S, dtype=torch.float32, device=w.device)

    def objective(x):
        gpus = [dataclasses.replace(gpu_t, mpf_frac=m) for m in
                x["mpf"].unbind()]
        bats = [dataclasses.replace(bat_t, capacity_j=c) for c in
                (x["cap"] * hyper["cap_scale"]).unbind()]
        smoothed, _ = GpuPowerSmoothing.apply_batch(gpus, per_chip, dt)
        g_on = torch.sigmoid((x["mpf"] - _GPU_GATE_PIVOT * mpf_max)
                             / (tau * mpf_max))[:, None]
        chip_out = g_on * smoothed + (1.0 - g_on) * per_chip
        out, _ = RackBattery.apply_batch(bats, chip_out * chips, dt)
        viol, _ = spec.loss_jax(out, dt, margin=hyper["margin"],
                                limits=limits)
        overhead = energy_overhead(w_rows, out)
        return (viol + hyper["overhead_weight"] * torch.maximum(overhead,
                                                                zero)
                + hyper["size_weight"] * (x["cap"] + 0.25 * x["mpf"]))

    x = {k: v.detach() for k, v in x0.items()}
    state = adam_init(x)
    losses = []
    for _ in range(steps):
        xg = {k: v.clone().requires_grad_(True) for k, v in x.items()}
        loss = objective(xg)
        gm, gc = torch.autograd.grad(loss.sum(), (xg["mpf"], xg["cap"]))
        g, _ = clip_by_global_norm({"mpf": gm, "cap": gc}, 100.0,
                                   batch_dims=1)
        x, state = adam_update(x, g, state, hyper["lr"])
        x = {k: torch.clamp(v, lo[k], hi[k]) for k, v in x.items()}
        losses.append(loss.detach())
    return x, torch.stack(losses, dim=1)


def _solution(spec, candidates, outs, ok, overhead, flags, metrics, idx,
              ranked, top_k, n_chips, swing, hw, method, target_tau_s=None
              ) -> Dict:
    """The solution dict of candidate ``idx`` (host data)."""
    mpf, cap = candidates[idx]
    gpu_sel, bat_sel = _design_pair(spec, mpf, cap, n_chips, swing, hw,
                                    target_tau_s=target_tau_s)
    sol = {
        "mpf_frac": mpf,
        "battery_capacity_j": cap,
        "energy_overhead": float(overhead[idx]),
        "report": report_from_arrays(
            ok[idx], {k: v[idx].item() for k, v in flags.items()},
            {k: v[idx].item() for k, v in metrics.items()}),
        "device_mitigation": gpu_sel,
        "rack_mitigation": bat_sel,
        "mitigated": outs[idx].cpu().numpy(),
        "alternatives": [{
            "mpf_frac": candidates[i][0],
            "battery_capacity_j": candidates[i][1],
            "energy_overhead": float(overhead[i]),
        } for i in ranked[:top_k]],
        "method": method,
        "aux": {},
    }
    if target_tau_s is not None:
        sol["target_tau_s"] = target_tau_s
    return sol


def design_gradient(spec: UtilitySpec, w, dt: float, n_chips: int, *,
                    swing: Optional[float] = None, hw: Hardware = DEFAULT_HW,
                    seeds: Optional[Sequence[Tuple[float, float]]] = None,
                    steps: int = 120, lr: float = 0.08,
                    smooth_tau: float = 0.05, margin: float = 0.05,
                    overhead_weight: float = 0.5, size_weight: float = 0.02,
                    period_hint_s: float = 2.0, top_k: int = 4,
                    cap_scale: Optional[float] = None,
                    mpf_bounds: Optional[Tuple[float, float]] = None,
                    cap_bounds_j: Optional[Tuple[float, float]] = None,
                    device=None) -> Optional[Dict]:
    """Gradient descent on (MPF fraction, battery capacity).

    The forward model is the gated gpu -> battery stack the grid search
    evaluates, run through the mitigations' ``smooth_tau`` relaxation
    (kernels J and K, forward and adjoint, on the card); the objective is
    ``UtilitySpec.loss_jax`` plus an energy-overhead regularizer.
    ``seeds`` are (mpf_frac, capacity_j) starts, augmented with a fixed
    6-point lattice over the box; all starts descend as rows of one batch.

    The answer is exact: every final iterate (with a capacity ladder around
    it and its battery-only variant) and every seed is re-validated under
    the hard semantics in one batch, and the minimal-overhead passing
    candidate wins.  Returns ``design_grid``'s dict (plus
    ``loss_history`` ``[S, steps]``), or None when nothing passes.  Runs
    on ``device`` (None: the card).
    """
    dev = resolve_device(device)
    w = np.asarray(w, np.float32)
    swing = float(w.max() - w.min()) if swing is None else float(swing)
    cap_scale = float(cap_scale or swing * period_hint_s)
    mpf_lo, mpf_hi = mpf_bounds or (0.0, hw.chip.mpf_max)
    cap_lo_j, cap_hi_j = cap_bounds_j or (0.0, 4.0 * cap_scale)
    # caller seeds are augmented with a fixed lattice over the box: a
    # degenerate seed set (only MPF-only configs with cap ~ 0, where the
    # saturated battery's capacity gradient vanishes) cannot climb out
    lattice = [(m, f * cap_scale) for m in (0.3, 0.6, 0.85)
               for f in (0.25, 1.0)]
    seeds = lattice if seeds is None else list(seeds) + lattice
    seeds = list(dict.fromkeys(
        (float(np.clip(m, mpf_lo, mpf_hi)),
         float(np.clip(c, cap_lo_j, cap_hi_j))) for m, c in seeds))
    # the descent stays above a small capacity floor: at cap -> 0 the SoC
    # fraction's reverse-mode terms scale like 1/cap^2 and overflow f32;
    # the raw (possibly cap = 0) seeds are still hard-validated below
    cap_floor_j = max(cap_lo_j, 1e-3 * cap_scale)

    gpu_t = GpuPowerSmoothing(
        mpf_frac=0.5, hw=hw,
        ramp_up_w_per_s=spec.time.ramp_up_w_per_s / n_chips,
        ramp_down_w_per_s=spec.time.ramp_down_w_per_s / n_chips,
        smooth_tau=smooth_tau)
    bat_t = RackBattery(capacity_j=cap_scale, max_discharge_w=swing,
                        max_charge_w=swing, smooth_tau=smooth_tau)
    f32 = np.float32
    x0 = {"mpf": torch.tensor([m for m, _ in seeds], dtype=torch.float32,
                              device=dev),
          "cap": torch.tensor([max(c, cap_floor_j) / cap_scale
                               for _, c in seeds], dtype=torch.float32,
                              device=dev)}
    lo = {"mpf": float(f32(mpf_lo)), "cap": float(f32(cap_floor_j
                                                      / cap_scale))}
    hi = {"mpf": float(f32(mpf_hi)), "cap": float(f32(cap_hi_j / cap_scale))}
    hyper = {"lr": float(f32(lr)), "margin": float(f32(margin)),
             "overhead_weight": float(f32(overhead_weight)),
             "size_weight": float(f32(size_weight)),
             "cap_scale": float(f32(cap_scale))}
    w_t = torch.as_tensor(w, device=dev)
    xf, losses = _design_descend(x0, gpu_t, bat_t, w_t, float(n_chips), lo,
                                 hi, hyper, spec, spec.limits(), dt, steps)

    # hard re-validation: each final iterate with a geometric capacity
    # ladder around it, its battery-only variant, and the seeds themselves
    # (so a refined answer is never worse than its seed)
    finals = list(zip(xf["mpf"].cpu().tolist(),
                      (xf["cap"].cpu().numpy() * f32(cap_scale)).tolist()))
    candidates: List[Tuple[float, float]] = []
    for m, c in finals:
        for f in (0.75, 0.8, 0.87, 0.93, 1.0, 1.08, 1.25, 1.6):
            ck = float(np.clip(c * f, cap_lo_j, cap_hi_j))
            candidates.append((m, ck))
            candidates.append((0.0, ck))
    candidates += seeds
    # snap a mostly-gated-off device stage to an exactly-off one
    candidates = [(0.0 if m < _GPU_GATE_PIVOT * hw.chip.mpf_max else m,
                   0.0 if c < 1e-6 * cap_scale else c)
                  for m, c in candidates]
    candidates = list(dict.fromkeys(candidates))
    outs, ok, overhead, flags, metrics = _eval_candidates(
        spec, w_t, dt, n_chips, candidates, swing=swing, hw=hw)
    ok = ok.cpu().numpy()
    if not ok.any():
        return None
    overhead = overhead.cpu().numpy()
    ranked = _rank_feasible(ok, overhead, candidates)
    sol = _solution(spec, candidates, outs, ok, overhead, flags, metrics,
                    int(ranked[0]), ranked, top_k, n_chips, swing, hw,
                    "gradient")
    sol["loss_history"] = losses.cpu().numpy()
    return sol


# capacity rungs the warm-start fast path walks around a predicted seed:
# sub-1.0 rungs reclaim an over-provisioned prediction, the >1.0 rungs
# rescue an under-provisioned one without falling back to the polisher
_WARMSTART_CAP_LADDER = (0.8, 0.9, 1.0, 1.15, 1.4, 2.0)


def design_warmstart(spec: UtilitySpec, w, dt: float, n_chips: int, *,
                     predictor, swing: Optional[float] = None,
                     hw: Hardware = DEFAULT_HW, features=None,
                     period_hint_s: float = 2.0, top_k: int = 4,
                     polish_steps: int = 40, device=None,
                     **gradient_kwargs) -> Optional[Dict]:
    """(MPF, capacity, battery horizon) design from a predictor's seeds.

    ``predictor(spec, w, dt, n_chips, features=features)`` returns
    ``[(mpf_frac, capacity_j, target_tau_s), ...]``; any callable does.
    The fast path expands each seed into a capacity ladder (plus
    battery-only variants) and judges them all under the hard semantics
    in one batch; a passing rung wins by the solvers' (overhead, capacity,
    mpf) order.  If none passes, a short gradient polish from the seeds,
    then the full ``hybrid`` solver, so the verdict matches the solver
    this path stands in for.  ``aux["warmstart_path"]`` says which tier
    answered ("fast", "polish" or "hybrid_fallback").
    """
    dev = resolve_device(device)
    w = np.asarray(w, np.float32)
    swing = float(w.max() - w.min()) if swing is None else float(swing)
    preds = predictor(spec, w, dt, n_chips, features=features)
    dedup: Dict[Tuple[float, float], float] = {}
    for mpf, cap, tau in preds:
        mpf = float(np.clip(mpf, 0.0, hw.chip.mpf_max))
        if mpf < _GPU_GATE_PIVOT * hw.chip.mpf_max:
            mpf = 0.0                       # snap a gated-off device stage
        cap = max(float(cap), 0.0)
        tau = float(tau)
        for f in _WARMSTART_CAP_LADDER:
            ck = round(cap * f, 3)
            if mpf == 0.0 and ck <= 0.0:
                continue            # no-mitigation rung: nothing to verify
            dedup.setdefault((mpf, ck), tau)
            if mpf > 0 and ck > 0:          # battery-only variant
                dedup.setdefault((0.0, ck), tau)
    candidates = list(dedup)
    taus = [dedup[c] for c in candidates]
    if candidates:
        outs, ok, overhead, flags, metrics = _eval_candidates(
            spec, torch.as_tensor(w, device=dev), dt, n_chips, candidates,
            swing=swing, hw=hw, target_tau_s=taus)
        ok = ok.cpu().numpy()
        if ok.any():
            overhead = overhead.cpu().numpy()
            ranked = _rank_feasible(ok, overhead, candidates)
            idx = int(ranked[0])
            sol = _solution(spec, candidates, outs, ok, overhead, flags,
                            metrics, idx, ranked, top_k, n_chips, swing, hw,
                            "warmstart", target_tau_s=taus[idx])
            sol["aux"] = {"warmstart_path": "fast"}
            return sol
    # the ladder missed: a short polish from the predicted seeds, then the
    # full solver
    sol = design_gradient(spec, w, dt, n_chips, swing=swing, hw=hw,
                          seeds=[(m, c) for m, c, _ in preds] or None,
                          steps=polish_steps, period_hint_s=period_hint_s,
                          top_k=top_k, device=dev, **gradient_kwargs)
    path = "polish"
    if sol is None:
        sol = design(spec, w, dt, n_chips, method="hybrid", hw=hw,
                     period_hint_s=period_hint_s, top_k=top_k, device=dev,
                     **gradient_kwargs)
        path = "hybrid_fallback"
    if sol is None:
        return None
    sol = dict(sol)
    sol["method"] = "warmstart"
    sol["aux"] = dict(sol.get("aux") or {}, warmstart_path=path)
    return sol


def design(spec: UtilitySpec, w, dt: float, n_chips: int, *,
           method: str = "hybrid", hw: Hardware = DEFAULT_HW,
           period_hint_s: float = 2.0,
           mpf_grid: Optional[Sequence[float]] = None,
           cap_grid: Optional[Sequence[float]] = None, top_k: int = 4,
           warmstart=None, features=None, polish_steps: int = 40,
           device=None, **gradient_kwargs) -> Optional[Dict]:
    """The (MPF, battery-capacity) design entry point.

    method="grid"      the batched coarse grid search (``design_grid``)
                       over MPF floors up to the chip's cap and battery
                       capacities of ``swing * period_hint_s`` times 0 and
                       1/8 to 2;
    method="gradient"  Adam through the relaxed pipeline
                       (``design_gradient``), lattice-seeded;
    method="hybrid"    the grid first, then the gradient refinement seeded
                       from its top-k feasible configs: never worse than
                       the grid, and finds the compliance frontier between
                       grid points (the default, as in the reference);
    method="warmstart" ``design_warmstart`` from the predictor passed as
                       ``warmstart=`` (and optional ``features=``).

    Runs on ``device`` (None: the card).
    """
    w = np.asarray(w, np.float32)
    swing = float(w.max() - w.min())
    if method == "warmstart":
        if warmstart is None:
            raise ValueError(
                "method='warmstart' needs a predictor: design(..., "
                "warmstart=predictor)")
        return design_warmstart(spec, w, dt, n_chips, predictor=warmstart,
                                swing=swing, hw=hw, features=features,
                                period_hint_s=period_hint_s, top_k=top_k,
                                polish_steps=polish_steps, device=device,
                                **gradient_kwargs)
    if mpf_grid is None:
        # the hardware caps how high a floor is programmable
        mpf_grid = [m for m in (0.0, 0.5, 0.65, 0.8, 0.9)
                    if m <= hw.chip.mpf_max + 1e-9]
    if cap_grid is None:
        cap_grid = [0.0] + [swing * period_hint_s * f for f in
                            (0.125, 0.25, 0.5, 1.0, 2.0)]
    if method == "grid":
        return design_grid(spec, w, dt, n_chips, mpf_grid, cap_grid,
                           swing=swing, hw=hw, top_k=top_k, device=device)
    if method == "gradient":
        return design_gradient(spec, w, dt, n_chips, swing=swing, hw=hw,
                               period_hint_s=period_hint_s, top_k=top_k,
                               device=device, **gradient_kwargs)
    if method != "hybrid":
        raise ValueError(f"method must be grid|gradient|hybrid|warmstart, "
                         f"got {method!r}")
    grid_sol = design_grid(spec, w, dt, n_chips, mpf_grid, cap_grid,
                           swing=swing, hw=hw, top_k=top_k, device=device)
    seeds = None
    if grid_sol is not None:
        seeds = [(a["mpf_frac"], a["battery_capacity_j"])
                 for a in grid_sol["alternatives"]]
        seeds.append((grid_sol["mpf_frac"], grid_sol["battery_capacity_j"]))
    grad_sol = design_gradient(spec, w, dt, n_chips, swing=swing, hw=hw,
                               period_hint_s=period_hint_s, seeds=seeds,
                               top_k=top_k, device=device, **gradient_kwargs)
    sols = [s for s in (grad_sol, grid_sol) if s is not None]
    if not sols:
        return None
    # the rounded (overhead, capacity, mpf) order _rank_feasible applies:
    # raw-float overhead would let 1e-7 noise hand the win back to the
    # grid's bigger battery
    best = min(sols, key=lambda s: (round(s["energy_overhead"], 6),
                                    s["battery_capacity_j"], s["mpf_frac"]))
    best = dict(best)
    best["method"] = "hybrid"
    return best
