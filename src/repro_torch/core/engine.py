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
  ``design``          the (MPF, battery capacity) design search on one
                      trace: ``method="grid"`` (``design_grid``) judges
                      every candidate of the coarse grid in one batch.

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
run, one-shot or chunked.  Sharding and the gradient-based design solvers
(``method`` gradient, hybrid, warmstart) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.hardware import DEFAULT_HW, Hardware
from repro_torch.core.smoothing.base import (apply_mitigation,
                                             energy_overhead, structure)
from repro_torch.core.smoothing.battery import RackBattery
from repro_torch.core.smoothing.gpu_floor import GpuPowerSmoothing
from repro_torch.core.spec import SpecReport, UtilitySpec, report_from_arrays
from repro_torch.core.spectrum import critical_band_report
from repro_torch.core.waveform import (WaveformConfig, aggregate,
                                       chip_waveform, jitter_shifts,
                                       phase_levels, swing_stats)
from repro_torch.device import resolve_device

DESIGN_NOT_PORTED = ("design(method={!r}) is not ported yet: ROADMAP queue "
                     "A, the design path (only method='grid' runs)")

# rows of one analysis call (tails repeat their last row): reductions on the
# card and on the CPU pick their order by the number of rows they reduce,
# so every row is analysed in a batch of this one size
ANALYSIS_ROWS = 32


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
    ``[B]``."""
    dc_raw: torch.Tensor
    dc_mitigated: torch.Tensor
    n_valid: torch.Tensor
    energy_overhead: torch.Tensor
    swing: Dict[str, torch.Tensor]
    swing_mitigated: Dict[str, torch.Tensor]
    aux: Dict


def simulate_batch(timelines, n_chips, wave_cfg: Optional[WaveformConfig]
                   = None, *, device_mitigation=None, rack_mitigation=None,
                   hw: Hardware = DEFAULT_HW, seeds=0, keys=None,
                   sample_chips: int = 64,
                   levels: Optional[Sequence[np.ndarray]] = None,
                   pad_to: Optional[int] = None,
                   device="cuda") -> BatchResult:
    """Simulate a batch of scenario rows of one mitigation structure.

    Each batched argument is a singleton (broadcast) or a length-B
    sequence; mitigation rows may be None (disabled).  ``keys`` (one per
    row, or one for all) feed the mitigations that draw noise; without
    them such a mitigation draws from ``prng_key(0)`` on every row.
    Without ``pad_to`` every row must expand to the same sample count;
    with it, rows are edge-padded to ``pad_to`` and masked.
    """
    cfg = wave_cfg or WaveformConfig()
    dt = cfg.dt
    device = torch.device(device)
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
    return BatchResult(
        dc_raw=dc_raw, dc_mitigated=dc, n_valid=n_valid,
        energy_overhead=((e_out - e_in) / torch.clamp(e_in, min=1e-12)
                         ).to(torch.float32),
        swing=swing_stats(dc_raw, n_valid),
        swing_mitigated=swing_stats(dc, n_valid), aux=aux)


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
                   skip_rows: int = 0, device="cuda"):
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

    ``skip_rows`` skips every chunk whose rows all lie below it without
    dispatching it (the resume path restores those from disk); it must
    fall on a chunk boundary.
    """
    cfg = wave_cfg or WaveformConfig()
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

    def dispatch(lo: int, hi: int):
        C = hi - lo
        tail = chunk_size - C if n_chunks > 1 else 0

        def sl(xs):
            return xs[lo:hi] + [xs[hi - 1]] * tail

        ks = None
        if keys_t is not None:
            ks = torch.cat([keys_t[lo:hi], keys_t[hi - 1:hi].expand(tail, 2)])
        res = simulate_batch(sl(tls), sl(chips), cfg,
                             device_mitigation=sl(dev_list),
                             rack_mitigation=sl(rack_list), hw=hw,
                             seeds=sl(seed_list), keys=ks,
                             sample_chips=sample_chips,
                             levels=sl(level_rows), pad_to=pad_to,
                             device=device)
        groups: Dict[int, List[int]] = {}
        for i in range(C):
            groups.setdefault(lens[lo + i], []).append(i)
        gres = []
        for L, g in sorted(groups.items()):
            for part in _analysis_slices(g):
                sel = torch.tensor(part, device=res.dc_mitigated.device)
                mit = res.dc_mitigated[sel, :L]
                per_spec = []
                for si, sp in enumerate(spec_list):
                    do_bands = bands and si == 0
                    per_spec.append(
                        None if sp is None and not do_bands else _to_host(
                            analyze_batch(mit, cfg.dt, sp, bands=do_bands)))
                gres.append((part, per_spec))
        direct = _to_host({"eo": res.energy_overhead[:C],
                           "sw": {k: v[:C] for k, v in res.swing.items()},
                           "swm": {k: v[:C] for k, v in
                                   res.swing_mitigated.items()}})
        done = None
        if res.dc_mitigated.is_cuda:
            done = torch.cuda.Event()
            done.record()
        return lo, hi, res.dc_mitigated.shape[1], direct, gres, done

    def materialize(pending) -> StreamChunk:
        lo, hi, n, direct, gres, done = pending
        if done is not None:
            done.synchronize()
        C = hi - lo
        direct = _numpy(direct)
        chunk = StreamChunk(
            start=lo, stop=hi, n=n, n_valid=np.asarray(lens[lo:hi], np.int64),
            energy_overhead=direct["eo"], swing=direct["sw"],
            swing_mitigated=direct["swm"], bands_mitigated=None,
            spec_ok=[None] * S, spec_flags=[None] * S,
            spec_metrics=[None] * S)
        bands_cols: Dict[str, np.ndarray] = {}
        seen = set()
        for part, per_spec in gres:
            # a slice's padding repeats a row it already holds
            keep = [j for j, i in enumerate(part) if i not in seen]
            g = [part[j] for j in keep]
            seen.update(g)
            for si, a in enumerate(per_spec):
                if a is None:
                    continue
                a = _numpy(a)
                for k, v in a.get("bands_mitigated", {}).items():
                    bands_cols.setdefault(k, np.empty(C, v.dtype))[g] = v[keep]
                if spec_list[si] is None:
                    continue
                if chunk.spec_ok[si] is None:
                    chunk.spec_ok[si] = np.zeros(C, bool)
                    chunk.spec_flags[si] = {k: np.zeros(C, bool)
                                            for k in a["spec_flags"]}
                    chunk.spec_metrics[si] = [None] * C
                chunk.spec_ok[si][g] = a["spec_ok"][keep]
                for k, v in a["spec_flags"].items():
                    chunk.spec_flags[si][k][g] = v[keep]
                for j, i in zip(keep, g):
                    chunk.spec_metrics[si][i] = {
                        k: float(v[j]) for k, v in a["spec_metrics"].items()}
        if bands_cols:
            chunk.bands_mitigated = bands_cols
        return chunk

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
                 swing: float, hw: Hardware
                 ) -> Tuple[Optional[GpuPowerSmoothing],
                            Optional[RackBattery]]:
    """The (device, rack) mitigations a candidate stands for; an ``mpf``
    or ``cap`` of 0 turns its stage off."""
    gpu = (GpuPowerSmoothing(
        mpf_frac=mpf, hw=hw,
        ramp_up_w_per_s=spec.time.ramp_up_w_per_s / n_chips,
        ramp_down_w_per_s=spec.time.ramp_down_w_per_s / n_chips)
        if mpf > 0 else None)
    bat = (RackBattery(capacity_j=cap, max_discharge_w=swing,
                       max_charge_w=swing) if cap > 0 else None)
    return gpu, bat


def _eval_candidates(spec: UtilitySpec, w: torch.Tensor, dt: float,
                     n_chips: int, candidates: Sequence[Tuple[float, float]],
                     *, swing: float, hw: Hardware):
    """Every ``(mpf, cap)`` candidate applied to the trace ``w`` ``[n]``
    and judged, as one batch: ``(outs [B, n], ok [B], overhead [B],
    flags, metrics)`` on ``w``'s device.  The device stage runs on the
    per-chip trace (``w / n_chips``) and is multiplied back; the rack
    stage follows on the aggregate."""
    B = len(candidates)
    pairs = [_design_pair(spec, m, c, n_chips, swing, hw)
             for m, c in candidates]
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
    idx = int(np.argmax(ok))
    mpf, cap = candidates[idx]
    overhead = overhead.cpu().numpy()
    ranked = _rank_feasible(ok, overhead, candidates)[:top_k]
    gpu_sel, bat_sel = _design_pair(spec, mpf, cap, n_chips, swing, hw)
    return {
        "mpf_frac": mpf,
        "battery_capacity_j": cap,
        "energy_overhead": float(overhead[idx]),
        "report": report_from_arrays(
            ok[idx], {k: v[idx].item() for k, v in flags.items()},
            {k: v[idx].item() for k, v in metrics.items()}),
        "device_mitigation": gpu_sel,
        "rack_mitigation": bat_sel,
        "mitigated": outs[idx].cpu().numpy(),
        "grid_ok": ok.reshape(len(mpf_grid), len(cap_grid)),
        "alternatives": [{
            "mpf_frac": candidates[i][0],
            "battery_capacity_j": candidates[i][1],
            "energy_overhead": float(overhead[i]),
        } for i in ranked],
        "method": "grid",
        "aux": {},
    }


def design(spec: UtilitySpec, w, dt: float, n_chips: int, *,
           method: str = "grid", hw: Hardware = DEFAULT_HW,
           period_hint_s: float = 2.0,
           mpf_grid: Optional[Sequence[float]] = None,
           cap_grid: Optional[Sequence[float]] = None, top_k: int = 4,
           warmstart=None, device=None, **unported) -> Optional[Dict]:
    """The (MPF, battery-capacity) design entry point.

    ``method="grid"`` is the batched coarse grid search (``design_grid``)
    over MPF floors up to the chip's cap and battery capacities of
    ``swing * period_hint_s`` times 0 and 1/8 to 2.  The gradient-based
    methods (``gradient``, ``hybrid``, ``warmstart``) and their options
    (``warmstart=``, the gradient keywords) are not ported yet and raise
    ``NotImplementedError``.  The reference
    defaults to ``hybrid``; the port to the one method it has.
    """
    if (method in ("gradient", "hybrid", "warmstart")
            or warmstart is not None or unported):
        raise NotImplementedError(DESIGN_NOT_PORTED.format(method))
    if method != "grid":
        raise ValueError(f"method must be grid|gradient|hybrid|warmstart, "
                         f"got {method!r}")
    w = np.asarray(w, np.float32)
    swing = float(w.max() - w.min())
    if mpf_grid is None:
        # the hardware caps how high a floor is programmable
        mpf_grid = [m for m in (0.0, 0.5, 0.65, 0.8, 0.9)
                    if m <= hw.chip.mpf_max + 1e-9]
    if cap_grid is None:
        cap_grid = [0.0] + [swing * period_hint_s * f for f in
                            (0.125, 0.25, 0.5, 1.0, 2.0)]
    return design_grid(spec, w, dt, n_chips, mpf_grid, cap_grid,
                       swing=swing, hw=hw, top_k=top_k, device=device)
