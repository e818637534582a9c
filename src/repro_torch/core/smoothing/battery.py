"""Rack-level energy storage (paper Sec. IV-C), hard semantics.

The BESS tracks a slowly-moving grid target (EMA of load) by discharging
into compute peaks and recharging in comm valleys (Fig. 7).  Limits
modeled: capacity (J), charge/discharge power (W), one-way efficiency,
and the charge/discharge mode-switch latency.

The per-sample SoC recursion runs as kernel C (``kernels/scans/csrc/
battery.cu``) on a CUDA tensor and as ``battery_scan_plain``, a Python
loop over samples, on a CPU tensor.  The relaxed design path
(``smooth_tau > 0``) is not ported yet.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.core.smoothing.base import (RELAXED_NOT_PORTED, energy_overhead, mean64,
                                             stack_params)
from repro_torch.kernels.build import CudaKernel, ptr, stream_of

BATTERY_KERNEL = CudaKernel(
    "scans/csrc/battery.cu", "battery_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                               ctypes.c_void_p],
    extra_flags=("-fmad=false",))

# column order of the per-row parameter matrix the kernel reads
PARAM_COLUMNS = ("alpha", "lat_n", "cap_j", "max_dis", "max_chg", "eff",
                 "soc0", "tgt0")


def battery_scan_plain(w: torch.Tensor, params: torch.Tensor, dt: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel C's plain version: the reference step, f32, in a Python loop
    over the samples of ``w`` ``[B, n]``.  Returns ``(grid [B, n],
    soc_min [B], soc_max [B])``."""
    alpha, lat_n, cap_j, max_dis, max_chg, eff, soc, tgt = params.unbind(-1)
    # constants as device tensors: a division by a Python scalar may run as
    # a multiplication by its reciprocal, which rounds differently
    dt = torch.tensor(dt, dtype=torch.float32, device=w.device)
    tenth = torch.tensor(0.1, dtype=torch.float32, device=w.device)
    zero = torch.zeros_like(soc)
    one = torch.ones_like(soc)
    mode = zero
    hold = zero
    lo = torch.full_like(soc, float("inf"))
    hi = torch.full_like(soc, float("-inf"))
    grid = torch.empty_like(w)
    for i in range(w.shape[1]):
        p = w[:, i]
        tgt = tgt + alpha * (p - tgt)
        want = p - tgt
        new_mode = torch.sign(want)
        switching = (new_mode != mode) & (new_mode != 0) & (mode != 0)
        hold = torch.where(switching, lat_n, torch.clamp(hold - 1.0, min=0.0))
        blocked = hold > 0
        soc_frac = soc / cap_j
        taper_lo = torch.clamp(soc_frac / tenth, 0.0, 1.0)
        taper_hi = torch.clamp((one - soc_frac) / tenth, 0.0, 1.0)
        dis = torch.minimum(torch.clamp(want, min=0.0), max_dis * taper_lo)
        dis = torch.minimum(dis, soc * eff / dt)
        chg = torch.minimum(torch.clamp(-want, min=0.0), max_chg * taper_hi)
        chg = torch.minimum(chg, (cap_j - soc) / eff / dt)
        dis = torch.where(blocked, zero, dis)
        chg = torch.where(blocked, zero, chg)
        grid[:, i] = p - dis + chg
        soc = soc - dis * dt / eff + chg * dt * eff
        soc = torch.minimum(torch.clamp(soc, min=0.0), cap_j)
        mode = new_mode
        lo = torch.minimum(lo, soc)
        hi = torch.maximum(hi, soc)
    return grid, lo, hi


def battery_scan(w: torch.Tensor, params: torch.Tensor, dt: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grid-side power ``[B, n]`` and the SoC minimum and maximum ``[B]`` of
    batteries with per-row ``params`` ``[B, 8]`` (f32, ``PARAM_COLUMNS``
    order) behind loads ``w`` ``[B, n]`` (f32)."""
    B, n = w.shape
    if w.dtype != torch.float32 or params.shape != (B, len(PARAM_COLUMNS)):
        raise ValueError("battery_scan: w must be f32 [B, n], params "
                         f"[B, {len(PARAM_COLUMNS)}]")
    if w.device.type == "cpu":
        return battery_scan_plain(w, params.to(torch.float32), dt)
    if w.device.type != "cuda" or params.device != w.device:
        raise ValueError("battery_scan: w and params must share one CUDA "
                         "device")
    w = w.contiguous()
    params = params.to(torch.float32).contiguous()
    grid = torch.empty_like(w)
    soc_min = torch.empty(B, dtype=torch.float32, device=w.device)
    soc_max = torch.empty_like(soc_min)
    BATTERY_KERNEL.launch(ptr(w), ptr(params), float(dt), ptr(grid),
                          ptr(soc_min), ptr(soc_max), B, n, stream_of(w))
    return grid, soc_min, soc_max


@dataclasses.dataclass(frozen=True)
class RackBattery:
    capacity_j: float                    # usable energy per rack-equivalent
    max_discharge_w: float
    max_charge_w: float
    efficiency: float = 0.95             # one-way (sqrt of round-trip)
    target_tau_s: float = 30.0           # EMA horizon for the grid target
    initial_soc: float = 0.5
    switch_latency_s: float = 0.0        # mode-switch dead time
    # 0 = exact hard semantics; > 0 = the design-time relaxation
    smooth_tau: float = 0.0

    STATIC_FIELDS = ("smooth_tau",)
    PARAMS = ("capacity_j", "max_discharge_w", "max_charge_w", "efficiency",
              "target_tau_s", "initial_soc", "switch_latency_s")

    @classmethod
    def apply_batch(cls, mits: Sequence["RackBattery"], w: torch.Tensor,
                    dt: float) -> Tuple[torch.Tensor, Dict]:
        if mits[0].smooth_tau:
            raise NotImplementedError(RELAXED_NOT_PORTED)
        w = w.to(torch.float32)
        p = stack_params(mits, cls.PARAMS, w.device)
        dt32 = torch.tensor(dt, dtype=torch.float32, device=w.device)
        # the reference's f32 parameter arithmetic, operation for operation;
        # a zero capacity degrades to a passthrough instead of 0/0
        cap_j = torch.clamp(p["capacity_j"], min=1e-9)
        params = torch.stack([
            dt32 / torch.maximum(p["target_tau_s"], dt32),
            torch.round(p["switch_latency_s"] / dt32),
            cap_j,
            p["max_discharge_w"],
            p["max_charge_w"],
            p["efficiency"],
            p["initial_soc"] * cap_j,
            # the grid target starts at the trace mean (the scheduled
            # steady-state draw), not at the initial transient
            mean64(w)], dim=-1)
        grid, soc_min, soc_max = battery_scan(w, params, dt)
        return grid, {
            "soc_min_frac": soc_min / cap_j,
            "soc_max_frac": soc_max / cap_j,
            "energy_overhead": energy_overhead(w, grid),
            "peak_reduction_w": w.amax(-1) - grid.amax(-1),
        }
