"""GB200-style device power smoothing (paper Sec. IV-B), hard semantics.

Feature model:
  * ramp-up / ramp-down rate limits (W/s), programmable;
  * Minimum Power Floor (MPF, <= 90% TDP): while the workload is engaged,
    the chip burns at least MPF watts;
  * stop delay: on zero activity the floor holds for stop_delay seconds,
    then releases at the programmed ramp-down rate;
  * EDP cap: output clamped at ``edp_cap_frac`` x TDP (at most the EDP
    factor).

The per-sample recursion runs as kernel B (``kernels/scans/csrc/
gpu_floor.cu``) on a CUDA tensor and as ``gpu_floor_scan_plain``, a
Python loop over samples, on a CPU tensor.  The relaxed design path
(``smooth_tau > 0``) is not ported yet.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.core.hardware import DEFAULT_HW, Hardware
from repro_torch.core.smoothing.base import (RELAXED_NOT_PORTED, energy_overhead, stack_params)
from repro_torch.kernels.build import CudaKernel, ptr, stream_of

GPU_FLOOR_KERNEL = CudaKernel(
    "scans/csrc/gpu_floor.cu", "gpu_floor_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                             ctypes.c_void_p],
    extra_flags=("-fmad=false",))

# column order of the per-row parameter matrix the kernel reads
PARAM_COLUMNS = ("mpf", "thresh", "ru", "rd", "stop_n", "cap")


def gpu_floor_scan_plain(w: torch.Tensor, params: torch.Tensor
                         ) -> torch.Tensor:
    """Kernel B's plain version: the reference step, f32, in a Python loop
    over the samples of ``w`` ``[B, n]``; ``params`` ``[B, 6]`` in
    ``PARAM_COLUMNS`` order."""
    mpf, thresh, ru, rd, stop_n, cap = params.unbind(-1)
    out = torch.empty_like(w)
    o = w[:, 0].clone()
    idle = torch.zeros_like(o)
    zero = torch.zeros_like(o)
    for i in range(w.shape[1]):
        p = w[:, i]
        idle = torch.where(p > thresh, zero, idle + 1.0)
        floor = torch.where(idle <= stop_n, mpf, zero)
        target = torch.minimum(torch.maximum(p, floor), cap)
        o = torch.minimum(torch.maximum(target, o - rd), o + ru)
        out[:, i] = o
    return out


def gpu_floor_scan(w: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Smoothed chip power ``[B, n]`` of ``w`` ``[B, n]`` (f32), per-row
    ``params`` ``[B, 6]`` (f32, ``PARAM_COLUMNS`` order)."""
    B, n = w.shape
    if w.dtype != torch.float32 or params.shape != (B, len(PARAM_COLUMNS)):
        raise ValueError("gpu_floor_scan: w must be f32 [B, n], params "
                         f"[B, {len(PARAM_COLUMNS)}]")
    if w.device.type == "cpu":
        return gpu_floor_scan_plain(w, params.to(torch.float32))
    if w.device.type != "cuda" or params.device != w.device:
        raise ValueError("gpu_floor_scan: w and params must share one CUDA "
                         "device")
    w = w.contiguous()
    params = params.to(torch.float32).contiguous()
    out = torch.empty_like(w)
    GPU_FLOOR_KERNEL.launch(ptr(w), ptr(params), ptr(out), B, n,
                            stream_of(w))
    return out


@dataclasses.dataclass(frozen=True)
class GpuPowerSmoothing:
    mpf_frac: float = 0.9               # floor as fraction of TDP (<= 0.9)
    ramp_up_w_per_s: float = 1000.0     # per chip
    ramp_down_w_per_s: float = 1000.0
    stop_delay_s: float = 2.0
    activity_threshold_frac: float = 0.35  # "no real workload activity"
    # paper Sec. III-C "Control EDP": when EDP peaks are visible beyond the
    # rack PSUs the EDP must be programmed down; 1.0 clamps output at TDP
    edp_cap_frac: float = 1.0
    hw: Hardware = DEFAULT_HW
    # 0 = exact hard semantics; > 0 = the design-time relaxation
    smooth_tau: float = 0.0

    STATIC_FIELDS = ("hw", "smooth_tau")
    PARAMS = ("mpf_frac", "ramp_up_w_per_s", "ramp_down_w_per_s",
              "stop_delay_s", "activity_threshold_frac", "edp_cap_frac")

    def __post_init__(self):
        if self.mpf_frac > self.hw.chip.mpf_max + 1e-9:
            raise ValueError(
                f"GB200 feature caps MPF at {self.hw.chip.mpf_max:.0%} TDP")

    @classmethod
    def apply_batch(cls, mits: Sequence["GpuPowerSmoothing"],
                    w: torch.Tensor, dt: float
                    ) -> Tuple[torch.Tensor, Dict]:
        if mits[0].smooth_tau:
            raise NotImplementedError(RELAXED_NOT_PORTED)
        hw = mits[0].hw
        tdp = hw.chip.tdp_w
        p = stack_params(mits, cls.PARAMS, w.device)
        dt32 = torch.tensor(dt, dtype=torch.float32, device=w.device)
        # the reference's f32 parameter arithmetic, operation for operation
        mpf = p["mpf_frac"] * tdp
        cap = torch.minimum(
            p["edp_cap_frac"],
            torch.tensor(hw.chip.edp_factor, dtype=torch.float32,
                         device=w.device)) * tdp
        params = torch.stack([
            mpf,
            p["activity_threshold_frac"] * tdp,
            p["ramp_up_w_per_s"] * dt32,
            p["ramp_down_w_per_s"] * dt32,
            p["stop_delay_s"] / dt32,
            cap], dim=-1)
        w = w.to(torch.float32)
        out = gpu_floor_scan(w, params)
        return out, {"energy_overhead": energy_overhead(w, out),
                     "floor_w": mpf}
