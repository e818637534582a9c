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
Python loop over samples, on a CPU tensor.

``smooth_tau > 0`` selects the design-time relaxation (reference
``_apply_smooth``): the activity gate, the idle counter's reset, the
stop-delay gate and the floor and cap selects become sigmoid blends and
logaddexp maxima at temperature tau; the ramp clip stays hard.  It runs as
kernel J (``kernels/scans/csrc/gpu_floor_relaxed.cu``: each row cut into
chunks of 1024 samples, a warp a chunk, the recurrences in segmented walks
with an exact merge test, the adjoint in float64 affine scans), a forward
and an adjoint behind one ``torch.autograd.Function``, on a CUDA tensor, and as
``gpu_floor_relaxed_plain`` (a Python loop that autograd differentiates)
on a CPU tensor.  The parameter columns are built from the fields with
ordinary torch ops, so a field that holds a tensor gets its gradient.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.core.hardware import DEFAULT_HW, Hardware
from repro_torch.core.smoothing.base import energy_overhead, stack_params
from repro_torch.core.smoothing.relax import (chain_chunks, chain_scratch,
                                             per_sample, sigmoid_gate,
                                             smooth_max)
from repro_torch.kernels.build import CudaKernel, ptr, stream_of

GPU_FLOOR_KERNEL = CudaKernel(
    "scans/csrc/gpu_floor.cu", "gpu_floor_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                             ctypes.c_void_p],
    extra_flags=("-fmad=false",))

# kernel J: the relaxed recursion's forward and its adjoint, one library
RELAXED_FLAGS = ("-fmad=false",)
RELAXED_FORWARD = CudaKernel(
    "scans/csrc/gpu_floor_relaxed.cu", "gpu_floor_relaxed_forward",
    [ctypes.c_void_p] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2
    + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_void_p] * 3,
    extra_flags=RELAXED_FLAGS)
RELAXED_ADJOINT = CudaKernel(
    "scans/csrc/gpu_floor_relaxed.cu", "gpu_floor_relaxed_adjoint",
    [ctypes.c_void_p] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 5
    + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_void_p] * 2,
    extra_flags=RELAXED_FLAGS, name="gpu_floor_relaxed_adjoint")
# the forward's recurrences, in the order of its merge statistics
RELAXED_CHAINS = ("idle", "o")

# column order of the per-row parameter matrix the kernels read
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


def gpu_floor_relaxed_plain(w: torch.Tensor, params: torch.Tensor,
                            tau: float, tdp: float) -> torch.Tensor:
    """Kernel J's plain version: the reference's relaxed step in torch ops
    over the rows, a Python loop over the samples of ``w`` ``[B, n]``, with
    ``params`` ``[B, 6]`` in ``PARAM_COLUMNS`` order; autograd gives its
    gradient.  Maxima and minima are ``torch.maximum``/``minimum``, which
    split a tie's gradient in halves, as JAX does.  Each sample takes its
    own copy of ``params`` (``per_sample``), so their gradients are summed
    in float64, as the kernel sums them."""
    outs = []
    # one unbind: a select a sample would make autograd add a zero
    # [B, n] gradient for each of them
    cols = w.unbind(-1)
    o = cols[0]
    idle = torch.zeros_like(o)
    for p, prm in zip(cols, per_sample(params, len(cols))):
        mpf, thresh, ru, rd, stop_n, cap = prm.unbind(-1)
        active = sigmoid_gate(p - thresh, tau, tdp)
        idle = (1.0 - active) * (idle + 1.0)
        floor = mpf * sigmoid_gate(stop_n - idle, tau, stop_n + 1.0)
        target = smooth_max(p, floor, tau, tdp)
        target = -smooth_max(-target, -cap, tau, tdp)
        o = torch.minimum(torch.maximum(target, o - rd), o + ru)
        outs.append(o)
    return torch.stack(outs, dim=-1)


class _GpuFloorRelaxed(torch.autograd.Function):
    """Kernel J on the card: the forward kernel keeps the idle counter's
    trace, from which the adjoint kernel recomputes every step."""

    @staticmethod
    def forward(ctx, w, params, tau, tdp):
        B, n = w.shape
        out = torch.empty_like(w)
        idle = torch.empty_like(w)
        T = float(tau * tdp)
        RELAXED_FORWARD.launch(ptr(w), ptr(params), float(tau), T, ptr(out),
                               ptr(idle), B, n,
                               ptr(chain_scratch(B, n, w.device)), None,
                               stream_of(w))
        ctx.save_for_backward(w, params, out, idle)
        ctx.tau, ctx.T = float(tau), T
        return out

    @staticmethod
    def backward(ctx, g_out):
        w, params, out, idle = ctx.saved_tensors
        B, n = w.shape
        g_out = g_out.to(torch.float32).contiguous()
        g_w = torch.empty_like(w)
        g_p = torch.empty_like(params)
        RELAXED_ADJOINT.launch(ptr(w), ptr(params), ctx.tau, ctx.T, ptr(out),
                               ptr(idle), ptr(g_out), ptr(g_w), ptr(g_p), B,
                               n, ptr(chain_scratch(B, n, w.device)),
                               stream_of(w))
        return g_w, g_p, None, None


def gpu_floor_relaxed_merges(w: torch.Tensor, params: torch.Tensor,
                             tau: float, tdp: float
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel J's forward on CUDA tensors ``w`` ``[B, n]`` and ``params``
    ``[B, 6]`` (as ``gpu_floor_relaxed`` takes them), with its merge
    statistics: ``(out [B, n], stats [B, chunks, 2, 3])``, for each chunk
    and recurrence (``RELAXED_CHAINS``) the segments walked again once
    the chunk's start came in, those among them that did not merge, and
    the steps they walked.  A diagnostic: it counts a launch
    of the forward like any call."""
    B, n = w.shape
    w = w.contiguous()
    params = params.to(torch.float32).contiguous()
    out, idle = torch.empty_like(w), torch.empty_like(w)
    stats = torch.zeros((B, chain_chunks(n), len(RELAXED_CHAINS), 3),
                        dtype=torch.int32, device=w.device)
    RELAXED_FORWARD.launch(ptr(w), ptr(params), float(tau),
                           float(tau * tdp), ptr(out), ptr(idle), B, n,
                           ptr(chain_scratch(B, n, w.device)), ptr(stats),
                           stream_of(w))
    return out, stats


def gpu_floor_relaxed(w: torch.Tensor, params: torch.Tensor, tau: float,
                      tdp: float) -> torch.Tensor:
    """The relaxed smoothed chip power ``[B, n]`` of ``w`` ``[B, n]`` (f32)
    with per-row ``params`` ``[B, 6]`` (f32, ``PARAM_COLUMNS`` order), at
    temperature ``tau``: kernel J (differentiable in ``w`` and ``params``)
    on a CUDA tensor, its plain version on a CPU tensor."""
    B, n = w.shape
    if w.dtype != torch.float32 or params.shape != (B, len(PARAM_COLUMNS)):
        raise ValueError("gpu_floor_relaxed: w must be f32 [B, n], params "
                         f"[B, {len(PARAM_COLUMNS)}]")
    if w.device.type == "cpu":
        return gpu_floor_relaxed_plain(w, params.to(torch.float32), tau, tdp)
    if w.device.type != "cuda" or params.device != w.device:
        raise ValueError("gpu_floor_relaxed: w and params must share one "
                         "CUDA device")
    return _GpuFloorRelaxed.apply(w.contiguous(),
                                  params.to(torch.float32).contiguous(),
                                  float(tau), float(tdp))


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
        # a tensor field (the design's iterate) is projected by its caller
        if (not isinstance(self.mpf_frac, torch.Tensor)
                and self.mpf_frac > self.hw.chip.mpf_max + 1e-9):
            raise ValueError(
                f"GB200 feature caps MPF at {self.hw.chip.mpf_max:.0%} TDP")

    @classmethod
    def apply_batch(cls, mits: Sequence["GpuPowerSmoothing"],
                    w: torch.Tensor, dt: float
                    ) -> Tuple[torch.Tensor, Dict]:
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
        tau = mits[0].smooth_tau
        out = (gpu_floor_relaxed(w, params, tau, tdp) if tau
               else gpu_floor_scan(w, params))
        return out, {"energy_overhead": energy_overhead(w, out),
                     "floor_w": mpf}
