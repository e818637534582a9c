"""Rack-level energy storage (paper Sec. IV-C), hard semantics.

The BESS tracks a slowly-moving grid target (EMA of load) by discharging
into compute peaks and recharging in comm valleys (Fig. 7).  Limits
modeled: capacity (J), charge/discharge power (W), one-way efficiency,
and the charge/discharge mode-switch latency.

The per-sample SoC recursion runs as kernel C (``kernels/scans/csrc/
battery.cu``) on a CUDA tensor and as ``battery_scan_plain``, a Python
loop over samples, on a CPU tensor.

``smooth_tau > 0`` selects the design-time relaxation (reference
``_apply_smooth``): the charge/discharge mode is a tanh of the power
mismatch, the latency hold engages in proportion to the mode flip, and the
blocked gate is a sigmoid of the remaining hold; the taper widths are
floored at two power-limit samples of energy, so that the reverse-mode
factor stays bounded as the capacity goes to 0.  It runs as kernel K
(``kernels/scans/csrc/battery_relaxed.cu``: each row cut into chunks of
1024 samples, a warp a chunk, the target, hold and SoC in segmented walks
with an exact merge test, the adjoint in float64 affine scans), a forward
and an adjoint behind one ``torch.autograd.Function``, on a CUDA tensor, and as
``battery_relaxed_plain`` (a Python loop that autograd differentiates) on a
CPU tensor.  ``lat_n`` carries no gradient, as in the reference; the
target's start is ``mean64`` of the trace, so its gradient reaches every
sample by 1/n.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.core.smoothing.base import (energy_overhead, mean64,
                                             stack_params)
from repro_torch.core.smoothing.relax import (chain_chunks, chain_scratch,
                                             per_sample, sigmoid_gate,
                                             soft_sign)
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

# kernel K: the relaxed recursion's forward and its adjoint, one library
RELAXED_FLAGS = ("-fmad=false",)
RELAXED_FORWARD = CudaKernel(
    "scans/csrc/battery_relaxed.cu", "battery_relaxed_forward",
    [ctypes.c_void_p] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 5
    + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_void_p] * 3,
    extra_flags=RELAXED_FLAGS)
RELAXED_ADJOINT = CudaKernel(
    "scans/csrc/battery_relaxed.cu", "battery_relaxed_adjoint",
    [ctypes.c_void_p] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 8
    + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_void_p] * 2,
    extra_flags=RELAXED_FLAGS, name="battery_relaxed_adjoint")
# the forward's recurrences, in the order of its merge statistics
RELAXED_CHAINS = ("target", "hold", "soc")

# column order of the relaxed kernel's per-row parameter matrix
RELAXED_COLUMNS = ("alpha", "lat_n", "cap_j", "w_lo", "w_hi", "max_dis",
                   "max_chg", "eff", "soc0", "tgt0", "p_scale")


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


def battery_relaxed_plain(w: torch.Tensor, params: torch.Tensor, dt: float,
                          tau: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K's plain version: the reference's relaxed step in torch ops
    over the rows, a Python loop over the samples of ``w`` ``[B, n]``, with
    ``params`` ``[B, 11]`` in ``RELAXED_COLUMNS`` order; autograd gives its
    gradient.  Returns ``(grid [B, n], soc [B, n])``.  Every clip is
    ``torch.maximum``/``minimum``, which split a tie's gradient in halves,
    as JAX does (``torch.clamp`` gives all of it to the clipped value).
    Each sample takes its own copy of ``params`` (``per_sample``), so their
    gradients are summed in float64, as the kernel sums them."""
    soc, tgt = params[:, 8], params[:, 9]
    dt = torch.tensor(dt, dtype=torch.float32, device=w.device)
    zero = torch.zeros_like(soc)
    one = torch.ones_like(soc)

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    mode = zero
    hold = zero
    grids, socs = [], []
    # one unbind, not a select a sample
    for p, prm in zip(w.unbind(-1), per_sample(params, w.shape[-1])):
        (alpha, lat_n, cap_j, w_lo, w_hi, max_dis, max_chg, eff, _, _,
         p_scale) = prm.unbind(-1)
        lat_n = lat_n.detach()   # a count of samples: no gradient
        tgt = tgt + alpha * (p - tgt)
        want = p - tgt
        new_mode = soft_sign(want, tau, p_scale)
        switching = clip(-(new_mode * mode), zero, one)
        hold = (switching * lat_n
                + (1.0 - switching) * torch.maximum(hold - 1.0, zero))
        open_f = sigmoid_gate(0.5 - hold, tau, lat_n + 1.0)
        taper_lo = clip(soc / w_lo, zero, one)
        taper_hi = clip((cap_j - soc) / w_hi, zero, one)
        dis = clip(want, zero, max_dis * taper_lo)
        dis = torch.minimum(dis, soc * eff / dt)
        chg = clip(-want, zero, max_chg * taper_hi)
        chg = torch.minimum(chg, (cap_j - soc) / eff / dt)
        dis = open_f * dis
        chg = open_f * chg
        grids.append(p - dis + chg)
        soc = soc - dis * dt / eff + chg * dt * eff
        soc = clip(soc, zero, cap_j)
        socs.append(soc)
        mode = new_mode
    return torch.stack(grids, dim=-1), torch.stack(socs, dim=-1)


class _BatteryRelaxed(torch.autograd.Function):
    """Kernel K on the card: the forward kernel keeps every carry's trace,
    from which the adjoint kernel recomputes every step."""

    @staticmethod
    def forward(ctx, w, params, dt, tau):
        B, n = w.shape
        grid, soc, tgt, mode, hold = (torch.empty_like(w) for _ in range(5))
        RELAXED_FORWARD.launch(ptr(w), ptr(params), float(tau), float(dt),
                               ptr(grid), ptr(soc), ptr(tgt), ptr(mode),
                               ptr(hold), B, n,
                               ptr(chain_scratch(B, n, w.device)), None,
                               stream_of(w))
        ctx.save_for_backward(w, params, soc, tgt, mode, hold)
        ctx.dt, ctx.tau = float(dt), float(tau)
        ctx.set_materialize_grads(False)
        return grid, soc

    @staticmethod
    def backward(ctx, g_grid, g_soc):
        w, params, soc, tgt, mode, hold = ctx.saved_tensors
        B, n = w.shape
        if g_grid is None:
            g_grid = torch.zeros_like(w)
        g_grid = g_grid.to(torch.float32).contiguous()
        if g_soc is not None:
            g_soc = g_soc.to(torch.float32).contiguous()
        g_w = torch.empty_like(w)
        g_p = torch.empty_like(params)
        RELAXED_ADJOINT.launch(
            ptr(w), ptr(params), ctx.tau, ctx.dt, ptr(soc), ptr(tgt),
            ptr(mode), ptr(hold), ptr(g_grid),
            None if g_soc is None else ptr(g_soc), ptr(g_w), ptr(g_p), B,
            n, ptr(chain_scratch(B, n, w.device)), stream_of(w))
        return g_w, g_p, None, None


def battery_relaxed_merges(w: torch.Tensor, params: torch.Tensor,
                           dt: float, tau: float
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Kernel K's forward on CUDA tensors ``w`` ``[B, n]`` and ``params``
    ``[B, 11]`` (as ``battery_relaxed`` takes them), with its merge
    statistics: ``(grid, soc, stats [B, chunks, 3, 3])``, for each chunk
    and recurrence (``RELAXED_CHAINS``) the segments walked again once
    the chunk's start came in, those among them that did not merge, and
    the steps they walked.  A diagnostic: it counts a launch
    of the forward like any call."""
    B, n = w.shape
    w = w.contiguous()
    params = params.to(torch.float32).contiguous()
    grid, soc, tgt, mode, hold = (torch.empty_like(w) for _ in range(5))
    stats = torch.zeros((B, chain_chunks(n), len(RELAXED_CHAINS), 3),
                        dtype=torch.int32, device=w.device)
    RELAXED_FORWARD.launch(ptr(w), ptr(params), float(tau), float(dt),
                           ptr(grid), ptr(soc), ptr(tgt), ptr(mode),
                           ptr(hold), B, n,
                           ptr(chain_scratch(B, n, w.device)), ptr(stats),
                           stream_of(w))
    return grid, soc, stats


def battery_relaxed(w: torch.Tensor, params: torch.Tensor, dt: float,
                    tau: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relaxed grid-side power and SoC ``[B, n]`` behind loads ``w``
    ``[B, n]`` (f32), per-row ``params`` ``[B, 11]`` (f32,
    ``RELAXED_COLUMNS`` order), at temperature ``tau``: kernel K
    (differentiable in ``w`` and ``params``) on a CUDA tensor, its plain
    version on a CPU tensor."""
    B, n = w.shape
    if w.dtype != torch.float32 or params.shape != (B, len(RELAXED_COLUMNS)):
        raise ValueError("battery_relaxed: w must be f32 [B, n], params "
                         f"[B, {len(RELAXED_COLUMNS)}]")
    if w.device.type == "cpu":
        return battery_relaxed_plain(w, params.to(torch.float32), dt, tau)
    if w.device.type != "cuda" or params.device != w.device:
        raise ValueError("battery_relaxed: w and params must share one CUDA "
                         "device")
    return _BatteryRelaxed.apply(w.contiguous(),
                                 params.to(torch.float32).contiguous(),
                                 float(dt), float(tau))


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
            return cls._apply_relaxed(mits, w, dt)
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

    @classmethod
    def _apply_relaxed(cls, mits: Sequence["RackBattery"], w: torch.Tensor,
                       dt: float) -> Tuple[torch.Tensor, Dict]:
        """The relaxed SoC model at temperature ``smooth_tau`` (kernel K),
        its parameter columns built from the fields with torch ops."""
        tau = mits[0].smooth_tau
        w = w.to(torch.float32)
        p = stack_params(mits, cls.PARAMS, w.device)
        dt32 = torch.tensor(dt, dtype=torch.float32, device=w.device)
        max_dis, max_chg = p["max_discharge_w"], p["max_charge_w"]
        eff = p["efficiency"]
        cap_j = torch.maximum(p["capacity_j"], torch.full_like(
            p["capacity_j"], 1e-9))
        # taper widths floored at about two power-limit samples of energy:
        # the hard 0.10 cap width makes the SoC recursion's reverse-mode
        # factor grow without bound as cap -> 0
        w_lo = torch.maximum(0.10 * cap_j, 2.0 * max_dis * dt / eff)
        w_hi = torch.maximum(0.10 * cap_j, 2.0 * max_chg * dt * eff)
        params = torch.stack([
            dt32 / torch.maximum(p["target_tau_s"], dt32),
            torch.round(p["switch_latency_s"] / dt32).detach(),
            cap_j, w_lo, w_hi, max_dis, max_chg, eff,
            p["initial_soc"] * cap_j, mean64(w),
            0.5 * (max_dis + max_chg)], dim=-1)
        grid, soc = battery_relaxed(w, params, dt, tau)
        return grid, {
            "soc_trace": soc,
            "soc_min_frac": soc.amin(-1) / cap_j,
            "soc_max_frac": soc.amax(-1) / cap_j,
            "energy_overhead": energy_overhead(w, grid),
            "peak_reduction_w": w.amax(-1) - grid.amax(-1),
        }
