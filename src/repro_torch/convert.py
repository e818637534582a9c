"""Build the port's configuration objects from plain field dicts.

``from_reference_fields(kind, fields)`` takes the numbers, strings,
tuples and numpy arrays of one object, as ``dataclasses.asdict`` gives
them for the reference package's dataclasses (nested dataclasses as
nested dicts), and returns the port's object of that kind.  A ``Stack``
is ``{"stages": [(kind, fields), ...]}``; a ``Firefly``'s ``telemetry``
and ``hw`` and a ``CombinedMitigation``'s ``gpu`` and ``battery`` are
nested field dicts.  Nothing of the reference package is imported: the
dicts are the interface.

``key_from_reference(words)`` takes a JAX key's two uint32 words
(``np.asarray(jax.random.key_data(key))``) and returns the port's key.

``from_reference_carry(carry, n_bins=K)`` carries a stream's state
across: it takes the reference's ``SlidingCarry`` or ``MonitorCarry``
(its arrays as numpy, or anything ``np.asarray`` reads) and returns the
port's, so a stream started in the reference resumes in the port.

``params_from_reference(tree)`` carries a model's params across: the
reference's params pytree, its leaves as numpy arrays, becomes the
port's dict of tensors with the same structure and values (the MoE FFN's
f32 ``router`` and ``[E, d_in, d_out]`` experts with ``shared``, MLA's
``wq``, ``wdkv``, ``wkr``, ``kv_norm``, ``wuk``, ``wuv``, ``wo``, and the
``prefix`` list included).  A decode cache tree (``k``/``v``, or MLA's
``ckv``/``krope``) goes across the same way.

``train_state_from_reference(state)`` carries a training state across:
the reference's ``TrainState`` (params, the optimizer's ``m``, ``v`` and
``count``, and ``step``, as numpy arrays) becomes the port's, so both
packages can take steps from one state.

``predictor_from_reference(pred)`` carries a trained warm-start
predictor across: the reference's ``params``, ``norm`` and ``meta`` become
the port's ``WarmStartPredictor``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.core.hardware import (ChipSpec, DatacenterTopology, Hardware,
                                       ServerSpec)
from repro_torch.core.phases import IterationTimeline, Phase
from repro_torch.core import prng
from repro_torch.core.smoothing import (CombinedMitigation, Firefly,
                                        GpuPowerSmoothing, RackBattery, Stack,
                                        TelemetryBackstop)
from repro_torch.core.spec import (FrequencyDomainSpec, TimeDomainSpec,
                                   UtilitySpec)
from repro_torch.core.telemetry import TelemetrySource
from repro_torch.core.waveform import WaveformConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.goertzel.ops import MonitorCarry, SlidingCarry

KINDS = ("WaveformConfig", "IterationTimeline", "Phase", "Hardware",
         "UtilitySpec", "GpuPowerSmoothing", "RackBattery",
         "TelemetryBackstop", "Stack", "TelemetrySource", "Firefly",
         "CombinedMitigation")


def _plain(v):
    """numpy scalars and arrays -> Python numbers and tuples."""
    if isinstance(v, np.ndarray):
        return tuple(_plain(x) for x in v.tolist())
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (list, tuple)):
        return tuple(_plain(x) for x in v)
    return v


def _fields(d: Mapping[str, Any]) -> Dict[str, Any]:
    return {k: _plain(v) for k, v in d.items()}


def _hardware(d: Mapping) -> Hardware:
    return Hardware(chip=ChipSpec(**_fields(d["chip"])),
                    server=ServerSpec(**_fields(d["server"])),
                    topo=DatacenterTopology(**_fields(d["topo"])))


def _phase(d: Mapping) -> Phase:
    return Phase(**_fields(d))


def from_reference_fields(kind: str, fields: Mapping[str, Any]):
    """The port's ``kind`` object from a plain field dict."""
    if kind == "Phase":
        return _phase(fields)
    if kind == "IterationTimeline":
        return IterationTimeline(tuple(_phase(p) for p in fields["phases"]))
    if kind == "WaveformConfig":
        f = _fields({k: v for k, v in fields.items() if k != "ckpt_phase"})
        ck = fields.get("ckpt_phase")
        return WaveformConfig(**f, ckpt_phase=None if ck is None
                              else _phase(ck))
    if kind == "Hardware":
        return _hardware(fields)
    if kind == "UtilitySpec":
        return UtilitySpec(name=fields["name"],
                           time=TimeDomainSpec(**_fields(fields["time"])),
                           freq=FrequencyDomainSpec(**_fields(fields["freq"])))
    if kind == "GpuPowerSmoothing":
        f = _fields({k: v for k, v in fields.items() if k != "hw"})
        return GpuPowerSmoothing(**f, hw=_hardware(fields["hw"]))
    if kind == "RackBattery":
        return RackBattery(**_fields(fields))
    if kind == "TelemetryBackstop":
        return TelemetryBackstop(**_fields(fields))
    if kind == "Stack":
        return Stack(tuple(from_reference_fields(k, f)
                           for k, f in fields["stages"]))
    if kind == "TelemetrySource":
        return TelemetrySource(**_fields(fields))
    if kind == "Firefly":
        f = _fields({k: v for k, v in fields.items()
                     if k not in ("telemetry", "hw")})
        return Firefly(**f, telemetry=TelemetrySource(
            **_fields(fields["telemetry"])), hw=_hardware(fields["hw"]))
    if kind == "CombinedMitigation":
        return CombinedMitigation(
            gpu=from_reference_fields("GpuPowerSmoothing", fields["gpu"]),
            battery=from_reference_fields("RackBattery", fields["battery"]),
            n_chips=_plain(fields["n_chips"]))
    raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")


def key_from_reference(words) -> torch.Tensor:
    """The port's key (int64 ``[..., 2]`` on the CPU) from a JAX key's
    uint32 words ``[..., 2]`` (``jax.random.key_data``, as numpy)."""
    return prng.as_key(np.asarray(words, np.uint32))


def _sliding_carry(c, n_bins: int, device) -> SlidingCarry:
    def table(t):
        # the reference pads K up to a multiple of 8 rows; rows >= K are 0
        return torch.tensor(np.asarray(t, np.float32)[:n_bins][None],
                            device=device)
    return SlidingCarry(
        offset=int(c.offset), fill=int(c.fill),
        seg=torch.tensor(np.asarray(c.seg, np.float32)[None], device=device),
        prev_re=table(c.prev_re), prev_im=table(c.prev_im),
        mean=float(c.mean))


def from_reference_carry(carry, *, n_bins: int, device=None
                         ) -> Union[SlidingCarry, MonitorCarry]:
    """The port's carry from the reference's ``SlidingCarry`` (fields
    ``offset, fill, seg [win], prev_re/prev_im [KP, win], mean``) or
    ``MonitorCarry`` (``sliding`` and the escalation tuple ``esc`` of four
    scalars).  The ``[KP, win]`` tables become ``[1, K, win]`` with
    ``K = n_bins``; ``esc`` becomes the ``[1, 4]`` int64 carry.  The
    reference holds its mean as a float32 value: subtracted in float64
    from a float32 sample near it, it centres exactly as the reference's
    float32 subtraction does.  ``device=None`` means the card."""
    dev = resolve_device(device)
    if hasattr(carry, "sliding"):
        esc = torch.tensor([[int(np.asarray(v)) for v in carry.esc]],
                           dtype=torch.int64, device=dev)
        return MonitorCarry(sliding=_sliding_carry(carry.sliding, n_bins,
                                                   dev), esc=esc)
    return _sliding_carry(carry, n_bins, dev)


def _leaf_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX gives it
        t = torch.from_numpy(np.array(a).view(np.uint16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_reference(tree, device=None):
    """The port's model params from the reference's params pytree, its
    leaves as numpy arrays (``jax.tree.map(np.asarray, params)``).  The
    tree keeps its structure (dicts, the ``prefix`` list, the ``unit``
    tuple with its stacked ``[n_repeats, ...]`` leaves, ``wq [d, H, D]``,
    ``wo [H, D, d]``) and every value and dtype: a rename and a copy.
    ``device=None`` means the card."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        if isinstance(t, tuple):
            return tuple(walk(v) for v in t)
        return _leaf_tensor(t, dev)

    return walk(tree)


def train_state_from_reference(state, device=None):
    """The port's ``train.TrainState`` from the reference's: ``state``
    has ``params``, ``opt`` (``{"m", "v", "count"}``) and ``step``, their
    leaves as numpy arrays (``jax.tree.map(np.asarray, state)``).  The
    moments keep their dtype; ``count`` and ``step`` become int32 0-d
    tensors.  ``device=None`` means the card."""
    from repro_torch.train.trainer import TrainState
    dev = resolve_device(device)

    def count(a):
        return torch.tensor(int(np.asarray(a)), dtype=torch.int32,
                            device=dev)

    opt = {"m": params_from_reference(state.opt["m"], dev),
           "v": params_from_reference(state.opt["v"], dev),
           "count": count(state.opt["count"])}
    return TrainState(params_from_reference(state.params, dev), opt,
                      count(state.step))


def predictor_from_reference(pred, device=None):
    """The port's ``WarmStartPredictor`` from the reference's: ``pred``
    has its ``params`` and ``norm`` trees (leaves as numpy arrays, or
    anything ``np.asarray`` reads) and its ``meta`` dict.  ``device=None``
    means the card."""
    from repro_torch.serve.warmstart import WarmStartPredictor

    def host(t):
        if isinstance(t, dict):
            return {k: host(v) for k, v in t.items()}
        return np.asarray(t)

    return WarmStartPredictor(
        params_from_reference(host(pred.params), device),
        params_from_reference(host(pred.norm), device), dict(pred.meta))
