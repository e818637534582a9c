"""The learned warm start of the compliance service's design fallback
(reference: ``repro/serve/warmstart.py``).

A small MLP maps a query's spectral fingerprint (the grid-critical
Goertzel bin amplitudes, swing, trace length, fleet size and the spec's
normalized thresholds; ``extract_features``) to design seeds ``(mpf_frac,
capacity_j, target_tau_s)``.  ``engine.design(method="warmstart",
warmstart=predictor)`` expands a seed into a ladder of candidates that
are judged under the hard semantics, so an answer is still exact.

The model: features and a ones column -> a dense embed -> a residual GELU
block (``models/mlp.py``) -> a dense head; a few thousand parameters,
trained by ``train.trainer.make_regression_train_step`` on scale-free
targets (MPF as a fraction of the chip's cap, capacity in units of ``2 s *
swing``, tau in units of 30 s), so one checkpoint serves any job power.
Checkpoints use ``ckpt/checkpoint.py`` with the reference's leaf paths
and manifest (the model's meta under ``extra``): each package reads the
other's.  The predictor runs eagerly on the device of its params.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import restore_pytree, save_pytree
from repro_torch.core.hardware import DEFAULT_HW
from repro_torch.core.optim import adam_init, tree_map
from repro_torch.core.spec import UtilitySpec
from repro_torch.core.spectrum import GRID_CRITICAL_HZ, goertzel_bin_amplitudes
from repro_torch.device import resolve_device
from repro_torch.models.layers import dense_init
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.train.trainer import make_regression_train_step

# capacity targets are in units of (CAP_PERIOD_S * swing), the engine's
# default cap_scale at its 2 s period hint; tau targets in units of the
# battery's default horizon
CAP_PERIOD_S = 2.0
TAU_SCALE_S = 30.0

FEATURE_NAMES: Tuple[str, ...] = (
    "log10_n_chips", "log10_mean_w", "swing_frac", "trace_s",
    *(f"goertzel_{f:g}hz_frac" for f in GRID_CRITICAL_HZ),
    "dominant_critical_hz",
    "ramp_up_frac_per_s", "ramp_down_frac_per_s", "dynamic_range_frac",
    "max_energy_fraction", "log10_min_ac_rms_frac",
)
N_FEATURES = len(FEATURE_NAMES)
N_TARGETS = 3   # (mpf_frac / mpf_max, cap_j / (2 s * swing), tau_s / 30 s)

# the features the predictor reads back to denormalize capacity:
# swing_w = swing_frac * 10**log10_mean_w
_F_LOG_MEAN = FEATURE_NAMES.index("log10_mean_w")
_F_SWING_FRAC = FEATURE_NAMES.index("swing_frac")


def extract_features(spec: UtilitySpec, w: np.ndarray, dt: float,
                     n_chips: int) -> np.ndarray:
    """The ``[N_FEATURES]`` float32 fingerprint of one (waveform, fleet,
    spec) query, computed in float64 numpy as the reference computes it.
    Waveform terms and spec thresholds are divided by the mean draw, so
    the same workload at 10 MW and at 100 MW maps to the same point."""
    w = np.asarray(w, np.float64)
    mean = max(float(w.mean()), 1e-9)
    swing = float(w.max() - w.min())
    amps = goertzel_bin_amplitudes(w, dt) / mean
    dom = float(GRID_CRITICAL_HZ[int(np.argmax(amps))])
    feats = [
        np.log10(max(float(n_chips), 1.0)),
        np.log10(mean),
        swing / mean,
        len(w) * dt,
        *amps.tolist(),
        dom,
        spec.time.ramp_up_w_per_s / mean,
        spec.time.ramp_down_w_per_s / mean,
        spec.time.dynamic_range_w / mean,
        spec.freq.max_energy_fraction,
        np.log10(max(spec.freq.min_ac_rms_frac, 1e-12)),
    ]
    return np.asarray(feats, np.float32)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def init_warmstart(gen: torch.Generator, *, n_features: int = N_FEATURES,
                   d_model: int = 32, d_ff: int = 64,
                   n_targets: int = N_TARGETS,
                   dtype=torch.float32) -> Dict:
    """Params drawn from ``gen`` on its device: the embed takes
    ``n_features + 1`` inputs, the last a constant one (the dense layers
    have no bias, and the ones column gives the net one)."""
    return {"w_embed": dense_init(gen, n_features + 1, d_model, dtype),
            "mlp": init_mlp(gen, d_model, d_ff, "gelu", dtype),
            "w_head": dense_init(gen, d_model, n_targets, dtype)}


def warmstart_forward(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """``[B, F]`` normalized features -> ``[B, T]`` normalized targets."""
    ones = torch.ones((*x.shape[:-1], 1), dtype=x.dtype, device=x.device)
    h = torch.cat([x, ones], dim=-1) @ params["w_embed"]
    h = h + mlp_forward(params["mlp"], h, "gelu")
    return h @ params["w_head"]


def _forward_normalized(norm: Dict, params: Dict, x: torch.Tensor
                        ) -> torch.Tensor:
    return warmstart_forward(params, (x - norm["mean"]) / norm["std"])


class WarmStartPredictor:
    """The trained model, its feature normalization and its meta.

    ``predictor(spec, w, dt, n_chips, features=None)`` returns
    ``[(mpf_frac, capacity_j, target_tau_s)]`` in physical units (the
    engine's predictor protocol), so an instance serves as
    ``design(method="warmstart", warmstart=predictor)`` and as
    ``PowerComplianceService(warmstart=...)``.
    """

    def __init__(self, params: Dict, norm: Dict, meta: Dict):
        self.params = params
        self.norm = norm
        self.meta = dict(meta)

    @property
    def device(self) -> torch.device:
        return self.params["w_embed"].device

    # -- inference ----------------------------------------------------------

    def predict_normalized(self, features: np.ndarray) -> np.ndarray:
        """``[B, F]`` raw features -> ``[B, T]`` scale-free targets."""
        x = np.atleast_2d(np.asarray(features, np.float32))
        with torch.no_grad():
            out = _forward_normalized(
                self.norm, self.params,
                torch.as_tensor(x, device=self.device))
        return out.cpu().numpy()

    def __call__(self, spec: UtilitySpec, w: np.ndarray, dt: float,
                 n_chips: int, features: Optional[np.ndarray] = None
                 ) -> List[Tuple[float, float, float]]:
        f = (extract_features(spec, w, dt, n_chips)
             if features is None else np.asarray(features, np.float32))
        out = self.predict_normalized(f)[0]
        swing = float(f[_F_SWING_FRAC]) * 10.0 ** float(f[_F_LOG_MEAN])
        mpf_max = float(self.meta.get("mpf_max", DEFAULT_HW.chip.mpf_max))
        mpf = float(np.clip(out[0], 0.0, 1.0)) * mpf_max
        cap = max(float(out[1]), 0.0) * CAP_PERIOD_S * swing
        # tau clamped to a sane controller range: [1/6, 4] x 30 s
        tau = float(np.clip(out[2], 1.0 / 6.0, 4.0)) * TAU_SCALE_S
        return [(mpf, cap, tau)]

    # -- persistence (ckpt/checkpoint.py) -----------------------------------

    def save(self, directory: str, step: int = 0) -> str:
        return save_pytree(directory,
                           {"params": self.params, "norm": self.norm},
                           step, extra=self.meta)

    @classmethod
    def load(cls, directory: str, device=None) -> "WarmStartPredictor":
        """A saved predictor (the port's or the reference's), on
        ``device`` (None: the card)."""
        dev = resolve_device(device)
        with open(os.path.join(directory, "manifest.json")) as fh:
            meta = json.load(fh)["extra"]
        template = {
            "params": init_warmstart(
                torch.Generator().manual_seed(0),
                n_features=int(meta["n_features"]),
                d_model=int(meta["d_model"]), d_ff=int(meta["d_ff"]),
                n_targets=int(meta.get("n_targets", N_TARGETS))),
            "norm": {"mean": None, "std": None},
        }
        tree, manifest = restore_pytree(directory, template)
        tree = tree_map(lambda t: t.to(dev), tree)
        return cls(tree["params"], tree["norm"], manifest["extra"])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def normalize_targets(targets: np.ndarray, swings: np.ndarray,
                      mpf_max: float) -> np.ndarray:
    """Physical (mpf_frac, capacity_j, tau_s) ``[N, 3]`` -> scale-free."""
    t = np.asarray(targets, np.float64)
    s = np.maximum(np.asarray(swings, np.float64), 1e-9)
    return np.stack([t[:, 0] / max(mpf_max, 1e-9),
                     t[:, 1] / (CAP_PERIOD_S * s),
                     t[:, 2] / TAU_SCALE_S], axis=1).astype(np.float32)


def swings_from_features(features: np.ndarray) -> np.ndarray:
    """Each sample's raw swing (watts) from its feature row."""
    f = np.atleast_2d(np.asarray(features, np.float64))
    return f[:, _F_SWING_FRAC] * 10.0 ** f[:, _F_LOG_MEAN]


def train_warmstart(features: np.ndarray, targets: np.ndarray, *,
                    mpf_max: float = DEFAULT_HW.chip.mpf_max,
                    d_model: int = 32, d_ff: int = 64,
                    epochs: int = 400, batch_size: int = 64,
                    lr: float = 3e-3, weight_decay: float = 1e-4,
                    seed: int = 0, device=None,
                    ) -> Tuple[WarmStartPredictor, Dict[str, List[float]]]:
    """Fit a ``WarmStartPredictor`` on solved designs, on ``device``
    (None: the card).

    ``features`` ``[N, F]`` from ``extract_features``; ``targets``
    ``[N, 3]`` physical ``(mpf_frac, capacity_j, target_tau_s)``.  Each
    sample's capacity is normalized by the swing its own feature row
    gives.  The params are drawn from a ``torch.Generator`` seeded with
    ``seed`` on the device, and the batches follow the reference's numpy
    permutations of ``seed``.  Returns the predictor and ``{"loss": [the
    mean batch MSE of each epoch]}`` in the normalized target space.
    """
    dev = resolve_device(device)
    x = np.asarray(features, np.float32)
    if x.ndim != 2 or x.shape[1] != N_FEATURES:
        raise ValueError(f"features must be [N, {N_FEATURES}], got {x.shape}")
    y = normalize_targets(targets, swings_from_features(x), mpf_max)
    n = len(x)
    norm = {"mean": torch.as_tensor(x.mean(axis=0), device=dev),
            "std": torch.as_tensor(np.maximum(x.std(axis=0), 1e-6),
                                   device=dev)}
    params = init_warmstart(torch.Generator(device=dev).manual_seed(seed),
                            d_model=d_model, d_ff=d_ff)
    opt = adam_init(params)
    step = make_regression_train_step(
        lambda p, xb: _forward_normalized(norm, p, xb), lr=lr,
        weight_decay=weight_decay, device=dev)
    x_t = torch.as_tensor(x, device=dev)
    y_t = torch.as_tensor(y, device=dev)

    rng = np.random.default_rng(seed)
    batch_size = max(1, min(batch_size, n))
    losses: List[float] = []
    for _ in range(epochs):
        order = torch.as_tensor(rng.permutation(n), device=dev)
        ep = []
        for lo in range(0, n, batch_size):
            sel = order[lo:lo + batch_size]
            params, opt, m = step(params, opt, x_t[sel], y_t[sel])
            ep.append(m["loss"])
        losses.append(float(torch.stack(ep).double().mean()))
    meta = {"n_features": N_FEATURES, "n_targets": N_TARGETS,
            "d_model": d_model, "d_ff": d_ff, "mpf_max": float(mpf_max),
            "cap_period_s": CAP_PERIOD_S, "tau_scale_s": TAU_SCALE_S,
            "n_train": int(n), "final_loss": losses[-1] if losses else None,
            "feature_names": list(FEATURE_NAMES)}
    return WarmStartPredictor(params, norm, meta), {"loss": losses}
