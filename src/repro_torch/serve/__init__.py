"""Serving (reference: ``repro/serve``): batched serving of the model zoo
(``ServeEngine``), and the power-compliance service with its learned
warm start (``serve/power.py``, ``serve/warmstart.py``)."""
from repro_torch.serve.engine import ServeEngine, make_serve_step

_POWER = ("PowerComplianceService", "default_catalog")
_WARMSTART = ("WarmStartPredictor", "train_warmstart", "extract_features",
              "init_warmstart", "warmstart_forward", "FEATURE_NAMES")

__all__ = ["ServeEngine", "make_serve_step", *_POWER, *_WARMSTART]


def __getattr__(name):
    # lazy, as in the reference: `python -m repro_torch.serve.power` then
    # imports the module once, and the model serving engine imports
    # without the compliance stack
    if name in _POWER:
        from repro_torch.serve import power
        return getattr(power, name)
    if name in _WARMSTART:
        from repro_torch.serve import warmstart
        return getattr(warmstart, name)
    raise AttributeError(name)
