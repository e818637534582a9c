"""Batched serving of the model zoo (reference: ``repro/serve``)."""
from repro_torch.serve.engine import ServeEngine, make_serve_step

__all__ = ["ServeEngine", "make_serve_step"]
