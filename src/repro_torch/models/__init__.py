"""The model zoo's dense GQA family (granite-3-8b, minitron-4b) and its
sparse-expert and latent-attention archs (dbrx-132b, deepseek-v2-lite-16b),
ported from the reference's ``repro.models``."""
from repro_torch.models.model import (Ctx, Model, forward, init_cache,
                                      init_params, loss_fn, make_decode_step,
                                      make_prefill)

__all__ = ["Ctx", "Model", "forward", "init_cache", "init_params", "loss_fn",
           "make_decode_step", "make_prefill"]
