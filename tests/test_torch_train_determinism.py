"""Repeated runs of the port on the CPU are equal bit for bit, layer by
layer: reduced dbrx-132b (2 repeats, ``chunk_size`` 32) prefilling
B 2 x S 512 (S 2048 in the study below), and its ``loss_fn`` with every
gradient (B 2 x S 64), with and without
``torch.use_deterministic_algorithms(True)``.  The training step's
bitwise restart rests on this.

``python tests/test_torch_train_determinism.py [N]`` repeats each case N
times (default 200) at torch's thread count, the prefill at S 2048, and
prints, per mode, how many runs differed from the first and at which
layer or leaf first.
"""
import contextlib
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import TrainConfig, get_config, reduced  # noqa: E402
from repro_torch.core.optim import tree_leaves  # noqa: E402
from repro_torch.models import init_cache, init_params  # noqa: E402
from repro_torch.models import make_prefill  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.train.trainer import make_value_and_grad  # noqa: E402

B, S_LOSS = 2, 64
S_TEST, S_STUDY = 512, 2048     # the prefill's length


def _cfg():
    cfg = reduced(get_config("dbrx-132b"))
    return dataclasses.replace(cfg, n_repeats=2, attention=dataclasses.replace(
        cfg.attention, chunk_size=32))


@contextlib.contextmanager
def _deterministic(on):
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(on)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _prefill_layers(cfg, params, tokens):
    """Each layer's output and the last logits of one prefill."""
    B, S = tokens.shape
    outs = []
    orig = tmodel.apply_layer

    def rec(spec, p, x, ctx, cache=None):
        out = orig(spec, p, x, ctx, cache=cache)
        outs.append(out[0].clone())
        return out

    tmodel.apply_layer = rec
    try:
        cache = init_cache(cfg, B, S, torch.float32, "cpu")
        logits, _ = make_prefill(cfg)(params, {"tokens": tokens}, cache)
    finally:
        tmodel.apply_layer = orig
    return outs + [logits]


def _loss_leaves(cfg, params, batch):
    (loss, _), grads = make_value_and_grad(cfg, TrainConfig(remat="none"))(
        params, batch)
    return [loss] + tree_leaves(grads)


def _cases(s_prefill):
    cfg = _cfg()
    params = init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (B, s_prefill)))
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                              (B, S_LOSS)).astype(np.int32))
             for k in ("tokens", "labels")}
    return {"prefill": lambda: _prefill_layers(cfg, params, tokens),
            "loss_fn": lambda: _loss_leaves(cfg, params, batch)}


def first_difference(a, b):
    """The index of the first tensor of ``b`` that differs from ``a``'s,
    or None."""
    return next((i for i, (x, y) in enumerate(zip(a, b))
                 if not torch.equal(x, y)), None)


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("case", ["prefill", "loss_fn"])
def test_repeated_runs_are_bitwise_equal(case, deterministic):
    run = _cases(S_TEST)[case]
    with _deterministic(deterministic):
        assert first_difference(run(), run()) is None


def main(n):
    cases = _cases(S_STUDY)
    print(f"torch {torch.__version__}, {torch.get_num_threads()} threads, "
          f"{n} runs a case and mode")
    for deterministic in (False, True):
        with _deterministic(deterministic):
            for name, run in cases.items():
                first = run()
                where = [first_difference(first, run()) for _ in range(n - 1)]
                bad = [w for w in where if w is not None]
                print(f"use_deterministic_algorithms({deterministic}) "
                      f"{name}: {len(bad)} of {n - 1} runs differ from the "
                      f"first ({len(first)} tensors compared a run)"
                      + (f"; first at tensor {sorted(set(bad))}" if bad
                         else ""), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 200)
