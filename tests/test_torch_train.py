"""The port's training step on the CPU, on its own terms.

Reduced configs in f32 with inputs from numpy seeds:
- microbatches: 4 microbatches against 1 at the reference's own
  tolerance (``tests/test_train.py``: rtol 3e-4, atol 2e-6);
- remat: ``"none"``, ``"dots"`` and ``"full"`` give the same loss,
  gradients and params bit for bit (granite, dbrx, deepseek);
- the reference's overfit test: the loss falls by more than 1.5 in 60
  steps;
- ballast: a step with ``ballast=True`` gives the loss, metrics and
  params of the step without it (``torch.equal``);
- a step leaves its input state as it was, and two runs of one step are
  equal bit for bit;
- checkpoints: a ``TrainState`` saved and restored (sync and async, the
  named tuple rebuilt), and the reference's restart test: 3 steps, save,
  restore into a fresh state, 3 more, losses and params bit for bit the
  uninterrupted run's;
- the unported sharding options raise, naming their queue item.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt import CheckpointManager, restore_pytree, save_pytree  # noqa: E402
from repro_torch.configs import TrainConfig, get_config, reduced  # noqa: E402
from repro_torch.core.optim import tree_leaves, tree_map  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.train import (TrainState, init_train_state,  # noqa: E402
                               make_train_step)
from repro_torch.train import trainer  # noqa: E402

ARCHS = ["granite-3-8b", "dbrx-132b", "deepseek-v2-lite-16b"]


def _cfg(arch="granite-3-8b"):
    return reduced(get_config(arch))


def _batch(cfg, B=8, S=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_microbatches_match_one_batch():
    cfg = _cfg()
    t1 = TrainConfig(learning_rate=1e-2, warmup_steps=5, total_steps=10)
    t4 = dataclasses.replace(t1, microbatches=4)
    s = init_train_state(0, cfg, t1, device="cpu")
    batch = _batch(cfg)
    s1, m1 = make_train_step(cfg, t1)(s, batch)
    s4, m4 = make_train_step(cfg, t4)(s, batch)
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s4.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-4,
                                   atol=2e-6)
    assert abs(m1["loss"].item() - m4["loss"].item()) <= 1e-5 * m1[
        "loss"].item()
    # the reference's microbatch metrics: ce is the mean loss, no aux
    assert torch.equal(m4["ce"], m4["loss"])
    assert m4["moe_aux"].item() == 0.0
    assert int(s4.step) == 1 and s4.opt["count"].item() == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_are_bitwise_equal(arch):
    cfg = _cfg(arch)
    base = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    s = init_train_state(0, cfg, base, device="cpu")
    batch = _batch(cfg, B=4, S=32, seed=1)
    out = {}
    for remat in ("none", "dots", "full"):
        tcfg = dataclasses.replace(base, remat=remat)
        (loss, _), grads = trainer.make_value_and_grad(cfg, tcfg)(
            s.params, {k: torch.from_numpy(v) for k, v in batch.items()})
        state, m = make_train_step(cfg, tcfg)(s, batch)
        out[remat] = (loss, grads, state, m)
    ref = out["none"]
    for remat in ("dots", "full"):
        loss, grads, state, m = out[remat]
        assert torch.equal(loss, ref[0]), remat
        assert _equal_trees(grads, ref[1]), remat
        assert _equal_trees(state.params, ref[2].params), remat
        assert _equal_trees(state.opt, ref[2].opt), remat
        assert all(torch.equal(m[k], ref[3][k]) for k in m), remat
    with pytest.raises(ValueError, match="remat"):
        make_train_step(cfg, dataclasses.replace(base, remat="some"))(
            s, batch)


def test_overfit_tiny_model():
    cfg = _cfg()
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=5, total_steps=60)
    state = init_train_state(0, cfg, tcfg, device="cpu")
    step = make_train_step(cfg, tcfg)
    data = SyntheticLM(cfg, batch=8, seq=32, seed=0)
    losses = []
    for i in range(60):
        state, m = step(state, data(i))
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0] - 1.5, (losses[0], losses[-1])


def test_ballast_leaves_the_step_unchanged(monkeypatch):
    """``ballast=True`` runs the chain in every step (counted here) and
    changes no bit of the loss, the metrics or the state."""
    from repro_torch.core import ballast_inject
    cfg = _cfg()
    t0 = TrainConfig(learning_rate=1e-3, warmup_steps=5, total_steps=10)
    tb = dataclasses.replace(t0, ballast=True, ballast_gflops=0.2)
    s = init_train_state(0, cfg, t0, device="cpu")
    batch = _batch(cfg)
    calls = []
    orig = ballast_inject.ballast_chain

    def counted(*a, **k):
        calls.append(a)
        return orig(*a, **k)

    monkeypatch.setattr(ballast_inject, "ballast_chain", counted)
    s0, m0 = make_train_step(cfg, t0)(s, batch)
    assert not calls
    sb, mb = make_train_step(cfg, tb)(s, batch)
    s4, m4 = make_train_step(cfg, dataclasses.replace(tb, microbatches=4))(
        s, batch)
    assert len(calls) == 1 + 4          # once a microbatch
    assert all(torch.equal(m0[k], mb[k]) for k in m0)
    assert _equal_trees(s0, sb)
    s4b, _ = make_train_step(cfg, dataclasses.replace(t0, microbatches=4))(
        s, batch)
    assert _equal_trees(s4, s4b)


def test_a_step_is_functional_and_repeatable():
    cfg = _cfg("dbrx-132b")
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    s = init_train_state(0, cfg, tcfg, device="cpu")
    before = tree_map(lambda t: t.clone(), s)
    step = make_train_step(cfg, tcfg)
    a, ma = step(s, _batch(cfg))
    b, mb = step(s, _batch(cfg))
    assert _equal_trees(s, before)
    assert _equal_trees(a, b) and all(torch.equal(ma[k], mb[k]) for k in ma)
    assert not _equal_trees(a.params, s.params)


def test_train_state_checkpoints_restore_as_named_tuples(tmp_path):
    cfg = _cfg("deepseek-v2-lite-16b")
    tcfg = TrainConfig(total_steps=10, moment_dtype="bfloat16")
    state, _ = make_train_step(cfg, tcfg)(
        init_train_state(0, cfg, tcfg, device="cpu"), _batch(cfg))
    assert state.opt["m"]["embed"]["emb"].dtype == torch.bfloat16
    d = save_pytree(str(tmp_path / "ck"), state, step=1)
    restored, manifest = restore_pytree(d, state)
    assert isinstance(restored, TrainState) and manifest["step"] == 1
    assert _equal_trees(restored, state)
    assert restored.step.dtype == torch.int32
    mgr = CheckpointManager(str(tmp_path / "async"), keep=2,
                            async_save=True)
    for s in (1, 2, 3):
        mgr.save(s, state)
    mgr.wait()
    assert mgr.steps() == [2, 3]
    again, manifest = mgr.restore_latest(state)
    assert isinstance(again, TrainState) and manifest["step"] == 3
    assert _equal_trees(again, state)


def test_failure_restart_reproduces_training(tmp_path):
    """The reference's restart test: kill at step 3, restore, continue;
    the losses and the final state equal the uninterrupted run's."""
    cfg = _cfg()
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    step = make_train_step(cfg, tcfg)
    data = SyntheticLM(cfg, batch=4, seq=16, seed=0)
    state = init_train_state(0, cfg, tcfg, device="cpu")
    ref_losses = []
    for i in range(6):
        state, m = step(state, data(i))
        ref_losses.append(m["loss"])
    mgr = CheckpointManager(str(tmp_path / "ckpts"), keep=2)
    s2 = init_train_state(0, cfg, tcfg, device="cpu")
    for i in range(3):
        s2, m = step(s2, data(i))
        assert torch.equal(m["loss"], ref_losses[i])
    mgr.save(3, s2)
    del s2
    template = init_train_state(1, cfg, tcfg, device="cpu")
    s3, manifest = mgr.restore_latest(template)
    assert int(s3.step) == 3 and manifest["step"] == 3
    for i in range(3, 6):
        s3, m = step(s3, data(i))
        assert torch.equal(m["loss"], ref_losses[i]), i
    assert _equal_trees(s3, state)


def test_sharding_plans_raise_naming_their_queue_item():
    cfg = _cfg()
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue A, sharding the model"):
        make_train_step(cfg, TrainConfig(), plan=object())
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue A, sharding the model"):
        trainer.in_out_shardings(cfg, object(), None, None)
