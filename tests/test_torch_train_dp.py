"""The port's int8 error-feedback data-parallel train step on the CPU.

- World size 1: ``make_dp_compressed_train_step`` without a process group
  against the reference's on a one-device mesh, 2 steps from one state
  (reduced granite-3-8b, f32, ``SyntheticLM`` 4 x 32): loss and grad norm
  within 1e-5 relative, lr equal, the params within the Adam bound of
  ``tests/test_torch_train_step.py``, and the residuals: 99.9% of each
  leaf's within 1e-3 of its max |residual|, every one within an int8 step
  (a gradient's rounding may carry a value across a quantization level).
- World size 2: two gloo processes on the CPU through
  ``parallel.distributed.launch_workers`` take the same 2 steps on the
  same global batches; both ranks' params and residuals are equal bit for
  bit, and equal to a one-process emulation: each half's gradients
  quantized with its own residual, the two dequantized payloads summed and
  divided by 2, then clipping and AdamW; the loss is the ranks' mean.
"""
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch.mesh import make_debug_mesh  # noqa: E402
from repro.train import init_train_state as jinit  # noqa: E402
from repro.train.trainer import (  # noqa: E402
    make_dp_compressed_train_step as jmake_dp)
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import train_state_from_reference  # noqa: E402
from repro_torch.core.optim import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.parallel import collectives, distributed  # noqa: E402
from repro_torch.train import init_train_state, trainer  # noqa: E402

KW = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10)
B, S, STEPS = 4, 32, 2
LAUNCH_TIMEOUT = 300
ERR_Q999 = 1e-3


def _by_path(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", None))]
    return tree


def test_world_size_one_matches_the_reference():
    jc = jcfgs.reduced(jcfgs.get_config("granite-3-8b"))
    tc = tcfgs.reduced(tcfgs.get_config("granite-3-8b"))
    js = jinit(jax.random.PRNGKey(0), jc, jcfgs.TrainConfig(**KW))
    ts = train_state_from_reference(jax.tree.map(np.asarray, js),
                                    device="cpu")
    jstep, jinit_err = jmake_dp(jc, jcfgs.TrainConfig(**KW),
                                make_debug_mesh(1, 1))
    tstep, tinit_err = trainer.make_dp_compressed_train_step(
        tc, tcfgs.TrainConfig(**KW))
    jerr, terr = jinit_err(js.params), tinit_err(ts.params)
    data = JSyntheticLM(jc, batch=B, seq=S, seed=0)
    lr_sum = 0.0
    for i in range(STEPS):
        batch = data(i)
        js, jerr, jm = jax.jit(jstep)(
            js, jerr, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, terr, tm = tstep(ts, terr, batch)
        for k in ("loss", "grad_norm"):
            assert abs(tm[k].item() - float(jm[k])) <= 1e-5 * abs(
                float(jm[k])), (i, k)
        assert tm["lr"].item() == float(jm["lr"])
        lr_sum += float(jm["lr"])
    for path, e in jax.tree_util.tree_flatten_with_path(jerr)[0]:
        e = np.asarray(e)
        got = _by_path(terr, path)
        assert got.dtype == torch.float32
        # a residual is at most half an int8 step of its block; where a
        # gradient's rounding moves a value across a step, the two sides'
        # residuals differ by one step
        gap, top = np.abs(got.numpy() - e), np.abs(e).max()
        assert gap.max() <= 2.01 * top, path
        assert np.quantile(gap, 0.999) <= ERR_Q999 * top, path
    gaps = np.concatenate([
        np.abs(_by_path(ts.params, path).numpy() - np.asarray(p)).ravel()
        for path, p in jax.tree_util.tree_flatten_with_path(js.params)[0]])
    assert gaps.max() <= 2 * lr_sum and np.quantile(gaps, 0.999) <= 1e-5


WORKER = """
import json, sys
import numpy as np
import torch
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.data import SyntheticLM
from repro_torch.parallel import distributed as D
from repro_torch.train import init_train_state, trainer

out_dir = sys.argv[1]
assert D.initialize(device="cpu"), "REPRO_DIST_* contract missing"
rank = D.process_index()
cfg = reduced(get_config("granite-3-8b"))
tcfg = TrainConfig(**%(kw)r)
state = init_train_state(0, cfg, tcfg, device="cpu")
step, init_err = trainer.make_dp_compressed_train_step(cfg, tcfg)
err = init_err(state.params)
data = SyntheticLM(cfg, batch=%(B)d, seq=%(S)d, seed=0)
losses = []
for i in range(%(steps)d):
    state, err, m = step(state, err, data(i))
    losses.append(m["loss"].item())
leaves = trainer.tree_leaves((state.params, err))
np.savez(out_dir + "/rank_%%d.npz" %% rank,
         *[t.numpy() for t in leaves])
with open(out_dir + "/rank_%%d.json" %% rank, "w") as fh:
    json.dump({"losses": losses, "world": D.process_count()}, fh)
D.shutdown()
print("TRAIN_DP_WORKER_OK", rank, flush=True)
""" % {"kw": KW, "B": B, "S": S, "steps": STEPS}


def _emulate(cfg, tcfg, data, world=2):
    """One process: each rank's rows' gradients, quantized with its own
    residual, summed and halved; clip and AdamW; the ranks' mean loss."""
    state = init_train_state(0, cfg, tcfg, device="cpu")
    grad_fn = trainer.make_value_and_grad(cfg, tcfg)
    n_leaves = len(tree_leaves(state.params))
    errs = [[torch.zeros_like(p) for p in tree_leaves(state.params)]
            for _ in range(world)]
    losses = []
    for i in range(STEPS):
        lr = trainer.lr_schedule(state.step, tcfg)
        batch = {k: torch.from_numpy(v) for k, v in data(i).items()}
        per = B // world
        payloads, loss_sum = [], None
        for r in range(world):
            (loss, _), g = grad_fn(state.params, {
                k: v[r * per:(r + 1) * per] for k, v in batch.items()})
            loss_sum = loss if loss_sum is None else loss_sum + loss
            deq = []
            for j, x in enumerate(tree_leaves(g)):
                flat = collectives._flat_padded(x + errs[r][j])
                q, s = collectives._quantize_int8(flat)
                d = collectives._dequantize_int8(q, s)
                errs[r][j] = (flat - d)[:x.numel()].reshape(x.shape)
                deq.append(d)
            payloads.append(deq)
        mean = [((payloads[0][j] + payloads[1][j]) / 2.0)[
            :p.numel()].reshape(p.shape)
            for j, p in enumerate(tree_leaves(state.params))]
        assert len(mean) == n_leaves
        state, _ = trainer._apply(state, tree_unflatten(state.params, mean),
                                  tcfg, lr)
        losses.append((loss_sum / world).item())
    return state, errs, losses


def test_two_gloo_processes_equal_each_other_and_the_emulation(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    done = distributed.launch_workers([sys.executable, str(script),
                                       str(tmp_path)], num_processes=2,
                                      timeout=LAUNCH_TIMEOUT)
    assert all("TRAIN_DP_WORKER_OK" in r.stdout for r in done)
    ranks = [np.load(tmp_path / f"rank_{r}.npz") for r in range(2)]
    reports = [json.loads((tmp_path / f"rank_{r}.json").read_text())
               for r in range(2)]
    assert [r["world"] for r in reports] == [2, 2]
    a, b = ([z[f"arr_{i}"] for i in range(len(z.files))] for z in ranks)
    n = len(a) // 2                      # params, then the residuals
    assert all(np.array_equal(x, y) for x, y in zip(a[:n], b[:n]))
    assert not all(np.array_equal(x, y) for x, y in zip(a[n:], b[n:]))
    assert reports[0]["losses"] == reports[1]["losses"]

    cfg = tcfgs.reduced(tcfgs.get_config("granite-3-8b"))
    tcfg = tcfgs.TrainConfig(**KW)
    state, errs, losses = _emulate(cfg, tcfg,
                                   SyntheticLM(cfg, batch=B, seq=S, seed=0))
    params = [t.numpy() for t in tree_leaves(state.params)]
    assert len(params) == n
    assert all(np.array_equal(x, y) for x, y in zip(a[:n], params))
    # each rank keeps its own residual
    for got, want in ((a, errs[0]), (b, errs[1])):
        assert all(np.array_equal(x, y.numpy())
                   for x, y in zip(got[n:], want))
    assert np.allclose(losses, reports[0]["losses"], rtol=1e-6, atol=0)
    single = init_train_state(0, cfg, tcfg, device="cpu")
    assert not np.array_equal(params[0], tree_leaves(single.params)[0])
