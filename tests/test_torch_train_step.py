"""The port's train step against the reference's on the CPU.

From one state (the reference's ``init_train_state`` carried over by
``convert.train_state_from_reference``), the port's ``make_train_step``
and the reference's jitted step take 3 steps on the same ``SyntheticLM``
batches (4 x 32), on reduced granite-3-8b, dbrx-132b and
deepseek-v2-lite-16b in f32, with ``remat="full"`` on both sides.  After
each step: ``loss`` and ``grad_norm`` within 1e-5 relative, ``lr`` and
``step`` equal; after steps 1 and 3, the params: every element within
2 x the summed learning rates (Adam's first steps move an element whose
gradient is near ``eps`` by about ``lr``, so two correct runs may differ
there by up to 2 lr a step) and 99.9% of them within 1e-5.  Also the
optimizer: ``lr_schedule`` equal to the reference's bit for bit for
steps 0-99, and the set of weight-decayed leaves equal for the three
archs (the reference's substring mask).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.train import init_train_state as jinit  # noqa: E402
from repro.train import make_train_step as jmake  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import train_state_from_reference  # noqa: E402
from repro_torch.train import make_train_step, optimizer  # noqa: E402

ARCHS = ["granite-3-8b", "dbrx-132b", "deepseek-v2-lite-16b"]
KW = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10)
METRIC_RTOL = 1e-5
PARAM_Q999 = 1e-5


def _by_path(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", None))]
    return tree


def _param_gaps(jparams, tparams):
    out = []
    for path, a in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        got = _by_path(tparams, path).numpy()
        out.append(np.abs(got - np.asarray(a)).ravel())
    return np.concatenate(out)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_the_references(arch):
    jc = jcfgs.reduced(jcfgs.get_config(arch))
    tc = tcfgs.reduced(tcfgs.get_config(arch))
    js = jinit(jax.random.PRNGKey(0), jc, jcfgs.TrainConfig(**KW))
    ts = train_state_from_reference(jax.tree.map(np.asarray, js),
                                    device="cpu")
    assert int(ts.step) == 0 and ts.step.dtype == torch.int32
    jstep = jax.jit(jmake(jc, jcfgs.TrainConfig(**KW)))
    tstep = make_train_step(tc, tcfgs.TrainConfig(**KW))
    data = JSyntheticLM(jc, batch=4, seq=32, seed=0)
    lr_sum = 0.0
    for i in range(3):
        batch = data(i)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tstep(ts, batch)
        for k in ("loss", "grad_norm"):
            ref = float(jm[k])
            assert abs(tm[k].item() - ref) <= METRIC_RTOL * abs(ref), (i, k)
        assert tm["lr"].item() == float(jm["lr"])
        assert int(ts.step) == int(js.step) == i + 1
        lr_sum += float(jm["lr"])
        if i in (0, 2):
            gap = _param_gaps(js.params, ts.params)
            assert gap.max() <= 2 * lr_sum, (i, gap.max())
            assert np.quantile(gap, 0.999) <= PARAM_Q999, i
    assert set(tm) == {"ce", "moe_aux", "loss", "grad_norm", "lr"}


def test_lr_schedule_equals_the_references():
    for kw in (dict(learning_rate=1e-3, warmup_steps=10, total_steps=100),
               dict(learning_rate=3e-4, warmup_steps=2, total_steps=8),
               dict(learning_rate=1e-2, warmup_steps=0, total_steps=60)):
        jt, tt = jcfgs.TrainConfig(**kw), tcfgs.TrainConfig(**kw)
        ref = np.array([np.float32(jopt.lr_schedule(jnp.asarray(s), jt))
                        for s in range(100)])
        got = np.array([optimizer.lr_schedule(torch.tensor(
            s, dtype=torch.int32), tt).item() for s in range(100)],
            np.float32)
        np.testing.assert_array_equal(got, ref)
        lr = optimizer.lr_schedule(3, tt)
        assert lr.dtype == torch.float32 and lr.dim() == 0


def test_cosf_is_the_references_cos():
    """The schedule's cosine, the C library's ``cosf``, is what the
    reference's float32 ``jnp.cos`` computes on the CPU, bit for bit."""
    x = np.random.default_rng(5).uniform(0, 4, 4000).astype(np.float32)
    ref = np.asarray(jnp.cos(jnp.asarray(x)))
    got = np.array([optimizer._cosf(v) for v in x], np.float32)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_equals_the_references(arch):
    """The leaves that weight decay reaches: by the last name of a leaf's
    path, with the reference's substring test (``w_gate``, ``w_out``,
    ``router``, ``wuk`` and ``wuv`` are exempt besides the norms)."""
    jc = jcfgs.reduced(jcfgs.get_config(arch))
    jp = jax.eval_shape(lambda k: jinit(k, jc, jcfgs.TrainConfig()),
                        jax.random.PRNGKey(0)).params
    ref = {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
           for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]
           if jopt._decay_mask(tuple(
               str(getattr(k, "key", getattr(k, "idx", k))) for k in path))}
    tc = tcfgs.reduced(tcfgs.get_config(arch))
    from repro_torch.models import init_params
    tp = init_params(0, tc, device="cpu")
    got = {p for p in optimizer._paths(tp) if optimizer._decay_mask(p)}
    assert got == ref
    names = {p[-1] for p in got}
    assert not names & {"w_gate", "w_out", "router", "wuk", "wuv",
                        "norm1", "norm2", "final_norm", "kv_norm"}
    assert {"emb", "lm_head", "wq", "wo", "w_in"} <= names
