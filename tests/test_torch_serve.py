"""The port's ``ServeEngine`` against the reference's on the CPU, at
``tests/test_serve.py``'s sizes (reduced granite-3-8b, batch 2, prompts of
8, 6 new tokens), the reference's params carried over by
``convert.params_from_reference``: greedy tokens equal, runs
deterministic, the first token equal to teacher forcing.  Temperature
sampling draws from a ``torch.Generator`` where the reference draws from
a JAX key, so the two draw different tokens: it is held to shape, range
and same-generator-same-output only."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import Model, init_cache  # noqa: E402
from repro_torch.serve import ServeEngine, make_serve_step  # noqa: E402

B, L, G = 2, 8, 6


@pytest.fixture(scope="module")
def served():
    jcfg = jreduced(jget_config("granite-3-8b"))
    cfg = reduced(get_config("granite-3-8b"))
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, L)).astype(np.int32)
    ref = JServeEngine(jcfg, jparams, max_seq=L + G + 1, batch=B).generate(
        prompts, G)
    return cfg, params, prompts, np.asarray(ref)


def test_greedy_tokens_equal_the_references(served):
    cfg, params, prompts, ref = served
    eng = ServeEngine(cfg, params, max_seq=L + G + 1, batch=B, device="cpu")
    out = eng.generate(prompts, G)
    assert out.shape == (B, G) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    # the engine keeps the cache its generation ended with
    assert eng.cache["unit"][0]["k"][:, :, :, L + G - 1].any()
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate(prompts, G + 2)


def test_generate_greedy_deterministic(served):
    cfg, params, prompts, _ = served
    outs = [ServeEngine(cfg, params, max_seq=L + G + 1, batch=B,
                        device="cpu").generate(torch.from_numpy(prompts), G)
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])


def test_generate_matches_teacher_forcing(served):
    cfg, params, prompts, _ = served
    eng = ServeEngine(cfg, params, max_seq=L + 4, batch=B, device="cpu")
    out = eng.generate(prompts, 1)
    x, _ = Model(cfg).forward(params, {"tokens": torch.from_numpy(prompts)})
    first = torch.argmax((x @ params["lm_head"].to(x.dtype))[:, -1], dim=-1)
    assert torch.equal(out[:, 0].long(), first)


def test_serve_step_is_one_decode(served):
    cfg, params, prompts, _ = served
    step = make_serve_step(cfg)
    cache = init_cache(cfg, B, L, torch.float32, "cpu")
    logits, cache = step(params, torch.from_numpy(prompts[:, :1]), cache, 0)
    assert logits.shape == (B, 1, cfg.vocab_size)
    with pytest.raises(NotImplementedError, match="parallel/"):
        make_serve_step(cfg, plan=object())


def test_sampling_temperature(served):
    cfg, params, prompts, _ = served

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        eng = ServeEngine(cfg, params, max_seq=L + 10, batch=B, device="cpu")
        return eng.generate(prompts, 8, temperature=1.5, generator=gen)

    out = draw(7)
    assert out.shape == (B, 8)
    assert 0 <= int(out.min()) and int(out.max()) < cfg.vocab_size
    assert torch.equal(out, draw(7))
    assert not torch.equal(out, draw(8))
