"""The checks' hook on the MoE router (``models.moe.forced_routes``):
within it each ``route`` call takes its experts and gates from a given
sequence, so two runs whose routers part on near ties can be held on the
same experts (``chip_smoke.py`` phase 22 re-runs the flash route's decode
on the chunked route's routing).  Reduced dbrx-132b in f32 on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import init_params, make_decode_step  # noqa: E402
from repro_torch.models import init_cache, make_prefill  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import Ctx, _at  # noqa: E402


def _setup():
    cfg = reduced(get_config("dbrx-132b"))
    params = init_params(0, cfg, device="cpu")
    p = _at(params["unit"][0], 0)["ffn"]
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 24, cfg.d_model)).astype(np.float32))
    return cfg, params, p, x


def test_forcing_the_routers_own_routes_changes_nothing():
    cfg, _, p, x = _setup()
    out, aux = moe.moe_forward(p, x, cfg, Ctx(cfg=cfg, dropless=True))
    _, gate, idx = moe.route(x.reshape(-1, cfg.d_model), p["router"],
                             cfg.moe.top_k)
    with moe.forced_routes([(idx, gate)]):
        again, aux2 = moe.moe_forward(p, x, cfg, Ctx(cfg=cfg, dropless=True))
    assert torch.equal(out, again) and torch.equal(aux, aux2)


def test_forced_routes_reach_the_dispatch_and_the_plain_version():
    """Other experts forced on both ``moe_forward`` and its plain version:
    the two agree with each other and differ from the router's own."""
    cfg, _, p, x = _setup()
    k, E = cfg.moe.top_k, cfg.moe.n_experts
    _, gate, idx = moe.route(x.reshape(-1, cfg.d_model), p["router"], k)
    other = (idx + 1) % E
    own, _ = moe.moe_forward(p, x, cfg, Ctx(cfg=cfg, dropless=True))
    with moe.forced_routes([(other, gate)] * 2):
        got, _ = moe.moe_forward(p, x, cfg, Ctx(cfg=cfg, dropless=True))
        ref = moe.moe_forward_ref(p, x, cfg)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * ref.abs().max().item())
    assert not torch.allclose(got, own)
    # the router is its own again outside the hook
    assert torch.equal(moe.moe_forward(p, x, cfg, Ctx(
        cfg=cfg, dropless=True))[0], own)


def test_forced_routes_raise_when_they_do_not_fit():
    cfg, _, p, x = _setup()
    k = cfg.moe.top_k
    xt = x.reshape(-1, cfg.d_model)
    _, gate, idx = moe.route(xt, p["router"], k)
    with pytest.raises(RuntimeError, match="more route calls"):
        with moe.forced_routes([]):
            moe.route(xt, p["router"], k)
    with pytest.raises(ValueError, match="a route of"):
        with moe.forced_routes([(idx[:3], gate[:3])]):
            moe.route(xt, p["router"], k)
    with pytest.raises(RuntimeError, match="does not nest"):
        with moe.forced_routes([]):
            with moe.forced_routes([]):
                pass
    assert moe._FORCED is None


def test_a_decode_rerun_on_recorded_routes_is_bitwise_the_same():
    """The phase-22 use: a decode step's routes recorded, then the step
    re-run from the same cache with them forced gives the same logits."""
    cfg, params, _, _ = _setup()
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 8)))
    cache = init_cache(cfg, 2, 10, torch.float32, "cpu")
    logits, cache = make_prefill(cfg)(params, {"tokens": tokens}, cache)
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    decode = make_decode_step(cfg)
    routes = []
    orig = moe.route

    def record(xt, router, k):
        probs, gate, idx = orig(xt, router, k)
        routes.append((idx.clone(), gate.clone()))
        return probs, gate, idx

    moe.route = record
    try:
        first, cache = decode(params, tok, cache, 8)
    finally:
        moe.route = orig
    assert len(routes) == cfg.n_repeats
    with moe.forced_routes(routes):
        again, _ = decode(params, tok, cache, 8)
    assert torch.equal(first, again)
