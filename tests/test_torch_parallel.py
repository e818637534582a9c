"""The scenario mesh in one process (``repro_torch.parallel``): the shard
plan's arithmetic against the reference's ``ScenarioShardPlan`` with the
rank faked on both sides, a Study sharded over two CPU devices equal to an
unsharded one bit for bit (two lengths, ``padding="pad"`` and
``"bucket"``, keyed rows, one-shot and chunked), ``simulate_batch(plan=)``
row by row, the int8 quantization bit for bit against JAX's and the
compressed all-reduce at world size 1 against the reference's case, the
host merge's one-process branches, and ``restore_pytree(shardings=)``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_parallel.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.parallel import collectives as ref_coll  # noqa: E402
from repro.parallel import sharding as ref_sharding  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.ckpt import (CheckpointManager, restore_pytree,  # noqa: E402
                              save_pytree)
from repro_torch.core import engine  # noqa: E402
from repro_torch.parallel import collectives, distributed  # noqa: E402
from repro_torch.parallel.sharding import ScenarioShardPlan  # noqa: E402
from test_torch_stream_resume import (_mixed_study,  # noqa: E402
                                      assert_columns_equal)


# ---------------------------------------------------------------------------
# the plan's arithmetic against the reference's
# ---------------------------------------------------------------------------

class _FakeDevice:
    def __init__(self, process_index):
        self.process_index = process_index


class _FakeMesh:
    def __init__(self, devices):
        self.devices = np.asarray(devices, dtype=object)


def _plans(procs, per_proc):
    n = procs * per_proc
    ref = ref_sharding.ScenarioShardPlan(_FakeMesh(
        [_FakeDevice(i // per_proc) for i in range(n)]))
    port = ScenarioShardPlan(tuple(torch.device("cpu") for _ in range(n)),
                             tuple(i // per_proc for i in range(n)))
    return ref, port


@pytest.mark.parametrize("per_proc", [1, 2])
@pytest.mark.parametrize("procs", [1, 2, 3, 4])
def test_pad_and_local_rows_match_the_reference(monkeypatch, procs,
                                                per_proc):
    ref, port = _plans(procs, per_proc)
    assert (port.n_shards, port.n_processes) == (ref.n_shards,
                                                 ref.n_processes)
    for rank in range(procs):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        monkeypatch.setattr(distributed, "process_index", lambda r=rank: r)
        for B in range(1, 71):
            assert port.pad_rows(B) == ref.pad_rows(B)
            padded = B + ref.pad_rows(B)
            assert port.local_rows(padded) == ref.local_rows(padded)
            shards, got = port.local_shards(B)
            assert got == padded
            rows = port.local_rows(padded)
            assert [s for _, s in shards][0].start == rows.start
            assert [s for _, s in shards][-1].stop == rows.stop
            assert len(shards) == per_proc


def test_shards_of_every_rank_tile_the_padded_batch(monkeypatch):
    _, port = _plans(3, 2)
    for B in (1, 5, 6, 7, 64):
        seen = []
        for rank in range(3):
            monkeypatch.setattr(distributed, "process_index",
                                lambda r=rank: r)
            shards, padded = port.local_shards(B)
            seen += [i for _, s in shards for i in range(padded)[s]]
        assert seen == list(range(padded))


def test_plan_rejects_a_bad_layout():
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="in order"):
        ScenarioShardPlan((cpu, cpu), (1, 0))
    with pytest.raises(ValueError, match="as many devices"):
        ScenarioShardPlan((cpu, cpu, cpu), (0, 0, 1))
    with pytest.raises(ValueError, match="one rank a device"):
        ScenarioShardPlan((cpu,), (0, 0))


def test_shard_batch_pads_with_the_last_row_and_places_each_shard():
    plan = ScenarioShardPlan.make(["cpu"] * 4)
    x = np.arange(10.0).reshape(5, 2)
    tree = {"x": x, "t": torch.arange(5), "none": None}
    shards, padded = plan.shard_batch(tree, 5)
    assert padded == 8 and len(shards) == 4
    got = torch.cat([t["x"] for _, t in shards]).numpy()
    want = np.concatenate([x, np.repeat(x[-1:], 3, axis=0)])
    assert np.array_equal(got, want)
    assert torch.equal(torch.cat([t["t"] for _, t in shards]),
                       torch.tensor([0, 1, 2, 3, 4, 4, 4, 4]))
    assert all(t["none"] is None and isinstance(t["x"], torch.Tensor)
               and t["x"].device == d for d, t in shards)


def test_make_without_a_card_raises_unless_cpu_is_given(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScenarioShardPlan.make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.distributed_plan()
    plan = distributed.distributed_plan(device="cpu")
    assert plan.devices == (torch.device("cpu"),) and plan.ranks == (0,)


# ---------------------------------------------------------------------------
# a Study over two CPU devices equals the unsharded Study
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed():
    study = _mixed_study()
    return study, {p: study.run(padding=p) for p in ("pad", "bucket")}


@pytest.mark.parametrize("padding", ["pad", "bucket"])
@pytest.mark.parametrize("stream", [None, 3, 7])
def test_study_on_two_devices_equals_one(mixed, padding, stream):
    study, base = mixed
    sharded = _mixed_study()
    sharded.plan = ScenarioShardPlan.make(["cpu", "cpu"])
    seen = []
    got = sharded.run(padding=padding, stream=stream,
                      on_chunk=lambda d, t, e: seen.append((d, t)))
    assert_columns_equal(got, base[padding])
    assert seen[-1] == (study.n_rows, study.n_rows)


def test_three_shards_pad_every_chunk(mixed):
    """Chunks of 5 rows on 3 shards: every chunk padded by one row, the
    last chunk's tail and a shard of padding only included."""
    study, base = mixed
    sharded = _mixed_study()
    sharded.plan = ScenarioShardPlan.make(["cpu"] * 3)
    assert_columns_equal(sharded.run(padding="pad", stream=5), base["pad"])
    sharded.plan = ScenarioShardPlan.make(["cpu"] * 8)
    assert_columns_equal(sharded.run(padding="pad", stream=3), base["pad"])


def test_shard_devices_means_the_default_plan(mixed, monkeypatch):
    study, base = mixed
    monkeypatch.setattr(engine, "scenario_plan",
                        lambda: ScenarioShardPlan.make(["cpu", "cpu"]))
    sharded = _mixed_study()
    sharded.shard_devices = True
    assert_columns_equal(sharded.run(padding="pad", stream=4), base["pad"])


def test_shard_devices_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    study = api.Study({"w": api.synthetic_timeline(1.0)}, fleets=[64],
                      wave_cfg=api.WaveformConfig(dt=0.01, steps=2),
                      device="cpu", shard_devices=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        study.run()


def test_a_plan_of_another_device_type_raises():
    study = api.Study({"w": api.synthetic_timeline(1.0)}, fleets=[64],
                      wave_cfg=api.WaveformConfig(dt=0.01, steps=2),
                      device="cpu",
                      plan=ScenarioShardPlan((torch.device("meta"),), (0,)))
    with pytest.raises(ValueError, match="device type"):
        study.run()


def _batch_args():
    cfg = api.WaveformConfig(dt=0.01, steps=3, jitter_s=0.02)
    gpu = api.GpuPowerSmoothing(mpf_frac=0.75, ramp_up_w_per_s=2000,
                                ramp_down_w_per_s=2000)
    ff = api.Firefly(telemetry=api.TelemetrySource(
        period_s=0.02, latency_s=0.02, noise_w=20.0))
    bat = api.RackBattery(capacity_j=4e4, max_discharge_w=4e4,
                          max_charge_w=4e4)
    tl = [api.synthetic_timeline(1.0, 0.3),
          api.synthetic_timeline(1.5, 0.3, moe_notch=True)] * 3
    return dict(timelines=tl, n_chips=[64, 128, 64, 64, 128, 64],
                wave_cfg=cfg, seeds=[0, 1, 2, 0, 1, 2],
                device_mitigation=[None, gpu, gpu, None, gpu, None],
                rack_mitigation=[bat, None, bat, bat, None, None],
                keys=[0, 1, 2, 3, 4, 5], pad_to=500, spectra=False,
                device="cpu"), ff


@pytest.mark.parametrize("n_shards", [2, 4])
def test_simulate_batch_on_a_plan_equals_one_device(n_shards):
    kw, _ = _batch_args()
    base = engine.simulate_batch(**kw)
    got = engine.simulate_batch(
        **kw, plan=ScenarioShardPlan.make(["cpu"] * n_shards))
    for k in ("dc_raw", "dc_mitigated", "n_valid", "energy_overhead",
              "chip_raw", "chip_mitigated", "dev_on", "rack_on"):
        assert torch.equal(getattr(got, k), getattr(base, k)), k
    for k in ("swing", "swing_mitigated"):
        for m in base.swing:
            assert torch.equal(getattr(got, k)[m], getattr(base, k)[m])
    for i in range(len(base)):
        a, b = got.scenario(i), base.scenario(i)
        assert np.array_equal(a.dc_mitigated, b.dc_mitigated)
        assert a.aux.keys() == b.aux.keys()
        for stage in a.aux:
            for k, v in b.aux[stage].items():
                assert np.array_equal(a.aux[stage][k], v), (stage, k)


def test_simulate_batch_on_a_plan_without_pad_to_needs_one_length():
    kw, _ = _batch_args()
    kw.pop("pad_to")
    with pytest.raises(ValueError, match="pad_to"):
        engine.simulate_batch(**kw, plan=ScenarioShardPlan.make(["cpu"]))


# ---------------------------------------------------------------------------
# the int8 quantization and the compressed all-reduce
# ---------------------------------------------------------------------------

def _seeded(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


@pytest.mark.parametrize("shape", [(512,), (1, 512), (3, 100), (7,),
                                   (4, 256, 3)])
def test_quantize_roundtrip_is_jax_bit_for_bit(shape):
    for seed, scale in ((0, 1.0), (1, 1e-3), (2, 3e4)):
        x = _seeded(shape, seed, scale)
        got = collectives.quantize_roundtrip(torch.from_numpy(x)).numpy()
        want = np.asarray(ref_coll.quantize_roundtrip(jnp.asarray(x)))
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_quantize_rounds_half_to_even_as_jax():
    """A block whose largest magnitude is 127 has scale 1: every x.5
    lands on a tie, which both round to even."""
    x = np.zeros(256, np.float32)
    x[0] = 127.0
    x[1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -3.5]
    q, s = collectives._quantize_int8(torch.from_numpy(x))
    qj, sj = ref_coll._quantize_int8(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(qj))
    assert np.array_equal(s.numpy(), np.asarray(sj))
    assert q.numpy()[0, 1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, -4]
    assert np.array_equal(collectives._dequantize_int8(q, s).numpy(),
                          np.asarray(ref_coll._dequantize_int8(qj, sj)))


@pytest.mark.parametrize("n", [1, 255, 256, 257, 10 ** 6])
def test_compressed_bytes_match_the_reference(n):
    assert collectives.compressed_bytes(n) == ref_coll.compressed_bytes(n)


def test_compressed_allreduce_single_process_matches_the_reference():
    """The reference's ``test_parallel.py`` case at world size 1, and the
    port's outputs equal to the reference's under ``vmap`` bit for bit."""
    x = _seeded((1, 512), 0)

    def ref_run(x, err):
        return jax.vmap(lambda a, e: ref_coll.compressed_allreduce_mean(
            a, e, "i"), axis_name="i")(x, err)

    xt = torch.from_numpy(x)
    mean, err = collectives.compressed_allreduce_mean(
        xt, torch.zeros_like(xt))
    np.testing.assert_allclose((mean + err).numpy(), x, rtol=1e-5, atol=1e-5)
    mean2, err2 = collectives.compressed_allreduce_mean(xt, err)
    np.testing.assert_allclose(mean2.numpy(), x, atol=6e-2)
    avg = (mean.numpy() + mean2.numpy()) / 2
    assert np.abs(avg - x).mean() <= np.abs(mean.numpy() - x).mean() + 1e-6
    rm, re = ref_run(jnp.asarray(x), jnp.zeros_like(jnp.asarray(x)))
    rm2, re2 = ref_run(jnp.asarray(x), re)
    for a, b in ((mean, rm), (err, re), (mean2, rm2), (err2, re2)):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_compressed_allreduce_keeps_shape_and_dtype():
    x = torch.from_numpy(_seeded((3, 100), 4)).double()
    mean, err = collectives.compressed_allreduce_mean(x, torch.zeros_like(x))
    assert mean.shape == x.shape and mean.dtype == torch.float64
    assert err.shape == x.shape and err.dtype == torch.float64


# ---------------------------------------------------------------------------
# the host merge in one process, after the reference's test_distributed.py
# ---------------------------------------------------------------------------

def test_host_allgather_single_process_is_plain_host_pull():
    tree = {"a": np.arange(6.0), "b": {"c": torch.ones((4, 2))}, "n": None}
    out = collectives.host_allgather(tree, None)
    assert np.array_equal(out["a"], tree["a"])
    assert isinstance(out["b"]["c"], np.ndarray)
    plan = ScenarioShardPlan.make(["cpu"])
    out2 = collectives.host_allgather(tree, plan, take=3)
    assert np.array_equal(out2["a"], tree["a"][:3])
    assert np.array_equal(out2["b"]["c"], np.ones((3, 2)))
    assert out2["n"] is None


def test_gather_rows_matches_numpy():
    x = np.arange(24.0).reshape(6, 4)
    got = collectives.gather_rows(x, [4, 0, 2], None, length=3)
    assert np.array_equal(got, x[[4, 0, 2]][:, :3])
    got2 = collectives.gather_rows(torch.from_numpy(x), [1, 1],
                                   ScenarioShardPlan.make(["cpu"]))
    assert np.array_equal(got2.numpy(), x[[1, 1]])


def test_concat_trees_keeps_row_order_and_scalars():
    a = {"x": np.arange(2), "s": np.float32(3), "o": np.array([{}], object)}
    b = {"x": np.arange(2, 5), "s": np.float32(4), "o": np.array([{1: 2}],
                                                                 object)}
    out = collectives.concat_trees([a, b])
    assert out["x"].tolist() == [0, 1, 2, 3, 4]
    assert out["s"] == 3 and out["o"].tolist() == [{}, {1: 2}]


# ---------------------------------------------------------------------------
# restore onto another device layout
# ---------------------------------------------------------------------------

def test_restore_pytree_places_each_leaf_on_its_device(tmp_path):
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "layers": [np.ones(4), np.zeros(2, np.int64)],
            "names": np.array(["a", ("b", "c")], dtype=object)}
    d = str(tmp_path / "ckpt")
    save_pytree(d, tree, step=3)
    shardings = {"w": torch.device("cpu"), "layers": ["cpu", None],
                 "names": None}
    got, manifest = restore_pytree(d, tree, shardings=shardings)
    assert manifest["step"] == 3
    assert torch.equal(got["w"], torch.from_numpy(tree["w"]))
    assert got["w"].device == torch.device("cpu")
    assert all(isinstance(t, torch.Tensor) for t in got["layers"])
    assert isinstance(got["names"], np.ndarray)
    assert list(got["names"]) == list(tree["names"])
    with pytest.raises(KeyError, match="missing"):
        restore_pytree(d, tree, shardings={"missing": "cpu"})
    meta = {"w": torch.device("meta"), "layers": [None, None],
            "names": None}
    placed, _ = restore_pytree(d, tree, shardings=meta)
    assert placed["w"].device.type == "meta"
    assert placed["layers"][0].device == torch.device("cpu")


def test_checkpoint_manager_restores_latest_onto_devices(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "mgr"), keep=2)
    for step in (1, 2):
        mgr.save(step, {"p": torch.full((3,), float(step))})
    got, manifest = mgr.restore_latest({"p": 0}, shardings={"p": "cpu"})
    assert manifest["step"] == 2
    assert torch.equal(got["p"], torch.full((3,), 2.0, dtype=torch.float32))


# ---------------------------------------------------------------------------
# a row's analysis does not depend on its batch (what shards change)
# ---------------------------------------------------------------------------

def test_row_aligned_keeps_values_and_aligns_rows():
    x = torch.arange(3 * 7, dtype=torch.float32).reshape(3, 7)
    from repro_torch.core.spectrum import row_aligned
    y = row_aligned(x)
    assert torch.equal(y, x) and y.stride(0) % 4 == 0
    z = torch.zeros(2, 8)
    assert row_aligned(z) is z


@pytest.mark.parametrize("n", [1500, 1501, 1875, 3001])
def test_spectrum_matches_numpy_for_odd_and_even_lengths(n):
    from repro_torch.core.spectrum import spectrum
    x = _seeded((3, n), n, 1e4) + 5e5
    freqs, mag = spectrum(torch.from_numpy(x), 0.002)
    x64 = x.astype(np.float64)
    xac = (x64 - x64.mean(-1, keepdims=True)) * np.hanning(n)
    want = np.abs(np.fft.rfft(xac, axis=-1)) * 2.0 / n
    assert mag.shape == want.shape
    assert np.array_equal(freqs, np.fft.rfftfreq(n, 0.002))
    # float32 input and transform against float64 numpy
    np.testing.assert_allclose(mag.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("n", [1500, 1501, 3001])
def test_a_rows_analysis_does_not_depend_on_its_batch(n):
    """A row analysed at several places in a 32-row batch of other rows
    gives the same bits each time (bands and every spec metric)."""
    spec = api.example_specs(job_mw=0.05)["moderate"]
    x0 = torch.from_numpy(_seeded((n,), 7, 2e3) + 4e4)
    ref = None
    for p, seed in ((0, 1), (1, 2), (2, 3), (3, 4), (5, 5), (31, 6)):
        X = torch.from_numpy(_seeded((32, n), seed, 2e3) + 4e4)
        X[p] = x0
        out = engine.analyze_batch(X, 0.002, spec)
        row = {k: v[p] for k, v in out["bands_mitigated"].items()}
        row.update({k: v[p] for k, v in out["spec_metrics"].items()})
        if ref is None:
            ref = row
        assert all(torch.equal(row[k], ref[k]) for k in ref), p
