"""Rules of the port: it imports neither JAX nor the reference package,
it never runs on the CPU unless asked to, and ``convert.py`` carries
every configuration dataclass of the slice across unchanged."""
import ast
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core  # noqa: E402
from repro.core.phases import CKPT, Phase  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.convert import from_reference_fields  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 15
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    bad = [(p.relative_to(ROOT).as_posix(), m)
           for p in _port_files() for m in _imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_rules_cover_the_control_slice():
    """The walk that the import rule reads reaches the control slice and
    the modules of kernels G, H and I."""
    files = _port_files()
    for module in ("control/loop.py", "kernels/goertzel/sliding.py",
                   "device.py", "kernels/ballast/ballast.py",
                   "kernels/ballast/ops.py", "kernels/goertzel/windows.py",
                   "kernels/goertzel/sliding_v1.py"):
        assert ROOT / "src" / "repro_torch" / module in files


def test_build_registers_all_nine_kernels():
    """Once the API and the modules of F, G, H, I, L and M are imported
    (as ``chip_smoke.py`` imports them), ``launch_counts`` names every
    kernel A-I, L and M, kernel A's adjoint and both entry points of J and
    K (forward and adjoint, one source each): sixteen counts over fourteen
    sources."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ballast import ballast  # noqa: F401
    from repro_torch.kernels.flash import flash  # noqa: F401
    from repro_torch.kernels.goertzel import sliding_v1, windows  # noqa: F401
    from repro_torch.kernels.scans import selective_scan, wkv6  # noqa: F401
    counts = build.launch_counts()
    assert set(counts) == {"monitor", "gpu_floor", "battery", "escalation",
                           "sliding", "flash_fwd", "ballast", "windows",
                           "sliding_v1", "gpu_floor_relaxed",
                           "gpu_floor_relaxed_adjoint", "battery_relaxed",
                           "battery_relaxed_adjoint", "monitor_adjoint",
                           "selective_scan", "wkv6"}
    sources = [k.source for k in build.KERNELS]
    assert len(sources) == 16 and len(set(sources)) == 14
    assert all(p.exists() for p in sources)
    # the two entry points of one source share one library
    by_source = {}
    for k in build.KERNELS:
        by_source.setdefault(k.source, set()).add(k.library_path())
    assert all(len(v) == 1 for v in by_source.values())


def _scan_operands(name, device="cpu", grad=False):
    """Tiny operands of kernel L (``selective_scan``) or M (``wkv6``)."""
    gen = torch.Generator().manual_seed(0)

    def t(*shape, sign=1.0):
        x = (sign * torch.rand(shape, generator=gen)).to(device)
        return x.requires_grad_(grad) if grad else x
    if name == "selective_scan":
        return t(1, 3, 8), t(1, 3, 8), t(1, 3, 4), t(1, 3, 4), \
            t(8, 4, sign=-1.0), t(1, 8, 4)
    return t(1, 3, 2, 4), t(1, 3, 2, 4), t(1, 3, 2, 4), t(1, 3, 2, 4), \
        t(2, 4), t(1, 2, 4, 4)


@pytest.mark.parametrize("name", ["selective_scan", "wkv6"])
def test_scan_kernels_take_the_plain_version_only_on_a_cpu_tensor(
        name, monkeypatch):
    """Kernels L and M: a CPU tensor runs the plain version and never
    reaches ``CudaKernel.launch`` (the plain version's gradient flows); a
    tensor on any other device than the card's raises; on a device other
    than the CPU, inputs that require a gradient raise
    ``NotImplementedError`` naming the kernel's missing backward, before
    any launch (the meta device stands in for the card here;
    ``chip_smoke.py`` checks the card itself)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.scans import selective_scan, wkv6
    fn, plain = ((selective_scan.selective_scan,
                  selective_scan.selective_scan_plain)
                 if name == "selective_scan" else (wkv6.wkv6,
                                                   wkv6.wkv6_plain))

    def refuse(self, *args):
        raise AssertionError(f"{self.name} launched on a CPU tensor")
    monkeypatch.setattr(build.CudaKernel, "launch", refuse)
    ops = _scan_operands(name, grad=True)
    out, last = fn(*ops)
    ref = plain(*ops)
    assert torch.equal(out, ref[0]) and torch.equal(last, ref[1])
    (out.sum() + last.sum()).backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in ops)
    with pytest.raises(NotImplementedError, match=(
            "backward of the (selective scan|wkv) kernel .* not ported")):
        fn(*_scan_operands(name, "meta", grad=True))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(*_scan_operands(name, "meta"))


# kernels G, H and I and their entry points: reached only through their
# own modules, as in the reference
LATE_KERNEL_MODULES = ("repro_torch.kernels.ballast",
                       "repro_torch.kernels.goertzel.windows",
                       "repro_torch.kernels.goertzel.sliding_v1")
LATE_KERNEL_NAMES = ("bin_power", "phase_tables_v1", "goertzel_coef",
                     "goertzel_windows", "sliding_goertzel_v1",
                     "ballast_burn", "ballast")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from ((a.name, None) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield from ((node.module, a.name) for a in node.names)


@pytest.mark.parametrize("package", ["core", "control", "serve", "models"])
def test_no_path_of_the_port_reaches_kernels_g_h_i(package):
    """No Study, control, serving or model module imports kernel G, H or I
    or their entry points: the reference's paths never call them."""
    files = sorted((ROOT / "src" / "repro_torch" / package).rglob("*.py"))
    assert files
    bad = [(p.relative_to(ROOT).as_posix(), m, name)
           for p in files for m, name in _imports(p)
           if m.startswith(LATE_KERNEL_MODULES)
           or (m.startswith("repro_torch.kernels") and name
               in LATE_KERNEL_NAMES)
           or (m == "repro_torch.kernels.goertzel" and name in (
               "windows", "sliding_v1"))
           or (m == "repro_torch.kernels" and name == "ballast")]
    assert not bad, bad


def test_study_without_a_card_raises_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    study = api.Study({"w": api.synthetic_timeline(1.0)}, fleets=[64],
                      wave_cfg=api.WaveformConfig(dt=0.01, steps=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        study.run()
    with pytest.raises(RuntimeError):
        api.Study({"w": api.synthetic_timeline(1.0)}, device="cuda",
                  wave_cfg=api.WaveformConfig(dt=0.01, steps=2)).run()
    res = api.Study({"w": api.synthetic_timeline(1.0)}, fleets=[64],
                    wave_cfg=api.WaveformConfig(dt=0.01, steps=2),
                    device="cpu").run()
    assert len(res) == 1


def _model_entry(name, device):
    """Call one model-zoo entry point at a tiny size on ``device``."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_reference
    from repro_torch.kernels.flash.ops import flash_sdpa
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine
    cfg = reduced(get_config("granite-3-8b"))
    if name == "init_params":
        return init_params(0, cfg, device=device)
    if name == "ServeEngine":
        params = init_params(0, cfg, device="cpu")
        return ServeEngine(cfg, params, max_seq=8, batch=1, device=device)
    if name == "params_from_reference":
        return params_from_reference({"w": np.ones((2, 3), np.float32)},
                                     device=device)
    q = torch.zeros((1, 4, 1, 2, 8), device=device)
    kv = torch.zeros((1, 4, 1, 8), device=device)
    return flash_sdpa(q, kv, kv)


@pytest.mark.parametrize("name", ["init_params", "ServeEngine",
                                  "params_from_reference", "flash_sdpa"])
def test_model_entry_points_without_a_card_raise_unless_cpu_is_asked(
        monkeypatch, name):
    """``device=None`` means the card: without CUDA the entry points raise.
    ``flash_sdpa`` takes its device from its tensors; on anything but a
    CPU tensor it launches kernel F or raises (here: ``meta``), never the
    plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if name == "flash_sdpa":
        with pytest.raises(ValueError, match="no kernel for meta"):
            _model_entry(name, "meta")
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _model_entry(name, None)
    assert _model_entry(name, "cpu") is not None


def test_unported_options_raise(tmp_path):
    """Model sharding still raises, naming its queue item by title; the
    scenario mesh (``Study(plan=)``, ``restore_pytree(shardings=)``),
    ``Study.optimize`` and a relaxed (``smooth_tau > 0``) Study, which
    raised before their slices were ported, run."""
    from repro_torch.configs import get_config
    from repro_torch.serve import make_serve_step
    with pytest.raises(NotImplementedError, match="ROADMAP queue A"):
        make_serve_step(get_config("granite-3-8b"), plan=object())
    with pytest.raises(NotImplementedError, match="ROADMAP queue A"):
        get_config("qwen1.5-110b")
    plan = api.ScenarioShardPlan.make(["cpu", "cpu"])
    sharded = api.Study({"w": api.synthetic_timeline(1.0)}, device="cpu",
                        wave_cfg=api.WaveformConfig(dt=0.01, steps=2),
                        plan=plan)
    assert len(sharded.run()) == 1
    from repro_torch.ckpt import restore_pytree, save_pytree
    save_pytree(str(tmp_path / "ckpt"), {"a": np.ones(2)}, step=0)
    tree, _ = restore_pytree(str(tmp_path / "ckpt"), {"a": 0},
                             shardings={"a": "cpu"})
    assert tree["a"].device == torch.device("cpu")
    study = api.Study({"w": api.synthetic_timeline(1.0)}, device="cpu",
                      wave_cfg=api.WaveformConfig(dt=0.01, steps=2))
    assert len(study.optimize()) == 0          # no spec: no design cell
    relaxed = api.Study({"w": api.synthetic_timeline(1.0)}, device="cpu",
                        wave_cfg=api.WaveformConfig(dt=0.01, steps=2),
                        configs={"g": (api.GpuPowerSmoothing(smooth_tau=0.1),
                                       None)})
    assert len(relaxed.run()) == 1


def test_no_message_names_a_queue_item_by_number():
    """Queue items are named by title ("ROADMAP queue A, the model zoo"):
    the queues are renumbered as items land."""
    pattern = re.compile(r"(queue [A-C][,:]? item \d|item \d+[,)])")
    bad = [(p.relative_to(ROOT).as_posix(), i + 1)
           for p in _port_files()
           for i, line in enumerate(p.read_text().splitlines())
           if pattern.search(line)]
    assert not bad, bad


def test_design_defaults_match_the_reference():
    """``design()`` and ``Study.optimize`` default to the reference's
    solver (``hybrid``); ``design_mitigation`` to its (``grid``)."""
    import inspect
    from repro.core import engine as rengine
    from repro_torch.core import engine
    pairs = [(engine.design, rengine.design),
             (api.Study.optimize, core.Study.optimize),
             (api.design_mitigation, core.design_mitigation),
             (engine.design_gradient, rengine.design_gradient),
             (engine.design_warmstart, rengine.design_warmstart)]
    for port, ref in pairs:
        got = inspect.signature(port).parameters
        want = inspect.signature(ref).parameters
        for name, p in want.items():
            if p.default is inspect.Parameter.empty:
                continue
            a, b = got[name].default, p.default
            if dataclasses.is_dataclass(b):      # DEFAULT_HW, two classes
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (port.__name__, name)
    assert inspect.signature(engine.design).parameters[
        "method"].default == "hybrid"


def test_hard_paths_never_reach_kernels_j_k(monkeypatch):
    """``smooth_tau == 0`` paths (the Study, the serial reference, the
    sweep, the grid design) never reach kernels J and K."""
    from repro_torch.core.smoothing import battery, gpu_floor

    def boom(*_a, **_k):
        raise AssertionError("a smooth_tau == 0 path reached J or K")

    monkeypatch.setattr(gpu_floor, "gpu_floor_relaxed", boom)
    monkeypatch.setattr(battery, "battery_relaxed", boom)
    gpu = api.GpuPowerSmoothing(mpf_frac=0.7)
    bat = api.RackBattery(capacity_j=1e5, max_discharge_w=1e4,
                          max_charge_w=1e4)
    cfg = api.WaveformConfig(dt=0.01, steps=2)
    tl = api.synthetic_timeline(1.0)
    spec = api.example_specs(0.05)["moderate"]
    api.Study({"w": tl}, fleets=[64], configs={"g": (gpu, bat)}, specs=spec,
              wave_cfg=cfg, device="cpu").run()
    api.simulate(tl, 64, cfg, device_mitigation=gpu, rack_mitigation=bat,
                 device="cpu")
    from repro_torch.core.engine import design, sweep
    sweep({"w": tl}, [64], [(gpu, bat)], cfg, device="cpu")
    w = api.simulate(tl, 64, cfg, device="cpu").dc_raw
    design(spec, w, 0.01, 64, method="grid", device="cpu")


@pytest.mark.parametrize("name", ["simulate", "simulate_jit", "sweep",
                                  "design_gradient", "optimize",
                                  "validate_many"])
def test_design_and_serial_entry_points_without_a_card_raise(monkeypatch,
                                                             name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.core import engine
    tl = api.synthetic_timeline(1.0)
    cfg = api.WaveformConfig(dt=0.01, steps=2)
    spec = api.example_specs(0.05)["moderate"]
    w = np.linspace(1e4, 2e4, 200, dtype=np.float32)
    calls = {
        "simulate": lambda d: api.simulate(tl, 64, cfg, device=d),
        "simulate_jit": lambda d: api.simulate_jit(tl, 64, cfg, device=d),
        "sweep": lambda d: engine.sweep({"w": tl}, [64], [(None, None)],
                                        cfg, device=d),
        "design_gradient": lambda d: api.design_gradient(
            spec, w, 0.01, 64, steps=1, device=d),
        "optimize": lambda d: api.Study({"w": tl}, fleets=[64], specs=spec,
                                        wave_cfg=cfg, device=d).optimize(
            method="grid"),
        "validate_many": lambda d: engine.validate_many(w[None], spec, 0.01,
                                                        device=d),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[name](None)
    calls[name]("cpu")


def _reference_objects():
    gpu = core.GpuPowerSmoothing(mpf_frac=0.8, ramp_up_w_per_s=1500.0,
                                 edp_cap_frac=1.05)
    bat = core.RackBattery(capacity_j=3e6, max_discharge_w=2e6,
                           max_charge_w=1e6, switch_latency_s=0.01)
    bs = core.TelemetryBackstop(critical_hz=(0.5, 2.0), window_s=4.0,
                                amp_threshold_w=2.5e5)
    return {
        "WaveformConfig": core.WaveformConfig(
            dt=0.002, steps=7, ckpt_every=3,
            ckpt_phase=Phase("checkpoint", 1.5, CKPT), jitter_s=0.003),
        "IterationTimeline": core.synthetic_timeline(2.0, 0.2,
                                                     moe_notch=True),
        "Hardware": core.Hardware(),
        "UtilitySpec": core.example_specs(12.0)["tight"],
        "GpuPowerSmoothing": gpu, "RackBattery": bat,
        "TelemetryBackstop": bs,
        "TelemetrySource": core.TelemetrySource(period_s=0.004, noise_w=5.0,
                                                averaged=True),
        "Firefly": core.Firefly(engage_frac=0.9, threshold_frac=0.85,
                                telemetry=core.TelemetrySource(
                                    latency_s=0.004, noise_w=20.0),
                                ballast_steps=16),
        "CombinedMitigation": core.CombinedMitigation(gpu, bat, 4096),
    }


@pytest.mark.parametrize("kind", ["WaveformConfig", "IterationTimeline",
                                  "Hardware", "UtilitySpec",
                                  "GpuPowerSmoothing", "RackBattery",
                                  "TelemetryBackstop", "TelemetrySource",
                                  "Firefly", "CombinedMitigation"])
def test_convert_carries_reference_objects_across(kind):
    ref = _reference_objects()[kind]
    fields = dataclasses.asdict(ref)
    port = from_reference_fields(kind, fields)
    assert type(port).__name__ == type(ref).__name__
    assert dataclasses.asdict(port) == fields
    # and the port's own fields round-trip to an equal object
    assert from_reference_fields(kind, dataclasses.asdict(port)) == port


def test_convert_builds_a_stack_and_reads_numpy_fields():
    objs = _reference_objects()
    stages = [(k, dataclasses.asdict(objs[k]))
              for k in ("RackBattery", "TelemetryBackstop")]
    stack = from_reference_fields("Stack", {"stages": stages})
    assert isinstance(stack, api.Stack)
    assert [type(s).__name__ for s in stack.stages] == [k for k, _ in stages]
    assert from_reference_fields("Stack", {"stages": [
        (type(s).__name__, dataclasses.asdict(s)) for s in stack.stages]}
    ) == stack
    bs = from_reference_fields("TelemetryBackstop", {
        "critical_hz": np.array([0.5, 9.0]),
        "amp_threshold_w": np.float32(1e5)})
    assert bs.critical_hz == (0.5, 9.0) and bs.amp_threshold_w == 1e5
    with pytest.raises(ValueError, match="unknown kind"):
        from_reference_fields("ScenarioShardPlan", {})


def test_rules_cover_the_serve_slice():
    """The import rule's walk reaches the compliance service, the warm
    start and the regression step."""
    files = _port_files()
    for module in ("serve/power.py", "serve/warmstart.py",
                   "train/__init__.py", "train/trainer.py", "core/optim.py",
                   "core/phases.py", "core/spectrum.py", "convert.py"):
        assert ROOT / "src" / "repro_torch" / module in files


def test_api_exports_every_name_of_the_reference_api():
    """``repro_torch.api`` exports every name of ``repro.api`` (47 of 47
    since the scenario mesh's pair, ``ScenarioShardPlan`` and
    ``scenario_plan``, came with ``parallel/``), and each is defined."""
    from repro import api as ref_api
    assert set(ref_api.__all__) <= set(api.__all__)
    assert len(ref_api.__all__) == 47
    assert all(hasattr(api, name) for name in api.__all__)


def test_rules_cover_the_parallel_slice():
    """The import rule's walk reaches the scenario mesh's modules, and
    none of them imports ``jax`` or ``repro``."""
    files = _port_files()
    for module in ("parallel/__init__.py", "parallel/sharding.py",
                   "parallel/distributed.py", "parallel/collectives.py"):
        path = ROOT / "src" / "repro_torch" / module
        assert path in files
        bad = [m for m in _imported_modules(path)
               if m.split(".")[0] in ("jax", "repro")]
        assert not bad, (module, bad)


def _serve_entry(name, device, tmp_path):
    """Call one entry point of the serve slice at a tiny size."""
    from repro_torch.serve import power, warmstart
    from repro_torch.train import make_regression_train_step
    x = np.random.default_rng(0).normal(
        size=(4, warmstart.N_FEATURES)).astype(np.float32)
    if name == "PowerComplianceService":
        return power.PowerComplianceService(device=device)
    if name == "train_warmstart":
        return warmstart.train_warmstart(x, np.ones((4, 3), np.float32),
                                         epochs=1, device=device)
    if name == "WarmStartPredictor.load":
        ckpt = tmp_path / "ws"
        if not ckpt.exists():
            warmstart.train_warmstart(x, np.ones((4, 3), np.float32),
                                      epochs=1, device="cpu")[0].save(
                str(ckpt))
        return warmstart.WarmStartPredictor.load(str(ckpt), device=device)
    if name == "make_regression_train_step":
        return make_regression_train_step(warmstart.warmstart_forward,
                                          device=device)
    argv = {"cli": ["--n-chips", "8", "--period-s", "0.1"],
            "cli watch": ["watch", "--max-ticks", "1", "--dt", "0.01"]}[name]
    if device is not None:
        argv += ["--device", device]
    return power.main(argv) or True


@pytest.mark.parametrize("name", ["PowerComplianceService", "train_warmstart",
                                  "WarmStartPredictor.load",
                                  "make_regression_train_step", "cli",
                                  "cli watch"])
def test_serve_entry_points_without_a_card_raise(monkeypatch, tmp_path,
                                                 capsys, name):
    """``device=None`` (and the CLI without ``--device``) means the card:
    without CUDA each entry point of the serve slice raises, and runs
    with ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _serve_entry(name, None, tmp_path)
    assert _serve_entry(name, "cpu", tmp_path) is not None


def test_rules_cover_the_training_slice():
    """The import rule's walk reaches ``train/``, ``data/`` and
    ``launch/``, and none of their modules imports ``jax`` or
    ``repro``."""
    files = _port_files()
    for package in ("train", "data", "launch"):
        paths = sorted((ROOT / "src" / "repro_torch" / package).glob("*.py"))
        assert len(paths) >= 2, package
        for path in paths:
            assert path in files
            bad = [m for m in _imported_modules(path)
                   if m.split(".")[0] in FORBIDDEN]
            assert not bad, (path.name, bad)
    for module in ("train/optimizer.py", "data/synthetic.py",
                   "launch/train.py", "launch/serve.py",
                   "core/ballast_inject.py"):
        assert ROOT / "src" / "repro_torch" / module in files


def test_core_exports_the_ballast_as_the_reference_does():
    import repro_torch.core as port_core
    for name in ("attach_ballast", "ballast_gflops_for_cell"):
        assert hasattr(core, name) and hasattr(port_core, name)
        assert name in port_core.__all__
    from repro_torch.core import ballast_inject
    assert port_core.attach_ballast is ballast_inject.attach_ballast


def test_train_exports_what_the_reference_exports():
    import repro.train as ref_train
    import repro_torch.train as port_train
    names = {n for n in dir(ref_train) if not n.startswith("_")
             and n not in ("optimizer", "trainer")}
    assert names <= set(port_train.__all__)
    assert all(hasattr(port_train, n) for n in port_train.__all__)


def _train_entry(name, device):
    from repro_torch.configs import TrainConfig, get_config, reduced
    from repro_torch.convert import train_state_from_reference
    from repro_torch.train import init_train_state
    cfg = reduced(get_config("granite-3-8b"))
    if name == "init_train_state":
        return init_train_state(0, cfg, TrainConfig(), device=device)
    from repro.train import init_train_state as ref_init
    from repro import configs as ref_configs
    import jax
    ref = ref_init(jax.random.PRNGKey(0),
                   ref_configs.reduced(ref_configs.get_config(
                       "granite-3-8b")), ref_configs.TrainConfig())
    return train_state_from_reference(jax.tree.map(np.asarray, ref),
                                      device=device)


@pytest.mark.parametrize("name", ["init_train_state",
                                  "train_state_from_reference"])
def test_training_entry_points_without_a_card_raise(monkeypatch, name):
    """``device=None`` means the card: without CUDA they raise, and with
    ``device="cpu"`` every tensor of the state is on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _train_entry(name, None)
    from repro_torch.core.optim import tree_leaves
    state = _train_entry(name, "cpu")
    assert {t.device.type for t in tree_leaves(state)} == {"cpu"}


@pytest.mark.parametrize("dp", [False, True])
def test_train_steps_run_where_the_state_is(monkeypatch, dp):
    """A train step moves its numpy batch to the state's device (the card
    for a state made with the defaults) and returns everything there."""
    from repro_torch.configs import TrainConfig, get_config, reduced
    from repro_torch.core.optim import tree_leaves
    from repro_torch.models import model
    from repro_torch.train import init_train_state, make_train_step, trainer
    cfg = reduced(get_config("granite-3-8b"))
    tcfg = TrainConfig()
    state = init_train_state(0, cfg, tcfg, device="cpu")
    seen = []
    orig = model.loss_fn

    def spy(params, cfg, batch, ctx=None):
        seen.extend(v.device for v in batch.values())
        return orig(params, cfg, batch, ctx)

    monkeypatch.setattr(trainer, "loss_fn", spy)
    batch = {"tokens": np.zeros((2, 8), np.int32),
             "labels": np.zeros((2, 8), np.int32)}
    if dp:
        step, init_err = trainer.make_dp_compressed_train_step(cfg, tcfg)
        out, _, m = step(state, init_err(state.params), batch)
    else:
        out, m = make_train_step(cfg, tcfg)(state, batch)
    assert seen and {d.type for d in seen} == {"cpu"}
    assert {t.device.type for t in tree_leaves((out, m))} == {"cpu"}
