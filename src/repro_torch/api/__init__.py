"""repro_torch.api: the public surface of the port (declare -> run ->
query), mirroring ``repro.api``.

    from repro_torch import api

    study = api.Study(
        workloads={"dense": api.synthetic_timeline(2.0, 0.19),
                   "moe":   api.synthetic_timeline(3.0, 0.25, moe_notch=True)},
        fleets=[8192, 32768],
        configs={"none": None,
                 "mpf90": (api.GpuPowerSmoothing(mpf_frac=0.9), None)},
        specs=api.example_specs(job_mw=5.0), key=0)
    result = study.run()                      # on the card
    result = study.run(stream=64, resume="sweep_ckpt")  # chunked, resumable
    study.plan = api.scenario_plan()          # rows sharded over the cards
    result.passing().pivot("workload", "config", "energy_overhead")

    log = api.watch_trace(api.synthesize_ramp(), 0.002, n_chips=512,
                          spec=api.example_specs(500.0)["moderate"])

    one = api.simulate(api.synthetic_timeline(2.0), 8192,
                       rack_mitigation=api.RackBattery(4e7, 8e6, 8e6))
    sol = api.design(api.example_specs(5.0)["tight"], one.dc_raw, 0.001,
                     8192)                      # hybrid, as in repro

    service = api.PowerComplianceService()    # the serve path, on the card
    service.query(api.synthetic_timeline(2.0, 0.25), 512, "moderate")
"""
from repro_torch.control import (ControlLog, ControlLoop, GridController,
                                 InterventionLadder, OnlineGoertzelDetector,
                                 ReplaySource, synthesize_ramp, watch_trace)
from repro_torch.core.engine import (StreamChunk, design, design_gradient,
                                     design_grid, stream_batches)
from repro_torch.core.hardware import DEFAULT_HW, Hardware
from repro_torch.core.phases import (IterationTimeline, Phase,
                                     from_dryrun_cell, load_cell,
                                     synthetic_timeline)
from repro_torch.core.smoothing import (CombinedMitigation, Firefly,
                                        GpuPowerSmoothing, RackBattery, Stack,
                                        TelemetryBackstop, design_mitigation)
from repro_torch.core.spec import (FrequencyDomainSpec, SpecReport,
                                   TimeDomainSpec, UtilitySpec, example_specs)
from repro_torch.core.stratosim import SimResult, simulate, simulate_jit
from repro_torch.core.study import (MitigationConfig, Scenario, Study,
                                    StudyResult)
from repro_torch.core.telemetry import TelemetrySource
from repro_torch.parallel.sharding import ScenarioShardPlan, scenario_plan
from repro_torch.core.waveform import WaveformConfig
from repro_torch.serve.power import PowerComplianceService, default_catalog
from repro_torch.serve.warmstart import WarmStartPredictor, train_warmstart

__all__ = [
    "Study", "StudyResult", "MitigationConfig", "Scenario",
    "stream_batches", "StreamChunk", "design", "design_grid",
    "design_gradient", "simulate", "simulate_jit",
    # the scenario mesh across devices and processes
    "ScenarioShardPlan", "scenario_plan",
    # the serve path
    "PowerComplianceService", "default_catalog",
    "WarmStartPredictor", "train_warmstart",
    # the grid-interactive control plane
    "ControlLoop", "ControlLog", "GridController", "InterventionLadder",
    "OnlineGoertzelDetector", "ReplaySource", "synthesize_ramp",
    "watch_trace",
    "IterationTimeline", "Phase", "synthetic_timeline", "from_dryrun_cell",
    "load_cell", "WaveformConfig",
    "TelemetrySource",
    "Hardware", "DEFAULT_HW",
    "GpuPowerSmoothing", "Firefly", "RackBattery", "TelemetryBackstop",
    "CombinedMitigation", "Stack", "design_mitigation",
    "UtilitySpec", "TimeDomainSpec", "FrequencyDomainSpec", "SpecReport",
    "example_specs", "SimResult",
]
