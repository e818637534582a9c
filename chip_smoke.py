#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``,
holds each kernel against its plain PyTorch version at the shapes the
main paths give it, runs a full-size ``Study.run()`` on the card (counting
every kernel's launches), re-runs a subset of it on the CPU, then closes
the grid-interactive control loop (``control.watch_trace``) on the
canonical 48 s ramp and on a 10-minute 1 kHz replay, holds kernel E and
the monitor's chunked online path against their offline calls, holds
kernel C bit for bit against its plain version at the Study's, the
canonical loop's, a 600 000-sample and a ragged [3 x 4099] shape and
times its chain alone, times kernels A and D on the device alone at the
Study's and a tick's shapes, holds A bit for bit against kernel E on the
same operands (the witness: A's worst, peaks and state out from E's
amplitudes and state), times D's chain alone, holds D exactly at its
int32 range rule's edge and in chunks, holds A at four geometries no
path reaches (4-byte copies, rounds, several bins a block), holds kernel
B bit for bit at the Study's, the loop's and the replay's shapes (every
replay call, captured from a run of its own) and on two seeded rows,
times it there and in its worst case (no segment merges) and its chain
alone, times kernels E, I and H on the device alone at each of their
shapes (E at A's shapes against A; H also with its chain alone and each
shape's chain floor), and re-runs the canonical loop on the CPU (phases
1-10).  Then the model zoo
(phases 11-14): kernel F (flash attention) against its plain version and
a float64 oracle at four shapes in bf16 and f32; granite-3-8b at full
width (random f32 params from seed 0) prefilling 4 x 4096 tokens on the
flash route (40 launches of F) and on the chunked route the reference
serves on, the two compared; ``ServeEngine.generate`` of 32 greedy tokens
against 32 tokens decoded from the flash route's cache; and the model cut
to 2 layers in f32, run on the card and on the CPU.  Phase 22 (below)
serves dbrx-132b and deepseek-v2-lite-16b the same way.  Last (phase 15), the
three kernels that only the reference's own entry points reach:
``bin_power`` (kernel H) on the 600 s replay, on it cut to leave a
2765-sample tail window, on the 48 s ramp and on "day" (the 600 s trace
tiled 144 times: 24 h of 1 kHz telemetry, 21 600 windows), the v1
sliding layout (kernel I) on the 600 s trace's segments, and
``ballast_burn`` (kernel G) at 140 GFLOP, each held against its plain
version and its float64 oracle (H bit for bit on the three traces and,
at "day", on the 600 s windows tiled against the 600 s output tiled; no
worse than twice the reference's own error there, "day" as the 600 s
trace; I also against kernel E bit for bit after the warm-up scale; G
also on five more cases and one shape for each of its two routes, the
burn timed on both), with no earlier path launching any of the three.
Phase 16 runs before phase 15: the keyed Study, phase 5's workloads,
fleets, seeds and specs with eight Firefly and ``CombinedMitigation``
configurations (noisy telemetry among them) and ``key=0``, 128 rows on
the card.  It holds two runs of one key equal bit for bit, ``stream=16``
and ``stream=True`` equal to the one-shot run in every column, a
``resume=`` run stopped after its third chunk and run again equal to it,
a restore that computes nothing and an extension by one configuration
that computes only its rows; checks that two keys draw two noises and
``key=None`` one; and re-runs 16 rows (noisy ones among them) on the CPU
at phase 6's tolerances, counting where card and CPU noise differ.
Phase 17 runs after 16 and before 15; phase 18 runs its card's part
after phase 6, and its CPU workers run on beside every later phase and
are waited for and gated after phase 15.  Phase 17, the serial
reference: phase 5's Study again with ``keep_waveforms=True`` (its
records equal to phase 5's), ``simulate`` and ``simulate_jit`` on eight
of its rows against each other (bit for bit) and against the kept
``sim_result`` (bit for bit on the unpadded rows), ``sweep`` over its
grid against its records, and ``apply_batch`` and ``validate_many``
against per-row calls.  Phase 18, the design path at full size: the
grid, gradient (120 Adam steps through kernels J and K, forward and
adjoint) and hybrid designs on phase 5's longest workload (90 000
samples) at both fleets and both specs, with the gradient design passing
its spec and the hybrid never worse than the grid; J and K against their
plain versions, forward and gradient, each output, the trace's gradient
and each parameter column's gradient against its own max |plain|: on the
CPU at the full shape of their first and last design calls with the most
rows (one worker process a call, ``--jk-plain``, running while the card
goes on), and on the card on those rows cut to 3000 samples; J and K
timed alone with their chains and the serial part their walks leave
(how the segmented walks merged on the first and last calls);
``Study.optimize`` on the four cells against the hybrid designs; the
first three Adam steps on the CPU's plain versions (the trace's first
3000 samples) against the card; and no J or K launch on any other path.
Phase 19, after 18: the relaxed backstop's gradient with respect to the
trace on ten rows of phase 18's workload, through kernel A forward and
kernel E and A's adjoint backward, and A's adjoint against its plain
version (float64 torch) at [10 x 90 000 x 4 bins], timed alone; no
launch of A's adjoint on any other path.
Phase 20, after 19: the compliance service at its own width, after
``benchmarks/serve_bench.py``.  (a) The warm-start predictor's training
set, ``design(method="hybrid")`` on the card on the four smoke cells of
``benchmarks/warmstart_data.py`` at dt 5 ms, 8 steps, each battery
horizon refined over (5, 10, 15, 30) s in one ``_eval_candidates``
call; 400 epochs on the card (the loss must fall), a save and load equal
bit for bit, and the card's predictions within 1e-5 of the same params'
CPU forward.  (b) serve_bench's design problem (1.8 s, comm 0.28, 512
chips, tight) by hybrid and warm start, cold and warm: the same
feasibility, both answers passing their hard re-validation.  (c)
``PowerComplianceService()`` at its defaults (20 configs, dt 2 ms, 10
steps): phase 5's four workloads x both fleets x moderate and tight, 16
queries coalesced into one Study run and asked serially of another
instance, the answers equal; cache-hit p50 and p99; 8 threads on one
cold query running one Study; a dry-run cell file through ``handle``;
the design fallback by hybrid and by the warm start on a narrowed
catalog; two of the queries again on the CPU.  (d) ``watch`` on the 48 s
ramp with the predictor, on the card and on the CPU: the same records
and timeline.  (e) ``python -m repro_torch.serve.power`` and its
``watch`` subcommand as subprocesses, each exiting 0 with JSON.  The
phase must launch B, C, J, K, A, D and E (and no G, H, I or F); the
CPU's parts launch nothing.
Phase 21, after 20: the Study on the scenario mesh (``repro_torch.
parallel``).  (a) How a batched ``rfft`` and a float32 row sum treat one
row at six places of a 32-row batch (measured: what the analysis avoids),
then one row analysed at those places at five lengths (odd and even),
equal bit for bit; phase 5's Study with
``plan=scenario_plan()`` and with ``shard_devices=True``, records equal
to phase 5's.  (b) One ``launch_workers`` of two processes
(``--mesh-worker``) that share the card through gloo, each running phase
5's grid with ``stream=64``, phase 16's keyed grid with ``stream=16``
and again resumed from a 112-row prefix this process checkpointed, and
one int8 ``compressed_allreduce_mean``: each grid's records equal to
this process's, ``on_chunk`` on process 0 only and ending at ``done ==
total``, B, C, D and A launched in each worker and no other kernel, the
all-reduce equal to the mean of both ranks' dequantized payloads.  (c)
``python -m repro_torch.parallel.distributed --smoke`` as a subprocess
beside (b), printing its OK line.
Phase 22, right after phase 14: sparse experts and latent attention at
the published widths, the depth cut to one card.  Kernel F at the two
models' prefill shapes (q [4, 4096, 8, 6, 128] and MLA's [4, 4096, 16,
1, 192] with Dv 128, bf16) against its plain version and the float64
oracle.  (a) dbrx-132b with 4 of its 40 repeats, random bf16 params from
seed 0 drawn on the card, and (b) deepseek-v2-lite-16b with its dense
first layer and 8 of its 26 repeats, f32 params: one MoE layer's
``moe_forward`` (dropless) against ``moe_forward_ref`` on 512 tokens;
prefills of 4 x 4096 on the flash route (F once a layer: 4 and 9
launches) and the chunked route (none), two runs of each equal bit for
bit, their first layer's caches equal, and a free-running run of each
with every MoE call's routing recorded (the routing rule: a token at a
margin under 1e-5 between its k-th and (k+1)-th probabilities, whose
experts differ, or whose kept slots differ because the capacity's edge
moved, is set aside and counted; the other rows' last logits within
2^-5); the routes walked layer by layer, each layer given the same input
on both (its outputs within 2^-5 of max |.| past the routing rule's
tokens, whose experts may differ only at a margin under 2^-7);
``ServeEngine.generate`` of 32 greedy tokens against the flash route's
own decode (the parting step and top-2 gap reported), then the engine's
tokens fed teacher-forced through decode from both routes' caches (the
chunked one's logits equal to the engine's bit for bit, the flash one's
within 2^-5 past the routing rule's steps), and the flash route's decode
again with the chunked route's experts and gates forced on every MoE
call (``moe.forced_routes``), every set-aside step within 2^-5 there
(the steps still set aside counted); decode ms per step beside
its byte bound (the weights a step uses, the routed experts its tokens
chose, and the cache read once, over 3.35 TB/s); a profiled flash
prefill and four profiled decode steps; and each model's peak memory.
(c) deepseek-v2-lite-16b with its prefix and 1 repeat in f32, a prefill
of 1 x 256 and 4 greedy decode steps on the card and on the CPU (params
from a CPU generator), logits within 1e-4 under the routing rule (no
expert may differ at a wider margin), tokens equal.
Phase 23, after 21 and before 15: training granite-3-8b at its
published widths (``repro_torch.train``), launching none of the kernels
A-K or A'.  (a) 6 of its 40 repeats (1.598 B params), f32 params and
bf16 compute, ``SyntheticLM`` batches of 4 x 4096 in 2 microbatches,
``remat="full"``: 1 cold and 5 warm steps, every loss and grad norm
finite, the median warm step's wall, tokens/s, 6 N tokens over it as a
share of 989 TFLOP/s, peak memory, and one profiled step's busy share
and top device ops.  (d) From the last state, the next step profiled,
again (bit for bit), with 100 GFLOPs of ballast a microbatch (loss,
metrics and params bit for bit, both walls printed) and with the ballast
profiled (2 x 2980 products of [256 x 256] bf16 counted, with their
device time).  (c) The ``CheckpointManager`` checkpoint taken after step
3 restored into a fresh state and steps 4-5 run again: losses and params
bit for bit the uninterrupted run's.  (b) 1 repeat in f32 on 1 x 256
tokens (``loss_chunk`` 128) on the card and on the CPU from one state,
in a worker process (``--train-cpu OUT``) started before phase 17, whose
card half ends before (a) starts and whose CPU half runs beside (a)-(c):
step 0's gradients within 1e-4 of each leaf's max |g|, 2 steps' losses
within 1e-5.  (e) Two gloo workers on the card (``--train-dp-worker``)
take 2 int8 data-parallel steps of 1 repeat in bf16 on 2 x 512 tokens:
both ranks' params equal bit for bit and equal to a one-process
emulation (each rank's rows' gradients quantized with its own residual,
the payloads summed and halved, clipping and AdamW), each rank's
residual the emulation's.  (f) ``python -m repro_torch.launch.train
--reduced --steps 4`` and ``launch.serve --reduced`` as subprocesses on
the card beside (a)-(e), each exiting 0.
Phase 24, right after phase 22: Mamba and RWKV-6 at the published
widths.  Kernels L (the selective scan) and M (the wkv recurrence)
against their plain versions (1e-5 of max |plain|, each output) and
float64 plain versions (1e-4) at jamba-v0.1-52b's prefill shape [4 x
4096, d_inner 8192, d_state 16] and rwkv6-3b's [4 x 4096, 40 heads of
64], bf16, at a decode step and at ragged shapes (L at d_state 16 and
8, d_inner 8190; M at head dim 16 with 3 x 5 heads and at 1 x 1001 x
40); calls that carry the state every 1000 steps and 64 one-step calls
equal one call bit for bit; grad-enabled inputs refused; event, device
and plain ms beside each bound (L's expf counted on the special function
units); each kernel's step loop counted in its SASS (``cuobjdump``) and
the floors that follow, with M's 7 operations an element issued one by
one.  (a) jamba-v0.1-52b with 1 of its 4
repeats (7 Mamba layers, 1 attention, 4 MoE; bf16, random from seed 0)
and (b) rwkv6-3b with all 32 layers (f32) through phase 22's
``zoo_model``: every gate there, L or M launched once a layer a pass,
F once on jamba's flash prefill, rwkv6-3b's two routes equal bit for
bit.  (c) Each cut in depth (jamba: a unit of two Mamba layers with
dense FFNs; rwkv6-3b: 2 layers) in f32: a prefill of 1 x 256 and 4
greedy steps on the card and, in a worker process per model (``--ssm-cpu
ARCH OUT``, its params drawn on the card and copied) started first, on
the CPU: logits within 1e-4 of max |logit|, tokens equal.  L and M
launch on no other path.  Phase 9's 600 000-sample row of kernel C's
plain version (``--battery-plain IN OUT``) and phase 6's 16 CPU rows
(``--cpu-subset OUT``) run in worker processes beside the later phases
and are gated at the end.
It prints:

  * the card's name and power limit (``nvidia-smi``);
  * build times and ``ptxas`` register and spill lines, and for kernels
    F and C each function's registers, shared memory and spills;
  * per kernel: error against its plain version (and, for the monitor,
    the float64 oracle and chunked state-in/out calls), ``ms``,
    ``plain_ms``, ``bound_ms``/``bound_by`` and launches per Study;
  * the Study's wall times, rows/s, verdicts, backstop levels, device busy
    share and top device operations;
  * per control-loop run: the action timeline, detection lead,
    counterfactual breach, warm dispatch latencies, loop wall,
    ``realtime_x``, per-tick step times, launches per run of every kernel,
    and the device busy share of a profiled run (the 600 s replay's wall
    beside its wall on kernel C's first design);
  * kernel C's chain alone: SM cycles and ns a step, and each shape's
    floor (ns a step times its steps);
  * kernels A and D at the Study's and a tick's shapes: CUDA-event ms
    around the wrapper and device-only ms from the profiler's kernel
    durations; A against E bit for bit; D's chain alone (int32 and
    int64) and each shape's chain floor;
  * kernel B at its three paths' shapes, the seeded rows and its worst
    case: event and device ms, how its segments' walks merge, its chain
    alone and each shape's serial and segmented floors;
  * kernels E, I and H at each of their shapes: event and device ms, the
    bound and the geometry (``sliding.sliding_route``,
    ``windows.windows_route``); H's chain alone
    (``goertzel_step_cycles``: SM cycles and ns a step) and each shape's
    chain floor, and "day" again with persistent blocks;
  * per model phase: kernel F's errors, times and TFLOP/s beside its
    bound and ``F.scaled_dot_product_attention``'s time, prefill walls,
    tokens/s,
    peak memory, the routes' gaps, the device busy share of a profiled
    prefill, decode ms per token, and the CPU re-run's gaps; for phase
    22 also the routing rule's counts by layer (near ties, experts that
    differ and their widest margin, moved capacity edges, dropped
    slots), the teacher-forced decode's gaps, the decode bound and the
    experts a step used;
  * for kernels G, H and I: errors, ``ms``, ``plain_ms``, ``bound_ms``,
    ``library_ms``, ``ptxas`` lines and launches on every path (H also its
    route and ``chain_floor_ms``); for G
    each case's route, ms and TFLOP/s, the burn's device ms on both
    routes, and each cluster geometry's shared memory and resident
    clusters;
  * for phase 16: launches of every kernel, warm walls and rows/s of the
    one-shot and both streamed runs, the resumed run's and the restore's
    times, the device busy share and top device operations of a profiled
    run, ``prng.normal``'s device ms and share of that busy time, and the
    CPU subset's gaps with the noise samples where card and CPU differ
    (and their largest gap in ulps);
  * for phases 17 and 18: each gate's gaps and walls; each design's
    wall, ms per Adam step, starts, first and last losses and chosen
    (MPF, capacity); J's and K's launches, event and device ms, merges
    per segment, chain floors and errors against their plain versions;
  * for phase 19: launches, the backward's wall, and A's adjoint's error,
    ms, device ms, plain ms and bound;
  * for phase 20: the training set and the predictor's loss, train
    seconds and card-vs-CPU gap; the design walls and the warm start's
    tier; the coalesced and serial walls, cache-hit p50 and p99, the
    single-flight and fallback results; the watch's action timeline and
    loop wall; the CLI's answers; launches by part;
  * for phase 21: the distinct results of one row at six places under a
    batched ``rfft`` and a float32 sum, each step's wall, each worker's
    backend, start-up
    seconds, walls, merges and their seconds, all-reduce seconds and
    launches, and the smoke's OK line;
  * for phase 24: L's and M's errors, bitwise checks, event, device and
    plain ms and bounds at each shape, their step loops' SASS
    counts and floors, registers and shared memory, each model's
    phase-22 lines and its seconds by part, and (c)'s gaps;
  * for phase 23: each step's loss, grad norm, lr and wall, the warm
    median, tokens/s, the FLOP share, peak memory, the profiled step's
    busy share and top device ops, the ballast's product count and
    walls, the restore's seconds, the card-vs-CPU gaps, the workers'
    losses and checks, the launchers' last lines, and the phase's
    seconds;
  * one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line again,
    and, last, ``{"ok": true, "device": {...}}``.

Every phase raises on failure, so the script exits non-zero and prints
no result line.  It needs one card and exits non-zero without one, or
when ``src/repro_torch`` is not beside it.

    python3 chip_smoke.py --ad

measures only what kernels A, B, D, E, G, H and I change, to compare two
trees on one card: the warm Study, the canonical loop and the 600 s
replay with their device busy shares (and B's device time in the
replay), A and D alone at both shapes, B at its three paths' shapes with
its chain where the library has a probe, G at phase 15's burn on each of
its routes, E at the loop's, the replay's and A's shapes (A against E
there), I at phase 15's shape (against E) and H at phase 15's four
shapes (bit for bit against its plain version on the three traces, the
600 s windows tiled at "day", its route and chain probe where the tree
has them), with event and device ms, and J and K forward and adjoint at
the design's shapes with the sha256 of each forward's outputs (saved
under ``chiprun_out/ad_jk/``) and A's adjoint where the tree has it (run
this script from the root of each tree; it prints one ``{"ad": ...}``
line).  It also times L and M at each of phase 24's shapes where the
tree has them.

    python3 chip_smoke.py --study-time

times phase 5's warm Study 12 times, with its device busy time and the
host seconds of its engine functions under ``cProfile``, to compare two
trees on one card (run this script from the root of each, parent,
change, change, parent; it prints one ``{"study_time": ...}`` line).
"""
from __future__ import annotations

import atexit
import collections
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SCRIPT_T0 = time.perf_counter()

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, and f32
# operations/s outside the tensor cores, used for every kernel here (their
# arithmetic is 32-bit scalar)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

MONITOR_TOL = 1e-4        # of the row's amplitude scale max |x - mean|
ORACLE_TOL = 1e-3         # of the amplitude scale, against float64
STUDY_RTOL = 1e-4         # CPU-vs-card metrics

# the control loop (benchmarks/control_bench.py's configuration)
CONTROL_DT = 0.002
CONTROL_CHIPS = 512
CONTROL_JOB_MW = 500.0
CARRY_TICKS = (7, 250, 1999, 2000, 3, 1211, 777, 2000, 753)
SLIDING_OPS = 20          # f32 operations per sample and bin, kernel E
LONG_REPLAY_WAS_S = 13.306  # the 600 s replay's wall on kernel C's first design

# the model zoo (phases 11-14): granite-3-8b at full width
PREFILL_B, PREFILL_S = 4, 4096
NEW_TOKENS = 32
FLASH_BLOCKS = (2048, 1024)   # the reference's q_chunk and chunk_size
# kernel F's checks: (q shape [B, S, KV, G, D], Dv, causal), each in bf16
# and f32: the prefill's shape, a non-causal one and a Dv != D one
FLASH_SHAPES = (((PREFILL_B, PREFILL_S, 8, 4, 128), 128, True),
                ((1, 2048, 8, 4, 128), 128, False),
                ((1, 2048, 16, 1, 192), 128, True))
GRANITE = "granite-3-8b"
DEVICE = "cuda"  # where phases 11-14 and 16 put the card's side
# kernel F against its plain version and the float64 oracle, of max |plain|
FLASH_TOL = {"bfloat16": (2.0 ** -8, 2.0 ** -7), "float32": (1e-5, 1e-5)}
# dense tensor-core peaks (NVIDIA data sheet) for kernel F's bound
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
ROUTE_TOL = 2.0 ** -5     # flash vs chunked prefill, of max |.|
CPU_RERUN_TOL = 1e-4      # card vs CPU logits, of max |logit|

DT = 0.001
FLEETS = (8192, 32768)
SEEDS = (0, 1)
SPEC_NAMES = ("moderate", "tight")
JOB_MW = 6.0


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def import_port():
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        raise SystemExit("chip_smoke: src/repro_torch is not beside this "
                         "script")
    sys.path.insert(0, src)
    import repro_torch
    if not os.path.abspath(repro_torch.__file__).startswith(src):
        raise SystemExit(f"chip_smoke: imported {repro_torch.__file__}, "
                         f"not the port under {src}")


# ---------------------------------------------------------------------------
# the Study of the main path
# ---------------------------------------------------------------------------

def study_configs(api):
    """34 configurations: baseline, 3 MPF floors, 3 batteries, the 9
    MPF x battery pairs, 3 backstops alone, 6 battery+backstop stacks and
    9 MPF+battery+backstop stacks.  Backstop thresholds sit between the
    raw critical-bin amplitudes of the two fleets (about 0.45 MW and
    1.8 MW for the 1 s dense workload), so some rows escalate and some
    do not."""
    mpfs = {f"mpf{int(m * 100)}": api.GpuPowerSmoothing(
        mpf_frac=m, ramp_up_w_per_s=2000.0, ramp_down_w_per_s=2000.0)
        for m in (0.6, 0.75, 0.9)}
    bats = {
        "bat2MJ": api.RackBattery(capacity_j=2e6, max_discharge_w=1e6,
                                  max_charge_w=1e6),
        "bat8MJ": api.RackBattery(capacity_j=8e6, max_discharge_w=3e6,
                                  max_charge_w=3e6, switch_latency_s=0.01),
        "bat30MJ": api.RackBattery(capacity_j=3e7, max_discharge_w=6e6,
                                   max_charge_w=6e6),
    }
    backstops = {f"bs{t}": api.TelemetryBackstop(amp_threshold_w=t * 1e5)
                 for t in (3, 8, 15)}
    cfgs = {"none": None}
    cfgs.update({k: (m, None) for k, m in mpfs.items()})
    cfgs.update({k: (None, b) for k, b in bats.items()})
    cfgs.update({f"{km}+{kb}": (m, b) for km, m in mpfs.items()
                 for kb, b in bats.items()})
    cfgs.update({k: (None, s) for k, s in backstops.items()})
    cfgs.update({f"{kb}+{ks}": (None, api.Stack((b, s)))
                 for kb, b in bats.items()
                 for ks, s in list(backstops.items())[:2]})
    cfgs.update({f"{km}+{kb}+{ks}": (m, api.Stack((b, s)))
                 for km, m in mpfs.items() for kb, b in bats.items()
                 for ks, s in list(backstops.items())[1:2]})
    return cfgs


# phase 5's workloads: (period, MoE notch), comm 0.25
WORKLOAD_PERIODS = {"dense_1s": (1.0, False), "dense_1p5s": (1.5, False),
                    "moe_2s": (2.0, True), "dense_3s": (3.0, False)}


def study_timelines(api):
    return {k: api.synthetic_timeline(p, 0.25, moe_notch=moe)
            for k, (p, moe) in WORKLOAD_PERIODS.items()}


def build_study(api, workloads=None, fleets=FLEETS, configs=None,
                device="cuda", keep_waveforms=False):
    all_wl = study_timelines(api)
    cfgs = study_configs(api)
    specs = api.example_specs(JOB_MW)
    return api.Study(
        {k: all_wl[k] for k in (workloads or all_wl)}, fleets=list(fleets),
        configs={k: cfgs[k] for k in (configs or cfgs)},
        specs=[specs[n] for n in SPEC_NAMES], seeds=list(SEEDS),
        wave_cfg=api.WaveformConfig(dt=DT, steps=30, jitter_s=0.002),
        sample_chips=64, keep_waveforms=keep_waveforms, device=device)


class Capture:
    """Wrap each kernel wrapper where the main path looks it up, keeping
    copies of the arguments of its largest call and the escalation
    levels of every backstop row.  ``by="rows"`` keeps the first call
    with the most rows (the Study's batches); ``by="numel"`` the last call
    with the most elements (the control loop's one-row calls, whose
    latest carry the most signal).  Kernels J and K (``RELAXED_KEPT``)
    also keep, in ``last``, the last call with the most rows (a design's
    late Adam step).  Every ``_design_descend`` is timed (synchronised)
    into ``descend_s``, and every Adam step's gradients, as they reach
    ``clip_by_global_norm``, are copied into ``grads``."""

    def __init__(self, torch, by="rows"):
        self.by = by
        from repro_torch.core import engine
        from repro_torch.core.smoothing import battery, gpu_floor
        from repro_torch.kernels.goertzel import ops
        self.torch = torch
        self.sites = [(gpu_floor, "gpu_floor_scan", "gpu_floor"),
                      (battery, "battery_scan", "battery"),
                      (ops, "sliding_monitor", "monitor"),
                      (ops, "escalation_scan", "escalation"),
                      (ops, "sliding_bin_power_v2", "sliding"),
                      (gpu_floor, "gpu_floor_relaxed", "gpu_floor_relaxed"),
                      (battery, "battery_relaxed", "battery_relaxed"),
                      (engine, "_design_descend", "_design_descend"),
                      (engine, "clip_by_global_norm", "clip_by_global_norm")]
        self.args = {}
        self.last = {}
        self.max_levels = []
        self.descend_s = []
        self.grads = []

    def __enter__(self):
        self.saved = [(mod, attr, getattr(mod, attr))
                      for mod, attr, _ in self.sites]
        for mod, attr, name in self.sites:
            setattr(mod, attr, self._wrap(getattr(mod, attr), name))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)

    def _copy(self, args):
        return tuple(a.detach().clone() if isinstance(a, self.torch.Tensor)
                     else a for a in args)

    def _wrap(self, fn, name):
        torch = self.torch
        if name == "_design_descend":
            def timed(*args, **kw):
                out, s = timed_run(torch, lambda: fn(*args, **kw))
                self.descend_s.append(s)
                return out
            return timed
        if name == "clip_by_global_norm":
            def logged(tree, *args, **kw):
                self.grads.append({k: v.detach().clone()
                                   for k, v in tree.items()})
                return fn(tree, *args, **kw)
            return logged

        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            if self.by == "rows":
                rows = args[0].shape[0]
                bigger = name not in self.args or rows > self.args[name][0]
            else:
                rows = args[0].numel()
                bigger = name not in self.args or rows >= self.args[name][0]
            if bigger:
                self.args[name] = (rows, self._copy(args), dict(kw))
            if name in RELAXED_KEPT and rows >= self.args[name][0]:
                self.last[name] = (rows, self._copy(args), dict(kw))
            if name == "escalation":
                self.max_levels += out[1].amax(-1).tolist()
            return out
        return wrapped


# ---------------------------------------------------------------------------
# kernel checks and timings
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, repeat):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeat):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeat


def timed_once(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(nbytes_, nops):
    t_bytes = nbytes_ / PEAK_BYTES_S * 1e3
    t_ops = nops / PEAK_OPS_S * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_monitor(torch, cap, launches, freqs):
    import numpy as np
    from repro_torch.kernels.goertzel import monitor
    from repro_torch.kernels.goertzel.ref import sliding_bin_power_ref
    _, args, _ = cap.args["monitor"]
    xseg, cosp, sinp, rot, thr, rel, n, seg0, re0, im0 = args
    B, S, win = xseg.shape
    K = cosp.shape[0]
    got = monitor.sliding_monitor(*args)
    torch.cuda.synchronize()
    plain, plain_ms = timed_once(
        torch, lambda: monitor.sliding_monitor_plain(*args))
    scale = xseg.abs().amax(dim=(1, 2))                       # [B]
    err = ((got[0] - plain[0]).abs() / scale[:, None, None]).max().item()
    err_w = (got[0] - plain[0]).abs().max().item()
    peak_err = ((got[2] - plain[2]).abs()
                / scale[:, None, None]).max().item()
    tol = MONITOR_TOL * scale[:, None, None]
    near = (((plain[0] - thr[:, None, None]).abs() <= tol)
            | ((plain[0] - rel[:, None, None]).abs() <= tol))
    mismatch = got[1] != plain[1]
    off_band = int((mismatch & ~near).sum())
    log(f"monitor [{B} rows x {S} segments x {win}, K={K}]: max |worst - "
        f"plain| {err_w:.4g} W ({err:.3g} of the amplitude scale, tol "
        f"{MONITOR_TOL}); peaks {peak_err:.3g}; class mismatches off the "
        f"threshold band {off_band}, on it {int((mismatch & near).sum())}"
        f" (samples within tol of a threshold: {int(near.sum())})")
    if err > MONITOR_TOL or peak_err > MONITOR_TOL or off_band:
        raise AssertionError("monitor kernel disagrees with its plain "
                             "version")
    # chunked calls that pass the state on equal one call
    parts, re, im = [], re0, im0
    cuts = [0, S // 3, S // 3 + 1, S]
    for lo, hi in zip(cuts, cuts[1:]):
        out = monitor.sliding_monitor(
            xseg[:, lo:hi].contiguous(), cosp, sinp, rot, thr, rel, n,
            seg0 + lo, re, im)
        parts.append(out[:3])
        re, im = out[3], out[4]
    chunk_err = max(
        ((torch.cat([p[0] for p in parts], 1) - got[0]).abs()
         / scale[:, None, None]).max().item(),
        ((torch.cat([p[2] for p in parts], 1) - got[2]).abs()
         / scale[:, None, None]).max().item())
    bitwise = all(torch.equal(torch.cat([p[i] for p in parts], 1), got[i])
                  for i in range(3))
    log(f"monitor chunked state in/out ({len(cuts) - 1} calls) vs one "
        f"call: {chunk_err:.3g} of the amplitude scale, bitwise {bitwise}")
    if chunk_err > MONITOR_TOL:
        raise AssertionError("chunked monitor calls differ from one call")
    # against the float64 oracle, on two rows (the worst over bins)
    worst_oracle = 0.0
    for r in (0, B - 1):
        x = xseg[r].reshape(-1)[: int(n[r])].double().cpu().numpy()
        ref = sliding_bin_power_ref(x, DT, freqs, win)
        d = np.abs(got[0][r].reshape(-1)[: int(n[r])].cpu().numpy()
                   - ref.max(1)).max() / float(scale[r])
        worst_oracle = max(worst_oracle, d)
    log(f"monitor vs float64 oracle on 2 rows: {worst_oracle:.3g} of the "
        f"amplitude scale (tol {ORACLE_TOL})")
    if worst_oracle > ORACLE_TOL:
        raise AssertionError("monitor kernel disagrees with the float64 "
                             "oracle")
    ms = cuda_ms(torch, lambda: monitor.sliding_monitor(*args), 20)
    inputs = nbytes(xseg, cosp, sinp, rot, thr, rel, n, seg0, re0, im0)
    outputs = nbytes(*got)
    b_ms, b_by = bound(inputs + outputs, 21 * B * S * win * K)
    return {"name": "sliding_monitor", "route": "cuda",
            "source": "src/repro_torch/kernels/goertzel/csrc/monitor.cu",
            "replaces": "src/repro/kernels/goertzel/goertzel.py:340",
            "launches": launches["monitor"], "max_abs_err": err_w,
            "tolerance": f"{MONITOR_TOL} x amplitude scale",
            "class_mismatches_off_band": off_band,
            "near_threshold_samples": int(near.sum()),
            "chunked_bitwise": bitwise, "oracle_err": worst_oracle,
            "shape": [B, S, win, K], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library_note": "no single PyTorch call computes a sliding "
                            "windowed DFT reduced to a worst bin"}


def kernel_vs_plain(torch, name, args, kw, repeat=10):
    """A kernel against its plain version on the arguments of one of its
    calls: ``(shape, max_abs_err, ok, ms, plain_ms, bound_ms,
    bound_by)``.  Escalation and the two smoothing scans must be exact (B
    and C with ``torch.equal`` on every output); the others within their
    tolerance of the input's max |x| (a monitor's classes may differ
    only within it of a threshold)."""
    from repro_torch.core import telemetry
    from repro_torch.core.smoothing import battery, gpu_floor
    from repro_torch.kernels.goertzel import monitor, sliding
    kern, plain, ops_per, tol = {
        "monitor": (monitor.sliding_monitor, monitor.sliding_monitor_plain,
                    21, MONITOR_TOL),
        "sliding": (sliding.sliding_bin_power_v2,
                    sliding.sliding_bin_power_v2_plain, SLIDING_OPS,
                    MONITOR_TOL),
        "gpu_floor": (gpu_floor.gpu_floor_scan,
                      gpu_floor.gpu_floor_scan_plain, 11, 0.0),
        "battery": (battery.battery_scan, battery.battery_scan_plain, 32,
                    0.0),
        "escalation": (telemetry.escalation_scan,
                       telemetry.escalation_scan_plain, 14, 0.0),
    }[name]
    got = kern(*args, **kw)
    torch.cuda.synchronize()
    ref, plain_ms = timed_once(torch, lambda: plain(*args, **kw))
    got_t = got if isinstance(got, tuple) else (got,)
    ref_t = ref if isinstance(ref, tuple) else (ref,)
    x = args[0]
    if name == "escalation":
        err = float(sum(int((g != r).sum()) for g, r in zip(got_t, ref_t)))
        ok = err == 0
    elif name == "monitor":
        scale = max(x.abs().max().item(), 1e-30)
        err = (got_t[0] - ref_t[0]).abs().max().item()
        # classes may differ only within tol of a threshold
        near = (((ref_t[0] - args[4][:, None, None]).abs() <= tol * scale)
                | ((ref_t[0] - args[5][:, None, None]).abs() <= tol * scale))
        off_band = int(((got_t[1] != ref_t[1]) & ~near).sum())
        ok = err <= tol * scale and off_band == 0
    elif name in ("battery", "gpu_floor"):
        # bitwise: the kernel takes the plain version's f32 steps in order
        # (B's target and counter are exact, and its segments' walks meet
        # the true one only where they agree bit for bit)
        err = max((g - r).abs().max().item() for g, r in zip(got_t, ref_t))
        ok = all(torch.equal(g, r) for g, r in zip(got_t, ref_t))
    elif name == "sliding":
        # amplitudes within tol of the scale; the state out holds prefix
        # sums, up to win times larger
        scale = max(x.abs().max().item(), 1e-30)
        err = (got_t[0] - ref_t[0]).abs().max().item()
        state = max((got_t[i] - ref_t[i]).abs().max().item() for i in (1, 2))
        ok = err <= tol * scale and state <= tol * scale * x.shape[-1]
    else:
        scale = max(x.abs().max().item(), 1e-30)
        err = max((g.float() - r.float()).abs().max().item()
                  for g, r in zip(got_t, ref_t))
        ok = err <= tol * scale
    ms = cuda_ms(torch, lambda: kern(*args, **kw), repeat)
    inputs = nbytes(*(a for a in args if isinstance(a, torch.Tensor)))
    per = x.numel() * (args[1].shape[0] if name in ("monitor", "sliding")
                       else 1)
    b_ms, b_by = bound(inputs + nbytes(*got_t), ops_per * per)
    return list(x.shape), err, ok, ms, plain_ms, b_ms, b_by


def check_scan(torch, cap, launches, name):
    _, args, kw = cap.args[name]
    src, rep, tname = {
        "gpu_floor": ("gpu_floor.cu",
                      "src/repro/core/smoothing/gpu_floor.py:85",
                      "gpu_floor_scan"),
        "battery": ("battery.cu", "src/repro/core/smoothing/battery.py:96",
                    "battery_scan"),
        "escalation": ("escalation.cu", "src/repro/core/telemetry.py:212",
                       "escalation_scan")}[name]
    (B, n), err, ok, ms, plain_ms, b_ms, b_by = kernel_vs_plain(
        torch, name, args, kw, repeat=3)
    tol = "exact" if name == "escalation" else "bitwise (torch.equal)"
    log(f"{name} [{B} rows x {n}]: max |kernel - plain| {err:.4g} (tol "
        f"{tol})")
    if not ok:
        raise AssertionError(f"{name} kernel disagrees with its plain "
                             "version")
    return {"name": tname, "route": "cuda",
            "source": f"src/repro_torch/kernels/scans/csrc/{src}",
            "replaces": rep, "launches": launches[name],
            "max_abs_err": err, "tolerance": tol, "shape": [B, n],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by,
            "limited_by": f"serial chain: {n} dependent steps per row",
            "library_ms": None,
            "library_note": "no single PyTorch call computes this "
                            "recurrence"}


# ---------------------------------------------------------------------------
# kernels A and D: device time, the A-vs-E witness, D's chain alone
# ---------------------------------------------------------------------------

# each kernel's function name as the profiler reports it (a substring)
DEVICE_NAME = {"monitor": "monitor_kernel", "escalation": "escalation_kernel",
               "gpu_floor": "gpu_floor_kernel", "ballast": "ballast"}
ESC_EDGE_N = 3000         # samples of the int32 range rule's edge rows


def event_device_us(e):
    """An averaged profiler event's device time in microseconds (the
    attribute's name changed across PyTorch versions)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def kernel_device_total(events, name):
    """(device ms in all, launches) of the kernels whose profiler key
    contains ``name``, over ``events`` (``key_averages()``)."""
    hits = [e for e in events if name in e.key and event_device_us(e) > 0]
    return (sum(event_device_us(e) for e in hits) / 1e3,
            sum(e.count for e in hits))


def kernel_device_ms(events, name):
    """Device ms per launch of the kernels whose profiler key contains
    ``name``, over ``events`` (``key_averages()``): their summed device
    time over their summed count.  None if no such kernel ran."""
    total, count = kernel_device_total(events, name)
    return total / count if count else None


def device_ms(torch, fn, name, repeat=20):
    """``fn()`` ``repeat`` times under ``torch.profiler`` after a warm-up:
    the device-only ms per launch of the kernel named ``name``, from the
    profiler's kernel durations (the host's time to issue the call is not
    in it).  The card's tracing has dropped every launch of kernel A (a
    cluster launch) from some profiles on some machines, and any kernel's
    from a profile now and then; so a profile that records none is taken
    again, then with device activity alone, and if all five record none
    the time is not measured (None): a measurement, not a gate."""
    return profiled(torch, fn, lambda ev: kernel_device_ms(ev, name), name,
                    repeat)


def call_device_ms(torch, fn, what, repeat=20):
    """As ``device_ms``, for every kernel that ``fn()`` launches once a
    call: the sum over those kernels of each one's device-only ms per
    recorded launch (a wrapper that launches two kernels a call is charged
    both; a launch the profiler dropped changes no mean)."""
    def per_call(events):
        # device-side events only, where the profiler marks them: a host
        # op's device time would count its kernels twice
        hits = [e for e in events if str(getattr(
            e, "device_type", "CUDA")).endswith("CUDA")
            and event_device_us(e) > 0 and e.count]
        return (sum(event_device_us(e) / e.count for e in hits) / 1e3
                if hits else None)
    return profiled(torch, fn, per_call, what, repeat)


def profiled(torch, fn, read, what, repeat):
    """``read(key_averages())`` of a profile of ``repeat`` calls of ``fn``
    after a warm-up; taken again, and then with device activity alone,
    while it reads None (``device_ms``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for activities in (both, both, [ProfilerActivity.CUDA],
                       [ProfilerActivity.CUDA], [ProfilerActivity.CUDA]):
        with profile(activities=activities) as prof:
            for _ in range(repeat):
                fn()
            torch.cuda.synchronize()
        got = read(prof.key_averages())
        if got is not None:
            return got
        log(f"the profiler recorded no launch of {what}; profiling again")
    log(f"{what}: device time not measured (the profiler recorded no "
        f"launch in five profiles)")
    return None


def chain_step(cycles, ms, steps):
    """(SM cycles a step, ns a step) of a chain probe that took ``cycles``
    SM cycles and ``ms`` by CUDA events over ``steps`` dependent steps."""
    return cycles / steps, ms / steps * 1e6


def chain_floor_ms(ns_per_step, shapes):
    """Each shape's chain floor: ns a step times a row's steps (its last
    dimension), in ms."""
    return {tag: ns_per_step * shape[-1] / 1e6 for tag, shape in
            shapes.items()}


def witness_compare(torch, a_out, e_out, n, seg0):
    """Kernel A's outputs against kernel E's on the same operands, reduced
    the way A reduces them: A's worst against the amax over bins of E's
    amplitudes, A's peaks against E's amplitudes masked to live samples
    (``win - 1 <= idx < n``) with the amax per segment, and A's state out
    against E's.  Returns {output: max |A - E|} and whether all are equal
    bit for bit."""
    worst, _, peaks, nre, nim = a_out
    amps, ere, eim = e_out
    B, S, win = worst.shape
    pos = torch.arange(win, device=worst.device)
    idx = ((seg0[:, None] + torch.arange(S, device=worst.device))[..., None]
           * win + pos)                                   # [B, S, win]
    live = (idx >= win - 1) & (idx < n[:, None, None])
    pairs = {"worst": (worst, amps.amax(-1)),
             "peaks": (peaks, torch.where(live[..., None], amps, 0.0)
                       .amax(2)),
             "nre": (nre, ere), "nim": (nim, eim)}
    gaps = {k: (a - e).abs().max().item() for k, (a, e) in pairs.items()}
    equal = all(torch.equal(a, e) for a, e in pairs.values())
    return gaps, equal


def monitor_witness(torch, args):
    """Kernel A against kernel E on A's operands (``args`` of one
    ``sliding_monitor`` call): ``witness_compare``'s gaps and verdict."""
    from repro_torch.kernels.goertzel import monitor, sliding
    xseg, cosp, sinp, rot, thr, rel, n, seg0, re0, im0 = args
    a_out = monitor.sliding_monitor(*args)
    e_out = sliding.sliding_bin_power_v2(xseg, cosp, sinp, rot, seg0, re0,
                                         im0)
    torch.cuda.synchronize()
    return witness_compare(torch, a_out, e_out, n, seg0)


def escalation_chain(torch, cls, kw, wide=False, reps=200):
    """D's chain alone (``escalation_step_cycles`` in ``escalation.cu``):
    lane 0 steps over the first 1024 classes of ``cls``, already in shared
    memory, ``reps`` times, in int32 (or, with ``wide``, int64).  Returns
    (SM cycles a step, ns a step by CUDA events)."""
    import ctypes
    from repro_torch.core import telemetry
    from repro_torch.kernels.build import ptr, stream_of
    fn = ctypes.CDLL(str(telemetry.ESCALATION_KERNEL.library_path())
                     ).escalation_step_cycles
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int] + [ctypes.c_longlong] * 3
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    cycles = torch.zeros(1, dtype=torch.int64, device=cls.device)
    sink = torch.zeros(1, dtype=torch.int64, device=cls.device)
    n = cls.shape[-1]

    def run():
        err = fn(ptr(cls), n, reps, int(wide), kw["sustain_n"], kw["cool_n"],
                 kw.get("max_level", 3), ptr(cycles), ptr(sink),
                 stream_of(cls))
        if err:
            raise RuntimeError(f"escalation_step_cycles: CUDA error {err}")
    ms = cuda_ms(torch, run, 3)
    return chain_step(cycles.item(), ms, reps * min(n, 1024))


def escalation_edges(torch, kw):
    """D's int32 range rule at its edge: all-hit rows whose ``above``
    starts one more than n short of 2^31, and n short, so the second runs
    in int64 (``telemetry.escalation_fits_int32``), never escalating
    (``max_level`` 0), with the path's other settings; each row exact
    against the plain version.  Returns the rule's verdicts per row."""
    from repro_torch.core import telemetry
    n = ESC_EDGE_N
    cls = torch.full((2, n), telemetry.CLS_HIT, dtype=torch.int8,
                     device="cuda")
    carry = telemetry.escalation_init(2, "cuda")
    carry[0, 1] = 2 ** 31 - 1 - n
    carry[1, 1] = 2 ** 31 - n
    edge = dict(kw, max_level=0)
    fits = telemetry.escalation_fits_int32(carry, n, **edge).tolist()
    got = telemetry.escalation_scan(cls, 5, carry, **edge)
    ref = telemetry.escalation_scan_plain(cls.cpu(), 5, carry.cpu(), **edge)
    equal = all(torch.equal(g.cpu(), r) for g, r in zip(got, ref))
    tops = got[0][:, 1].tolist()
    log(f"escalation int32 range rule at its edge (above0 + n = 2^31 - 1, "
        f"2^31; fits int32 {fits}): exact {equal}, above out {tops}")
    if not equal or tops != [2 ** 31 - 1, 2 ** 31] or fits != [True, False]:
        raise AssertionError("kernel D is not exact at the int32 range "
                             "rule's edge")
    return fits


def escalation_chunked(torch, args, kw):
    """D in three chunks that pass the carry on against one call, exactly."""
    from repro_torch.core import telemetry
    cls, idx0, carry = args
    n = cls.shape[1]
    whole = telemetry.escalation_scan(cls, idx0, carry, **kw)
    cuts = [0, n // 3, n // 3 + 17, n]
    parts, c = [], carry
    for lo, hi in zip(cuts, cuts[1:]):
        c, lv = telemetry.escalation_scan(cls[:, lo:hi].contiguous(),
                                          idx0 + lo, c, **kw)
        parts.append(lv)
    return (torch.equal(torch.cat(parts, 1), whole[1])
            and torch.equal(c, whole[0]))


def ad_measure(torch, study_calls, tick_calls):
    """Kernels A and D at the Study's and a control tick's shapes: CUDA-
    event ms around the wrapper and device-only ms per launch, the
    A-vs-E witness at both A shapes, and D's chain probe where the
    library has one.  ``*_calls`` map "monitor"/"escalation" to a captured
    ``(rows, args, kw)``."""
    from repro_torch.core import telemetry
    from repro_torch.kernels.goertzel import monitor
    fns = {"monitor": monitor.sliding_monitor,
           "escalation": telemetry.escalation_scan}
    ops_per = {"monitor": 21, "escalation": 14}   # as kernel_vs_plain
    out = {}
    for tag, calls in (("study", study_calls), ("tick", tick_calls)):
        for nm, fn in fns.items():
            _, args, kw = calls[nm]
            run = (lambda fn=fn, a=args, k=kw: fn(*a, **k))
            ev = cuda_ms(torch, run, 20)
            dev = device_ms(torch, run, DEVICE_NAME[nm])
            outs = run()
            x = args[0]
            per = x.numel() * (args[1].shape[0] if nm == "monitor" else 1)
            b_ms, b_by = bound(
                nbytes(*(a for a in args if isinstance(a, torch.Tensor)))
                + nbytes(*outs), ops_per[nm] * per)
            row = {"shape": list(x.shape), "event_ms": ev,
                   "device_ms": dev, "bound_ms": b_ms, "bound_by": b_by}
            if nm == "monitor":
                row["shape"].append(args[1].shape[0])
                gaps, equal = monitor_witness(torch, args)
                row["witness_vs_E"] = {"bitwise": equal, "max_abs": gaps}
            out[f"{nm}_{tag}"] = row
            dev_s = "not measured" if dev is None else f"{dev:.4g} ms"
            log(f"{nm} at {row['shape']} ({tag}): {ev:.4g} ms by CUDA "
                f"events around the wrapper, {dev_s} on the device, "
                f"bound {b_ms:.4g} ms by {b_by}"
                + (f"; vs kernel E bitwise {row['witness_vs_E']['bitwise']}"
                   f" (max |A - E| {row['witness_vs_E']['max_abs']})"
                   if nm == "monitor" else ""))
    import ctypes
    lib = ctypes.CDLL(str(telemetry.ESCALATION_KERNEL.library_path()))
    if hasattr(lib, "escalation_step_cycles"):
        _, args, kw = study_calls["escalation"]
        cyc, ns = escalation_chain(torch, args[0][:1].contiguous(), kw)
        cyc64, ns64 = escalation_chain(torch, args[0][:1].contiguous(), kw,
                                       wide=True)
        shapes = {t: out[f"escalation_{t}"]["shape"] for t in ("study",
                                                               "tick")}
        out["escalation_chain"] = {
            "cycles_per_step": cyc, "ns_per_step": ns,
            "int64_cycles_per_step": cyc64, "int64_ns_per_step": ns64,
            "floor_ms": chain_floor_ms(ns, shapes)}
        log(f"escalation chain alone: {cyc:.1f} SM cycles a step, {ns:.3f} "
            f"ns a step (int64: {cyc64:.1f}, {ns64:.3f}); floors (ms) "
            + json.dumps(out["escalation_chain"]["floor_ms"]))
    return out


# kernel A's geometries that no path here reaches: [B, S, win, K] with win
# not a multiple of 4 (4-byte copies), win past one round of shared memory,
# K past one cluster (several bins a block), and both at once
MONITOR_VARIANTS = ((2, 3, 1001, 3), (1, 3, 12000, 4), (2, 2, 600, 11),
                    (1, 3, 20000, 10))


def variant_operands(torch, B, S, win, K, seed=21, dev="cuda"):
    """Kernel A's seeded operands at one ``MONITOR_VARIANTS`` shape (a
    seeded prefix state in, row 0 in its warm-up), as the arguments of
    one ``sliding_monitor`` call."""
    import numpy as np
    from repro_torch.kernels.goertzel import ops
    rng = np.random.default_rng(seed + win + K)
    xseg = torch.as_tensor(rng.standard_normal((B, S, win)).astype(
        np.float32) * 1e3, device=dev)
    freqs = tuple(0.05 + 0.37 * i for i in range(K))
    cosp, sinp, rot = (torch.as_tensor(t, device=dev) for t in
                       ops.phase_tables(freqs, DT, win))
    re0, im0 = (torch.as_tensor(rng.standard_normal((B, K, win)).astype(
        np.float32), device=dev) for _ in range(2))
    seg0 = torch.as_tensor(rng.integers(0, 3, B), device=dev)
    seg0[0] = 0
    n = seg0 * win + S * win - win // 3
    thr = torch.full((B,), 2e3, device=dev)
    return (xseg, cosp, sinp, rot, thr, thr * 0.6, n, seg0, re0, im0)


def monitor_variants(torch, seed=21, dev="cuda"):
    """Kernel A at ``MONITOR_VARIANTS`` on seeded operands
    (``variant_operands``): within ``MONITOR_TOL`` of its plain
    version with no class mismatch off the threshold band, equal to
    kernel E by the witness, and two chunked calls that pass the state on
    equal to one call, bit for bit.  Returns one summary per shape."""
    from repro_torch.kernels.goertzel import monitor
    out = []
    for B, S, win, K in MONITOR_VARIANTS:
        args = variant_operands(torch, B, S, win, K, seed, dev)
        xseg, cosp, sinp, rot, thr, _, n, seg0, re0, im0 = args
        got = monitor.sliding_monitor(*args)
        ref = monitor.sliding_monitor_plain(*args)
        scale = xseg.abs().max().item()
        err = (got[0] - ref[0]).abs().max().item() / scale
        near = (((ref[0] - thr[:, None, None]).abs() <= MONITOR_TOL * scale)
                | ((ref[0] - 0.6 * thr[:, None, None]).abs()
                   <= MONITOR_TOL * scale))
        off_band = int(((got[1] != ref[1]) & ~near).sum())
        gaps, equal = monitor_witness(torch, args)
        part1 = monitor.sliding_monitor(xseg[:, :1].contiguous(), cosp, sinp,
                                        rot, thr, thr * 0.6, n, seg0, re0,
                                        im0)
        part2 = monitor.sliding_monitor(xseg[:, 1:].contiguous(), cosp, sinp,
                                        rot, thr, thr * 0.6, n, seg0 + 1,
                                        part1[3], part1[4])
        chunked = all(torch.equal(torch.cat([part1[i], part2[i]], 1), got[i])
                      for i in range(3)) and torch.equal(part2[3], got[3])
        log(f"monitor [{B} x {S} x {win}, K={K}]: {err:.3g} of the scale "
            f"from the plain version, class mismatches off the band "
            f"{off_band}; vs kernel E bitwise {equal}; chunked bitwise "
            f"{chunked}")
        if err > MONITOR_TOL or off_band or not equal or not chunked:
            raise AssertionError(f"kernel A fails at [{B} x {S} x {win}, "
                                 f"K={K}]: {gaps}")
        out.append({"shape": [B, S, win, K], "err_of_scale": err,
                    "witness_bitwise": equal, "chunked_bitwise": chunked})
    return out


def ad_gates(torch, study_calls, ad):
    """A equal to E bit for bit by the witness at both shapes; D exact at
    the int32 rule's edge and in chunks at the Study's shape."""
    for tag in ("study", "tick"):
        w = ad[f"monitor_{tag}"]["witness_vs_E"]
        if not w["bitwise"]:
            raise AssertionError(f"kernel A differs from kernel E at the "
                                 f"{tag} shape: {w['max_abs']}")
    _, args, kw = study_calls["escalation"]
    ad["escalation_int32_edge"] = escalation_edges(torch, kw)
    chunked = escalation_chunked(torch, args, kw)
    log(f"escalation [{args[0].shape[0]} x {args[0].shape[1]}] in 3 chunks "
        f"that carry the state on vs one call: exact {chunked}")
    if not chunked:
        raise AssertionError("chunked escalation calls differ from one call")
    ad["escalation_chunked_exact"] = chunked


def ad_rows(kernels, ad):
    """A's and D's rows of the kernels line: both shapes with their event
    and device ms, the witness, D's chain floor."""
    for name, nm in (("sliding_monitor", "monitor"),
                     ("escalation_scan", "escalation")):
        row = next(k for k in kernels if k["name"] == name)
        row["shapes"] = {t: ad[f"{nm}_{t}"] for t in ("study", "tick")}
        row["device_ms"] = ad[f"{nm}_study"]["device_ms"]
    next(k for k in kernels if k["name"] == "sliding_monitor")[
        "other_geometries"] = ad["monitor_variants"]
    d = next(k for k in kernels if k["name"] == "escalation_scan")
    chain = ad["escalation_chain"]
    d.update({"chain_cycles_per_step": chain["cycles_per_step"],
              "chain_ns_per_step": chain["ns_per_step"],
              "chain_int64_cycles_per_step": chain["int64_cycles_per_step"],
              "chain_floor_ms": chain["floor_ms"],
              "int32_edge_fits": ad["escalation_int32_edge"],
              "chunked_exact": ad["escalation_chunked_exact"]})


# ---------------------------------------------------------------------------
# kernels E, I and H alone: each path's shapes, E and I against A and E
# ---------------------------------------------------------------------------

def e_operands(monitor_args):
    """Kernel E's operands from kernel A's (one ``sliding_monitor`` call)."""
    xseg, cosp, sinp, rot, _, _, _, seg0, re0, im0 = monitor_args
    return (xseg, cosp, sinp, rot, seg0, re0, im0)


def sliding_geometry(win, K):
    """The tree's geometry for kernels E and I at ``win`` and ``K``
    (``sliding.sliding_route``) as a dict, or None in a tree without it."""
    from repro_torch.kernels.goertzel import sliding
    route = getattr(sliding, "sliding_route", None)
    return None if route is None else route(win, K)._asdict()


def timed_call(torch, fn, tensors, nops, what):
    """CUDA-event ms of ``fn()`` around the wrapper, device-only ms per call
    of every kernel it launches, and the bound of its work (``tensors``:
    its operands and outputs, each counted once)."""
    b_ms, b_by = bound(nbytes(*tensors), nops)
    return {"event_ms": cuda_ms(torch, fn, 20),
            "device_ms": call_device_ms(torch, fn, what),
            "bound_ms": b_ms, "bound_by": b_by}


def sliding_measure(torch, study_monitor_args, w, dt, w_long, dt_long):
    """Kernel E at the canonical loop's and the 600 s replay's
    counterfactual shapes, at A's Study shape and at the four
    ``MONITOR_VARIANTS`` (there against A by the witness); kernel I at
    phase 15's shape, warm-up scaled against E; kernel H at phase 15's
    four shapes (``windows_measure``).  Each: event ms, device ms and
    bound, with the tree's geometry.  A measurement; the gates are
    elsewhere."""
    from repro_torch.core.telemetry import warmup_scale
    from repro_torch.kernels.goertzel import sliding, sliding_v1
    e_shapes = {"loop": (sliding_args(torch, w, dt), None),
                "replay": (sliding_args(torch, w_long, dt_long), None),
                "study": (e_operands(study_monitor_args),
                          study_monitor_args)}
    for B, S, win, K in MONITOR_VARIANTS:
        a = variant_operands(torch, B, S, win, K)
        e_shapes[f"{B}x{S}x{win}_K{K}"] = (e_operands(a), a)
    out = {"E": {}}
    for tag, (args, a_args) in e_shapes.items():
        B, S, win = args[0].shape
        K = args[1].shape[0]
        outs = sliding.sliding_bin_power_v2(*args)
        row = {"shape": [B, S, win, K], **timed_call(
            torch, lambda a=args: sliding.sliding_bin_power_v2(*a),
            (*args, *outs), SLIDING_OPS * B * S * win * K, "kernel E"),
            "geometry": sliding_geometry(win, K)}
        if a_args is not None:
            gaps, equal = monitor_witness(torch, a_args)
            row["witness_vs_A"] = {"bitwise": equal, "max_abs": gaps}
        out["E"][tag] = row
        log(f"sliding (E) {tag} {row['shape']}: {row['event_ms']:.4g} ms by "
            f"events, {row['device_ms']} ms on the device, bound "
            f"{row['bound_ms']:.4g} ms; geometry {row['geometry']}"
            + (f"; A vs E bitwise {row['witness_vs_A']['bitwise']}"
               if a_args is not None else ""))
    xseg, tabs = v1_operands(torch, w_long, dt_long)
    S, win = xseg.shape
    K = tabs[0].shape[1]
    got = sliding_v1.sliding_goertzel_v1(xseg, *tabs)
    e = sliding.sliding_bin_power_v2(*e_shapes["replay"][0])[0][0]
    scaled = got * warmup_scale(torch.arange(S * win, device=DEVICE),
                                win).reshape(S, win, 1)
    out["I"] = {"shape": [S, win, K], **timed_call(
        torch, lambda: sliding_v1.sliding_goertzel_v1(xseg, *tabs),
        (xseg, *tabs, got), SLIDING_OPS * S * win * K, "kernel I"),
        "geometry": sliding_geometry(win, K),
        "scaled_vs_E_bitwise": torch.equal(scaled, e),
        "scaled_vs_E_max_abs": (scaled - e).abs().max().item()}
    log(f"sliding_v1 (I) {out['I']['shape']}: {out['I']['event_ms']:.4g} ms "
        f"by events, {out['I']['device_ms']} ms on the device; warm-up "
        f"scaled vs E bitwise {out['I']['scaled_vs_E_bitwise']} (max abs "
        f"{out['I']['scaled_vs_E_max_abs']:.4g})")
    out["H"] = windows_measure(torch, w, dt, w_long, dt_long)
    return out


WINDOWS_REPS = 200        # passes of H's chain probe
SM_SMEM = 233_472         # an H100 SM's shared memory (228 KB)
BLOCK_RESERVED_SMEM = 1024  # what the card keeps of it for each block


def windows_geometry(W, win, K):
    """The tree's geometry for kernel H at ``[W, win]``, K
    (``windows.windows_route``) as a dict, or None in a tree without it."""
    from repro_torch.kernels.goertzel import windows
    route = getattr(windows, "windows_route", None)
    return None if route is None else route(W, win, K)._asdict()


def windows_chain(torch, wnd, coef, reps=WINDOWS_REPS):
    """H's chain alone (``goertzel_step_cycles`` in ``windows.cu``): lane 0
    walks bin 0's chain over the first 2048 samples of window 0 (cut to a
    multiple of 32), staged in shared memory, ``reps`` times with the
    kernel's own walk.  Returns (SM cycles a step, ns a step by CUDA
    events), or None where the library has no probe."""
    import ctypes
    from repro_torch.kernels.build import ptr, stream_of
    from repro_torch.kernels.goertzel import windows
    lib = ctypes.CDLL(str(windows.WINDOWS_KERNEL.library_path()))
    if not hasattr(lib, "goertzel_step_cycles"):
        return None
    fn = lib.goertzel_step_cycles
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    cycles = torch.zeros(1, dtype=torch.int64, device=wnd.device)
    sink = torch.zeros(1, device=wnd.device)
    n = wnd.shape[1]

    def run():
        err = fn(ptr(wnd), ptr(coef), n, reps, ptr(cycles), ptr(sink),
                 stream_of(wnd))
        if err:
            raise RuntimeError(f"goertzel_step_cycles: CUDA error {err}")
    ms = cuda_ms(torch, run, 3)
    return chain_step(cycles.item(), ms, reps * (min(n, 2048) // 32 * 32))


def day_tiled(base_call, base, day):
    """Kernel H on the 600 s call's windows (less its pad rows) tiled as
    "day" tiles its trace, and that call's output tiled the same way:
    equal bit for bit where every route walks each chain in the same
    steps.  ``base`` and ``day`` are the two traces' (trace, dt, win)."""
    from repro_torch.kernels.goertzel import windows
    wnd, coef, block_w, raw = base_call
    (x, _, win), (x_day, _, _) = base, day
    W0, tiles = len(x) // win, len(x_day) // len(x)
    got = windows.goertzel_windows(wnd[:W0].repeat(tiles, 1), coef,
                                   block_w=block_w)
    return got, raw[:W0].repeat(tiles, 1)


def windows_measure(torch, w, dt, w_long, dt_long):
    """Kernel H at phase 15's four shapes: event and device ms, the bound
    and the tree's route; on the three traces whether it equals the plain
    version (on the card) bit for bit, at "day" whether the 600 s windows
    tiled give the 600 s output tiled, and, where the tree has routes,
    "day" again with persistent blocks; then the chain probe, where the
    library has one, and each shape's chain floor.  A measurement; the
    gates are in phase 15."""
    from repro_torch.kernels.goertzel import windows
    traces = phase15_traces(w, dt, w_long, dt_long)
    _, calls = bin_power_calls(traces)
    shapes = {}
    for name, (wnd, coef, block_w, raw) in zip(traces, calls):
        W, n = wnd.shape
        K = coef.shape[0]
        row = {"shape": [W, n, K], "geometry": windows_geometry(W, n, K),
               **timed_call(
                   torch, lambda a=(wnd, coef, block_w):
                   windows.goertzel_windows(a[0], a[1], block_w=a[2]),
                   (wnd, coef, raw), GOERTZEL_OPS * W * n * K, "kernel H")}
        if name == "day":
            got, want = day_tiled(calls[0], traces["600s"], traces["day"])
            row["tiled_bitwise"] = torch.equal(got, want)
        else:
            row["bitwise_vs_plain"] = torch.equal(
                raw, windows.goertzel_windows_plain(wnd, coef,
                                                    block_w=block_w))
        shapes[name] = row
        log(f"goertzel_windows (H) {name} {row['shape']}: "
            f"{row['event_ms']:.4g} ms by events, {row['device_ms']} ms on "
            f"the device, bound {row['bound_ms']:.4g} ms; route "
            f"{row['geometry']}; "
            + (f"600 s windows tiled bitwise {row['tiled_bitwise']}"
               if name == "day" else
               f"bitwise vs plain {row['bitwise_vs_plain']}"))
    out = {"shapes": shapes}
    if hasattr(windows, "launch_route"):
        wnd, coef, _, raw = calls[-1]
        route = windows.windows_route(*wnd.shape, coef.shape[0])
        per_sm = min(32, 64 // route.warps,
                     SM_SMEM // (route.smem_bytes + BLOCK_RESERVED_SMEM))
        persistent = route._replace(blocks=windows.SMS * per_sm)
        got = windows.launch_route(wnd, coef, persistent)
        out["day_persistent"] = {
            "geometry": persistent._asdict(),
            "bitwise_vs_route": torch.equal(got, raw), **timed_call(
                torch, lambda: windows.launch_route(wnd, coef, persistent),
                (wnd, coef, raw), GOERTZEL_OPS * wnd.numel() * coef.shape[0],
                "kernel H")}
        log(f"goertzel_windows (H) day, persistent {persistent}: "
            f"{out['day_persistent']['event_ms']:.4g} ms by events, "
            f"{out['day_persistent']['device_ms']} ms on the device; bitwise "
            f"vs the route's blocks {out['day_persistent']['bitwise_vs_route']}")
    chain = windows_chain(torch, calls[0][0], calls[0][1])
    if chain is not None:
        cyc, ns = chain
        floors = chain_floor_ms(ns, {t: r["shape"][:2]
                                     for t, r in shapes.items()})
        for t, r in shapes.items():
            r["chain_floor_ms"] = floors[t]
        out["chain"] = {"cycles_per_step": cyc, "ns_per_step": ns}
        log(f"goertzel_windows chain alone: {cyc:.2f} SM cycles a step, "
            f"{ns:.4f} ns a step; chain floors (ms) " + json.dumps(floors))
    return out


# ---------------------------------------------------------------------------
# kernels B and G: each path's shapes, B's chain and merges, G's routes
# ---------------------------------------------------------------------------

FLOOR_OPS = 11            # f32 operations per sample, kernel B
FLOOR_SEG = 64            # samples a lane walks in a tile (gpu_floor.cu kSeg)
FLOOR_LANES = 32          # segments a tile: one warp's lanes
FLOOR_REPS = 200          # passes of B's chain probe
IDLE_STUCK = 2 ** 24      # where the f32 idle counter stops counting
BALLAST_SEED = 15         # phase 15's burn
BALLAST_SHAPE = (1024, 256, 256)


def floor_calls_in(torch, control, api, w, dt, device="cuda"):
    """Kernel B's calls in one ``watch_trace`` run of ``w`` on ``device``:
    a clone of each call's ``(w, params)``, in order."""
    from repro_torch.core.smoothing import gpu_floor
    real = gpu_floor.gpu_floor_scan
    calls = []

    def spy(w_, params):
        calls.append((w_.clone(), params.clone()))
        return real(w_, params)
    gpu_floor.gpu_floor_scan = spy
    try:
        run_watch(torch, control, api, w, dt, device)
    finally:
        gpu_floor.gpu_floor_scan = real
    return calls


def shape_counts(calls):
    """{"B x n": calls of that shape}, in order of first call."""
    out = {}
    for w, _ in calls:
        key = " x ".join(str(d) for d in w.shape)
        out[key] = out.get(key, 0) + 1
    return out


def floor_targets(torch, w, params):
    """Kernel B's targets t for ``w`` ``[B, n]``, every sample at once, as
    the kernel takes them off the chain: the f32 idle counter in closed
    form, min(i - last_active(i), 2^24) with last_active -1 before the
    first active sample, then the floor and the cap."""
    mpf, thresh, _, _, stop_n, cap = (c[:, None] for c in params.unbind(-1))
    idx = torch.arange(w.shape[1], device=w.device)
    last = torch.where(w > thresh, idx, -1).cummax(dim=1).values
    idle = (idx - last).clamp(max=IDLE_STUCK).to(torch.float32)
    floor = torch.where(idle <= stop_n, mpf, torch.zeros_like(mpf))
    return torch.minimum(torch.maximum(w, floor), cap)


def merge_profile(torch, w, params, out, seg=FLOOR_SEG):
    """How kernel B's speculative walks meet the true one: each segment of
    ``seg`` samples (a lane's share of a tile) walked from its own first
    target, against ``out``, the true outputs.  A segment merges at the
    first step where the two agree bit for bit (from there on they
    agree).  Returns the segment count, how many merge at step 0, the
    latest merge among those that do, and how many do not merge within
    their segment (each of those costs the kernel further rounds)."""
    import torch.nn.functional as F
    ru, rd = params[:, 2:3, None], params[:, 3:4, None]
    B, n = w.shape
    S = -(-n // seg)
    pad = S * seg - n
    t = F.pad(floor_targets(torch, w, params), (0, pad)).reshape(B, S, seg)
    true = F.pad(out, (0, pad)).reshape(B, S, seg).view(torch.int32)
    live = (torch.arange(S * seg, device=w.device) < n).reshape(1, S, seg)
    o = t[:, :, :1]
    first = torch.full((B, S, 1), seg, dtype=torch.int64, device=w.device)
    for m in range(seg):
        o = torch.minimum(torch.maximum(t[:, :, m:m + 1], o - rd), o + ru)
        meet = (o.view(torch.int32) == true[:, :, m:m + 1]) & live[:, :, m:m + 1]
        first = torch.where(meet & (first == seg), m, first)
    merged = first < seg
    return {"segments": B * S, "merged_at_0": int((first == 0).sum()),
            "longest_merge": int(first[merged].max()) if merged.any() else None,
            "unmerged": int((~merged).sum())}


def floor_floors(ns_step, n, merges, seg=FLOOR_SEG, lanes=FLOOR_LANES):
    """Kernel B's chain floors for a row of ``n`` samples at ``ns_step``
    ns a step, in ms: serial, n steps; segmented, each tile's lane walks
    its ``seg`` samples and then, in the first round, to its latest merge
    (``merges`` from ``merge_profile``).  None for the segmented floor if a
    segment did not merge: then rounds follow, up to one a segment."""
    serial = ns_step * n / 1e6
    if merges["unmerged"] or merges["longest_merge"] is None:
        return serial, None
    tiles = -(-n // (seg * lanes))
    return serial, ns_step * tiles * (seg + merges["longest_merge"] + 1) / 1e6


def floor_chain(torch, w, params, reps=FLOOR_REPS):
    """B's chain alone (``gpu_floor_step_cycles`` in ``gpu_floor.cu``): lane
    0 walks o over the targets of the first 2048 samples of row 0 (cut to
    a multiple of 4), already in shared memory, ``reps`` times, as the
    kernel's walks do.  Returns (SM cycles a step, ns a step by CUDA
    events)."""
    import ctypes
    from repro_torch.core.smoothing import gpu_floor
    from repro_torch.kernels.build import ptr, stream_of
    fn = ctypes.CDLL(str(gpu_floor.GPU_FLOOR_KERNEL.library_path())
                     ).gpu_floor_step_cycles
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cycles = torch.zeros(1, dtype=torch.int64, device=w.device)
    sink = torch.zeros(1, device=w.device)
    n = w.shape[-1]

    def run():
        err = fn(ptr(w), ptr(params), n, reps, ptr(cycles), ptr(sink),
                 stream_of(w))
        if err:
            raise RuntimeError(f"gpu_floor_step_cycles: CUDA error {err}")
    ms = cuda_ms(torch, run, 3)
    return chain_step(cycles.item(), ms,
                      reps * (min(n, FLOOR_SEG * FLOOR_LANES) // 4 * 4))


def floor_plain(torch, w, params, on_cpu):
    """B's plain version on ``w`` (on the CPU if ``on_cpu``), back on
    ``w``'s device, and its ms."""
    from repro_torch.core.smoothing import gpu_floor
    if not on_cpu:
        ref, ms = timed_once(
            torch, lambda: gpu_floor.gpu_floor_scan_plain(w, params))
        return ref, ms
    t0 = time.perf_counter()
    ref = gpu_floor.gpu_floor_scan_plain(w.cpu(), params.cpu())
    return ref.to(w.device), (time.perf_counter() - t0) * 1e3


def floor_case(torch, w, params, tag, reps=20):
    """Kernel B at one call: event and device ms, its bound, and how its
    segments merge, against its own outputs (the gates that hold those
    equal to the plain version's are elsewhere)."""
    from repro_torch.core.smoothing import gpu_floor
    run = (lambda: gpu_floor.gpu_floor_scan(w, params))
    got = run()
    row = {"shape": list(w.shape),
           "merges": merge_profile(torch, w, params, got),
           "event_ms": cuda_ms(torch, run, reps),
           "device_ms": device_ms(torch, run, DEVICE_NAME["gpu_floor"],
                                  repeat=reps)}
    row["bound_ms"], row["bound_by"] = bound(nbytes(w, params, got),
                                             FLOOR_OPS * w.numel())
    dev = row["device_ms"]
    log(f"gpu_floor {tag} {row['shape']}: {row['event_ms']:.4g} ms by CUDA "
        f"events, " + ("device not measured" if dev is None else
                       f"{dev:.4g} ms on the device")
        + f", bound {row['bound_ms']:.4g} ms by {row['bound_by']}; merges "
        + json.dumps(row["merges"]))
    return row


def floor_rows(torch, kind, n, seed):
    """Seeded rows no path gives kernel B.  "no_merge": a square wave
    between 200 and 1400 W against ramps of 3 mW a step, so no walk
    reaches its target and no segment's walks meet.  "edges": samples on
    the threshold exactly (not active), a fractional stop delay, a cap
    below the floor and ramps of 0: each output is the row's first sample
    and each speculative walk holds its first target."""
    import numpy as np
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    if kind == "no_merge":
        w = np.where((i // 997) % 2 == 0, 1400.0, 200.0) + rng.uniform(
            -5.0, 5.0, n)
        params = [700.0, 350.0, 0.003, 0.003, 20.5, 1500.0]
    else:
        w = rng.choice(np.array([100.0, 350.0, 600.0, 900.0]), n)
        w[::7] = 350.0
        params = [700.0, 350.0, 0.0, 0.0, 12.75, 650.0]
    return (torch.as_tensor(w.astype(np.float32), device=DEVICE)[None],
            torch.tensor([params], dtype=torch.float32, device=DEVICE))


def floor_measure(torch, study_call, loop_call, replay_calls,
                  replay_plain=False):
    """Kernel B at the Study's, the canonical loop's and the 600 s
    replay's shapes: event and device ms, bound and merges, and with
    ``replay_plain`` every replay call bitwise against the plain version
    (their rows stacked, padded at the end, in one call on the CPU); then
    its chain probe, where the library has one, and each shape's floors."""
    import ctypes
    import torch.nn.functional as F
    from repro_torch.core.smoothing import gpu_floor
    longest = max(replay_calls, key=lambda c: c[0].numel())
    out = {"study": floor_case(torch, *study_call, "study"),
           "loop": floor_case(torch, *loop_call, "loop"),
           "replay": floor_case(torch, *longest, "replay, longest call")}
    rep = {"calls": len(replay_calls), "shapes": shape_counts(replay_calls)}
    if replay_plain:
        # every row of every call, padded at the end to the longest: the
        # plain version's outputs on a row's samples do not depend on
        # what follows them
        n = max(w.shape[1] for w, _ in replay_calls)
        stack = torch.cat([F.pad(w, (0, n - w.shape[1]))
                           for w, _ in replay_calls])
        params = torch.cat([p for _, p in replay_calls])
        ref, plain_ms = floor_plain(torch, stack, params, on_cpu=True)
        equal, r0 = True, 0
        for w, p in replay_calls:
            got = gpu_floor.gpu_floor_scan(w, p)
            equal = equal and torch.equal(
                got, ref[r0:r0 + w.shape[0], :w.shape[1]])
            r0 += w.shape[0]
        rep.update({"bitwise": equal, "plain_ms_stacked_cpu": plain_ms,
                    "stacked_rows": r0})
        log(f"gpu_floor replay: {len(replay_calls)} calls "
            + json.dumps(rep["shapes"]) + f"; every call bitwise {equal} "
            f"against the plain version ({r0} rows stacked on the CPU, "
            f"{plain_ms:.0f} ms)")
    out["replay_calls"] = rep
    lib = ctypes.CDLL(str(gpu_floor.GPU_FLOOR_KERNEL.library_path()))
    if hasattr(lib, "gpu_floor_step_cycles"):
        w, p = study_call
        cyc, ns = floor_chain(torch, w[:1].contiguous(), p[:1].contiguous())
        floors = {}
        for tag in ("study", "loop", "replay"):
            serial, seg = floor_floors(ns, out[tag]["shape"][1],
                                       out[tag]["merges"])
            floors[tag] = {"serial_ms": serial, "segmented_ms": seg}
        out["chain"] = {"cycles_per_step": cyc, "ns_per_step": ns,
                        "floor_ms": floors}
        log(f"gpu_floor chain alone: {cyc:.1f} SM cycles a step, {ns:.3f} "
            f"ns a step; floors (ms) " + json.dumps(floors))
    return out


FLOOR_ROW_N = 6151        # the seeded rows' length: a tile and a ragged one


def floor_seeded(torch):
    """Kernel B on the two seeded rows of ``floor_rows`` (one call, [2 x
    6151]: 16-byte copies do not apply, and the last tile is ragged),
    bitwise against the plain version on the CPU; then the worst case
    timed at the Study's shape, every row the no-merge row."""
    from repro_torch.core.smoothing import gpu_floor
    rows = [floor_rows(torch, kind, FLOOR_ROW_N, 22)
            for kind in ("no_merge", "edges")]
    w = torch.cat([r[0] for r in rows])
    p = torch.cat([r[1] for r in rows])
    got = gpu_floor.gpu_floor_scan(w, p)
    ref, _ = floor_plain(torch, w, p, on_cpu=True)
    out = {"shape": list(w.shape), "bitwise": torch.equal(got, ref),
           "merges": {kind: merge_profile(torch, w[i:i + 1], p[i:i + 1],
                                          ref[i:i + 1])
                      for i, kind in enumerate(("no_merge", "edges"))}}
    log(f"gpu_floor seeded rows [2 x {FLOOR_ROW_N}] (no merge; ties, "
        f"fractional stop delay, cap < floor, ramps 0): bitwise "
        f"{out['bitwise']} against the plain version; merges "
        + json.dumps(out["merges"]))
    if not out["bitwise"]:
        raise AssertionError("kernel B differs from its plain version on "
                             "the seeded rows")
    wn, pn = floor_rows(torch, "no_merge", 90000, 23)
    out["worst_case"] = floor_case(torch, wn.repeat(192, 1).contiguous(),
                                   pn.repeat(192, 1).contiguous(),
                                   "worst case (no segment merges)")
    return out


def floor_row(kernels, b_extra, replay_launches):
    """B's row of the kernels line: its three paths' shapes with their
    event and device ms and merges, the replay's calls, the seeded rows,
    the worst case, its chain and floors, and its registers."""
    from repro_torch.core.smoothing.gpu_floor import GPU_FLOOR_KERNEL
    row = next(k for k in kernels if k["name"] == "gpu_floor_scan")
    row.update({
        "device_ms": b_extra["study"]["device_ms"],
        "shapes": {t: b_extra[t] for t in ("study", "loop", "replay")},
        "replay_calls": dict(b_extra["replay_calls"],
                             launches=replay_launches),
        "seeded_rows": b_extra["seeded"],
        "chain_cycles_per_step": b_extra["chain"]["cycles_per_step"],
        "chain_ns_per_step": b_extra["chain"]["ns_per_step"],
        "chain_floor_ms": b_extra["chain"]["floor_ms"],
        "ptxas": ptxas_summary(GPU_FLOOR_KERNEL)})
    row["limited_by"] = ("the chain of o: rounds of a tile's segments until "
                         "their walks meet")


def ballast_timing(torch, a, b, n_iter, route=None):
    """Kernel G on ``(a, b, n_iter)``: event and device ms and TFLOP/s,
    through ``ballast`` or, with ``route``, that route's launch."""
    from repro_torch.kernels.ballast import ballast, ops
    run = ((lambda: ballast.ballast(a, b, n_iter)) if route is None else
           (lambda: ballast.launch_route(a, b, n_iter, 0.999, route)))
    ev = cuda_ms(torch, run, 3)
    dev = device_ms(torch, run, DEVICE_NAME["ballast"])
    flops = ops.ballast_flops(a.shape[0], a.shape[1], b.shape[1], n_iter)
    return {"shape": list(a.shape) + [b.shape[1]], "n_iter": n_iter,
            "route": route or (ballast.ballast_route(b.shape[1])
                               if hasattr(ballast, "ballast_route")
                               else "stream"),
            "event_ms": ev, "device_ms": dev,
            "tflops": flops / (dev or ev) * 1e-9}


def ballast_measure(torch):
    """Kernel G at phase 15's burn, timed alone (and, where the library
    has two routes, its streaming route at the same shape)."""
    from repro_torch.kernels.ballast import ballast, ops
    m, k, n = BALLAST_SHAPE
    n_iter = max(int(BALLAST_GFLOPS * 1e9 / (2.0 * m * k * n)), 1)
    a, b = ops._tiles(torch.Generator(device=DEVICE).manual_seed(
        BALLAST_SEED), m, k, n, torch.float32, DEVICE)
    out = {"burn": ballast_timing(torch, a, b, n_iter)}
    if hasattr(ballast, "launch_route"):
        out["burn_stream"] = ballast_timing(torch, a, b, n_iter, "stream")
    for tag, r in out.items():
        dev = r["device_ms"]
        log(f"ballast {tag} {r['shape']} x{n_iter} ({r['route']} route): "
            f"{r['event_ms']:.4g} ms by CUDA events, "
            + ("device not measured" if dev is None else
               f"{dev:.4g} ms on the device")
            + f", {r['tflops']:.2f} TFLOP/s")
    return out


# ---------------------------------------------------------------------------
# the Study, profiled, and its CPU subset
# ---------------------------------------------------------------------------

def profile_device(torch, run, top_n=12, totals=None):
    """Run ``run()`` once under ``torch.profiler``: its wall time, the
    device busy time inside it, and the ``top_n`` device operations as
    ``(ms, calls, name)``.  Busy over this same run's traced wall is the
    device busy share.  ``totals``, a dict of kernel names, gets each
    name's ``kernel_device_total`` in this run."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    if not events:
        events = list(prof.key_averages())

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, attr, None)
            if v is not None:
                return float(v)
        return 0.0

    events = [e for e in events if dev_us(e) > 0]
    for name in totals or {}:
        totals[name] = kernel_device_total(events, name)
    busy = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:top_n]
    return wall, busy, [(dev_us(e) / 1e3, e.count, e.key) for e in top]


def cpu_subset_study(api):
    """Phase 6's 16 rows of phase 5's Study, on the CPU."""
    return build_study(api, workloads=["dense_1s", "dense_3s"],
                       fleets=(32768,),
                       configs=["none", "mpf75+bat8MJ", "bs8",
                                "mpf75+bat8MJ+bs8"], device="cpu")


def cpu_subset_job(torch, path_out):
    """Phase 6's CPU half (``chip_smoke.py --cpu-subset OUT``): the 16 rows
    on the CPU's plain versions, on 4 threads at a low CPU priority; saves
    their records and seconds as JSON."""
    from repro_torch import api
    os.nice(10)
    torch.set_num_threads(4)
    sub = cpu_subset_study(api)
    t0 = time.perf_counter()
    res = sub.run()
    secs = time.perf_counter() - t0
    with open(path_out, "w") as fh:
        json.dump({"records": [dict(r) for r in res], "secs": secs}, fh,
                  default=lambda o: o.item() if hasattr(o, "item") else
                  list(o))
    return 0


def cpu_subset_start():
    """Phase 6's worker (``cpu_subset_job``), started after phase 5; its
    records are compared at the end (``compare_cpu_subset``)."""
    work = os.path.join(HERE, "build", "phase6_cpu")
    os.makedirs(work, exist_ok=True)
    stem = os.path.join(work, "rows")
    for ext in (".json", ".log"):
        if os.path.exists(stem + ext):
            os.remove(stem + ext)
    logf = open(stem + ".log", "w")
    job = {"stem": stem, "log": logf, "t0": time.perf_counter(),
           "proc": subprocess.Popen(
               [sys.executable, os.path.abspath(__file__), "--cpu-subset",
                stem + ".json"], cwd=HERE, stdout=logf,
               stderr=subprocess.STDOUT)}
    atexit.register(stop_worker, job)
    return job


def compare_cpu_subset(api, gpu_res, job, timeout=900):
    """Phase 6, gated: the worker's 16 CPU rows against the card's records
    of the same rows (STUDY_RTOL), verdicts equal off the limits."""
    t_wait = time.perf_counter()
    try:
        rc = job["proc"].wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"phase 6's CPU worker took more than {timeout}"
                             " s") from None
    finally:
        stop_worker(job)
    if rc != 0:
        with open(job["stem"] + ".log") as f:
            raise AssertionError(f"phase 6's CPU worker exited {rc}: "
                                 + f.read()[-2000:])
    waited = time.perf_counter() - t_wait
    with open(job["stem"] + ".json") as fh:
        out = json.load(fh)
    cpu_res, secs = out["records"], out["secs"]
    key = ("workload", "n_chips", "config", "seed", "spec")
    gpu = {tuple(r[k] for k in key): r for r in gpu_res}
    sub = cpu_subset_study(api)
    specs = dict(zip(SPEC_NAMES, (s for _, s in sub.specs)))
    limit_of = {"max_ramp_up_w_per_s": "ramp_up_w_per_s",
                "max_ramp_down_w_per_s": "ramp_down_w_per_s",
                "dynamic_range_w": "dynamic_range_w",
                "band_energy_fraction": "max_energy_fraction",
                "ac_rms_frac": "min_ac_rms_frac"}
    worst, near, equal = 0.0, 0, 0
    for c in cpu_res:
        g = gpu[tuple(c[k] for k in key)]
        vals = [(k, c[k], g[k]) for k in (
            "mean_mw", "swing_mw", "swing_mitigated_mw", "energy_overhead",
            "paper_band_frac")]
        vals += [(k, v, g["metrics"][k]) for k, v in c["metrics"].items()]
        for k, a, b in vals:
            # means, sums and the ramp box are float64 on both devices and
            # the scans bitwise equal: no absolute allowance but the energy's
            atol = 1e-6 if k == "energy_overhead" else 0.0
            if abs(a - b) > STUDY_RTOL * abs(b) + atol:
                raise AssertionError(f"cpu vs card: {k} {a} vs {b} in {c}")
            worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
        lim = specs[c["spec"]].limits()
        if any(abs(v - lim[limit_of[k]]) <= STUDY_RTOL * abs(lim[limit_of[k]])
               for k, v in g["metrics"].items() if k in limit_of):
            near += 1
            continue
        if (c["spec_ok"], tuple(c["violations"])) != (
                g["spec_ok"], tuple(g["violations"])):
            raise AssertionError(f"cpu vs card verdicts differ: {c} {g}")
        equal += 1
    log(f"cpu re-run of {sub.n_rows} rows: {secs:.1f} s in a worker beside "
        f"phases 18 and 7-10 (waited {waited:.1f} s for it at the end); "
        f"verdicts equal on {equal} records, {near} near-limit records not "
        f"compared; worst metric rel diff {worst:.3g} (rtol {STUDY_RTOL}, "
        "energy_overhead abs 1e-6)")


# ---------------------------------------------------------------------------
# the control loop: watch_trace on the canonical ramp and a long replay
# ---------------------------------------------------------------------------

def control_trace(control, long=False):
    """(trace, dt): the canonical 48 s ramp at 2 ms, or a 10-minute 1 kHz
    telemetry archive ramping from 60 s to 300 s."""
    if long:
        return control.synthesize_ramp(duration_s=600.0, dt=0.001,
                                       ramp_start_s=60.0,
                                       ramp_end_s=300.0), 0.001
    return control.synthesize_ramp(dt=CONTROL_DT), CONTROL_DT


def run_watch(torch, control, api, w, dt, device, step_times=None):
    """One ``watch_trace`` run; returns (log, wall seconds).  With
    ``step_times``, each detector step's wall time is appended to it
    (the step ends in a read-back, so the time includes its kernels)."""
    det_cls = control.OnlineGoertzelDetector
    step = det_cls.step
    if step_times is not None:
        def timed(self, chunk):
            t0 = time.perf_counter()
            out = step(self, chunk)
            step_times.append(time.perf_counter() - t0)
            return out
        det_cls.step = timed
    try:
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        clog = control.watch_trace(
            w, dt, spec=api.example_specs(CONTROL_JOB_MW)["moderate"],
            n_chips=CONTROL_CHIPS, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        return clog, time.perf_counter() - t0
    finally:
        det_cls.step = step


def pctl(values, q):
    import numpy as np
    return float(np.percentile(np.asarray(values, np.float64), q))


def report_loop(tag, clog, wall, trace_s, counts, steps=None):
    s = clog.summary()
    lats = clog.dispatch_latencies()
    log(f"[{tag}] action timeline:\n{clog.timeline()}")
    line = (f"[{tag}] n_ticks {s['n_ticks']}, dispatches "
            f"{s['n_dispatches']}, first escalate {s['first_escalate_t_s']} "
            f"s, counterfactual_breach_t_s {s['counterfactual_breach_t_s']}"
            f", detection_lead_s {s['detection_lead_s']}, recession_t_s "
            f"{s['recession_t_s']}, final level {s['final_level']}")
    log(line)
    if lats:
        log(f"[{tag}] dispatch latency p50 {pctl(lats, 50) * 1e3:.3f} ms, "
            f"max {max(lats) * 1e3:.3f} ms over {len(lats)}")
    log(f"[{tag}] loop wall {wall:.3f} s for {trace_s:g} s of telemetry: "
        f"realtime_x {trace_s / wall:.1f}")
    if steps:
        log(f"[{tag}] detector step p50 {pctl(steps, 50) * 1e3:.3f} ms, "
            f"p99 {pctl(steps, 99) * 1e3:.3f} ms, max "
            f"{max(steps) * 1e3:.3f} ms over {len(steps)} ticks")
    log(f"[{tag}] launches per run: " + json.dumps(counts))


def loop_invariants(tag, clog, counts):
    """What ``tests/test_control.py::TestClosedLoop`` and
    ``benchmarks/control_bench.py`` assert, and every kernel launched."""
    s = clog.summary()
    if min(counts.values()) <= 0:
        raise AssertionError(f"[{tag}] a kernel of the control path was not "
                             f"launched: {counts}")
    if s["n_dispatches"] < 1:
        raise AssertionError(f"[{tag}] no intervention fired")
    if not (s["detection_lead_s"] is not None and s["detection_lead_s"] > 0):
        raise AssertionError(f"[{tag}] detection after the breach")
    if s["recession_t_s"] is None:
        raise AssertionError(f"[{tag}] the amplitude never receded")
    row = next(r for r in clog.series if r["t_s"] == s["recession_t_s"])
    if not max(row["amps_w"]) < clog.release_w < clog.trigger_w:
        raise AssertionError(f"[{tag}] the recession row is not below the "
                             "release level")
    blob = json.loads(clog.dumps())
    if blob["summary"]["n_dispatches"] != s["n_dispatches"]:
        raise AssertionError(f"[{tag}] the log does not round-trip JSON")


# kernels A, B, C, D and E by their launch-count names
CONTROL_KERNELS = ("monitor", "gpu_floor", "battery", "escalation", "sliding")
# each row of the kernels line (A-I) by its kernel's launch-count name
COUNT_NAME = {"sliding_monitor": "monitor", "gpu_floor_scan": "gpu_floor",
              "battery_scan": "battery", "escalation_scan": "escalation",
              "sliding_bin_power_v2": "sliding", "flash_forward": "flash_fwd",
              "ballast": "ballast", "goertzel_windows": "windows",
              "sliding_goertzel_v1": "sliding_v1"}


def path_counts(build):
    counts = build.launch_counts()
    return {k: counts[k] for k in CONTROL_KERNELS}


def control_phase(torch, control, api, build, w, dt, tag):
    """Phase 7: cold and warm ``watch_trace`` on the card, launch counts
    from 0 before each run, the loop's invariants, and the arguments of
    each kernel's largest call on the path (captured in the cold run)."""
    cap = Capture(torch, by="numel")
    build.reset_launch_counts()
    with cap:
        cold_log, cold = run_watch(torch, control, api, w, dt, "cuda")
    cold_counts = path_counts(build)
    trace_s = len(w) * dt
    log(f"[{tag}] cold run {cold:.3f} s (argument captures included)")
    loop_invariants(tag + " cold", cold_log, cold_counts)
    steps = []
    build.reset_launch_counts()
    warm_log, warm = run_watch(torch, control, api, w, dt, "cuda",
                               step_times=steps)
    counts = path_counts(build)
    report_loop(tag, warm_log, warm, trace_s, counts, steps)
    loop_invariants(tag + " warm", warm_log, counts)
    if counts != cold_counts:
        raise AssertionError(f"[{tag}] cold and warm runs launched "
                             f"differently: {cold_counts} {counts}")
    if ([(r.tick, r.action) for r in cold_log.records]
            != [(r.tick, r.action) for r in warm_log.records]):
        raise AssertionError(f"[{tag}] cold and warm timelines differ")
    return {"cold_log": cold_log, "warm_log": warm_log, "counts": counts,
            "capture": cap, "wall": warm}


# ---------------------------------------------------------------------------
# kernel E and the chunked online path against their offline calls
# ---------------------------------------------------------------------------

def uneven_ticks(n):
    """Tick sizes summing to n: the reference tests' uneven ticks (some
    shorter than a window, some crossing one), cycled, the last cut."""
    sizes, i = [], 0
    while sum(sizes) < n:
        sizes.append(min(CARRY_TICKS[i % len(CARRY_TICKS)], n - sum(sizes)))
        i += 1
    return sizes


def sliding_args(torch, w, dt, device="cuda"):
    """Kernel E's operands over a whole trace, as the loop's
    counterfactual call builds them: the float64-centred trace in 4 s
    segments, the grid-critical bins, zero state in from segment 0."""
    from repro_torch.core.spectrum import GRID_CRITICAL_HZ
    from repro_torch.kernels.goertzel import ops
    win = int(4.0 / dt)
    x = torch.as_tensor(w, device=device)
    xseg = ops.segments(ops.centre(x[None]), win)
    cosp, sinp, rot = ops.device_tables(GRID_CRITICAL_HZ, dt, win, device)
    zeros = torch.zeros((1, cosp.shape[0], win), device=device)
    seg0 = torch.zeros(1, dtype=torch.int64, device=device)
    return (xseg, cosp, sinp, rot, seg0, zeros, zeros)


def check_sliding(torch, w, dt, device="cuda"):
    """Kernel E at a counterfactual shape against its plain version and
    the float64 oracle; its row of the kernels line."""
    import numpy as np
    from repro_torch.core.spectrum import GRID_CRITICAL_HZ
    from repro_torch.kernels.goertzel import sliding
    from repro_torch.kernels.goertzel.ref import sliding_bin_power_ref
    args = sliding_args(torch, w, dt, device)
    xseg, cosp = args[0], args[1]
    B, S, win = xseg.shape
    K = cosp.shape[0]
    freqs = GRID_CRITICAL_HZ
    got = sliding.sliding_bin_power_v2(*args)
    sliding.sliding_bin_power_v2_plain(*args)        # warm its first call
    ref, plain_ms = timed_once(
        torch, lambda: sliding.sliding_bin_power_v2_plain(*args))
    scale = xseg.abs().max().item()
    err_w = (got[0] - ref[0]).abs().max().item()
    state_err = max((got[i] - ref[i]).abs().max().item() for i in (1, 2))
    n = len(w)
    amps = got[0].reshape(-1, K)[:n].double().cpu().numpy()
    oracle = sliding_bin_power_ref(w, dt, freqs, win)
    oracle_err = float(np.abs(amps - oracle).max()) / scale
    log(f"sliding [{B} x {S} x {win}, K={K}]: max |kernel - plain| "
        f"{err_w:.4g} W ({err_w / scale:.3g} of the amplitude scale "
        f"{scale:.4g} W, tol {MONITOR_TOL}); state out {state_err:.4g}; vs "
        f"float64 oracle {oracle_err:.3g} of the scale (tol {ORACLE_TOL})")
    if err_w > MONITOR_TOL * scale or state_err > MONITOR_TOL * scale * win:
        raise AssertionError("kernel E disagrees with its plain version")
    if oracle_err > ORACLE_TOL:
        raise AssertionError("kernel E disagrees with the float64 oracle")
    ms = cuda_ms(torch, lambda: sliding.sliding_bin_power_v2(*args), 20)
    b_ms, b_by = bound(nbytes(*args) + nbytes(*got),
                       SLIDING_OPS * B * S * win * K)
    return {"shape": [B, S, win, K], "max_abs_err": err_w,
            "err_of_scale": err_w / scale, "oracle_err": oracle_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def check_chunked(torch, w, dt, device="cuda"):
    """Chunked carry calls at uneven ticks (a final partial one included)
    against one offline call, bit for bit: ``sliding_bin_power`` (E) and
    the online ``sliding_monitor_fused`` (A then D)."""
    from repro_torch.core.spectrum import GRID_CRITICAL_HZ
    from repro_torch.kernels.goertzel import ops
    win = int(4.0 / dt)
    freqs = GRID_CRITICAL_HZ
    x = torch.as_tensor(w, device=device)
    mean = ops.trace_mean(x)
    ticks = uneven_ticks(len(w))
    trig = CONTROL_JOB_MW * 1e6 * 0.2 * 0.5 * 0.85   # the loop's trigger
    rel = trig * 0.6 / 0.85
    kw = dict(win=win, threshold=trig, release=rel, sustain_n=500,
              cool_n=1000)
    off = ops.sliding_bin_power(x, dt, freqs, win=win)
    woff, loff, _, _ = ops.sliding_monitor_fused(x[None], dt, freqs, **kw)
    c = ops.sliding_carry_init(dt, freqs, win=win, mean=mean, device=device)
    mc = ops.monitor_carry_init(dt, freqs, win=win, mean=mean,
                                device=device)
    amps, worsts, levels, last_err, pos = [], [], [], 0.0, 0
    for m in ticks:
        a, c = ops.sliding_bin_power(x[pos:pos + m], dt, freqs, win=win,
                                     carry=c)
        wv, lv, al, mc = ops.sliding_monitor_fused(
            x[pos:pos + m], dt, freqs, carry=mc, **kw)
        amps.append(a)
        worsts.append(wv)
        levels.append(lv)
        pos += m
        last_err = max(last_err, (al - off[pos - 1]).abs().max().item())
    amps_eq = torch.equal(torch.cat(amps), off)
    worst_eq = torch.equal(torch.cat(worsts), woff[0])
    level_eq = torch.equal(torch.cat(levels), loff[0])
    scale = (x.double() - mean).abs().max().item()
    log(f"chunked carry, {len(ticks)} ticks of {min(ticks)}..{max(ticks)} "
        f"samples over {len(w)}: kernel E bitwise {amps_eq}; kernels A+D "
        f"worst bitwise {worst_eq}, levels bitwise {level_eq} (max level "
        f"{int(loff.max())}); per-tick amps_last vs offline E "
        f"{last_err / scale:.3g} of the scale (tol {MONITOR_TOL})")
    if not (amps_eq and worst_eq and level_eq):
        raise AssertionError("chunked carry calls differ from one offline "
                             "call")
    if last_err > MONITOR_TOL * scale or int(loff.max()) < 1:
        raise AssertionError("online per-bin amplitudes disagree, or the "
                             "machine never escalated")
    return {"ticks": len(ticks), "bitwise": True}


# ---------------------------------------------------------------------------
# kernel C at the replay's and a ragged shape, and its chain's floor
# ---------------------------------------------------------------------------

# phase 9's CPU worker: the plain version's 600 000 steps (about 100 s)
BATTERY_WAIT_S = 600


def battery_plain_start(torch, tag, w, p, dt, got):
    """Save one case's operands and start its CPU worker
    (``battery_plain_job``); returns what ``battery_finish`` waits for."""
    work = os.path.join(HERE, "build", "phase9_battery")
    os.makedirs(work, exist_ok=True)
    stem = os.path.join(work, tag)
    torch.save({"w": w, "p": p, "dt": dt}, stem + ".in.pt")
    logf = open(stem + ".log", "w")
    return {"got": got, "stem": stem, "log": logf, "t0": time.perf_counter(),
            "proc": subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--battery-plain", stem + ".in.pt", stem + ".out.pt"],
                cwd=HERE, stdout=logf, stderr=subprocess.STDOUT)}


def battery_stop(extra):
    for case in extra.values():
        job = case.get("job")
        if job is not None:
            if job["proc"].poll() is None:
                job["proc"].kill()
            job["proc"].wait()
            job["log"].close()


def battery_finish(torch, extra, timeout=BATTERY_WAIT_S):
    """Phase 9's CPU checks, at the end: wait for each worker, then kernel
    C's outputs bit for bit against its plain version's."""
    t0 = time.perf_counter()
    try:
        for tag, case in extra.items():
            job = case.get("job")
            if job is None:
                continue
            try:
                rc = job["proc"].wait(timeout=max(
                    timeout - (time.perf_counter() - t0), 1.0))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"kernel C's plain version at {tag} "
                                     f"took more than {timeout} s") from None
            if rc != 0:
                job["log"].flush()
                with open(job["stem"] + ".log") as f:
                    tail = f.read()[-2000:]
                raise AssertionError(f"kernel C's plain worker at {tag} "
                                     f"exited {rc}: {tail}")
            ref = torch.load(job["stem"] + ".out.pt", weights_only=True)
            equal = all(torch.equal(g, r) for g, r in zip(job["got"],
                                                          ref["ref"]))
            case.update(bitwise=equal, plain_ms=ref["plain_ms"],
                        worker_wall_s=time.perf_counter() - job["t0"])
            log(f"battery {case['shape']}: bitwise {equal} against the plain "
                f"version (CPU, {ref['plain_ms']:.0f} ms in a worker, its "
                f"wall {case['worker_wall_s']:.1f} s)")
            if not equal:
                raise AssertionError(f"kernel C differs from its plain "
                                     f"version at {case['shape']}")
    finally:
        battery_stop(extra)
    for case in extra.values():
        for k in ("job",):
            case.pop(k, None)
    log(f"phase 9's CPU check: waited {time.perf_counter() - t0:.1f} s for "
        "it at the end")


def battery_chain(torch, w, params, dt, ieee=False, reps=200):
    """The chain alone (``battery_step_cycles`` in ``battery.cu``): lane 0
    steps over 512 samples already in shared memory, ``reps`` times, with
    the kernel's divisions (or, with ``ieee``, the IEEE division
    throughout).  Returns (SM cycles per step, ns per step by CUDA
    events)."""
    import ctypes
    from repro_torch.core.smoothing import battery
    from repro_torch.kernels.build import ptr, stream_of
    fn = ctypes.CDLL(str(battery.BATTERY_KERNEL.library_path())
                     ).battery_step_cycles
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cycles = torch.zeros(1, dtype=torch.int64, device=w.device)
    sink = torch.zeros(1, device=w.device)

    def run():
        err = fn(ptr(w), ptr(params), float(dt), w.shape[-1], reps,
                 int(ieee), ptr(cycles), ptr(sink), stream_of(w))
        if err:
            raise RuntimeError(f"battery_step_cycles: CUDA error {err}")
    ms = cuda_ms(torch, run, 3)
    steps = reps * min(w.shape[-1], 512)
    return cycles.item() / steps, ms / steps * 1e6


def battery_plain_job(torch, path_in, path_out):
    """Phase 9's CPU check (``chip_smoke.py --battery-plain IN OUT``): kernel
    C's plain version on one thread at the lowest CPU priority, on the
    operands ``battery_phase`` saved; saves its outputs and milliseconds."""
    from repro_torch.core.smoothing import battery
    torch.set_num_threads(1)
    os.nice(19)
    job = torch.load(path_in, weights_only=True)
    t0 = time.perf_counter()
    ref = battery.battery_scan_plain(job["w"], job["p"], job["dt"])
    torch.save({"ref": ref, "plain_ms": (time.perf_counter() - t0) * 1e3},
               path_out)
    return 0


def battery_phase(torch, canon_call, w_long, dt_long):
    """Kernel C bitwise against its plain version on one 600 000-sample
    row (the 600 s replay's trace) and on a ragged [3 x 4099] cut of it,
    both with the canonical loop's battery parameters (the grid target
    starting at each row's mean, as ``RackBattery.apply_batch`` sets it);
    the 600 000-sample row's plain version runs on the CPU (600 000 steps
    of a Python loop: the card's launches would take longer), in a worker
    process beside the later phases (``battery_finish`` gates it).  Then
    the chain's own cycles per step, from which each shape's floor
    follows."""
    from repro_torch.core.smoothing import battery
    _, args, _ = canon_call
    params0 = args[1]
    x = torch.as_tensor(w_long, device=DEVICE)
    cases = {"600000": x[None].contiguous(),
             "3x4099": torch.stack([x[i * 4099:(i + 1) * 4099]
                                    for i in range(3)])}
    out = {}
    atexit.register(battery_stop, out)
    for tag, w in cases.items():
        p = params0[:w.shape[0]].clone()
        p[:, 7] = w.double().mean(1).float()
        got = battery.battery_scan(w, p, dt_long)
        torch.cuda.synchronize()
        ms = cuda_ms(torch, lambda: battery.battery_scan(w, p, dt_long), 3)
        out[tag] = {"shape": list(w.shape), "ms": ms}
        if w.shape[-1] > 100_000:
            out[tag]["plain_device"] = "cpu"
            out[tag]["job"] = battery_plain_start(
                torch, tag, w.cpu(), p.cpu(), dt_long,
                tuple(g.cpu() for g in got))
            log(f"battery [{w.shape[0]} x {w.shape[1]}]: {ms:.4g} ms; its "
                "plain version runs on the CPU in a worker")
            continue
        ref, plain_ms = timed_once(
            torch, lambda: battery.battery_scan_plain(w, p, dt_long))
        equal = all(torch.equal(g, r) for g, r in zip(got, ref))
        log(f"battery [{w.shape[0]} x {w.shape[1]}]: bitwise {equal} "
            f"against the plain version (card, {plain_ms:.0f} ms); "
            f"{ms:.4g} ms")
        if not equal:
            raise AssertionError(f"kernel C differs from its plain version "
                                 f"at [{w.shape[0]} x {w.shape[1]}]")
        out[tag].update(bitwise=True, plain_ms=plain_ms, plain_device="cuda")
    p1 = params0[:1].contiguous()
    cyc, ns = battery_chain(torch, cases["600000"], p1, dt_long)
    cyc_ieee, ns_ieee = battery_chain(torch, cases["600000"], p1, dt_long,
                                      ieee=True)
    log(f"battery chain alone: {cyc:.1f} SM cycles a step, {ns:.2f} ns a "
        f"step ({cyc / ns:.3f} GHz while it ran); with the IEEE division "
        f"throughout {cyc_ieee:.1f} cycles, {ns_ieee:.2f} ns")
    return out, cyc, ns, {"cycles_per_step": cyc_ieee,
                          "ns_per_step": ns_ieee}


# ---------------------------------------------------------------------------
# the canonical loop on the CPU against the card
# ---------------------------------------------------------------------------

def compare_cpu_loop(torch, control, api, w, dt, card_log):
    cpu_log, secs = run_watch(torch, control, api, w, dt, "cpu")
    a = [(r.tick, r.action, r.level, r.bin_hz) for r in cpu_log.records]
    b = [(r.tick, r.action, r.level, r.bin_hz) for r in card_log.records]
    if a != b:
        raise AssertionError(f"cpu vs card: timelines differ\n{a}\n{b}")
    worst = 0.0
    for c, g in zip(cpu_log.records, card_log.records):
        for k in ("amplitude_w", "margin_w"):
            x, y = getattr(c, k), getattr(g, k)
            if abs(x - y) > STUDY_RTOL * abs(y):
                raise AssertionError(f"cpu vs card: {k} {x} vs {y} at "
                                     f"tick {c.tick}")
            worst = max(worst, abs(x - y) / max(abs(y), 1e-30))
        if c.action == "dispatch:redesign":
            for k in ("mpf_frac", "battery_capacity_j"):
                if c.params[k] != g.params[k]:
                    raise AssertionError(f"cpu vs card: redesign {k} "
                                         f"{c.params[k]} vs {g.params[k]}")
            if abs(c.params["energy_overhead"]
                   - g.params["energy_overhead"]) > 1e-6:
                raise AssertionError("cpu vs card: redesign energy_overhead")
    scale = float(abs(w.astype("float64") - w.mean()).max())
    series = max(max(abs(x - y) for x, y in zip(c["amps_w"], g["amps_w"]))
                 for c, g in zip(cpu_log.series, card_log.series)) / scale
    if series > STUDY_RTOL:
        raise AssertionError(f"cpu vs card: tick amplitudes {series:.3g} of "
                             "the scale")
    # the counterfactual breach is the first sample whose raw amplitude
    # crosses breach_w: the two may cross at different samples only where
    # the amplitude sits within the kernel tolerance of breach_w
    from repro_torch.kernels.goertzel import ops
    t_cpu = cpu_log.counterfactual_breach_t_s
    t_card = card_log.counterfactual_breach_t_s
    if (t_cpu is None) != (t_card is None):
        raise AssertionError("cpu vs card: one run never breaches")
    lo, hi = sorted(int(round(t / dt)) for t in (t_cpu, t_card))
    amps = ops.sliding_bin_power(torch.as_tensor(w), dt, card_log.freqs,
                                 win=int(4.0 / dt)).amax(1)
    gap = (amps[lo:hi + 1] - card_log.breach_w).abs().max().item() / scale
    if gap > MONITOR_TOL:
        raise AssertionError(f"cpu vs card: counterfactual breach {t_cpu} vs"
                             f" {t_card} s, {gap:.3g} of the scale apart")
    log(f"cpu re-run of the canonical loop: {secs:.1f} s; {len(a)} records "
        f"equal in tick, action, level and bin; redesign choices equal; "
        f"worst record rel diff {worst:.3g} (rtol {STUDY_RTOL}); tick "
        f"amplitudes within {series:.3g} of the scale; energy_overhead abs "
        f"1e-6; counterfactual breach {t_cpu} s (cpu) vs {t_card} s (card),"
        f" the amplitude within {gap:.3g} of the scale of breach_w between")


# ---------------------------------------------------------------------------
# the model zoo: kernel F, granite-3-8b prefill on both routes, serving
# ---------------------------------------------------------------------------

def flash_case(torch, gen, shape, Dv, causal, dtype):
    """Kernel F against its plain version and the float64 dense oracle at
    one shape (S == T, the reference's full-width blocks 2048 and 1024,
    clamped to S as its ops.py does), with its times and bound."""
    from repro_torch.kernels.flash import flash
    from repro_torch.kernels.flash.ref import flash_ref
    B, S, KV, G, D = shape
    dt = getattr(torch, dtype)
    q = torch.randn(shape, generator=gen, device=DEVICE).to(dt)
    k = torch.randn((B, S, KV, D), generator=gen, device=DEVICE).to(dt)
    v = torch.randn((B, S, KV, Dv), generator=gen, device=DEVICE).to(dt)
    kw = dict(q_block=min(FLASH_BLOCKS[0], S), kv_chunk=min(FLASH_BLOCKS[1], S),
              causal=causal)
    got = flash.flash_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    plain, plain_ms = timed_once(
        torch, lambda: flash.flash_forward_plain(q, k, v, **kw))
    scale = plain.float().abs().max().item()
    err = (got.float() - plain.float()).abs().max().item()
    del plain
    err_oracle = (got.double() - flash_ref(q, k, v, causal=causal)
                  ).abs().max().item()
    tol_plain, tol_oracle = FLASH_TOL[dtype]
    ms = cuda_ms(torch, lambda: flash.flash_forward(q, k, v, **kw), 5)
    H = KV * G
    qh, kh, vh = (q.reshape(B, S, H, D).transpose(1, 2), k.transpose(1, 2),
                  v.transpose(1, 2))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(torch, lambda: sdpa(qh, kh, vh, is_causal=causal,
                                             enable_gqa=True), 5)
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    t_bytes = nbytes(q, k, v, got) / PEAK_BYTES_S * 1e3
    t_ops = pairs * 2 * (D + Dv) / PEAK_FLOPS[dtype] * 1e3
    tflops = pairs * 2 * (D + Dv) / ms / 1e9
    row = {"shape": [B, S, KV, G, D, Dv], "dtype": dtype, "causal": causal,
           "tflops": tflops, "smem_dynamic": flash_smem(D, Dv, dtype),
           "max_abs_err": err, "rel_err": err / scale, "tolerance": tol_plain,
           "oracle_rel_err": err_oracle / scale,
           "oracle_tolerance": tol_oracle, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    log(f"flash {dtype} {'causal' if causal else 'full'} q {list(shape)} Dv "
        f"{Dv}: vs plain {err / scale:.3g} of max |plain| (tol "
        f"{tol_plain:.3g}), vs float64 oracle {err_oracle / scale:.3g} (tol "
        f"{tol_oracle:.3g}); {ms:.4g} ms, {tflops:.1f} TFLOP/s on 2 (D + Dv) "
        f"a pair (plain {plain_ms:.4g}, sdpa "
        f"{library_ms:.4g}, bound {row['bound_ms']:.4g} by "
        f"{row['bound_by']})")
    if err > tol_plain * scale or err_oracle > tol_oracle * scale:
        raise AssertionError("kernel F disagrees with its plain version or "
                             "the float64 oracle")
    return row


def flash_smem(D, Dv, dtype):
    """The dynamic shared memory kernel F requests at head dims D, Dv
    (``flash_fwd_smem_bytes``; ptxas reports static memory only)."""
    import ctypes
    from repro_torch.kernels.flash import flash
    fn = ctypes.CDLL(str(flash.FLASH_KERNEL.library_path())
                     ).flash_fwd_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(D, Dv, int(dtype == "bfloat16"))


def flash_phase(torch, build):
    """Phase 11: kernel F at the prefill's shape in bf16 and f32, and at a
    non-causal and a Dv != D shape in both."""
    from repro_torch.kernels.flash import flash
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    rows = [flash_case(torch, gen, shape, Dv, causal, dtype)
            for shape, Dv, causal in FLASH_SHAPES
            for dtype in ("bfloat16", "float32")]
    ptxas = ptxas_summary(flash.FLASH_KERNEL)
    log("flash_fwd ptxas: " + json.dumps(ptxas))
    # the bf16 kernel's tensor-core products and TMA copies in its SASS
    sass = sass_counts(flash.FLASH_KERNEL, ("HGMMA", "UTMALDG", "SYNCS"))
    log("flash_fwd SASS opcodes (cuobjdump): " + json.dumps(sass))
    path = rows[0]
    return {"name": "flash_forward", "route": "cuda",
            "source": "src/repro_torch/kernels/flash/csrc/flash_fwd.cu",
            "replaces": "src/repro/kernels/flash/flash.py:64",
            "launches": None, "max_abs_err": path["max_abs_err"],
            "tolerance": f"{FLASH_TOL['bfloat16'][0]} x max |plain| (bf16), "
                         f"{FLASH_TOL['float32'][0]} (f32)",
            "shape": path["shape"], "ms": path["ms"],
            "plain_ms": path["plain_ms"], "bound_ms": path["bound_ms"],
            "bound_by": path["bound_by"], "library_ms": path["library_ms"],
            "library_note": "F.scaled_dot_product_attention(is_causal, "
                            "enable_gqa) on the same q, k, v",
            "cases": rows, "ptxas": ptxas, "sass": sass}


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)


def fresh_states(cache):
    """``cache`` for one more decode run: its recurrent layers' states
    (``STATE_KEYS``, which a decode step overwrites in place) copied, its
    attention caches shared (a run writes only the positions it then
    reads, the same ones from the same tokens)."""
    from repro_torch.models.model import STATE_KEYS

    def layer(c):
        return {k: t.clone() if k in STATE_KEYS else t for k, t in c.items()}
    return {"prefix": [layer(c) for c in cache["prefix"]],
            "unit": tuple(layer(c) for c in cache["unit"])}


def rel_gap(torch, a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def prefill_phase(torch, build, cfg, params, tokens):
    """Phase 12: full-width prefill on the flash route (kernel F) and on the
    chunked route the reference serves on, each cold (launch counts from 0)
    and warm; the routes compared; a profiled flash prefill."""
    from repro_torch.models import Ctx, init_cache, make_prefill
    B, S = tokens.shape
    prefill = make_prefill(cfg)
    cache0 = init_cache(cfg, B, S + NEW_TOKENS, torch.float32, DEVICE)
    batch = {"tokens": tokens}
    out = {}
    for flash in (True, False):
        ctx = Ctx(cfg=cfg, flash=flash)
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        (logits, cache), cold_ms = timed_once(
            torch, lambda: prefill(params, batch, cache0, ctx))
        launches = build.launch_counts()
        del cache
        (logits_w, cache), warm_ms = timed_once(
            torch, lambda: prefill(params, batch, cache0, ctx))
        peak = torch.cuda.max_memory_allocated()
        tag = "flash" if flash else "chunked"
        log(f"[prefill {tag}] B {B} x S {S}: cold {cold_ms:.1f} ms, warm "
            f"{warm_ms:.1f} ms ({B * S / warm_ms * 1e3:.0f} tokens/s), peak "
            f"{peak / 2**30:.2f} GiB allocated; launches "
            + json.dumps(launches))
        if launches["flash_fwd"] != (cfg.n_layers if flash else 0):
            raise AssertionError(f"[prefill {tag}] kernel F launched "
                                 f"{launches['flash_fwd']} times")
        if not torch.equal(logits, logits_w):
            raise AssertionError(f"[prefill {tag}] cold and warm logits differ")
        if (tuple(logits.shape) != (B, 1, cfg.vocab_size)
                or not torch.isfinite(logits).all()):
            raise AssertionError(f"[prefill {tag}] logits {tuple(logits.shape)}"
                                 " are not finite [B, 1, V]")
        out[tag] = {"logits": logits, "cache": cache, "cold_ms": cold_ms,
                    "warm_ms": warm_ms, "peak_bytes": peak,
                    "launches": launches}
    del cache0
    f, c = out["flash"], out["chunked"]
    layer0 = all(torch.equal(f["cache"]["unit"][0][n][0],
                             c["cache"]["unit"][0][n][0]) for n in ("k", "v"))
    gaps = [max(rel_gap(torch, f["cache"]["unit"][0][n][r],
                        c["cache"]["unit"][0][n][r]) for n in ("k", "v"))
            for r in range(cfg.n_repeats)]
    logit_gap = rel_gap(torch, f["logits"], c["logits"])
    worst = max(range(1, cfg.n_repeats), key=lambda r: gaps[r])
    log(f"[prefill] flash vs chunked route: layer 0 cache bitwise {layer0}; "
        f"caches of layers 1-{cfg.n_repeats - 1} within {gaps[worst]:.3g} of "
        f"their max |.| (worst layer {worst}; median "
        f"{sorted(gaps[1:])[len(gaps) // 2 - 1]:.3g}); last logits "
        f"{logit_gap:.3g} (tol {ROUTE_TOL:.3g})")
    if not layer0 or gaps[worst] > ROUTE_TOL or logit_gap > ROUTE_TOL:
        raise AssertionError("the flash and chunked routes disagree")
    del c["cache"]
    ctx = Ctx(cfg=cfg, flash=True)
    wall, busy, top = profile_device(
        torch, lambda: prefill(params, batch, f["cache"], ctx))
    log(f"[prefill flash] profiled run {wall:.3f} s, device busy {busy:.3f} s"
        f" ({100 * busy / wall:.1f}% of the traced wall)")
    for ms, cnt, key in top:
        log(f"  {ms:10.3f} ms {cnt:6d}x {key[:110]}")
    return {"flash": f, "chunked_logits": c["logits"],
            "launches": {"flash": f["launches"], "chunked": c["launches"]},
            "summary": {
                "B": B, "S": S, "layers": cfg.n_layers,
                "flash_warm_ms": f["warm_ms"], "chunked_warm_ms": c["warm_ms"],
                "flash_tokens_per_s": B * S / f["warm_ms"] * 1e3,
                "chunked_tokens_per_s": B * S / c["warm_ms"] * 1e3,
                "peak_gib": max(f["peak_bytes"], c["peak_bytes"]) / 2**30,
                "layer0_bitwise": layer0, "cache_gap": gaps[worst],
                "logit_gap": logit_gap, "busy_share": busy / wall}}


def serve_phase(torch, build, cfg, params, tokens, flash_out, tag="serve",
                gate_parting=True):
    """Phase 13 (and 22's serving): ServeEngine.generate (the chunked
    route, as the reference serves) on the prompts, greedy; then the same
    number of greedy tokens decoded from the flash route's cache, compared
    row by row.  With ``gate_parting`` the two may part only where
    ServeEngine's top-2 logits are within ROUTE_TOL of max |logit|; a
    routed model's caches differ at the tokens its routing rule sets
    aside, so phase 22 reports the parting and gates a teacher-forced
    decode instead (``zoo_decode_compare``)."""
    from repro_torch.models import make_decode_step
    from repro_torch.serve import ServeEngine
    B, S = tokens.shape
    eng = ServeEngine(cfg, params, max_seq=S + NEW_TOKENS, batch=B,
                      device=DEVICE)
    rec = {"prefill": [], "decode": [], "logits": []}

    def timed(fn, key):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = fn(*args)
            torch.cuda.synchronize()
            rec[key].append((time.perf_counter() - t0) * 1e3)
            rec["logits"].append(logits[:, -1].float().clone())
            return logits, cache
        return run

    eng._prefill = timed(eng._prefill, "prefill")
    eng._decode = timed(eng._decode, "decode")
    build.reset_launch_counts()
    served, wall_ms = timed_once(torch, lambda: eng.generate(tokens,
                                                             NEW_TOKENS))
    counts = build.launch_counts()
    launches = counts["flash_fwd"]
    dec = rec["decode"]
    log(f"[{tag}] ServeEngine.generate {B} x ({S} + {NEW_TOKENS}): "
        f"{wall_ms:.1f} ms, prefill {rec['prefill'][0]:.1f} ms, decode "
        f"p50 {pctl(dec, 50):.2f} ms max {max(dec):.2f} ms per step, "
        f"{B * NEW_TOKENS / wall_ms * 1e3:.1f} generated tokens/s "
        f"({B * NEW_TOKENS / sum(dec) * 1e3:.1f} in decode alone); kernel F "
        f"launches {launches}")
    if launches != 0 or tuple(served.shape) != (B, NEW_TOKENS):
        raise AssertionError("ServeEngine launched kernel F or returned "
                             f"{tuple(served.shape)}")
    del eng
    decode = make_decode_step(cfg)
    cache = fresh_states(flash_out["cache"])
    tok = torch.argmax(flash_out["logits"][:, -1], dim=-1)
    own = []
    for i in range(NEW_TOKENS):
        own.append(tok)
        logits, cache = decode(params, tok[:, None], cache, S + i)
        tok = torch.argmax(logits[:, -1], dim=-1)
    own = torch.stack(own, 1).to(served.dtype)
    leads, partings = [], []
    for b in range(B):
        diff = (own[b] != served[b]).nonzero()
        lead = NEW_TOKENS if len(diff) == 0 else int(diff[0])
        leads.append(lead)
        if lead < NEW_TOKENS:
            lg = rec["logits"][lead]
            top2 = torch.topk(lg[b], 2).values
            gap = (top2[0] - top2[1]).item()
            limit = ROUTE_TOL * lg.abs().max().item()
            partings.append({"row": b, "step": lead, "top2_gap": gap,
                             "limit": limit})
            log(f"[{tag}] row {b}: the flash route's tokens part at step "
                f"{lead}, where ServeEngine's top-2 logit gap is {gap:.4g} "
                f"({'limit' if gate_parting else 'not gated; ROUTE_TOL:'} "
                f"{limit:.4g})")
            if gap > limit and gate_parting:
                raise AssertionError("the routes' tokens part where the "
                                     "logits are not near a tie")
    log(f"[{tag}] flash-route decode vs ServeEngine: leading equal tokens "
        f"per row {leads} of {NEW_TOKENS}")
    return {"generate_ms": wall_ms, "prefill_ms": rec["prefill"][0],
            "decode_p50_ms": pctl(dec, 50), "decode_max_ms": max(dec),
            "tokens_per_s": B * NEW_TOKENS / wall_ms * 1e3,
            "decode_tokens_per_s": B * NEW_TOKENS / sum(dec) * 1e3,
            "leading_equal_tokens": leads, "partings": partings,
            "launches": counts, "served": served, "logits": rec["logits"]}


def cpu_rerun_phase(torch, build, cfg_full):
    """Phase 14: granite-3-8b at full width cut to 2 layers, in f32: a flash
    prefill of 1 x 2048 and 8 greedy tokens on the card (kernel F) and on
    the CPU (its plain version)."""
    import dataclasses
    import numpy as np
    from repro_torch.models import (Ctx, init_cache, init_params,
                                    make_decode_step, make_prefill)
    cfg = dataclasses.replace(cfg_full, n_repeats=2, compute_dtype="float32")
    S, n = 2048, 8
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, S)))

    def run(p, device):
        cache = init_cache(cfg, 1, S + n, torch.float32, device)
        logits, cache = make_prefill(cfg)(
            p, {"tokens": prompt.to(device)}, cache, Ctx(cfg=cfg, flash=True))
        decode = make_decode_step(cfg)
        seen, toks = [logits[:, -1].cpu()], []
        for i in range(n):
            toks.append(torch.argmax(logits[:, -1], dim=-1))
            logits, cache = decode(p, toks[-1][:, None], cache, S + i)
            seen.append(logits[:, -1].cpu())
        return torch.stack(toks, 1).cpu(), torch.stack(seen)

    build.reset_launch_counts()
    (card_toks, card_logits), card_ms = timed_once(
        torch, lambda: run(tree_to(params, DEVICE), DEVICE))
    counts = build.launch_counts()
    launches = counts["flash_fwd"]
    t0 = time.perf_counter()
    cpu_toks, cpu_logits = run(params, "cpu")
    cpu_s = time.perf_counter() - t0
    gap = rel_gap(torch, card_logits, cpu_logits)
    equal = torch.equal(card_toks, cpu_toks)
    log(f"[cpu re-run] granite-3-8b x 2 layers f32, 1 x {S} + {n}: card "
        f"{card_ms:.0f} ms (kernel F launches {launches}), CPU {cpu_s:.1f} s;"
        f" logits within {gap:.3g} of max |logit| (tol {CPU_RERUN_TOL}), "
        f"tokens equal {equal}")
    if gap > CPU_RERUN_TOL or not equal or launches != cfg.n_layers:
        raise AssertionError("the CPU re-run disagrees with the card")
    return {"logit_gap": gap, "tokens_equal": equal, "cpu_s": cpu_s,
            "card_ms": card_ms, "launches": counts}


def model_phases(torch, build, kernels, earlier_f_counts):
    """Phases 11-14; adds kernel F's row to ``kernels`` (its launches on
    the Study and control paths in ``earlier_f_counts``) and the model
    paths' launch counts to every row."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    f_row = flash_phase(torch, build)
    cfg = get_config(GRANITE)
    params, init_ms = timed_once(torch, lambda: init_params(
        torch.Generator(device=DEVICE).manual_seed(0), cfg, device=DEVICE))
    log(f"granite-3-8b: {cfg.param_count()} params (f32) drawn on the card in"
        f" {init_ms:.0f} ms, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_S))).to(DEVICE)
    pre = prefill_phase(torch, build, cfg, params, tokens)
    serve = serve_phase(torch, build, cfg, params, tokens, pre["flash"])
    del params, pre["flash"], serve["served"], serve["logits"]
    torch.cuda.empty_cache()
    rerun = cpu_rerun_phase(torch, build, cfg)
    f_row["launches"] = pre["launches"]["flash"]["flash_fwd"]
    f_row["launches_by_path"] = dict(earlier_f_counts)
    kernels.append(f_row)
    paths = {"prefill_flash": pre["launches"]["flash"],
             "prefill_chunked": pre["launches"]["chunked"],
             "serve_generate": serve["launches"],
             "cpu_rerun_card": rerun["launches"]}
    for k in kernels:
        nm = COUNT_NAME[k["name"]]
        k["launches_by_path"].update({p: c[nm] for p, c in paths.items()})
    return {"prefill": pre["summary"], "serve": serve, "cpu_rerun": rerun,
            "launches": paths}


# ---------------------------------------------------------------------------
# phase 22: sparse experts and latent attention at the published widths
# (dbrx-132b, deepseek-v2-lite-16b), depth cut to what one card holds
# ---------------------------------------------------------------------------

# (arch, repeats kept): dbrx 4 of its 40 (bf16, 28.5 GB), deepseek its
# dense first layer and 8 of its 26 (f32, 20.7 GB)
ZOO = (("dbrx-132b", 4), ("deepseek-v2-lite-16b", 8))
# kernel F at the two models' prefill shapes: q [B, S, KV, G, D], Dv
ZOO_FLASH_SHAPES = {"dbrx-132b": ((PREFILL_B, PREFILL_S, 8, 6, 128), 128),
                    "deepseek-v2-lite-16b": ((PREFILL_B, PREFILL_S, 16, 1,
                                              192), 128)}
MOE_CHECK_TOKENS = 512    # moe_forward against moe_forward_ref, dropless
MOE_TOL = 2.0 ** -5       # of max |moe_forward_ref|, in the prefill's bf16
NEAR_TIE = 1e-5           # routing margin (k-th minus (k+1)-th probability)
                          # under which a token is set aside
FLIP_MARGIN = 2.0 ** -7   # bf16: the widest margin at which the two routes'
                          # experts for a token may differ
PROFILED_STEPS = 4        # decode steps under torch.profiler
# (c): deepseek at full width with its prefix and 1 repeat, f32, on the
# card and on the CPU: a prefill of 1 x 256 and 4 greedy decode steps
ZOO_RERUN = ("deepseek-v2-lite-16b", 1, 256, 4)


def zoo_layers(cfg, params):
    """(spec, params) of every layer in order: the prefix, then the unit
    of each repeat."""
    from repro_torch.models.model import _at
    out = list(zip(cfg.prefix, params["prefix"]))
    for r in range(cfg.n_repeats):
        out += [(spec, _at(params["unit"][i], r))
                for i, spec in enumerate(cfg.unit)]
    return out


def layer_parts(spec, p, x, ctx):
    """``apply_layer``'s steps: the layer's output and its FFN's input."""
    from repro_torch.models import model as M
    eps = ctx.cfg.norm_eps
    h, _ = M._apply_mixer(spec, p["mix"], M.rms_norm(x, p["norm1"], eps),
                          ctx)
    mid = x + h
    r = M.rms_norm(mid, p["norm2"], eps)
    f, _, _ = M._apply_ffn(spec, p["ffn"], r, ctx)
    return mid + f, r


def routing(torch, cfg, p_ffn, r, dropless):
    """The router on FFN inputs ``r``: each token's experts, the experts
    that keep it (the dispatch ranks a token in an expert by token order
    and keeps the first C; a dropped one reads -1), both ascending, and
    the margin between its k-th and (k+1)-th probabilities."""
    from repro_torch.models.moe import capacity, route
    k = cfg.moe.top_k
    xt = r.reshape(-1, r.shape[-1])
    probs, _, idx = route(xt, p_ffn["router"], k)
    top = torch.topk(probs, k + 1, dim=-1).values
    hot = torch.zeros(probs.shape, dtype=torch.int32, device=r.device)
    hot.scatter_(1, idx, 1)
    rank = (torch.cumsum(hot, 0) - hot).gather(1, idx)
    C = capacity(cfg, xt.shape[0], dropless)
    kept = torch.where(rank < C, idx, -1)
    return (idx.sort(dim=1).values, kept.sort(dim=1).values,
            top[:, k - 1] - top[:, k])


class RecordRoutes:
    """Within ``with``, every ``moe_forward`` call records its tokens'
    ``routing`` in ``calls``, on the CPU, and its router's own ``(idx,
    gate)`` in ``raw`` (what ``moe.forced_routes`` takes)."""

    def __init__(self, torch):
        self.torch, self.calls, self.raw = torch, [], []

    def __enter__(self):
        from repro_torch.models import moe as moe_mod
        self.mod, self.orig = moe_mod, moe_mod.moe_forward

        def rec(p, x, cfg, ctx=None):
            dropless = ctx is not None and ctx.dropless
            self.calls.append(tuple(t.cpu() for t in routing(
                self.torch, cfg, p, x, dropless)))
            _, gate, idx = moe_mod.route(x.reshape(-1, x.shape[-1]),
                                         p["router"], cfg.moe.top_k)
            self.raw.append((idx, gate))
            return self.orig(p, x, cfg, ctx)
        moe_mod.moe_forward = rec
        return self

    def __exit__(self, *exc):
        self.mod.moe_forward = self.orig


def routes_compare(torch, a, b):
    """Two ``routing``s of the same tokens: the tokens at a margin under
    NEAR_TIE on either side, the tokens whose experts differ, the tokens
    whose experts agree but whose kept slots differ (a token that chose
    another expert earlier in the order moved the capacity's edge), and
    each token's smaller margin."""
    margin = torch.minimum(a[2], b[2])
    near = margin < NEAR_TIE
    flip = (a[0] != b[0]).any(1)
    moved = (a[1] != b[1]).any(1) & ~flip
    return near, flip, moved, margin


def moe_check(torch, cfg, params):
    """One MoE layer's ``moe_forward`` (dropless) against its plain version
    ``moe_forward_ref`` on MOE_CHECK_TOKENS tokens at the full width, in
    the prefill's dtype, with their times."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import Ctx
    spec, p = next((s, p) for s, p in zoo_layers(cfg, params)
                   if s.ffn == "moe")
    gen = torch.Generator(device=DEVICE).manual_seed(22)
    x = torch.randn((1, MOE_CHECK_TOKENS, cfg.d_model), generator=gen,
                    device=DEVICE).to(getattr(torch, cfg.compute_dtype))
    ctx = Ctx(cfg=cfg, dropless=True)
    (got, aux), ms = timed_once(
        torch, lambda: moe_mod.moe_forward(p["ffn"], x, cfg, ctx))
    ref, ref_ms = timed_once(
        torch, lambda: moe_mod.moe_forward_ref(p["ffn"], x, cfg))
    again, _ = moe_mod.moe_forward(p["ffn"], x, cfg, ctx)
    scale = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    row = {"tokens": MOE_CHECK_TOKENS, "dtype": cfg.compute_dtype,
           "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
           "shared": cfg.moe.n_shared, "max_abs_err": err,
           "rel_err": err / scale, "tolerance": MOE_TOL, "ms": ms,
           "plain_ms": ref_ms, "aux": aux.item(),
           "bitwise_rerun": torch.equal(got, again)}
    log(f"[{cfg.name}] moe_forward vs moe_forward_ref on {MOE_CHECK_TOKENS} "
        f"tokens (dropless, {cfg.compute_dtype}, {cfg.moe.n_experts} experts"
        f" top-{cfg.moe.top_k}, {cfg.moe.n_shared} shared): "
        f"{err / scale:.3g} of max |plain| (tol {MOE_TOL:.3g}); {ms:.2f} ms "
        f"(plain {ref_ms:.2f} ms, cold); rerun bitwise {row['bitwise_rerun']}")
    if (err > MOE_TOL * scale or not row["bitwise_rerun"]
            or not torch.isfinite(got).all()):
        raise AssertionError(f"[{cfg.name}] moe_forward disagrees with "
                             "moe_forward_ref or with itself")
    return row


def zoo_prefill(torch, build, cfg, params, tokens):
    """Both routes' prefills, cold (launch counts from 0) and warm; the two
    runs of each equal bit for bit; their first layer's caches equal; and
    a third run of each, free-running with every MoE call's routing
    recorded: a row whose last token the routing rule sets aside at some
    layer is counted, every other row's last logits are held within
    ROUTE_TOL."""
    from repro_torch.models import Ctx, init_cache, make_prefill
    B, S = tokens.shape
    prefill = make_prefill(cfg)
    cache0 = init_cache(cfg, B, S + NEW_TOKENS, torch.float32, DEVICE)
    out = {}
    for flash in (True, False):
        ctx = Ctx(cfg=cfg, flash=flash)
        tag = "flash" if flash else "chunked"
        build.reset_launch_counts()
        (logits, cache), cold_ms = timed_once(
            torch, lambda: prefill(params, {"tokens": tokens}, cache0, ctx))
        launches = build.launch_counts()
        (logits_w, cache_w), warm_ms = timed_once(
            torch, lambda: prefill(params, {"tokens": tokens}, cache0, ctx))
        same = torch.equal(logits, logits_w) and all(
            torch.equal(a[n], b[n])
            for a, b in zip(cache["prefix"] + list(cache["unit"]),
                            cache_w["prefix"] + list(cache_w["unit"]))
            for n in a)
        del cache_w
        log(f"[{cfg.name} prefill {tag}] B {B} x S {S}: cold {cold_ms:.1f} "
            f"ms, warm {warm_ms:.1f} ms ({B * S / warm_ms * 1e3:.0f} "
            f"tokens/s); two runs bitwise {same}; launches "
            + json.dumps(launches))
        want = model_launches(cfg, flash)
        if {k: launches[k] for k in want} != want or any(
                c for k, c in launches.items() if k not in want):
            raise AssertionError(f"[{cfg.name} prefill {tag}] launches "
                                 f"{launches}, want {want} and no other")
        if not same:
            raise AssertionError(f"[{cfg.name} prefill {tag}] two runs "
                                 "differ")
        if (tuple(logits.shape) != (B, 1, cfg.vocab_size)
                or not torch.isfinite(logits).all()):
            raise AssertionError(f"[{cfg.name} prefill {tag}] logits are not "
                                 "finite [B, 1, V]")
        out[tag] = {"logits": logits, "cache": cache, "cold_ms": cold_ms,
                    "warm_ms": warm_ms, "launches": launches}
    # free-running, the routes' MoE calls recorded: the tokens that either
    # route's routing rule sets aside at some layer (a model with no MoE
    # layer records none)
    recs = {True: [], False: []}
    for flash in (True, False) if cfg.moe is not None else ():
        with RecordRoutes(torch) as rec:
            prefill(params, {"tokens": tokens}, cache0,
                    Ctx(cfg=cfg, flash=flash))
        recs[flash] = rec.calls
    wall, busy, top = profile_device(torch, lambda: prefill(
        params, {"tokens": tokens}, cache0, Ctx(cfg=cfg, flash=True)))
    log(f"[{cfg.name} prefill flash] profiled run {wall:.3f} s, device busy "
        f"{busy:.3f} s ({100 * busy / wall:.1f}% of the traced wall)")
    for ms, cnt, key in top:
        log(f"  {ms:10.3f} ms {cnt:6d}x {key[:110]}")
    del cache0
    aside = torch.zeros(B * S, dtype=torch.bool)
    aside_by_layer = []
    for a, b in zip(recs[True], recs[False]):
        near, flip, moved, _ = routes_compare(torch, a, b)
        aside_by_layer.append(int((near | flip | moved).sum()))
        aside |= near | flip | moved
    last_aside = aside.view(B, S)[:, -1]
    f, c = out["flash"], out["chunked"]
    row_gaps = ((f["logits"].float() - c["logits"].float()).abs().amax(
        (1, 2)) / c["logits"].float().abs().max()).cpu()
    trees = list(zip(f["cache"]["prefix"] + list(f["cache"]["unit"]),
                     c["cache"]["prefix"] + list(c["cache"]["unit"])))
    first = trees[0][0] if cfg.prefix else {
        n: t[0] for n, t in trees[0][0].items()}
    first_c = trees[0][1] if cfg.prefix else {
        n: t[0] for n, t in trees[0][1].items()}
    layer0 = all(torch.equal(first[n], first_c[n]) for n in first)
    cache_gap = max(rel_gap(torch, a[n], b[n]) for a, b in trees for n in a)
    # a model with no attention layer takes one path on both routes
    one_path = not model_launches(cfg, True)["flash_fwd"]
    if one_path and not (torch.equal(f["logits"], c["logits"]) and all(
            torch.equal(a[n], b[n]) for a, b in trees for n in a)):
        raise AssertionError(f"[{cfg.name}] the routes differ, but the model "
                             "has no attention layer")
    logit_gap = float(row_gaps[~last_aside].max()) if (
        ~last_aside).any() else 0.0
    log(f"[{cfg.name} prefill] flash vs chunked route: first layer's cache "
        f"bitwise {layer0}; caches within {cache_gap:.3g} of their max |.| "
        f"(all layers, the routing rule's tokens included); tokens set "
        f"aside by the routing rule, free-running, per MoE layer "
        f"{aside_by_layer} ({int(aside.sum())} of {B * S} in all); last "
        f"logits per row {[round(float(g), 5) for g in row_gaps]} of max "
        f"|logit|, the row's last token set aside "
        f"{last_aside.tolist()}; the others within {logit_gap:.3g} (tol "
        f"{ROUTE_TOL:.3g})")
    if not layer0 or logit_gap > ROUTE_TOL:
        raise AssertionError(f"[{cfg.name}] the flash and chunked routes "
                             "disagree")
    return {"flash": f, "chunked_cache": c["cache"],
            "launches": {"flash": f["launches"], "chunked": c["launches"]},
            "summary": {"B": B, "S": S, "layers": cfg.n_layers,
                        "one_path_bitwise": one_path,
                        "flash_warm_ms": f["warm_ms"],
                        "chunked_warm_ms": c["warm_ms"],
                        "flash_cold_ms": f["cold_ms"],
                        "chunked_cold_ms": c["cold_ms"],
                        "flash_tokens_per_s": B * S / f["warm_ms"] * 1e3,
                        "chunked_tokens_per_s": B * S / c["warm_ms"] * 1e3,
                        "layer0_bitwise": layer0, "cache_gap": cache_gap,
                        "aside_by_layer": aside_by_layer,
                        "row_logit_gaps": row_gaps.tolist(),
                        "last_token_aside": last_aside.tolist(),
                        "logit_gap": logit_gap, "busy_share": busy / wall,
                        "profile_top": [[ms, cnt, key[:80]]
                                        for ms, cnt, key in top]}}


def zoo_walk(torch, cfg, params, tokens):
    """The routes layer by layer, each layer given the same input on both
    (the chunked route's, carried on): at each MoE layer the router is
    recomputed on both routes' FFN inputs; tokens at a margin under
    NEAR_TIE are set aside and counted, tokens whose experts differ are
    counted with their margins (each under FLIP_MARGIN: a bf16 rounding of
    the router's input moves its probabilities by up to a few 1e-3) and
    set aside too, and so are tokens that only the capacity's edge, moved
    by such a token earlier in the order, keeps on one route and drops on
    the other; every other token's layer output is held within ROUTE_TOL
    of max |.|."""
    from repro_torch.models import Ctx
    from repro_torch.models.model import _embed, apply_layer
    B, S = tokens.shape
    pos = torch.arange(S, device=DEVICE)
    ctx_f = Ctx(cfg=cfg, positions=pos, flash=True)
    ctx_c = Ctx(cfg=cfg, positions=pos, flash=False)
    one_path = not model_launches(cfg, True)["flash_fwd"]
    x = _embed(params, cfg, {"tokens": tokens}, ctx_c)
    rows, t0 = [], time.perf_counter()
    for i, (spec, p) in enumerate(zoo_layers(cfg, params)):
        out_c, r_c = layer_parts(spec, p, x, ctx_c)
        if i == 0:  # the walk's steps are apply_layer's
            same = torch.equal(out_c, apply_layer(spec, p, x, ctx_c)[0])
            if not same:
                raise AssertionError("layer_parts differs from apply_layer")
        out_f, r_f = layer_parts(spec, p, x, ctx_f)
        keep = torch.ones(B * S, dtype=torch.bool)
        row = {"layer": i, "mixer": spec.mixer, "ffn": spec.ffn}
        if spec.ffn == "moe":
            rc = routing(torch, cfg, p["ffn"], r_c, False)
            near, flip, moved, margin = routes_compare(
                torch, routing(torch, cfg, p["ffn"], r_f, False), rc)
            wide = flip & ~near
            row.update(near_ties=int(near.sum()), flips=int(flip.sum()),
                       flips_wider=int(wide.sum()),
                       widest_flip_margin=float(margin[flip].max())
                       if flip.any() else 0.0,
                       capacity_moved=int(moved.sum()),
                       dropped_slots=int((rc[1] < 0).sum()),
                       router_input_gap=rel_gap(torch, r_f, r_c))
            keep = ~(near | flip | moved)
            if flip.any() and margin[flip].max() >= FLIP_MARGIN:
                log(f"[{cfg.name} walk] layer {i}: " + json.dumps(row))
                raise AssertionError(
                    f"[{cfg.name}] layer {i}: the routes' experts differ at "
                    f"{int(flip.sum())} tokens, widest margin "
                    f"{row['widest_flip_margin']:.3g}")
        keep = keep.to(DEVICE).reshape(B, S)
        gap = ((out_f.float() - out_c.float()).abs().amax(-1)[keep].max()
               / out_c.float().abs().max()).item()
        row["out_gap"] = gap
        if one_path and not torch.equal(out_f, out_c):
            raise AssertionError(f"[{cfg.name}] layer {i}: the routes' "
                                 "outputs differ, but the model has no "
                                 "attention layer")
        rows.append(row)
        log(f"[{cfg.name} walk] layer {i} ({spec.mixer}, {spec.ffn}): "
            + json.dumps({k: v for k, v in row.items()
                          if k not in ("layer", "mixer", "ffn")}))
        if gap > ROUTE_TOL:
            raise AssertionError(f"[{cfg.name}] layer {i}: the routes' "
                                 f"outputs differ by {gap:.3g} of max |.|")
        x = out_c
        del out_f, r_f, r_c
    moe_rows = [r for r in rows if r["ffn"] == "moe"]
    summary = {k: sum(r[k] for r in moe_rows)
               for k in ("near_ties", "flips", "flips_wider",
                         "capacity_moved", "dropped_slots")}
    summary.update(widest_flip_margin=max((r["widest_flip_margin"]
                                           for r in moe_rows), default=0.0),
                   out_gap=max(r["out_gap"] for r in rows),
                   tokens_per_layer=B * S, walk_s=time.perf_counter() - t0)
    log(f"[{cfg.name} walk] {len(moe_rows)} MoE layers x {B * S} tokens: "
        f"{summary['near_ties']} set aside at a margin under {NEAR_TIE:g}, "
        f"experts differ at {summary['flips']} ({summary['flips_wider']} of "
        f"them at a wider margin, the widest "
        f"{summary['widest_flip_margin']:.3g}), the capacity's edge moved "
        f"{summary['capacity_moved']} more; other tokens within "
        f"{summary['out_gap']:.3g} of max |.| (tol {ROUTE_TOL:.3g}); "
        f"{summary['dropped_slots']} slots dropped by capacity on the "
        "chunked route")
    return {"layers": rows, "summary": summary}


def model_launches(cfg, flash, passes=1):
    """Launches of the kernels a model's layers launch, F (attention), L
    (Mamba) and M (RWKV-6), that ``passes`` passes over every layer of
    ``cfg`` make (F only on the flash route, and only in a prefill)."""
    n = collections.Counter(s.mixer for s in list(cfg.prefix)
                            + list(cfg.unit) * cfg.n_repeats)
    return {"flash_fwd": n["attn"] + n["mla"] if flash else 0,
            "selective_scan": n["mamba"] * passes,
            "wkv6": n["rwkv"] * passes}


def tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def decode_bound(torch, cfg, params, cache, index, experts_used, B):
    """The least bytes one decode step at position ``index`` moves: every
    weight it uses read once (the routed experts this step's tokens chose,
    ``experts_used`` per MoE layer), the cache up to ``index`` read and its
    entry written (a recurrent layer's state read and written whole), the
    logits written; and its bf16 operations (2 a
    multiply-add of the weights it uses, per token).  Returns (ms, by,
    bytes)."""
    emb = params["embed"]["emb"]
    nb = B * emb.shape[1] * emb.element_size()
    nb += tree_bytes(params["final_norm"]) + tree_bytes(params["lm_head"])
    macs = params["lm_head"].numel()
    it = iter(experts_used)
    for spec, p in zoo_layers(cfg, params):
        nb += tree_bytes(p["norm1"]) + tree_bytes(p["norm2"])
        nb += tree_bytes(p["mix"])
        macs += sum(t.numel() for t in p["mix"].values())
        f = p["ffn"]
        if spec.ffn == "moe":
            per = sum(f[n][0].numel() for n in ("w_in", "w_gate", "w_out"))
            used = next(it)
            nb += tree_bytes(f["router"]) + used * per * f["w_in"].element_size()
            macs += f["router"].numel() + cfg.moe.top_k * per
            if "shared" in f:
                nb += tree_bytes(f["shared"])
                macs += sum(t.numel() for t in f["shared"].values())
        else:
            nb += tree_bytes(f)
            macs += sum(t.numel() for t in f.values())
    from repro_torch.models.model import STATE_KEYS
    seq = {"k": 2, "v": 2, "ckv": 1, "krope": 1}  # a layer cache's S axis
    for trees, lead in ((cache["prefix"], 0), (cache["unit"], 1)):
        for tree in trees:  # the unit's caches carry a leading repeat axis
            for n, t in tree.items():
                if n in STATE_KEYS:  # a recurrent state: read, then written
                    nb += 2 * t.numel() * t.element_size()
                    continue
                per_pos = t.numel() // t.shape[seq[n] + lead]
                nb += per_pos * t.element_size() * (index + 2)
    nb += B * cfg.vocab_size * 2  # bf16 logits
    t_bytes = nb / PEAK_BYTES_S * 1e3
    t_ops = 2 * macs * B / PEAK_FLOPS["bfloat16"] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nb)


def zoo_decode_bound(torch, cfg, params, cache, index, tokens):
    """One more decode step from ``cache`` at ``index`` with its routes
    recorded: the experts its tokens use per MoE layer, and its bound."""
    from repro_torch.models import make_decode_step
    with RecordRoutes(torch) as rec:
        make_decode_step(cfg)(params, tokens, cache, index)
    used = [int(idx.unique().numel()) for idx, _, _ in rec.calls]
    ms, by, nb = decode_bound(torch, cfg, params, cache, index, used,
                              tokens.shape[0])
    return {"bound_ms": ms, "bound_by": by, "bytes": nb,
            "experts_used": used}


def zoo_decode_compare(torch, cfg, params, serve, caches):
    """ServeEngine's tokens fed back, teacher-forced, through decode steps
    from the chunked route's prefill cache (the engine's own route: its
    logits must equal the engine's bit for bit) and from the flash
    route's, with every MoE call's routing recorded.  A step's token whose
    experts differ between the two, or sit at a margin under NEAR_TIE, or
    whose kept slots differ, is set aside and counted; every other step's
    logits are held within ROUTE_TOL of max |logit|.  The two caches
    differ at the tokens the prefill's routing rule set aside, so a
    decode token's router input moves by more than a rounding, and its
    flips are counted with their widest margin but not bounded by
    FLIP_MARGIN.  Then the flash route's decode runs again from its cache
    with the chunked route's experts and gates forced on every MoE call
    (``moe.forced_routes``): every set-aside step is held within
    ROUTE_TOL there, and the steps still set aside are counted."""
    from repro_torch.models import make_decode_step
    from repro_torch.models import moe as moe_mod
    served, B = serve["served"], serve["served"].shape[0]
    n, S = served.shape[1], PREFILL_S
    decode = make_decode_step(cfg)
    runs, raw = {}, {}

    def teacher_forced(cache):
        cache = fresh_states(cache)
        logits = []
        for i in range(n):
            lg, cache = decode(params, served[:, i:i + 1].long(), cache,
                               S + i)
            logits.append(lg[:, -1].float())
        return torch.stack(logits)  # [n, B, V]

    for tag, cache in caches.items():
        with RecordRoutes(torch) as rec:
            logits = teacher_forced(cache)
        runs[tag], raw[tag] = (logits, rec.calls), rec.raw
    own, engine = runs["chunked"][0], serve["logits"]
    same = all(torch.equal(own[i], engine[i + 1]) for i in range(n))
    if not same:
        raise AssertionError(f"[{cfg.name}] decode from the chunked route's "
                             "prefill differs from ServeEngine's")
    n_moe = len(runs["flash"][1]) // n
    keep = torch.ones((n, B), dtype=torch.bool)
    near_n = flip_n = moved_n = 0
    widest = 0.0
    for j, (a, b) in enumerate(zip(runs["flash"][1], runs["chunked"][1])):
        near, flip, moved, margin = routes_compare(torch, a, b)
        near_n, flip_n = near_n + int(near.sum()), flip_n + int(flip.sum())
        moved_n += int(moved.sum())
        if flip.any():
            widest = max(widest, float(margin[flip].max()))
        keep[j // n_moe] &= ~(near | flip | moved)
    f, c = runs["flash"][0], runs["chunked"][0]
    gap = ((f - c).abs().amax(-1)[keep].max() / c.abs().max()).item() \
        if keep.any() else 0.0
    log(f"[{cfg.name} decode] teacher-forced on ServeEngine's tokens: the "
        f"chunked route's cache gives the engine's logits bit for bit; "
        f"flash against chunked over {n} steps x {B} rows: {near_n} "
        f"routings at a margin under {NEAR_TIE:g}, experts differ at "
        f"{flip_n} (widest margin {widest:.3g}), the capacity's edge moved "
        f"{moved_n}; logits of {int(keep.sum())} of {n * B} within "
        f"{gap:.3g} of max |logit| (tol {ROUTE_TOL:.3g})")
    if gap > ROUTE_TOL:
        raise AssertionError(f"[{cfg.name}] the routes' decodes disagree")
    # the set-aside steps again: the flash route's decode with the chunked
    # route's experts and gates forced (a step rewrites only its own
    # attention cache entry, and each run takes fresh recurrent states, so
    # the flash cache serves again); a model with no MoE layer has no
    # routing to force, and its first run serves
    routes = iter(raw["chunked"])
    if raw["chunked"]:
        with moe_mod.forced_routes(routes):
            forced = teacher_forced(caches["flash"])
    else:
        forced = f
    if next(routes, None) is not None:
        raise AssertionError(f"[{cfg.name}] the forced decode took fewer "
                             "routes than the chunked route's decode made")
    aside = ~keep
    rerun = ((forced - c).abs().amax(-1) / c.abs().max()).cpu()  # [n, B]
    held = aside & (rerun <= ROUTE_TOL)
    still = int(aside.sum() - held.sum())
    forced_gap = rerun[aside].max().item() if aside.any() else 0.0
    log(f"[{cfg.name} decode] the flash route again with the chunked "
        f"route's routing forced: {int(aside.sum())} set-aside steps "
        f"within {forced_gap:.3g} of max |logit| (tol {ROUTE_TOL:.3g}), "
        f"{still} of {n * B} still set aside; every step "
        f"{rerun.max().item():.3g}")
    if still:
        raise AssertionError(f"[{cfg.name}] {still} set-aside decode steps "
                             "disagree with the routing forced")
    return {"engine_bitwise": same, "near_ties": near_n, "flips": flip_n,
            "widest_flip_margin": widest, "capacity_moved": moved_n,
            "compared": int(keep.sum()), "logit_gap": gap,
            "set_aside": int(aside.sum()), "forced_gap": forced_gap,
            "forced_gap_all": rerun.max().item(), "still_set_aside": still}


def zoo_cpu_rerun(torch, build):
    """(c): deepseek-v2-lite at full width with its prefix and 1 repeat, in
    f32: a prefill of 1 x 256 and 4 greedy decode steps on the card and on
    the CPU, every MoE call's routing recorded on both.  A token at a
    margin under NEAR_TIE on either side is set aside (its logits not
    compared: the one MoE layer is the last, so a token's experts reach
    only its own logits); a token whose experts differ at a wider margin
    fails the run; the other logits are held within CPU_RERUN_TOL."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import (Ctx, init_cache, init_params,
                                    make_decode_step, make_prefill)
    arch, repeats, S, n = ZOO_RERUN
    cfg = dataclasses.replace(get_config(arch), n_repeats=repeats,
                              compute_dtype="float32")
    t0 = time.perf_counter()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    init_s = time.perf_counter() - t0
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, S)))

    def run(p, device):
        with RecordRoutes(torch) as rec:
            cache = init_cache(cfg, 1, S + n, torch.float32, device)
            logits, cache = make_prefill(cfg)(
                p, {"tokens": prompt.to(device)}, cache,
                Ctx(cfg=cfg, flash=True))
            decode = make_decode_step(cfg)
            seen, toks = [logits[:, -1].cpu()], []
            for i in range(n):
                toks.append(torch.argmax(logits[:, -1], dim=-1))
                logits, cache = decode(p, toks[-1][:, None], cache, S + i)
                seen.append(logits[:, -1].cpu())
        return torch.stack(toks, 1).cpu(), torch.cat(seen), rec.calls

    build.reset_launch_counts()
    (card_toks, card_logits, card_routes), card_ms = timed_once(
        torch, lambda: run(tree_to(params, DEVICE), DEVICE))
    counts = build.launch_counts()
    t0 = time.perf_counter()
    cpu_toks, cpu_logits, cpu_routes = run(params, "cpu")
    cpu_s = time.perf_counter() - t0
    # the compared logits: the prompt's last token, then each decode token
    # (MoE calls: the prefill's, then one a decode step)
    keep = torch.ones(n + 1, dtype=torch.bool)
    near_n = flip_n = moved_n = dropped = 0
    for j, (a, b) in enumerate(zip(card_routes, cpu_routes)):
        near, flip, moved, margin = routes_compare(torch, a, b)
        near_n += int(near.sum())
        flip_n += int(flip.sum())
        moved_n += int(moved.sum())
        dropped += int((b[1] < 0).sum())
        if (flip & ~near).any():
            raise AssertionError(
                f"[cpu re-run {arch}] MoE call {j}: experts differ at a "
                f"margin of {float(margin[flip & ~near].min()):.3g}")
        # the prefill's last token, or the step's one token
        if near[-1] or moved[-1]:
            keep[j] = False
    scale = cpu_logits[keep].abs().max()
    gap = ((card_logits[keep] - cpu_logits[keep]).abs().max()
           / scale).item()
    equal = torch.equal(card_toks, cpu_toks)
    log(f"[cpu re-run] {arch} x {repeats} repeat + prefix, f32, 1 x {S} + "
        f"{n}: card {card_ms:.0f} ms, CPU {cpu_s:.1f} s (params drawn in "
        f"{init_s:.1f} s); {near_n} routings set aside at a margin under "
        f"{NEAR_TIE:g}, experts differ at {flip_n}, the capacity's edge "
        f"moved {moved_n}, {dropped} slots dropped (CPU); logits of "
        f"{int(keep.sum())} of {n + 1} tokens within {gap:.3g} of max "
        f"|logit| (tol {CPU_RERUN_TOL}), tokens equal {equal}; launches "
        + json.dumps(counts))
    if gap > CPU_RERUN_TOL or not equal:
        raise AssertionError(f"[cpu re-run {arch}] the CPU disagrees with "
                             "the card")
    return {"arch": arch, "repeats": repeats, "S": S, "steps": n,
            "logit_gap": gap, "tokens_equal": equal, "near_ties": near_n,
            "flips": flip_n, "capacity_moved": moved_n,
            "dropped_slots": dropped, "compared": int(keep.sum()),
            "cpu_s": cpu_s,
            "card_ms": card_ms, "init_s": init_s, "launches": counts}


def zoo_model(torch, build, arch, repeats):
    """(a) or (b): one model at its published widths with ``repeats``
    repeats, random params from seed 0 drawn on the card."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, make_decode_step
    cfg = dataclasses.replace(get_config(arch), n_repeats=repeats)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params, init_ms = timed_once(torch, lambda: init_params(
        torch.Generator(device=DEVICE).manual_seed(0), cfg, device=DEVICE))
    log(f"[{arch}] {cfg.n_layers} layers ({repeats} of "
        f"{get_config(arch).n_repeats} repeats), {cfg.param_count()} params "
        f"({cfg.param_dtype}; the whole model {get_config(arch).param_count()}"
        f") drawn on the card in {init_ms:.0f} ms, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    parts, t_part = {}, [time.perf_counter()]

    def part(name):
        t = time.perf_counter()
        parts[name] = t - t_part[0]
        t_part[0] = t
    part("init")
    moe = moe_check(torch, cfg, params) if cfg.moe is not None else None
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_S))).to(DEVICE)
    part("moe_check")
    pre = zoo_prefill(torch, build, cfg, params, tokens)
    part("prefill")
    walk = zoo_walk(torch, cfg, params, tokens)
    part("walk")
    serve = serve_phase(torch, build, cfg, params, tokens, pre["flash"],
                        tag=f"{arch} serve", gate_parting=False)
    part("serve")
    # the engine's prefill and NEW_TOKENS decode steps: each runs every layer
    want = model_launches(cfg, False, passes=1 + NEW_TOKENS)
    if {k: serve["launches"][k] for k in want} != want:
        raise AssertionError(f"[{arch} serve] launches {serve['launches']}, "
                             f"want {want}")
    forced = zoo_decode_compare(torch, cfg, params, serve,
                                {"flash": pre["flash"]["cache"],
                                 "chunked": pre.pop("chunked_cache")})
    part("decode_compare")
    cache = pre["flash"]["cache"]
    tok = torch.argmax(pre["flash"]["logits"][:, -1], dim=-1)[:, None]
    bound = zoo_decode_bound(torch, cfg, params, fresh_states(cache),
                             PREFILL_S + NEW_TOKENS - 1, tok)
    log(f"[{arch} decode] {serve['decode_p50_ms']:.2f} ms a step (p50), its "
        f"bound {bound['bound_ms']:.3f} ms by {bound['bound_by']} "
        f"({bound['bytes'] / 1e9:.2f} GB at {PEAK_BYTES_S / 1e12:.2f} TB/s; "
        f"experts used per MoE layer {bound['experts_used']}), "
        f"{serve['decode_p50_ms'] / bound['bound_ms']:.2f} x the bound")
    decode = make_decode_step(cfg)

    def steps():
        c = fresh_states(cache)
        for i in range(PROFILED_STEPS):
            _, c = decode(params, tok, c, PREFILL_S + NEW_TOKENS - 1 - i)

    part("decode_bound")
    wall, busy, top = profile_device(torch, steps)
    part("decode_profile")
    log(f"[{arch} decode] {PROFILED_STEPS} profiled steps {wall * 1e3:.1f} "
        f"ms, device busy {busy * 1e3:.1f} ms ({100 * busy / wall:.1f}% of "
        "the traced wall)")
    for ms, cnt, key in top:
        log(f"  {ms:10.3f} ms {cnt:6d}x {key[:110]}")
    bound.update(profiled_ms_per_step=wall * 1e3 / PROFILED_STEPS,
                 busy_share=busy / wall,
                 profile_top=[[ms, cnt, key[:80]] for ms, cnt, key in top])
    peak = torch.cuda.max_memory_allocated()
    del params, cache, pre["flash"]
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t0
    log(f"[{arch}] peak {peak / 2**30:.2f} GiB allocated; {phase_s:.1f} s ("
        + json.dumps({k: round(v, 2) for k, v in parts.items()}) + ")")
    return {"arch": arch, "repeats": repeats, "layers": cfg.n_layers,
            "params": cfg.param_count(), "moe_check": moe,
            "prefill": pre["summary"], "walk": walk["summary"],
            "serve": {k: v for k, v in serve.items()
                      if k not in ("launches", "served", "logits")},
            "decode_forced": forced, "decode_bound": bound, "peak_gib": peak / 2**30,
            "phase_s": phase_s, "part_s": parts,
            "launches": {"prefill_flash": pre["launches"]["flash"],
                         "prefill_chunked": pre["launches"]["chunked"],
                         "serve_generate": serve["launches"]}}


def zoo_phase(torch, build):
    """Phase 22: kernel F at the two models' prefill shapes, then (a) dbrx,
    (b) deepseek-v2-lite, (c) the CPU re-run; (d), the decode bound, is in
    (a) and (b)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(22)
    f_cases = {arch: flash_case(torch, gen, shape, Dv, True, "bfloat16")
               for arch, (shape, Dv) in ZOO_FLASH_SHAPES.items()}
    models = [zoo_model(torch, build, arch, r) for arch, r in ZOO]
    rerun = zoo_cpu_rerun(torch, build)
    launches = {}
    for m in models:
        launches.update({f"{m['arch']} {p}": c
                         for p, c in m.pop("launches").items()})
    launches["zoo_cpu_rerun_card"] = rerun.pop("launches")
    phase_s = time.perf_counter() - t0
    log(f"phase 22: {phase_s:.1f} s")
    return {"flash_cases": f_cases, "models": models, "cpu_rerun": rerun,
            "launches": launches, "phase_s": phase_s}


# ---------------------------------------------------------------------------
# phase 24: Mamba and RWKV-6 at the published widths (jamba-v0.1-52b,
# rwkv6-3b), kernels L and M
# ---------------------------------------------------------------------------

# (arch, repeats kept): jamba 1 of its 4 (8 layers: 7 Mamba, 1 attention,
# 4 MoE; bf16, 13.30 B params, 26.6 GB), rwkv6-3b all 32 (f32, 12.3 GB)
SSM_ZOO = (("jamba-v0.1-52b", 1), ("rwkv6-3b", 32))
SCAN_TOL = 1e-5           # kernel against its plain version, of max |plain|
SCAN_ORACLE_TOL = 1e-4    # kernel against the float64 plain version
SCAN_CHUNK = 1000         # chunked calls: the state carried every 1000 steps
SCAN_ONE_BY_ONE = 64      # one-step calls against one call of as many steps
# each kernel's shapes: L (B, T, d_inner, d_state) at jamba's prefill, a
# decode step, a ragged cut (d_inner not a multiple of the block of 64, nor
# of 8: 4-byte copies) and the same at d_state 8 (4 states a lane); M (B,
# T, H, head_dim) at rwkv6-3b's, and at head dim 16 (4 key channels a
# lane) with B x H = 3 x 5
SCAN_SHAPES = {
    "selective_scan": {"prefill": (4, 4096, 8192, 16),
                       "decode": (4, 1, 8192, 16),
                       "ragged": (1, 1001, 8190, 16),
                       "ragged_ds8": (1, 1001, 8190, 8)},
    "wkv6": {"prefill": (4, 4096, 40, 64), "decode": (4, 1, 40, 64),
             "ragged": (1, 1001, 40, 64), "hd16": (3, 1001, 5, 16)}}
SCAN_SOURCE = {"selective_scan": ("src/repro_torch/kernels/scans/csrc/"
                                  "selective_scan.cu",
                                  "src/repro/models/mamba.py:90"),
               "wkv6": ("src/repro_torch/kernels/scans/csrc/wkv6.cu",
                        "src/repro/models/rwkv.py:89")}
# f32 operations of one step's element as the sources write them: L per
# (b, t, d, s): dt*A, dt*B, *x, dA*h, +, h*C, + (and one expf); M per (b, t,
# h, i, j): k*v, u*kv, +S, r*a, +y, w*S, +kv
SCAN_OPS = {"selective_scan": 7, "wkv6": 7}
# special-function results a second (H100 SXM: 16 a clock an SM, the CUDA
# C++ Programming Guide's throughput table for compute capability 9.0; 132
# SMs at 1.98 GHz): L's expf runs on these units
SFU_OPS_S = 132 * 16 * 1.98e9
# f32 instructions a second when each is issued alone (no fused multiply-
# add: the rounding contract), one a clock a lane: 4 schedulers of 32 lanes
# an SM, 132 SMs at 1.98 GHz
LANE_OPS_S = 132 * 128 * 1.98e9
# SASS opcodes that run on the f32 pipes
F32_OPCODES = ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX")
# (c): the published widths cut in depth, in f32 (params and compute), on
# the card and on the CPU: a prefill of 1 x 256 and 4 greedy decode steps
SSM_RERUN_S, SSM_RERUN_STEPS = 256, 4
SSM_RERUN_TIMEOUT_S = 300


def scan_fns(name):
    from repro_torch.kernels.scans import selective_scan, wkv6
    if name == "selective_scan":
        return (selective_scan.selective_scan,
                selective_scan.selective_scan_plain,
                selective_scan.SELECTIVE_SCAN_KERNEL)
    return wkv6.wkv6, wkv6.wkv6_plain, wkv6.WKV6_KERNEL


def scan_operands(torch, name, shape, seed):
    """Operands of kernel L or M at ``shape`` on the card, from a seeded
    generator: the compute-dtype ones in bf16, as the models pass them.  L:
    x, B, C ~ N(0, 1), dt in [1e-3, 0.1] (softplus of the initial dt_bias'
    range), A = -(1..ds) (-exp(A_log) at init), h0 ~ 0.1 N(0, 1).  M: r, k,
    v ~ N(0, 1), w = exp(-exp(U[-8, 0])) (decays from 0.37 to 1), u and S0
    ~ 0.1 N(0, 1)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def n(*shape_, dtype=torch.float32):
        return torch.randn(shape_, generator=gen, device=DEVICE).to(dtype)

    def u(lo, hi, *shape_):
        return lo + (hi - lo) * torch.rand(shape_, generator=gen,
                                           device=DEVICE)
    bf = torch.bfloat16
    if name == "selective_scan":
        B, T, di, ds = shape
        A = -torch.arange(1, ds + 1, dtype=torch.float32,
                          device=DEVICE).repeat(di, 1)
        return (n(B, T, di, dtype=bf), u(1e-3, 0.1, B, T, di),
                n(B, T, ds, dtype=bf), n(B, T, ds, dtype=bf), A,
                0.1 * n(B, di, ds))
    B, T, H, hd = shape
    return (n(B, T, H, hd, dtype=bf), n(B, T, H, hd, dtype=bf),
            n(B, T, H, hd, dtype=bf),
            torch.exp(-torch.exp(u(-8.0, 0.0, B, T, H, hd))),
            0.1 * n(H, hd), 0.1 * n(B, H, hd, hd))


def scan_cut(ops, lo, hi, state):
    """The operands of steps [lo, hi) with ``state`` as the initial one
    (the time axis is 1 in every per-step operand)."""
    return tuple(t[:, lo:hi] for t in ops[:4]) + (ops[4], state)


def scan_bound(name, ops, outs):
    """(ms, by): the bytes (each operand read once, each output written
    once) over 3.35 TB/s, against the f32 operations over 67 TFLOP/s and,
    for L, its expf calls over the special function units' rate."""
    nb = nbytes(*ops, *outs)
    elems = outs[0].numel() * (ops[4].shape[-1] if name == "selective_scan"
                               else ops[0].shape[-1])
    t_bytes = nb / PEAK_BYTES_S * 1e3
    t_ops = max(SCAN_OPS[name] * elems / PEAK_OPS_S,
                elems / SFU_OPS_S if name == "selective_scan" else 0.0) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nb)


# each element's FMULs as the sources write them (no product fused with
# its sum): L's dt*A, dt*B, *x, dA*h, h*C and the one in the library's
# expf; M's k*v, u*kv, r*a, w*S.  They count the elements a pass of a
# step loop covers.
SCAN_FMULS = {"selective_scan": 6, "wkv6": 4}
# the elements a pass of each step loop covers by design, at the prefill
# shape: L 4 steps x 8 states a lane, M 2 steps x 8 key channels x 2
# columns; a count from the SASS that differs means SCAN_FMULS no longer
# matches the compiled code
SCAN_LOOP_ELEMENTS = {"selective_scan": 32, "wkv6": 32}


def scan_key(name, shape):
    """The mangled name's part that picks the bf16 instantiation of kernel
    L (by d_state) or M (by head dim) at ``shape``."""
    stem = "selective_scan_kernel" if name == "selective_scan" else \
        "wkv6_kernel"
    return f"{stem}I13__nv_bfloat16Li{shape[3]}E"


def sass_step_loop(kernel, key):
    """Opcode counts (NOPs left out) of the hottest loop of the function of
    ``kernel``'s library whose mangled name holds ``key``: of the loops
    that ``cuobjdump -sass`` shows (a branch back to an earlier address)
    and that hold no other, the one with the most FMULs: the steps'
    arithmetic."""
    import re
    from repro_torch.kernels.build import nvcc_path
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(kernel.library_path())],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    code, inside = [], False
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            if inside:
                break
            inside = key in m.group(1)
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z0-9_]+)(.*)", ln)
        if inside and m and m.group(2) != "NOP":
            code.append((int(m.group(1), 16), m.group(2), m.group(3)))
    loops = []
    for addr, op, rest in code:
        m = re.search(r"0x([0-9a-f]+)", rest)
        if op == "BRA" and m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    best = None
    for lo, hi in loops:
        if any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in loops):
            continue  # not an innermost loop
        loop = collections.Counter(o for a, o, _ in code if lo <= a <= hi)
        if best is None or loop["FMUL"] > best["FMUL"]:
            best = loop
    if best is None:
        raise AssertionError(f"no loop in the SASS of {key}")
    return best


def scan_floors(name, kernel, shape, elems):
    """Kernel L's or M's floors at ``shape`` (``elems`` (b, t, channel,
    state or key channel) elements) from the compiled step loop of its
    bf16 instantiation (``sass_step_loop``), counted an element (its FMULs
    over SCAN_FMULS): its instructions over LANE_OPS_S (one instruction a
    clock a lane), its f32 ones likewise, its MUFUs over SFU_OPS_S; and
    SCAN_OPS operations an element issued one by one (the rounding
    contract) over LANE_OPS_S; with the instantiation's registers and
    static shared memory (``ptxas -v``)."""
    key = scan_key(name, shape)
    ops = sass_step_loop(kernel, key)
    per = ops["FMUL"] / SCAN_FMULS[name]
    if per != SCAN_LOOP_ELEMENTS[name]:
        raise AssertionError(
            f"{name}: {ops['FMUL']} FMULs in the step loop's SASS are "
            f"{per:g} elements at {SCAN_FMULS[name]} an element, not the "
            f"design's {SCAN_LOOP_ELEMENTS[name]}: {dict(ops)}")
    every = sum(ops.values()) / per
    f32 = sum(ops[o] for o in F32_OPCODES) / per
    mufu = ops["MUFU"] / per
    res = next((v for k, v in ptxas_summary(kernel).items() if key in k),
               None)
    return {"loop_opcodes": dict(ops), "loop_elements": per,
            "instructions_per_element": every, "f32_per_element": f32,
            "mufu_per_element": mufu,
            "contract_floor_ms": SCAN_OPS[name] * elems / LANE_OPS_S * 1e3,
            "issue_floor_ms": every * elems / LANE_OPS_S * 1e3,
            "f32_floor_ms": f32 * elems / LANE_OPS_S * 1e3,
            "sfu_floor_ms": mufu * elems / SFU_OPS_S * 1e3,
            "ptxas": res}


def scan_case(torch, name, tag, shape, seed):
    """Kernel L or M at one shape against its plain version (SCAN_TOL of
    max |plain|, each output) and, at the prefill's and the ragged shape,
    the float64 plain version (SCAN_ORACLE_TOL); chunked calls that carry
    the state (every SCAN_CHUNK steps) and SCAN_ONE_BY_ONE one-step calls
    equal one call bit for bit; event ms, device ms, plain ms and bound."""
    fn, plain, _ = scan_fns(name)
    ops = scan_operands(torch, name, shape, seed)
    got = fn(*ops)
    ref, plain_ms = timed_once(torch, lambda: plain(*ops))
    row = {"shape": list(shape), "dtype": "bfloat16", "plain_ms": plain_ms}
    errs = [((g - r).abs().max() / r.abs().max()).item()
            for g, r in zip(got, ref)]
    row.update(max_abs_err=max((g - r).abs().max().item()
                               for g, r in zip(got, ref)),
               rel_err=max(errs), tolerance=SCAN_TOL)
    ok = max(errs) <= SCAN_TOL and all(torch.isfinite(g).all() for g in got)
    T = shape[1]
    if tag != "decode":
        r64 = plain(*(t.double() for t in ops))
        row["oracle_rel_err"] = max(
            ((g.double() - r).abs().max() / p.abs().max()).item()
            for g, r, p in zip(got, r64, ref))
        ok = ok and row["oracle_rel_err"] <= SCAN_ORACLE_TOL
        del r64
        parts, state = [], ops[5]
        for lo in range(0, T, SCAN_CHUNK):
            y, state = fn(*scan_cut(ops, lo, min(lo + SCAN_CHUNK, T), state))
            parts.append(y)
        row["chunked_bitwise"] = (torch.equal(torch.cat(parts, 1), got[0])
                                  and torch.equal(state, got[1]))
        n1 = min(SCAN_ONE_BY_ONE, T)
        whole = fn(*scan_cut(ops, 0, n1, ops[5]))
        parts, state = [], ops[5]
        for i in range(n1):
            y, state = fn(*scan_cut(ops, i, i + 1, state))
            parts.append(y)
        row["one_step_bitwise"] = (torch.equal(torch.cat(parts, 1), whole[0])
                                   and torch.equal(state, whole[1]))
        ok = ok and row["chunked_bitwise"] and row["one_step_bitwise"]
    row["ms"] = cuda_ms(torch, lambda: fn(*ops), 20 if T > 1 else 50)
    row["device_ms"] = device_ms(torch, lambda: fn(*ops), f"{name}_kernel",
                                 repeat=10)
    row["bound_ms"], row["bound_by"], row["bytes"] = scan_bound(name, ops,
                                                                got)
    log(f"[{name} {tag}] {list(shape)}: {row['rel_err']:.3g} of max |plain|"
        f" (tol {SCAN_TOL}), float64 {row.get('oracle_rel_err', 'n/a')}, "
        f"chunked bitwise {row.get('chunked_bitwise', 'n/a')}, one-step "
        f"bitwise {row.get('one_step_bitwise', 'n/a')}; {row['ms']:.4g} ms "
        f"(device {row['device_ms']}, plain {plain_ms:.1f} ms, bound "
        f"{row['bound_ms']:.4g} ms by {row['bound_by']}, "
        f"{row['bytes'] / 1e9:.3f} GB)")
    if not ok:
        raise AssertionError(f"kernel {name} disagrees with its plain "
                             f"version at {tag} {list(shape)}: {row}")
    return row


def scan_kernel_rows(torch, build):
    """Kernels L and M at each of their shapes (``scan_case``); the grad
    rule on the card; their floors at the prefill shape from the compiled
    code (``scan_floors``).  No launch here counts on a path."""
    rows = {}
    for i, name in enumerate(SCAN_SHAPES):
        fn, _, kernel = scan_fns(name)
        cases = {tag: scan_case(torch, name, tag, shape, 240 + 10 * i + j)
                 for j, (tag, shape) in enumerate(SCAN_SHAPES[name].items())}
        ops = [t.clone().requires_grad_(True) for t in scan_operands(
            torch, name, SCAN_SHAPES[name]["decode"], 7)]
        try:
            fn(*ops)
            raise AssertionError(f"kernel {name} ran grad-enabled inputs")
        except NotImplementedError as e:
            refused = str(e)
        src, replaces = SCAN_SOURCE[name]
        pre = cases["prefill"]
        rows[name] = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "max_abs_err": pre["max_abs_err"],
            "ms": pre["ms"], "device_ms": pre["device_ms"],
            "plain_ms": pre["plain_ms"], "bound_ms": pre["bound_ms"],
            "bound_by": pre["bound_by"], "library_ms": None,
            "library_note": "no PyTorch call computes the recurrence",
            "tolerance": f"{SCAN_TOL} x max |plain|", "shapes": cases,
            "grad_refused": refused,
            "ptxas": ptxas_lines(kernel)}
        B, T, c, e = SCAN_SHAPES[name]["prefill"]
        floors = rows[name]["floors"] = scan_floors(
            name, kernel, SCAN_SHAPES[name]["prefill"],
            B * T * c * (e if name == "selective_scan" else e * e))
        log(f"[{name}] its step loop's SASS ({floors['loop_elements']:g} "
            f"elements a pass): {floors['instructions_per_element']:.3f} "
            f"instructions an element ({floors['f32_per_element']:.3f} f32,"
            f" {floors['mufu_per_element']:.3f} MUFU); floors at the prefill "
            f"shape: {SCAN_OPS[name]} operations an element issued one by "
            f"one {floors['contract_floor_ms']:.4g} ms, the loop's "
            f"instructions {floors['issue_floor_ms']:.4g} ms, its f32 ones "
            f"{floors['f32_floor_ms']:.4g} ms, the special function units "
            f"{floors['sfu_floor_ms']:.4g} ms (ms {pre['ms']:.4g}); "
            f"{floors['ptxas']}")
    log("grad-enabled inputs refused on the card: "
        + json.dumps({n: r["grad_refused"][:60] for n, r in rows.items()}))
    return rows


def ssm_rerun_cfg(arch):
    """(c)'s configuration: jamba cut to a unit of two Mamba layers with
    dense FFNs (1.1 B params), rwkv6-3b to 2 of its 32 layers (0.51 B),
    both in f32 (params and compute)."""
    import dataclasses
    from repro_torch.configs import LayerSpec, get_config
    cfg = get_config(arch)
    kw = ({"unit": (LayerSpec("mamba", "dense"),) * 2, "n_repeats": 1}
          if arch.startswith("jamba") else {"n_repeats": 2})
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32", **kw)


def ssm_rerun_params(torch, cfg):
    """(c)'s params, drawn on the card from seed 0 (the same bits in the
    worker and here)."""
    from repro_torch.models import init_params
    return init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg,
                       device=DEVICE)


def ssm_rerun_run(torch, cfg, params, device):
    """A prefill of 1 x SSM_RERUN_S and SSM_RERUN_STEPS greedy decode steps:
    the tokens and the last logits of the prompt and of each step."""
    import numpy as np
    from repro_torch.models import init_cache, make_decode_step, make_prefill
    S, n = SSM_RERUN_S, SSM_RERUN_STEPS
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, S))).to(device)
    cache = init_cache(cfg, 1, S + n, torch.float32, device)
    logits, cache = make_prefill(cfg)(params, {"tokens": prompt}, cache)
    decode = make_decode_step(cfg)
    seen, toks = [logits[:, -1].cpu()], []
    for i in range(n):
        toks.append(torch.argmax(logits[:, -1], dim=-1))
        logits, cache = decode(params, toks[-1][:, None], cache, S + i)
        seen.append(logits[:, -1].cpu())
    return torch.stack(toks, 1).cpu(), torch.cat(seen)


def ssm_rerun_job(torch, arch, path_out):
    """(c)'s CPU half (``chip_smoke.py --ssm-cpu ARCH OUT``): the params
    drawn on the card, copied to the CPU, the card freed; the plain
    versions' prefill and decode; saves the tokens, logits and seconds."""
    os.nice(10)
    torch.set_num_threads(4)
    cfg = ssm_rerun_cfg(arch)
    t0 = time.perf_counter()
    params = tree_to(ssm_rerun_params(torch, cfg), "cpu")
    torch.cuda.empty_cache()
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.no_grad():
        toks, logits = ssm_rerun_run(torch, cfg, params, "cpu")
    torch.save({"tokens": toks, "logits": logits, "draw_s": draw_s,
                "cpu_s": time.perf_counter() - t0}, path_out)
    return 0


def ssm_rerun_start():
    """(c)'s CPU workers, one a model, started before the card's work of
    phase 24."""
    import shutil
    work = os.path.join(HERE, "build", "phase24_cpu")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    jobs = []
    for arch, _ in SSM_ZOO:
        stem = os.path.join(work, arch)
        logf = open(stem + ".log", "w")
        jobs.append({"arch": arch, "stem": stem, "log": logf,
                     "t0": time.perf_counter(), "proc": subprocess.Popen(
                         [sys.executable, os.path.abspath(__file__),
                          "--ssm-cpu", arch, stem + ".pt"], cwd=HERE,
                         stdout=logf, stderr=subprocess.STDOUT)})
    return jobs


def ssm_rerun_stop(jobs):
    for j in jobs:
        if j["proc"].poll() is None:
            j["proc"].kill()
        j["proc"].wait()
        j["log"].close()


def ssm_rerun_finish(torch, build, jobs):
    """(c): each model's card half (the same params, drawn here), then its
    CPU worker's result: the logits within CPU_RERUN_TOL of max |logit|,
    the tokens equal, and L or M launched on the card half only as the
    layers ask."""
    out = {}
    try:
        for j in jobs:
            arch = j["arch"]
            cfg = ssm_rerun_cfg(arch)
            params = ssm_rerun_params(torch, cfg)
            build.reset_launch_counts()
            with torch.no_grad():
                (toks, logits), card_ms = timed_once(
                    torch, lambda: ssm_rerun_run(torch, cfg, params, DEVICE))
            counts = build.launch_counts()
            del params
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            try:
                rc = j["proc"].wait(timeout=SSM_RERUN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"[cpu re-run {arch}] the CPU worker "
                                     f"took more than {SSM_RERUN_TIMEOUT_S} "
                                     "s") from None
            waited = time.perf_counter() - t0
            if rc != 0:
                j["log"].flush()
                with open(j["stem"] + ".log") as f:
                    tail = f.read()[-2000:]
                raise AssertionError(f"[cpu re-run {arch}] the CPU worker "
                                     f"exited {rc}: {tail}")
            ref = torch.load(j["stem"] + ".pt", weights_only=True)
            gap = rel_gap(torch, logits, ref["logits"])
            equal = torch.equal(toks, ref["tokens"])
            want = model_launches(cfg, False, passes=1 + SSM_RERUN_STEPS)
            row = out[arch] = {
                "params": cfg.param_count(), "layers": cfg.n_layers,
                "S": SSM_RERUN_S, "steps": SSM_RERUN_STEPS,
                "logit_gap": gap, "tokens_equal": equal, "card_ms": card_ms,
                "cpu_s": ref["cpu_s"], "worker_draw_s": ref["draw_s"],
                "worker_wall_s": time.perf_counter() - j["t0"],
                "waited_s": waited, "launches": counts}
            log(f"[cpu re-run] {arch} cut to {cfg.n_layers} layers "
                f"({cfg.param_count()} params, f32), 1 x {SSM_RERUN_S} + "
                f"{SSM_RERUN_STEPS}: card {card_ms:.0f} ms, CPU "
                f"{ref['cpu_s']:.1f} s in a worker beside the card's work "
                f"(its draw and copy {ref['draw_s']:.1f} s, waited "
                f"{waited:.1f} s here); logits within {gap:.3g} of max "
                f"|logit| (tol {CPU_RERUN_TOL}), tokens equal {equal}; "
                "launches " + json.dumps(counts))
            if gap > CPU_RERUN_TOL or not equal or {
                    k: counts[k] for k in want} != want:
                raise AssertionError(f"[cpu re-run {arch}] the CPU disagrees"
                                     f" with the card, or launches {counts}"
                                     f" are not {want}")
    finally:
        ssm_rerun_stop(jobs)
    return out


def ssm_phase(torch, build):
    """Phase 24: (c)'s CPU workers started; kernels L and M at their
    shapes; (a) jamba-v0.1-52b with 1 of its 4 repeats and (b) rwkv6-3b
    with all 32 layers at their published widths through phase 22's
    ``zoo_model`` (its every gate; L and M launched as the layers ask);
    then (c)'s card halves against the workers."""
    t0 = time.perf_counter()
    jobs = ssm_rerun_start()
    try:
        rows = scan_kernel_rows(torch, build)
        checks_s = time.perf_counter() - t0
        models = [zoo_model(torch, build, arch, r) for arch, r in SSM_ZOO]
    except BaseException:
        ssm_rerun_stop(jobs)
        raise
    rerun = ssm_rerun_finish(torch, build, jobs)
    launches = {}
    for m in models:
        launches.update({f"{m['arch']} {p}": c
                         for p, c in m.pop("launches").items()})
    for arch, r in rerun.items():
        launches[f"{arch} cpu_rerun_card"] = r.pop("launches")
    for name, row in rows.items():
        arch = "jamba-v0.1-52b" if name == "selective_scan" else "rwkv6-3b"
        row["launches"] = launches[f"{arch} prefill_flash"][name]
    phase_s = time.perf_counter() - t0
    log(f"phase 24: {phase_s:.1f} s (L's and M's checks {checks_s:.1f} s)")
    return {"rows": rows, "models": models, "cpu_rerun": rerun,
            "launches": launches, "checks_s": checks_s, "phase_s": phase_s}


# ---------------------------------------------------------------------------
# phase 16: the keyed Study (Firefly, CombinedMitigation, noisy telemetry),
# chunked, resumed and held against the CPU
# ---------------------------------------------------------------------------

KEYED_STREAM = 16         # the streamed runs' chunk size
KEYED_KILL_AFTER = 3      # chunks the resumed run finishes before it stops
KEYED_CPU_ROWS = dict(workloads=("dense_1s", "dense_3s"), fleets=(32768,),
                      configs=("ff90", "ff85_noisy", "ff85_noisy+bat8MJ+bs8",
                               "comb75_8MJ_n32768"))


def keyed_configs(api):
    """Phase 16's eight configurations: Firefly at its defaults, at engage
    0.90 / threshold 0.85, and with noisy telemetry (period 2 ms, latency
    2 ms, 20 W of noise); Firefly with an 8 MJ battery, noisy Firefly with
    the battery and a backstop stacked, ``CombinedMitigation`` (MPF 0.75
    and the 8 MJ battery) sized for each fleet, and the baseline."""
    bat = api.RackBattery(capacity_j=8e6, max_discharge_w=3e6,
                          max_charge_w=3e6, switch_latency_s=0.01)
    bs8 = api.TelemetryBackstop(amp_threshold_w=8e5)
    noisy = api.Firefly(telemetry=api.TelemetrySource(
        period_s=0.002, latency_s=0.002, noise_w=20.0))
    mpf75 = api.GpuPowerSmoothing(mpf_frac=0.75, ramp_up_w_per_s=2000.0,
                                  ramp_down_w_per_s=2000.0)
    cfgs = {"ff85": (api.Firefly(), None),
            "ff90": (api.Firefly(engage_frac=0.90, threshold_frac=0.85),
                     None),
            "ff85_noisy": (noisy, None),
            "ff85+bat8MJ": (api.Firefly(), bat),
            "ff85_noisy+bat8MJ+bs8": (noisy, api.Stack((bat, bs8)))}
    cfgs.update({f"comb75_8MJ_n{n}": (None, api.CombinedMitigation(
        mpf75, bat, n)) for n in FLEETS})
    cfgs["none"] = None
    return cfgs


def build_keyed_study(api, key=0, device=None):
    """Phase 5's workloads, fleets, seeds and specs at full size with
    ``keyed_configs`` and a root key: 128 pipeline rows, 256 records."""
    base = build_study(api, configs=["none"], device=device or DEVICE)
    return api.Study(base.workloads, fleets=list(FLEETS),
                     configs=keyed_configs(api),
                     specs=[s for _, s in base.specs], seeds=list(SEEDS),
                     wave_cfg=base.wave_cfg, sample_chips=64, key=key,
                     device=device or DEVICE)


def columns_equal(a, b):
    """Names of the columns in which two results differ (NaN equal to
    NaN); empty when they are equal bit for bit."""
    import numpy as np
    ca, cb = a.columns, b.columns
    if list(ca) != list(cb):
        return ["<column names>"]
    bad = []
    for k in ca:
        if ca[k].dtype == object:
            same = list(ca[k]) == list(cb[k])
        else:
            same = np.array_equal(ca[k], cb[k], equal_nan=True)
        if not same:
            bad.append(k)
    return bad


def sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def timed_run(torch, run):
    sync(torch)
    t0 = time.perf_counter()
    out = run()
    sync(torch)
    return out, time.perf_counter() - t0


class NormalCalls:
    """Wrap ``prng.normal`` (the draw of every noisy row) and keep each
    call's keys and length."""

    def __init__(self):
        from repro_torch.core import prng
        self.prng, self.calls = prng, []

    def __enter__(self):
        self.fn = self.prng.normal

        def wrapped(key, n):
            self.calls.append((key.clone(), n))
            return self.fn(key, n)
        self.prng.normal = wrapped
        return self

    def __exit__(self, *exc):
        self.prng.normal = self.fn


def device_total_ms(torch, fn, repeat=5):
    """Device ms a call of ``fn`` takes in all kernels it launches (the
    profiler's kernel durations, summed, over ``repeat`` calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeat):
            fn()
        torch.cuda.synchronize()
    return sum(event_device_us(e) for e in prof.key_averages()) / 1e3 / repeat


def ulps32(np, a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def noise_card_vs_cpu(torch, api, study, rows):
    """The noisy rows' draws and telemetry on the card and on the CPU:
    samples where the normals differ and their largest gap in float32
    ulps, then samples where the measured telemetry (rounded to 1 W) and
    the Firefly output differ, on the chip waveform of each row's
    workload.  The device stage draws from ``fold_in(row_key, 0)``."""
    import numpy as np
    from repro_torch.core import prng
    from repro_torch.core.waveform import chip_waveform, phase_levels
    cfg = study.wave_cfg
    noisy = [r for r in rows if study.rows()[r][2].name.startswith(
        "ff85_noisy")]
    n = max(len(phase_levels(tl, cfg, study.hw))
            for tl in study.workloads.values())
    keys = prng.fold_in(torch.stack([study.scenario_key(r) for r in noisy]),
                        0)
    z_card = prng.normal(keys.to(DEVICE), n).cpu().numpy()
    z_cpu = prng.normal(keys, n).numpy()
    u = ulps32(np, z_card, z_cpu)
    levels = np.stack([np.pad(phase_levels(study.workloads[
        study.rows()[r][0]], cfg, study.hw), (0, 0)) for r in noisy[:1]])
    lv = torch.as_tensor(np.pad(levels, ((0, 0), (0, n - levels.shape[1])),
                                mode="edge"), dtype=torch.float32)
    chip = chip_waveform(lv, cfg.dt, study.hw).expand(len(noisy), -1)
    ff = study.rows()[noisy[0]][2].device
    meas = [ff.telemetry.measure_batch(chip.to(d).contiguous(), cfg.dt,
                                       keys.to(d)).cpu().numpy()
            for d in (DEVICE, "cpu")]
    outs = [type(ff).apply_batch([ff] * len(noisy), chip.to(d).contiguous(),
                                 cfg.dt, keys=keys.to(d))[0].cpu().numpy()
            for d in (DEVICE, "cpu")]
    return {"rows": len(noisy), "samples": int(z_card.size),
            "normal_differ": int((u > 0).sum()),
            "normal_max_ulps": int(u.max()),
            "telemetry_differ": int((meas[0] != meas[1]).sum()),
            "firefly_differ": int((outs[0] != outs[1]).sum()),
            "firefly_max_abs": float(np.abs(outs[0] - outs[1]).max())}


def keyed_cpu_subset(torch, api, study, gpu_res):
    """The 16 rows of ``KEYED_CPU_ROWS`` re-run on the CPU (the plain
    versions) with their own row keys, held to the card's records as
    phase 6 holds its subset."""
    from repro_torch.core.study import run_rows
    sel = [r for r, (w, n, c, s) in enumerate(study.rows())
           if w in KEYED_CPU_ROWS["workloads"]
           and n in KEYED_CPU_ROWS["fleets"]
           and c.name in KEYED_CPU_ROWS["configs"]]
    if len(sel) != 16:
        raise AssertionError(f"the CPU subset has {len(sel)} rows, not 16")
    t0 = time.perf_counter()
    cpu_res = run_rows(study.workloads, [study.rows()[r] for r in sel],
                       study.specs, wave_cfg=study.wave_cfg, hw=study.hw,
                       keys=[study.scenario_key(r) for r in sel],
                       sample_chips=study.sample_chips, device="cpu")
    secs = time.perf_counter() - t0
    S = len(study.specs)
    worst, near, equal = 0.0, 0, 0
    specs = dict(zip(SPEC_NAMES, (s for _, s in study.specs)))
    limit_of = {"max_ramp_up_w_per_s": "ramp_up_w_per_s",
                "max_ramp_down_w_per_s": "ramp_down_w_per_s",
                "dynamic_range_w": "dynamic_range_w",
                "band_energy_fraction": "max_energy_fraction",
                "ac_rms_frac": "min_ac_rms_frac"}
    for j, r in enumerate(sel):
        for si in range(S):
            c, g = cpu_res[j * S + si], gpu_res[r * S + si]
            for k in ("workload", "n_chips", "config", "seed", "spec"):
                if c[k] != g[k]:
                    raise AssertionError(f"cpu subset row {j} is not {g}")
            vals = [(k, c[k], g[k]) for k in (
                "mean_mw", "swing_mw", "swing_mitigated_mw",
                "energy_overhead", "paper_band_frac")]
            vals += [(k, v, g["metrics"][k]) for k, v in c["metrics"].items()]
            for k, a, b in vals:
                atol = 1e-6 if k == "energy_overhead" else 0.0
                if abs(a - b) > STUDY_RTOL * abs(b) + atol:
                    raise AssertionError(f"keyed cpu vs card: {k} {a} vs {b}"
                                         f" in {c}")
                worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
            lim = specs[c["spec"]].limits()
            if any(abs(v - lim[limit_of[k]])
                   <= STUDY_RTOL * abs(lim[limit_of[k]])
                   for k, v in g["metrics"].items() if k in limit_of):
                near += 1
                continue
            if (c["spec_ok"], tuple(c["violations"])) != (
                    g["spec_ok"], tuple(g["violations"])):
                raise AssertionError(f"keyed cpu vs card verdicts differ: "
                                     f"{c} {g}")
            equal += 1
    return {"rows": len(sel), "cpu_s": secs, "verdicts_equal": equal,
            "near_limit": near, "worst_rel": worst,
            "noise": noise_card_vs_cpu(torch, api, study, sel)}


def keyed_resume(torch, api, study, base):
    """A ``resume=`` run stopped after ``KEYED_KILL_AFTER`` chunks by an
    ``on_chunk`` that raises, run again (equal to the one-shot ``base``),
    restored whole (its time), and extended by one config of a structure
    of its own: only the new rows are computed."""
    import shutil
    from repro_torch.core import prng
    from repro_torch.core.study import MitigationConfig, run_rows
    d = os.path.join(HERE, "build", "phase16_resume")
    shutil.rmtree(d, ignore_errors=True)

    class Stop(Exception):
        pass

    seen = []

    def stop_after(done, total, secs):
        seen.append(done)
        if len(seen) == KEYED_KILL_AFTER:
            raise Stop

    try:
        study.run(stream=KEYED_STREAM, resume=d, on_chunk=stop_after)
        raise AssertionError("the stopped run was not stopped")
    except Stop:
        pass
    calls = []
    resumed, resume_s = timed_run(torch, lambda: study.run(
        stream=KEYED_STREAM, resume=d,
        on_chunk=lambda dn, t, e: calls.append(dn)))
    bad = columns_equal(resumed, base)
    if bad:
        raise AssertionError(f"the resumed run differs in {bad}")
    restored, restore_s = timed_run(torch, lambda: study.run(
        stream=KEYED_STREAM, resume=d))
    if columns_equal(restored, base):
        raise AssertionError("the restored run differs from the one-shot")
    rows = study.rows()
    extra = MitigationConfig("mpf90", device=api.GpuPowerSmoothing(
        mpf_frac=0.9, ramp_up_w_per_s=2000.0, ramp_down_w_per_s=2000.0))
    new = [(w, n, extra, s) for w in study.workloads for n in study.fleets
           for s in study.seeds]
    rows_ext = rows + new
    keys = list(prng.fold_in(study.key, torch.arange(len(rows_ext))))
    done = []
    ext, ext_s = timed_run(torch, lambda: run_rows(
        study.workloads, rows_ext, study.specs, wave_cfg=study.wave_cfg,
        hw=study.hw, keys=keys, stream=KEYED_STREAM, resume=d,
        sample_chips=study.sample_chips, device=study.device,
        on_chunk=lambda dn, t, e: done.append(dn)))
    # one report of the restored rows per old call stream, then one per
    # chunk of the new rows
    from repro_torch.core.study import _structure_groups
    n_streams = len(_structure_groups(rows))
    n_new_chunks = -(-len(new) // KEYED_STREAM)
    computed = done[-1] - done[n_streams - 1]
    if (done[n_streams - 1] != len(rows) or computed != len(new)
            or len(done) != n_streams + n_new_chunks):
        raise AssertionError(f"the extended run computed {computed} rows, "
                             f"not the {len(new)} new ones ({done})")
    n_old = len(rows) * len(study.specs)
    got = {k: v[:n_old] for k, v in ext.columns.items()}
    from repro_torch.core.study import StudyResult
    if columns_equal(StudyResult(got), base):
        raise AssertionError("the extended run's old rows differ")
    shutil.rmtree(d, ignore_errors=True)
    return {"stopped_after_rows": seen[-1],
            "resumed_first_report": calls[0], "resume_s": resume_s,
            "restore_s": restore_s, "extension_s": ext_s,
            "extension_computed_rows": computed,
            "extension_reports": done}


def keyed_study_phase(torch, api, build):
    """Phase 16: the keyed Study on the card, with launch counts from 0,
    warm walls one-shot and streamed, the bitwise gates (same key, chunked
    and resumed runs), the shared and per-row draws, a profiled run, the
    share of ``prng``'s work, and 16 rows on the CPU."""
    import numpy as np
    from repro_torch.core import prng
    from repro_torch.core.engine import simulate_batch
    t16 = time.perf_counter()
    study = build_keyed_study(api)
    log(study.describe() + f", key=0, device={DEVICE}")
    build.reset_launch_counts()
    res, cold = timed_run(torch, study.run)
    counts = build.launch_counts()
    log("[keyed] launches in the Study run: " + json.dumps(counts))
    for nm in ("gpu_floor", "battery", "monitor", "escalation"):
        if counts[nm] <= 0:
            raise AssertionError(f"[keyed] kernel {nm} was not launched")
    if counts["flash_fwd"]:
        raise AssertionError("[keyed] kernel F launched on the Study path")
    if len(res) != 256 or study.n_rows != 128:
        raise AssertionError(f"[keyed] {study.n_rows} rows, {len(res)} "
                             "records")
    out = {"launches": counts, "cold_s": cold}
    with NormalCalls() as nc:
        warm_res, warm = timed_run(torch, study.run)
    bad = columns_equal(warm_res, res)
    if bad:
        raise AssertionError(f"[keyed] two runs of one key differ in {bad}")
    out["one_shot"] = {"wall_s": warm, "rows_per_s": study.n_rows / warm}
    for tag, stream in (("stream16", KEYED_STREAM), ("stream_true", True)):
        got, wall = timed_run(torch, lambda: study.run(stream=stream))
        bad = columns_equal(got, res)
        if bad:
            raise AssertionError(f"[keyed] run(stream={stream}) differs from "
                                 f"the one-shot run in {bad}")
        out[tag] = {"wall_s": wall, "rows_per_s": study.n_rows / wall}
    log("[keyed] walls: " + json.dumps({k: out[k] for k in (
        "one_shot", "stream16", "stream_true")}) + f", cold {cold:.3f} s")
    # the draws: per row with keys, shared without
    ff = keyed_configs(api)["ff85_noisy"][0]
    tl = study.workloads["dense_1s"]
    two = [simulate_batch([tl] * 2, FLEETS[0], study.wave_cfg,
                          device_mitigation=ff, seeds=0, keys=keys,
                          device=DEVICE).dc_mitigated
           for keys in (torch.stack([study.scenario_key(r) for r in (0, 1)]),
                        None)]
    if torch.equal(two[0][0], two[0][1]):
        raise AssertionError("[keyed] two keys gave one noise draw")
    if not torch.equal(two[1][0], two[1][1]):
        raise AssertionError("[keyed] key=None rows drew differently")
    shared = build_keyed_study(api, key=None).run()
    noisy = np.array([c.startswith("ff85_noisy")
                      for c in res.columns["config"]])
    eo_k, eo_s = res.columns["energy_overhead"], \
        shared.columns["energy_overhead"]
    if not np.array_equal(eo_k[~noisy], eo_s[~noisy]) or np.array_equal(
            eo_k[noisy], eo_s[noisy]):
        raise AssertionError("[keyed] key=None should change the noisy rows "
                             "only")
    out["resume"] = keyed_resume(torch, api, study, res)
    log("[keyed] resume: " + json.dumps(out["resume"]))
    wall, busy, top = profile_device(torch, study.run)
    out["profile"] = {"wall_s": wall, "busy_s": busy,
                      "busy_share": busy / wall,
                      "top": [(round(ms, 4), cnt, key[:90])
                              for ms, cnt, key in top]}
    log(f"[keyed] profiled run {wall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}% of the traced wall)")
    for ms, cnt, key in top:
        log(f"  {ms:10.3f} ms {cnt:6d}x {key[:110]}")
    prng_ms = sum(device_total_ms(torch, lambda k=k, n=n: prng.normal(k, n))
                  for k, n in nc.calls)
    out["prng"] = {"calls": len(nc.calls),
                   "shapes": [list(k.shape[:-1]) + [n] for k, n in nc.calls],
                   "device_ms": prng_ms,
                   "share_of_busy": prng_ms / (busy * 1e3)}
    log("[keyed] prng.normal: " + json.dumps(out["prng"]))
    for r in res:
        vals = [r["mean_mw"], r["swing_mitigated_mw"], r["energy_overhead"]]
        vals += list(r["metrics"].values())
        if not all(v == v and abs(v) != float("inf") for v in vals):
            raise AssertionError(f"[keyed] non-finite metric in {r}")
    out["verdicts"] = {sp: dict(collections.Counter(
        "pass" if r["spec_ok"] else "fail" for r in res.filter(spec=sp)))
        for sp in SPEC_NAMES}
    out["passing_configs"] = {sp: res.filter(spec=sp).passing_configs()
                              for sp in SPEC_NAMES}
    out["cpu"] = keyed_cpu_subset(torch, api, study, res)
    log("[keyed] cpu subset: " + json.dumps(out["cpu"]))
    out["phase_s"] = time.perf_counter() - t16
    return out


# ---------------------------------------------------------------------------
# phase 17: the serial reference and the batch helpers on phase 5's rows
# ---------------------------------------------------------------------------

# rows of phase 5's Study that phase 17 re-runs serially: (workload, fleet,
# config, seed); dense_3s is the longest workload, so its rows are unpadded
# in the Study and equal to the serial run bit for bit; dense_1s is padded
SERIAL_ROWS = (("dense_3s", 32768, "none", 1),
               ("dense_3s", 32768, "mpf90", 0),
               ("dense_3s", 8192, "bat8MJ", 1),
               ("dense_3s", 8192, "mpf75+bat30MJ", 0),
               ("dense_3s", 32768, "bs8", 0),
               ("dense_3s", 32768, "bat2MJ+bs3", 1),
               ("dense_3s", 8192, "mpf60+bat8MJ+bs8", 1),
               ("dense_1s", 8192, "mpf90+bat2MJ", 0))
SERIAL_PAD_TOL = 1e-5     # padded rows: Study against serial, of max |w|
SWEEP_RTOL = 1e-4         # sweep against the Study, unpadded rows
VALIDATE_RTOL = 1e-5      # validate_many against per-row calls: metrics


METRIC_LIMIT = {"max_ramp_up_w_per_s": "ramp_up_w_per_s",
                "max_ramp_down_w_per_s": "ramp_down_w_per_s",
                "dynamic_range_w": "dynamic_range_w",
                "band_energy_fraction": "max_energy_fraction",
                "ac_rms_frac": "min_ac_rms_frac"}


def near_limit(spec, metrics, rtol=STUDY_RTOL):
    """True when a metric lies within ``rtol`` of its limit: two sums of
    one waveform in another order may then judge it differently."""
    lim = spec.limits()
    return any(abs(v - lim[METRIC_LIMIT[k]]) <= rtol * abs(
        lim[METRIC_LIMIT[k]]) for k, v in metrics.items()
        if k in METRIC_LIMIT)


def study_row_index(study, key):
    """The pipeline row of ``(workload, fleet, config, seed)``."""
    return next(r for r, (w, n, c, s) in enumerate(study.rows())
                if (w, n, c.name, s) == key)


def serial_rows(torch, api, study, kept):
    """``simulate`` and ``simulate_jit`` on the card for each of
    ``SERIAL_ROWS`` against each other (bit for bit) and against the kept
    Study's ``sim_result`` (bit for bit on unpadded rows, within
    ``SERIAL_PAD_TOL`` on padded ones)."""
    import numpy as np
    spec = dict(study.specs)["moderate"]
    out, walls = [], {"simulate": 0.0, "simulate_jit": 0.0}
    for key in SERIAL_ROWS:
        r = study_row_index(study, key)
        w, n, c, s = study.rows()[r]
        kw = dict(device_mitigation=c.device, rack_mitigation=c.rack,
                  spec=spec, seed=s, device=DEVICE)
        one, t1 = timed_run(torch, lambda: api.simulate(
            study.workloads[w], n, study.wave_cfg,
            sample_chips=study.sample_chips, **kw))
        jit, t2 = timed_run(torch, lambda: api.simulate_jit(
            study.workloads[w], n, study.wave_cfg, **kw))
        walls["simulate"] += t1
        walls["simulate_jit"] += t2
        for f in ("dc_raw", "dc_mitigated", "chip_raw"):
            if not np.array_equal(getattr(one, f), getattr(jit, f)):
                raise AssertionError(f"[serial] simulate and simulate_jit "
                                     f"differ in {f} on {key}")
        if (one.spec_report != jit.spec_report
                or one.energy_overhead != jit.energy_overhead):
            raise AssertionError(f"[serial] simulate and simulate_jit "
                                 f"differ in their report on {key}")
        kept_row = kept.sim_result(r)
        padded = len(kept_row.t) < study_max_len(study)
        err = float(np.abs(kept_row.dc_mitigated.astype(np.float64)
                           - one.dc_mitigated).max())
        scale = float(np.abs(one.dc_mitigated).max())
        bitwise = bool(np.array_equal(kept_row.dc_mitigated,
                                      one.dc_mitigated))
        if not (bitwise if not padded else err <= SERIAL_PAD_TOL * scale):
            raise AssertionError(f"[serial] sim_result({r}) differs from "
                                 f"simulate on {key}: {err} of {scale}")
        rec = kept.filter(row=r, spec="moderate")[0]
        if (rec["spec_ok"] != one.spec_report.ok and not padded
                and not near_limit(spec, rec["metrics"])):
            raise AssertionError(f"[serial] the Study's verdict differs from "
                                 f"simulate's on {key}")
        out.append({"row": key, "padded": padded, "bitwise": bitwise,
                    "max_abs_err": err, "scale": scale})
    return out, walls


def study_max_len(study):
    from repro_torch.core.waveform import phase_levels
    return max(len(phase_levels(tl, study.wave_cfg, study.hw))
               for tl in study.workloads.values())


def sweep_vs_study(torch, api, study, res):
    """``engine.sweep`` over phase 5's grid (one call a mitigation
    structure) against ``Study.run``'s records for the moderate spec: the
    unpadded rows (the longest workload) equal
    within ``SWEEP_RTOL`` with their verdicts; the padded ones counted
    (the Study pads shorter workloads and its backstop counts the pad as
    live, the sweep buckets them unpadded)."""
    from repro_torch.core.engine import sweep
    from repro_torch.core.smoothing.base import structure
    spec = dict(study.specs)["moderate"]
    # one sweep per mitigation structure, as each batch takes one
    groups = {}
    for c in study.configs:
        key = tuple(None if m is None else structure(m)
                    for m in (c.device, c.rack))
        groups.setdefault(key, []).append(c)
    got, wall, n_recs = {}, 0.0, 0
    for cfgs in groups.values():
        recs, t = timed_run(torch, lambda: sweep(
            study.workloads, study.fleets, [(c.device, c.rack) for c in cfgs],
            study.wave_cfg, spec=spec, seeds=study.seeds,
            sample_chips=study.sample_chips, device=DEVICE))
        wall += t
        n_recs += len(recs)
        got.update({(r["workload"], r["n_chips"], cfgs[r["config"]].name,
                     r["seed"]): r for r in recs})
    longest = max(study.workloads, key=lambda k: study.workloads[k].period_s)
    worst, compared, padded_diff = 0.0, 0, 0
    for rec in res.filter(spec="moderate"):
        key = (rec["workload"], rec["n_chips"], rec["config"], rec["seed"])
        g = got[key]
        diffs = [abs(g[k] - rec[k]) / max(abs(rec[k]), 1e-30) for k in (
            "mean_mw", "swing_mw", "swing_mitigated_mw", "paper_band_frac")]
        diffs.append(abs(g["energy_overhead"] - rec["energy_overhead"]))
        if rec["workload"] != longest:
            padded_diff += max(diffs) > SWEEP_RTOL
            continue
        if max(diffs) > SWEEP_RTOL or (g["spec_ok"] != rec["spec_ok"]
                                       and not near_limit(spec,
                                                          rec["metrics"])):
            raise AssertionError(f"[serial] sweep differs from the Study on "
                                 f"{key}: {g} vs {rec}")
        worst = max(worst, max(diffs))
        compared += 1
    return {"records": n_recs, "sweeps": len(groups), "wall_s": wall,
            "compared": compared,
            "worst_rel": worst, "padded_rows_past_rtol": int(padded_diff)}


def batch_helpers(torch, api, study, kept):
    """``apply_batch`` (three floors on one chip trace, three batteries on
    one aggregate) bit for bit against one ``np_apply`` a config, and
    ``validate_many`` of the serial rows against one call a row (verdicts
    equal, metrics within ``VALIDATE_RTOL``: the reductions pick their
    order by the row count)."""
    import numpy as np
    from repro_torch.core.engine import apply_batch, validate_many
    from repro_torch.core.smoothing.base import np_apply
    cfgs = study_configs(api)
    one = api.simulate(study.workloads["dense_3s"], FLEETS[0],
                       study.wave_cfg, seed=0, device=DEVICE)
    out = {}
    for tag, names, x in (("floors", ("mpf60", "mpf75", "mpf90"),
                           one.chip_raw),
                          ("batteries", ("bat2MJ", "bat8MJ", "bat30MJ"),
                           one.dc_raw)):
        mits = [cfgs[n][0] if tag == "floors" else cfgs[n][1] for n in names]
        (outs, _), wall = timed_run(torch, lambda: apply_batch(
            mits, x, DT, device=DEVICE))
        for i, m in enumerate(mits):
            row, _ = np_apply(m, x, DT, device=DEVICE)
            if not np.array_equal(outs[i], row):
                raise AssertionError(f"[serial] apply_batch row {i} of "
                                     f"{tag} differs from np_apply")
        out[tag] = {"rows": len(mits), "shape": list(outs.shape),
                    "wall_s": wall, "bitwise": True}
    spec = dict(study.specs)["moderate"]
    rows = [kept.sim_result(study_row_index(study, k)).dc_mitigated
            for k in SERIAL_ROWS if k[0] == "dense_3s"]
    ws = np.stack(rows)
    (ok, reports), wall = timed_run(torch, lambda: validate_many(
        ws, spec, DT, device=DEVICE))
    worst = 0.0
    for i in range(len(ws)):
        ok1, rep1 = validate_many(ws[i:i + 1], spec, DT, device=DEVICE)
        if bool(ok1[0]) != bool(ok[i]) or rep1[0].violations != \
                reports[i].violations:
            raise AssertionError(f"[serial] validate_many row {i} differs "
                                 "from its own call")
        for k, v in rep1[0].metrics.items():
            d = abs(reports[i].metrics[k] - v) / max(abs(v), 1e-30)
            if d > VALIDATE_RTOL:
                raise AssertionError(f"[serial] validate_many metric {k} of "
                                     f"row {i}: {reports[i].metrics[k]} vs "
                                     f"{v}")
            worst = max(worst, d)
    out["validate_many"] = {"rows": len(ws), "wall_s": wall,
                            "passing": int(ok.sum()), "worst_rel": worst}
    return out


def serial_phase(torch, api, build, res):
    """Phase 17: phase 5's Study again with ``keep_waveforms=True`` (its
    records equal to phase 5's bit for bit), the serial reference on rows
    of it, the sweep over its grid, and the batch helpers."""
    t17 = time.perf_counter()
    study = build_study(api, keep_waveforms=True)
    build.reset_launch_counts()
    kept, wall = timed_run(torch, study.run)
    bad = columns_equal(kept, res)
    if bad:
        raise AssertionError(f"[serial] keep_waveforms changed the records: "
                             f"{bad}")
    kept_mb = sum(w["dc_raw"].nbytes + w["dc_mitigated"].nbytes
                  for w in kept.waveforms) / 1e6
    log(f"[serial] Study(keep_waveforms=True): {wall:.3f} s, "
        f"{len(kept.waveforms)} rows, {kept_mb:.1f} MB of waveforms")
    rows, walls = serial_rows(torch, api, study, kept)
    log("[serial] simulate / simulate_jit / sim_result: " + json.dumps(rows)
        + "; walls " + json.dumps(walls))
    sw = sweep_vs_study(torch, api, study, res)
    log("[serial] sweep against the Study: " + json.dumps(sw))
    helpers = batch_helpers(torch, api, study, kept)
    log("[serial] batch helpers: " + json.dumps(helpers))
    return {"launches": build.launch_counts(), "keep_waveforms_s": wall,
            "waveforms_mb": kept_mb, "rows": rows, "walls": walls,
            "sweep": sw, "helpers": helpers,
            "phase_s": time.perf_counter() - t17}


# ---------------------------------------------------------------------------
# phase 18: the design path at full size, kernels J and K
# ---------------------------------------------------------------------------

DESIGN_WORKLOAD = "dense_3s"      # phase 5's longest: 90 000 samples
DESIGN_STEPS = 120                # the reference's default
# J and K against their plain versions: each output, the trace's gradient
# and each parameter column's gradient, over its own max |plain| (a column
# whose plain gradient is 0 everywhere must be 0)
JK_TOL = 1e-4
JK_CHECK_N = 3000                 # the card's plain check: its first 3 s
JK_WAIT_S = 600.0                 # the CPU's full-shape checks, all four
CPU_STEPS = 3                     # the Adam steps re-run on the CPU
CPU_N = 3000                      # their trace: the cell's first 3 s
CPU_TOL = 1e-3                    # CPU against card, rtol (+1e-5 of max)
PROBE_REPEATS = 5                 # chain probe readings, after a warm-up
RELAXED = ("gpu_floor_relaxed", "gpu_floor_relaxed_adjoint",
           "battery_relaxed", "battery_relaxed_adjoint")
RELAXED_KEPT = ("gpu_floor_relaxed", "battery_relaxed")
# f32 operations a sample, as written in the sources (a transcendental
# counted as one)
JK_OPS = {"gpu_floor_relaxed": 43, "gpu_floor_relaxed_adjoint": 85,
          "battery_relaxed": 55, "battery_relaxed_adjoint": 205}
# bytes a sample each function must move, its inputs read once and its
# outputs written once: J w -> out, its adjoint (w, g_out) -> g_w; K
# w -> (grid, soc), its adjoint (w, g_grid, g_soc) -> g_w.  The per-row
# parameters add 4 bytes a column (read; the adjoint also writes g_p).
JK_BYTES = {"gpu_floor_relaxed": 8, "gpu_floor_relaxed_adjoint": 12,
            "battery_relaxed": 12, "battery_relaxed_adjoint": 16}
# bytes a sample of the carries the forward saves for the adjoint (J: the
# idle counter and its output; K: soc, target, mode and hold): written by
# the forward (beyond its outputs) and read by the adjoint; reported, not
# in the bound
JK_SAVED_BYTES = {"gpu_floor_relaxed": 4, "gpu_floor_relaxed_adjoint": 8,
                  "battery_relaxed": 12, "battery_relaxed_adjoint": 16}
JK_DEVICE_NAME = {"gpu_floor_relaxed": "floor_forward_kernel",
                  "gpu_floor_relaxed_adjoint": "floor_adjoint_kernel",
                  "battery_relaxed": "battery_forward_kernel",
                  "battery_relaxed_adjoint": "battery_adjoint_kernel"}


def jk_columns(name):
    from repro_torch.core.smoothing import battery, gpu_floor
    return (gpu_floor.PARAM_COLUMNS if name == "gpu_floor_relaxed"
            else battery.RELAXED_COLUMNS)


def jk_bound(name, B, n, cols):
    """(bound ms, "bytes" or "operations") of J's or K's forward or
    adjoint entry (``name``) on ``B`` rows of ``n`` samples and ``cols``
    parameter columns."""
    moves = 2 if name.endswith("_adjoint") else 1
    return bound(JK_BYTES[name] * B * n + 4 * moves * B * cols,
                 JK_OPS[name] * B * n)


def jk_grads(torch, name, shape):
    """The output gradients of a check, on the CPU: one ``[B, n]`` for J,
    two (grid and SoC) for K, from seed 18."""
    gen = torch.Generator().manual_seed(18)
    k = 1 if name == "gpu_floor_relaxed" else 2
    return tuple(torch.randn(tuple(shape), generator=gen) for _ in range(k))


def jk_pass(torch, name, args, grads, plain):
    """Forward and gradient of J (``gpu_floor_relaxed``) or K
    (``battery_relaxed``), the kernels or (``plain``) their plain versions,
    on ``args`` for the loss ``sum(out * g)`` (K: plus ``sum(soc *
    g_soc)``): ``(outputs, d/dw, d/dparams, forward s, backward s)``."""
    from repro_torch.core.smoothing import battery, gpu_floor
    fn = {("gpu_floor_relaxed", False): gpu_floor.gpu_floor_relaxed,
          ("gpu_floor_relaxed", True): gpu_floor.gpu_floor_relaxed_plain,
          ("battery_relaxed", False): battery.battery_relaxed,
          ("battery_relaxed", True): battery.battery_relaxed_plain}[
        (name, plain)]
    w, params = (a.detach().clone().requires_grad_(True) for a in args[:2])
    grads = tuple(g.to(w.device) for g in grads)
    outs, fwd_s = timed_run(torch, lambda: fn(w, params, *args[2:]))
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * g).to(torch.float64).sum() for o, g in zip(outs, grads))
    (gw, gp), bwd_s = timed_run(torch, lambda: torch.autograd.grad(
        loss, (w, params)))
    return tuple(o.detach() for o in outs), gw, gp, fwd_s, bwd_s


def jk_fields(torch, name, got, ref):
    """Each field of a check, ``got`` against ``ref`` (``jk_pass``'s first
    three items): every output, ``d_w`` and ``d_<column>`` for each
    parameter column, with its largest error (``abs``), its max |ref|
    (``max``) and their ratio (``rel``; 0 or inf where max |ref| is 0)."""
    import math
    outs = ("out",) if name == "gpu_floor_relaxed" else ("grid", "soc")
    pairs = list(zip(outs, got[0], ref[0]))
    pairs.append(("d_w", got[1], ref[1]))
    pairs += [(f"d_{c}", got[2][:, i], ref[2][:, i])
              for i, c in enumerate(jk_columns(name))]
    fields = {}
    for k, x, y in pairs:
        x = x.detach().cpu().to(torch.float64)
        y = y.detach().cpu().to(torch.float64)
        a = float((x - y).abs().max())
        m = float(y.abs().max())
        rel = a / m if m > 0 else (0.0 if a == 0 else math.inf)
        fields[k] = {"abs": a, "max": m, "rel": rel}
    return fields


def jk_summary(fields):
    """The largest errors of a check's outputs and of its gradients, and
    the gradient field with the largest ``rel``."""
    outs = {k: f for k, f in fields.items() if not k.startswith("d_")}
    grads = {k: f for k, f in fields.items() if k.startswith("d_")}
    worst = max(grads, key=lambda k: grads[k]["rel"])
    return {"out_abs": max(f["abs"] for f in outs.values()),
            "out_rel": max(f["rel"] for f in outs.values()),
            "grad_abs": max(f["abs"] for f in grads.values()),
            "grad_rel": grads[worst]["rel"], "worst_grad": worst}


def jk_gate(name, fields, where):
    bad = {k: f for k, f in fields.items() if not f["rel"] <= JK_TOL}
    if bad:
        raise AssertionError(f"[design] {name} differs from its plain "
                             f"version {where}: {bad} (tol {JK_TOL} of "
                             f"each field's max |plain|)")


def jk_check(torch, name, args):
    """J or K against its plain version on the card, forward and
    gradient, on the captured rows cut to their first ``JK_CHECK_N``
    samples (the plain loop on the card is launch-bound): each field
    (``jk_fields``) gated at ``JK_TOL``.  Returns the largest errors
    (``jk_summary``), the fields, and the plain version's forward and
    backward ms there."""
    w, params = args[:2]
    cut = (w[:, :JK_CHECK_N].contiguous(), params) + tuple(args[2:])
    grads = jk_grads(torch, name, cut[0].shape)
    got = jk_pass(torch, name, cut, grads, False)
    ref = jk_pass(torch, name, cut, grads, True)
    fields = jk_fields(torch, name, got, ref)
    jk_gate(name, fields, f"on the card at {list(cut[0].shape)}")
    return dict(jk_summary(fields), shape=list(cut[0].shape), fields=fields,
                plain_fwd_ms=ref[3] * 1e3, plain_bwd_ms=ref[4] * 1e3)


def jk_plain_job(torch, path_in, path_out):
    """One CPU check's worker (``chip_smoke.py --jk-plain IN OUT``): J's or
    K's plain version on one thread at the lowest CPU priority, forward
    and gradient (``jk_pass``),
    on the inputs ``jk_full_start`` saved; saves its outputs, gradients
    and seconds."""
    global DEVICE
    DEVICE = "cpu"
    torch.set_num_threads(1)
    # the card's phases run beside this worker: they take the CPU first
    os.nice(19)
    job = torch.load(path_in, weights_only=True)
    outs, gw, gp, fwd_s, bwd_s = jk_pass(torch, job["name"], job["args"],
                                         job["grads"], True)
    torch.save({"outs": outs, "gw": gw, "gp": gp, "fwd_s": fwd_s,
                "bwd_s": bwd_s}, path_out)
    return 0


def jk_full_start(torch, calls, workdir):
    """Start one CPU process a captured call (``calls``: {(name, tag):
    args}), each running the plain version at the call's full shape
    (``jk_plain_job``), and run the kernel on the same inputs here.
    Returns the jobs for ``jk_full_finish``."""
    os.makedirs(workdir, exist_ok=True)
    jobs = []
    try:
        for (name, tag), args in calls.items():
            grads = jk_grads(torch, name, args[0].shape)
            host = tuple(a.detach().cpu() if isinstance(a, torch.Tensor)
                         else a for a in args)
            stem = os.path.join(workdir, f"{name}_{tag}")
            torch.save({"name": name, "args": host, "grads": grads},
                       stem + ".in.pt")
            logf = open(stem + ".log", "w")
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--jk-plain",
                 stem + ".in.pt", stem + ".out.pt"], cwd=HERE,
                stdout=logf, stderr=subprocess.STDOUT)
            jobs.append({"name": name, "tag": tag, "shape": list(
                args[0].shape), "proc": proc, "log": logf, "stem": stem,
                "t0": time.perf_counter()})
            got = jk_pass(torch, name, args, grads, False)
            jobs[-1]["got"] = tuple(
                tuple(o.cpu() for o in x) if isinstance(x, tuple) else
                x.cpu() for x in got[:3])
    except BaseException:
        jk_stop(jobs)
        raise
    return jobs


def jk_stop(jobs):
    for j in jobs:
        if j["proc"].poll() is None:
            j["proc"].kill()
        j["proc"].wait()
        j["log"].close()


def jk_full_finish(torch, jobs, wait_s=JK_WAIT_S):
    """Wait for ``jk_full_start``'s workers (``wait_s`` in all), stop
    every worker whatever happens, log each full-shape check and then gate
    them field by field (``jk_gate``).  Returns {(name, tag): the
    check}."""
    deadline = time.perf_counter() + wait_s
    out = {}
    try:
        for j in jobs:
            left = max(deadline - time.perf_counter(), 1.0)
            try:
                rc = j["proc"].wait(timeout=left)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"[design] the CPU's plain {j['name']} "
                                     f"({j['tag']}) took more than "
                                     f"{wait_s} s") from None
            wall = time.perf_counter() - j["t0"]
            if rc != 0:
                j["log"].flush()
                with open(j["stem"] + ".log") as f:
                    tail = f.read()[-2000:]
                raise AssertionError(f"[design] the CPU's plain {j['name']} "
                                     f"({j['tag']}) exited {rc}: {tail}")
            ref = torch.load(j["stem"] + ".out.pt", weights_only=True)
            fields = jk_fields(torch, j["name"], j["got"],
                               (ref["outs"], ref["gw"], ref["gp"]))
            c = out[(j["name"], j["tag"])] = dict(
                jk_summary(fields), shape=j["shape"], fields=fields,
                plain_cpu_fwd_ms=ref["fwd_s"] * 1e3,
                plain_cpu_bwd_ms=ref["bwd_s"] * 1e3, worker_wall_s=wall)
            log(f"[design] {j['name']} ({j['tag']} call) against the CPU: "
                + json.dumps(c))
    finally:
        jk_stop(jobs)
    for (name, tag), c in out.items():
        jk_gate(name, c["fields"], f"against the CPU at {c['shape']} "
                                   f"({tag} call)")
    return out


def jk_probe(torch, fn, steps, repeat=PROBE_REPEATS):
    """``repeat`` readings of a chain probe (``fn`` leaves the SM cycles of
    ``steps`` dependent steps in its cycles tensor, returned by ``fn``),
    each a launch timed by CUDA events after one warm-up launch: every
    reading's (cycles a step, ns a step), and their medians."""
    import statistics
    fn()
    torch.cuda.synchronize()
    reads = []
    for _ in range(repeat):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cycles = fn()
        end.record()
        torch.cuda.synchronize()
        reads.append(chain_step(cycles.item(), start.elapsed_time(end),
                                steps))
    return {"readings": [list(r) for r in reads],
            "cycles_per_step": statistics.median(r[0] for r in reads),
            "ns_per_step": statistics.median(r[1] for r in reads)}


def sm_clock_ghz():
    """The card's SM clock now (``nvidia-smi``), in GHz: the chain probes
    count SM cycles."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) / 1e3


def jk_merges(torch, name, args):
    """How the forward's segmented walks merged on one call's inputs (the
    ``*_merges`` diagnostic of J's or K's module, whose output must equal
    the call's own): for each recurrence, the segments, how many walked
    again once their chunk's start came in, how many of those did not meet
    their kept walk, the share that merged (the rest walked their whole
    segment from their true start), and the steps walked after the starts
    came in on the row that walked most (the serial part left)."""
    from repro_torch.core.smoothing import battery, gpu_floor
    w, params = (a.contiguous() for a in args[:2])
    if name == "gpu_floor_relaxed":
        out, stats = gpu_floor.gpu_floor_relaxed_merges(w, params, *args[2:])
        chains = gpu_floor.RELAXED_CHAINS
        with torch.no_grad():
            ref = gpu_floor.gpu_floor_relaxed(w, params, *args[2:])
        same = torch.equal(out, ref)
    else:
        grid, soc, stats = battery.battery_relaxed_merges(w, params,
                                                          *args[2:])
        chains = battery.RELAXED_CHAINS
        with torch.no_grad():
            ref = battery.battery_relaxed(w, params, *args[2:])
        same = torch.equal(grid, ref[0]) and torch.equal(soc, ref[1])
    if not same:
        raise AssertionError(f"[design] {name}'s merge diagnostic differs "
                             f"from its forward")
    st = stats.to(torch.int64).cpu()
    segs = w.shape[0] * st.shape[1] * 32
    out = {}
    for c, chain in enumerate(chains):
        walks, unmerged = int(st[:, :, c, 0].sum()), int(st[:, :, c, 1].sum())
        out[chain] = {"segments": segs, "walked_again": walks,
                      "unmerged": unmerged,
                      "merged_share": 1.0 - unmerged / segs,
                      "serial_steps_max_row": int(st[:, :, c, 2].sum(1).max())}
    return out


# the recurrences of J's and K's forward probes, in the order of the
# probe's cycle counts (the ``*_step_cycles`` entries), and the scans of
# their adjoints
JK_PROBE_CHAINS = {"gpu_floor_relaxed": ("o", "idle"),
                   "battery_relaxed": ("soc", "hold", "target")}
JK_SCANS = {"gpu_floor_relaxed": 2, "battery_relaxed": 3}


def jk_timing(torch, name, args, merges=None):
    """J's or K's forward and adjoint entries timed alone at the captured
    (design) shape: CUDA-event and device ms a launch, and the chains' own
    time a step (the library's ``*_step_cycles`` probe: the warp walks each
    forward recurrence in step with the merge test over the row's first
    512 samples, as the kernel's resolve does, or the adjoint's float64
    affine composition; SM cycles, and ns
    at the clock ``nvidia-smi`` reads; ``PROBE_REPEATS`` readings, their
    median).  The forward's chain floor is the serial part that is left:
    the most steps any row walked after its chunks' starts came in
    (``merges``, from ``jk_merges``) times that recurrence's ns a step,
    the largest over the recurrences; the adjoint's, each lane composing
    and applying its segment's maps once a scan (the chunks' handoffs are
    not in it)."""
    import ctypes
    import statistics
    from repro_torch.core.smoothing import battery, gpu_floor
    from repro_torch.core.smoothing.relax import chain_scratch
    from repro_torch.kernels.build import ptr, stream_of
    w, params = (a.contiguous() for a in args[:2])
    B, n = w.shape
    st = stream_of(w)
    if name == "gpu_floor_relaxed":
        mod, T = gpu_floor, float(args[2] * args[3])
        scal = (float(args[2]), T)
        outs = [torch.empty_like(w) for _ in range(2)]
    else:
        mod = battery
        scal = (float(args[3]), float(args[2]))       # tau, dt
        outs = [torch.empty_like(w) for _ in range(5)]
    g_in = [torch.randn_like(w) for _ in range(1 if mod is gpu_floor
                                               else 2)]
    g_w, g_p = torch.empty_like(w), torch.empty_like(params)
    scratch = chain_scratch(B, n, w.device)

    def fwd():
        mod.RELAXED_FORWARD.launch(ptr(w), ptr(params), *scal,
                                   *(ptr(o) for o in outs), B, n,
                                   ptr(scratch), None, st)

    def adj():
        extra = [ptr(o) for o in (outs if mod is gpu_floor else outs[1:])]
        mod.RELAXED_ADJOINT.launch(ptr(w), ptr(params), *scal, *extra,
                                   *(ptr(g) for g in g_in), ptr(g_w),
                                   ptr(g_p), B, n, ptr(scratch), st)

    fwd()
    out = {}
    for tag, fn in (("forward", fwd), ("adjoint", adj)):
        kname = name if tag == "forward" else name + "_adjoint"
        out[tag] = {"ms": cuda_ms(torch, fn, 3),
                    "device_ms": device_ms(torch, fn,
                                           JK_DEVICE_NAME[kname], repeat=10)}
    sym = ("gpu_floor_relaxed_step_cycles" if mod is gpu_floor
           else "battery_relaxed_step_cycles")
    probe = ctypes.CDLL(str(mod.RELAXED_FORWARD.library_path()))[sym]
    probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                      ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p]
    probe.restype = ctypes.c_int
    cycles = torch.zeros(4, dtype=torch.int64, device=w.device)
    sink = torch.zeros(1, device=w.device)
    reps, steps = 20, 20 * (min(n, 512) // 32 * 32)
    ghz = sm_clock_ghz()
    chains = JK_PROBE_CHAINS[name]
    for adj_flag, tag in ((0, "forward"), (1, "adjoint")):
        names = chains if adj_flag == 0 else ("compose",)
        reads = {c: [] for c in names}
        for _ in range(PROBE_REPEATS + 1):
            err = probe(ptr(w), ptr(params), *scal, n, reps, adj_flag,
                        ptr(cycles), ptr(sink), st)
            if err:
                raise RuntimeError(f"{sym}: CUDA error {err}")
            got = cycles.tolist()
            for k, c in enumerate(names):
                reads[c].append(got[k] / steps)
        chain = {c: {"cycles_per_step": statistics.median(r[1:]),
                     "readings": r[1:]} for c, r in reads.items()}
        for c in chain.values():
            c["ns_per_step"] = c["cycles_per_step"] / ghz
        out[tag]["chain"] = chain
        out[tag]["sm_clock_ghz"] = ghz
        if adj_flag == 0:
            floors = {c: (merges[c]["serial_steps_max_row"]
                          * chain[c]["ns_per_step"] / 1e6)
                      for c in names if merges is not None}
            out[tag]["chain_floor_ms"] = max(floors.values()) if floors \
                else None
            out[tag]["chain_floors_ms"] = floors
        else:
            out[tag]["chain_floor_ms"] = (2 * 32 * JK_SCANS[name]
                                          * chain["compose"]["ns_per_step"]
                                          / 1e6)
    return out


def design_cells(torch, api, study, build):
    """``design`` on phase 5's longest workload at both fleets and both
    specs: the grid, the gradient (``DESIGN_STEPS`` Adam steps, every start
    a row of one batch through J and K) and the hybrid, with the gates:
    the gradient design passes its spec under the hard semantics (its
    ``mitigated`` trace re-judged by ``validate_many``), the hybrid is
    never worse than the grid, every loss is finite.  Returns the cells,
    the solutions, the traces, the ``Capture`` (J's and K's first and last
    calls with the most rows) and the launch counts."""
    import numpy as np
    from repro_torch.core.engine import validate_many
    from repro_torch.core.waveform import job_waveform
    tl = study.workloads[DESIGN_WORKLOAD]
    traces = {n: job_waveform(tl, n, study.wave_cfg, seed=study.seeds[0],
                              sample_chips=study.sample_chips,
                              device=DEVICE)[1] for n in study.fleets}
    cap = Capture(torch)
    cells, sols = [], {}
    build.reset_launch_counts()
    with cap:
        for n, w in traces.items():
            for spec_name, spec in study.specs:
                cell = {"n_chips": n, "spec": spec_name, "n": len(w)}
                for method in ("grid", "gradient", "hybrid"):
                    before = len(cap.descend_s)
                    sol, wall = timed_run(torch, lambda: api.design(
                        spec, w, DT, n, method=method, device=DEVICE))
                    if sol is None and method != "grid":
                        raise AssertionError(f"[design] {method} found no "
                                             f"design for {cell}")
                    d = {"wall_s": wall}
                    if sol is not None:
                        d.update(mpf=sol["mpf_frac"],
                                 cap_j=sol["battery_capacity_j"],
                                 energy_overhead=sol["energy_overhead"],
                                 ok=sol["report"].ok)
                    if method != "grid":
                        hist = sol["loss_history"]
                        if not np.isfinite(hist).all():
                            raise AssertionError(f"[design] non-finite loss "
                                                 f"in {method} {cell}")
                        desc = cap.descend_s[before:]
                        d.update(starts=int(hist.shape[0]),
                                 descend_s=sum(desc),
                                 ms_per_step=sum(desc) / DESIGN_STEPS * 1e3,
                                 loss_first=hist[:, 0].tolist(),
                                 loss_last=hist[:, -1].tolist())
                    cell[method] = d
                    sols[(n, spec_name, method)] = sol
                g = sols[(n, spec_name, "gradient")]
                ok, _ = validate_many(g["mitigated"][None], spec, DT,
                                      device=DEVICE)
                if not (g["report"].ok and bool(ok[0])):
                    raise AssertionError(f"[design] the gradient design "
                                         f"fails its spec: {cell}")
                grid = sols[(n, spec_name, "grid")]
                hyb = sols[(n, spec_name, "hybrid")]
                if grid is not None and hyb["energy_overhead"] > \
                        grid["energy_overhead"] + 1e-6:
                    raise AssertionError(f"[design] hybrid worse than the "
                                         f"grid: {cell}")
                log("[design] " + json.dumps(cell))
                cells.append(cell)
    counts = build.launch_counts()
    return cells, sols, traces, cap, counts


def optimize_cells(torch, api, study, sols):
    """``Study.optimize(method="hybrid")`` on the same four cells: each
    designed record's choice and overhead equal the direct hybrid
    design's."""
    st = api.Study({DESIGN_WORKLOAD: study.workloads[DESIGN_WORKLOAD]},
                   fleets=list(study.fleets),
                   specs=[s for _, s in study.specs], seeds=[study.seeds[0]],
                   wave_cfg=study.wave_cfg, sample_chips=study.sample_chips,
                   device=DEVICE)
    res, wall = timed_run(torch, lambda: st.optimize(method="hybrid"))
    if len(res) != 4 or len(res.filter(designed=True)) != 4:
        raise AssertionError(f"[design] optimize gave {len(res)} records")
    bitwise = 0
    for r in res:
        h = sols[(r["n_chips"], r["spec"], "hybrid")]
        got = (r["mpf_frac"], r["battery_capacity_j"], r["energy_overhead"])
        want = (h["mpf_frac"], h["battery_capacity_j"],
                h["energy_overhead"])
        bitwise += got == want
        if any(abs(a - b) > 1e-6 * max(abs(b), 1.0)
               for a, b in zip(got, want)) or not r["spec_ok"]:
            raise AssertionError(f"[design] optimize's {r['spec']} record at "
                                 f"{r['n_chips']} differs from the hybrid "
                                 f"design: {got} vs {want}")
    return {"records": len(res), "wall_s": wall, "bitwise": bitwise}


def cpu_steps(torch, api, study, traces):
    """The first ``CPU_STEPS`` Adam steps of the tight design at the first
    fleet, on the card and on the CPU's plain versions, on the trace's
    first ``CPU_N`` samples: loss histories and every step's gradients (as
    they reach ``clip_by_global_norm``, ``Capture.grads``) within
    ``CPU_TOL`` (plus 1e-5 of the largest), the same design chosen."""
    import numpy as np
    n = study.fleets[0]
    spec = dict(study.specs)["tight"]
    w = traces[n][:CPU_N]
    runs = {}
    for dev in (DEVICE, "cpu"):
        cap = Capture(torch)
        with cap:
            sol, wall = timed_run(torch, lambda: api.design_gradient(
                spec, w, DT, n, steps=CPU_STEPS, device=dev))
        runs[dev] = (sol, [{k: v.cpu() for k, v in g.items()}
                           for g in cap.grads], wall)
    (a, la, wa), (b, lb, wb) = runs[DEVICE], runs["cpu"]
    if len(la) != CPU_STEPS or len(lb) != CPU_STEPS:
        raise AssertionError(f"[design] {len(la)} and {len(lb)} gradients "
                             f"logged for {CPU_STEPS} Adam steps")
    pairs = [(a["loss_history"], b["loss_history"])]
    pairs += [(x[k].numpy(), y[k].numpy()) for x, y in zip(la, lb)
              for k in ("mpf", "cap")]
    worst = 0.0
    for x, y in pairs:
        tol = CPU_TOL * np.abs(y) + 1e-5 * np.abs(y).max()
        if not np.all(np.abs(x - y) <= tol):
            raise AssertionError(f"[design] card and CPU Adam steps differ: "
                                 f"{x} vs {y}")
        worst = max(worst, float((np.abs(x - y) / np.maximum(
            np.abs(y), 1e-30)).max()))
    if (a["mpf_frac"], a["battery_capacity_j"]) != (
            b["mpf_frac"], b["battery_capacity_j"]) and abs(
            a["energy_overhead"] - b["energy_overhead"]) > 1e-6:
        raise AssertionError(f"[design] card and CPU chose differently: "
                             f"{a['mpf_frac'], a['battery_capacity_j']} vs "
                             f"{b['mpf_frac'], b['battery_capacity_j']}")
    return {"n": len(w), "steps": CPU_STEPS, "starts": len(la[0]["mpf"]),
            "card_s": wa, "cpu_s": wb, "worst_rel": worst}


def design_phase(torch, api, build):
    """Phase 18: the design path at full size with launch counts from 0
    (J and K must run); J and K held against their plain versions on the
    CPU at the full shape of their first and last design calls with the
    most rows (one worker process each, running while the card goes on),
    against the card's plain versions on ``JK_CHECK_N`` samples, and timed
    alone; ``Study.optimize`` on the same cells; the first Adam steps on
    the CPU."""
    t18 = time.perf_counter()
    study = build_study(api, workloads=[DESIGN_WORKLOAD])
    cells, sols, traces, cap, counts = design_cells(torch, api, study,
                                                    build)
    log("[design] launches: " + json.dumps(counts))
    for nm in RELAXED + ("gpu_floor", "battery"):
        if counts[nm] <= 0:
            raise AssertionError(f"[design] kernel {nm} was not launched")
    calls = {(nm, tag): src[nm][1] for nm in RELAXED_KEPT
             for tag, src in (("first", cap.args), ("last", cap.last))}
    jobs = jk_full_start(torch, calls, os.path.join(HERE, "build",
                                                    "jk_plain"))
    # the workers run on while the later phases use the card; whatever
    # happens, none outlives the script
    atexit.register(jk_stop, jobs)
    try:
        jk = {}
        for nm in RELAXED_KEPT:
            args = cap.args[nm][1]
            merges = {tag: jk_merges(torch, nm, src[nm][1])
                      for tag, src in (("first", cap.args),
                                       ("last", cap.last))}
            log(f"[design] {nm} merges per segment (first and last "
                f"calls): " + json.dumps(merges))
            jk[nm] = {"shape": list(args[0].shape), "merges": merges,
                      "check": jk_check(torch, nm, args),
                      "timing": jk_timing(torch, nm, args,
                                          merges["first"])}
            log(f"[design] {nm}: " + json.dumps(
                {k: v for k, v in jk[nm].items()
                 if k not in ("check", "merges")})
                + "; on the card at " + json.dumps(jk[nm]["check"]))
        opt = optimize_cells(torch, api, study, sols)
        log("[design] Study.optimize: " + json.dumps(opt))
        cpu = cpu_steps(torch, api, study, traces)
    except BaseException:
        jk_stop(jobs)
        raise
    log("[design] first Adam steps on the CPU: " + json.dumps(cpu))
    return {"launches": counts, "cells": cells, "jk": jk, "optimize": opt,
            "cpu": cpu, "jobs": jobs, "phase_s": time.perf_counter() - t18}


def design_finish(torch, design):
    """The end of phase 18: wait for its CPU workers (the full-shape
    checks of J and K), gate them and add them to ``design``."""
    t0 = time.perf_counter()
    full = jk_full_finish(torch, design.pop("jobs"))
    for (nm, tag), c in full.items():
        design["jk"][nm].setdefault("full", {})[tag] = c
    # an Adam step on the CPU at the full 90 000 samples runs J's and K's
    # plain forward and backward once: their seconds in this run's checks
    design["cpu"]["full_step_s_estimate"] = {
        tag: sum((c["plain_cpu_fwd_ms"] + c["plain_cpu_bwd_ms"]) / 1e3
                 for (_, t), c in full.items() if t == tag)
        for tag in ("first", "last")}
    log("[design] the CPU's full-shape checks: " + json.dumps(
        design["cpu"]["full_step_s_estimate"]) + f", waited "
        f"{time.perf_counter() - t0:.1f} s for them at the end")
    return design


def jk_rows(design, late):
    """The kernels line's rows of J and K (forward and adjoint): launches
    on the design path (and 0 on every other path, gated by the caller),
    device and event ms at the design's shape, the errors of the
    full-shape checks against the CPU (the worst of the first and last
    calls; the card's cut check beside them), the plain version's ms on
    the card at the cut shape and on the CPU at the full shape, the bound,
    the chain floor and (forward) the walks' merges."""
    rows = []
    src = {"gpu_floor_relaxed": ("gpu_floor_relaxed.cu",
                                 "src/repro/core/smoothing/gpu_floor.py:93"),
           "battery_relaxed": ("battery_relaxed.cu",
                               "src/repro/core/smoothing/battery.py:106")}
    for base, d in design["jk"].items():
        B, n = d["shape"]
        cols = len(jk_columns(base))
        chk = d["check"]
        full = d["full"]
        for tag in ("forward", "adjoint"):
            name = base if tag == "forward" else base + "_adjoint"
            t = d["timing"][tag]
            b_ms, b_by = jk_bound(name, B, n, cols)
            k_abs, k_rel = (("out_abs", "out_rel") if tag == "forward"
                            else ("grad_abs", "grad_rel"))
            worst = max(full.values(), key=lambda c: c[k_rel])
            row = {
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/scans/csrc/"
                          f"{src[base][0]}",
                "replaces": src[base][1] + (" (lax.scan)" if tag == "forward"
                                            else " (its jax.grad)"),
                "launches": design["launches"][name],
                "launches_by_path": {p: c[name] for p, c in late.items()},
                "max_abs_err": max(c[k_abs] for c in full.values()),
                "rel_err": worst[k_rel],
                "tolerance": f"{JK_TOL} x max |plain| of each output, of "
                             f"d/dw and of each parameter column, against "
                             f"the CPU's plain version at the full shape of "
                             f"the first and last design calls",
                "full_checks": {tag_: {"shape": c["shape"],
                                       k_abs: c[k_abs], k_rel: c[k_rel]}
                                for tag_, c in full.items()},
                "card_check": {"shape": chk["shape"], k_abs: chk[k_abs],
                               k_rel: chk[k_rel]},
                "shape": [B, n], "ms": t["ms"], "device_ms": t["device_ms"],
                "plain_ms": chk["plain_fwd_ms" if tag == "forward"
                                else "plain_bwd_ms"],
                "plain_shape": chk["shape"],
                "plain_cpu_ms": {tag_: c["plain_cpu_fwd_ms"
                                         if tag == "forward"
                                         else "plain_cpu_bwd_ms"]
                                 for tag_, c in full.items()},
                "bound_ms": b_ms, "bound_by": b_by,
                "saved_carry_bytes": JK_SAVED_BYTES[name] * B * n,
                "chain": t["chain"], "sm_clock_ghz": t["sm_clock_ghz"],
                "chain_floor_ms": t["chain_floor_ms"],
                "library_ms": None,
                "library_note": "no PyTorch call computes this recurrence"}
            if tag == "adjoint":
                row["worst_column"] = worst["worst_grad"]
            else:
                row["chain_floors_ms"] = t["chain_floors_ms"]
                row["merges"] = d["merges"]
            rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 19: the relaxed backstop's gradient, through kernel A's adjoint
# ---------------------------------------------------------------------------

BACKSTOP_ROWS = 10                # phase 18's hybrid rows
BACKSTOP_SEEDS = 5                # jitter draws a fleet: 2 x 5 rows
BACKSTOP_TAU = 0.05               # design_gradient's smooth_tau
BACKSTOP_THRESHOLD_W = 8e5        # phase 5's middle backstop (bs8)
MONITOR_ADJ_TOL = 1e-4            # kernel against plain, of max |plain|
# float64 operations a sample and bin of the adjoint as written (a phase
# counted as one), and the card's float64 peak outside the tensor cores
# (NVIDIA's H100 SXM data sheet: 34 TFLOP/s at 700 W)
MONITOR_ADJ_OPS = 30
PEAK_F64_OPS_S = 34e12


def backstop_traces(torch, study):
    """``[BACKSTOP_ROWS, 90 000]``: phase 5's longest workload at both
    fleets and ``BACKSTOP_SEEDS`` jitter draws each, on the card."""
    import numpy as np
    from repro_torch.core.waveform import job_waveform
    tl = study.workloads[DESIGN_WORKLOAD]
    rows = [np.asarray(job_waveform(tl, n, study.wave_cfg, seed=sd,
                                    sample_chips=study.sample_chips,
                                    device=DEVICE)[1])
            for n in study.fleets for sd in range(BACKSTOP_SEEDS)]
    return torch.as_tensor(np.stack(rows), dtype=torch.float32,
                           device=DEVICE)


def monitor_adjoint_operands(torch, w, bs):
    """Kernel A's adjoint's operands on rows ``w``: the centred trace,
    kernel E's amplitudes (what the backward recomputes) and a seeded
    ``g``; and the bins and window."""
    from repro_torch.kernels.goertzel import ops
    B, n = w.shape
    freqs = tuple(bs.critical_hz)
    win = max(int(bs.window_s / DT), 8)
    cosp, sinp, rot = ops._tables(freqs, DT, win, w.device)
    zeros = torch.zeros((B, len(freqs), win), device=w.device)
    xc = ops.centre(w)
    amps = ops.sliding_bin_power_v2(
        ops.segments(xc, win), cosp, sinp, rot,
        torch.zeros(B, dtype=torch.int64, device=w.device), zeros,
        zeros)[0].reshape(B, -1, len(freqs))[:, :n].contiguous()
    gen = torch.Generator(device=w.device).manual_seed(19)
    g = torch.randn((B, n), generator=gen, device=w.device)
    return (xc, amps, g, freqs, DT, win)


def backstop_gradient_phase(torch, api, build):
    """Phase 19: the relaxed backstop (phase 5's bs8, ``smooth_tau`` 0.05)
    on ``BACKSTOP_ROWS`` rows of 90 000 samples through ``apply_batch`` and
    its gradient with respect to the trace, with launch counts from 0
    (kernel A forward, E and A's adjoint backward); then A's adjoint
    against its plain version (float64 torch, on the card) on the same
    kind of operands, within ``MONITOR_ADJ_TOL`` of max |plain|, and timed
    alone.  Returns the launches and the kernels line's row."""
    from repro_torch.core.smoothing import apply_mitigation
    from repro_torch.kernels.goertzel import monitor
    t19 = time.perf_counter()
    study = build_study(api, workloads=[DESIGN_WORKLOAD])
    w = backstop_traces(torch, study)
    B, n = w.shape
    bs = api.TelemetryBackstop(amp_threshold_w=BACKSTOP_THRESHOLD_W,
                               smooth_tau=BACKSTOP_TAU)
    weight = torch.cos(torch.arange(n, device=DEVICE,
                                    dtype=torch.float64) / 9.0)
    build.reset_launch_counts()
    x = w.clone().requires_grad_(True)
    out, aux = apply_mitigation([bs] * B, x, DT)
    loss = (out.to(torch.float64) * weight).sum() / 1e9
    (gx,), wall = timed_run(torch, lambda: torch.autograd.grad(loss, (x,)))
    counts = build.launch_counts()
    for nm in ("monitor", "sliding", "monitor_adjoint"):
        if counts[nm] <= 0:
            raise AssertionError(f"[backstop gradient] kernel {nm} was not "
                                 f"launched")
    if not bool(torch.isfinite(gx).all()):
        raise AssertionError("[backstop gradient] a non-finite gradient")
    levels = aux["max_level"].tolist()
    args = monitor_adjoint_operands(torch, w, bs)
    got = monitor.monitor_adjoint(*args)
    ref = monitor.monitor_adjoint_plain(*args)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not err <= MONITOR_ADJ_TOL * scale:
        raise AssertionError(f"[backstop gradient] kernel A's adjoint "
                             f"differs from its plain version: {err} of "
                             f"{scale} (tol {MONITOR_ADJ_TOL})")
    K = len(args[3])
    b_ms, b_by = bound(4 * B * n * (3 + K), 0)
    ops_ms = MONITOR_ADJ_OPS * B * n * K / PEAK_F64_OPS_S * 1e3
    if ops_ms > b_ms:
        b_ms, b_by = ops_ms, "operations"
    row = {"name": "monitor_adjoint", "route": "cuda",
           "source": "src/repro_torch/kernels/goertzel/csrc/"
                     "monitor_adjoint.cu",
           "replaces": "src/repro/core/smoothing/backstop.py:124 (jax.grad "
                       "through sliding_bin_power_jnp, "
                       "src/repro/kernels/goertzel/ref.py:62)",
           "launches": counts["monitor_adjoint"],
           "max_abs_err": err, "rel_err": err / scale,
           "tolerance": f"{MONITOR_ADJ_TOL} x max |plain| (float64 torch "
                        f"on the card, same operands)",
           "shape": [B, n, K], "win": args[5],
           "ms": cuda_ms(torch, lambda: monitor.monitor_adjoint(*args), 5),
           "device_ms": device_ms(torch,
                                  lambda: monitor.monitor_adjoint(*args),
                                  "monitor_adjoint_kernel", repeat=5),
           "plain_ms": cuda_ms(torch,
                               lambda: monitor.monitor_adjoint_plain(*args),
                               2),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "library_note": "no PyTorch call computes the windowed DFT's "
                           "worst-bin adjoint"}
    res = {"launches": counts, "max_level": levels,
           "backward_wall_s": wall, "row": row,
           "phase_s": time.perf_counter() - t19}
    log("[backstop gradient] " + json.dumps(
        {k: v for k, v in res.items() if k != "row"}))
    return res


# ---------------------------------------------------------------------------
# phase 20: the compliance service and the warm-start predictor
# ---------------------------------------------------------------------------

# benchmarks/serve_bench.py's waveform, and benchmarks/warmstart_data.py's
# four smoke cells and tau ladder: the predictor's training set
SERVE_WAVE = dict(dt=0.005, steps=8, jitter_s=0.005)
SERVE_CELLS = ((2.0, 0.25, False, 512, "moderate"),
               (0.8, 0.3, False, 512, "tight"),
               (1.4, 0.2, True, 1024, "moderate"),
               (2.0, 0.35, False, 1024, "tight"))
TAU_LADDER = (5.0, 10.0, 15.0, 30.0)
SERVE_EPOCHS = 400
PREDICT_RTOL = 1e-5       # the card's predictions against the CPU forward
# serve_bench's design problem: (period, comm, chips, spec)
SERVE_DESIGN = (1.8, 0.28, 512, "tight")
CACHE_HIT_REPS = 300
SF_THREADS = 8
# a catalog narrowed until the tight spec fails it (the defaults pass every
# one of the 16 queries), and the query that takes its design fallback
NARROW_CATALOG = dict(mpf_grid=(0.5,), cap_fracs=(0.5,))
FALLBACK_QUERY = ("dense_1s", 8192, "tight")
CPU_QUERIES = (("dense_1s", 8192, "moderate"), ("dense_3s", 32768, "tight"))
SERVE_KERNELS = ("gpu_floor", "battery", "gpu_floor_relaxed",
                 "gpu_floor_relaxed_adjoint", "battery_relaxed",
                 "battery_relaxed_adjoint", "monitor", "escalation",
                 "sliding")
SERVE_CLI = (("query", ["--n-chips", "512", "--spec", "moderate"]),
             ("watch", ["watch", "--replay", "ramp", "--max-ticks", "40"]))


def host_problem(api, period_s, comm_frac, moe, n_chips, spec_name, cfg):
    """(float64 host waveform, spec) of one design problem, as
    ``benchmarks/warmstart_data.py`` builds it."""
    from repro_torch.core.waveform import aggregate_host, chip_waveform_host
    tl = api.synthetic_timeline(period_s, comm_frac, moe_notch=moe)
    w = aggregate_host(chip_waveform_host(tl, cfg), n_chips, cfg)
    return w, api.example_specs(float(w.mean()) / 1e6)[spec_name]


def predictor_dataset(torch, api):
    """The training set: each cell solved by ``design(method="hybrid")`` on
    the card, its battery horizon refined over ``TAU_LADDER`` in one
    ``_eval_candidates`` call (``warmstart_data._refine_tau``)."""
    import numpy as np
    from repro_torch.core import engine
    from repro_torch.serve.warmstart import extract_features
    cfg = api.WaveformConfig(**SERVE_WAVE)
    X, Y, cells = [], [], []
    for period, comm, moe, n_chips, spec_name in SERVE_CELLS:
        w, spec = host_problem(api, period, comm, moe, n_chips, spec_name,
                               cfg)
        sol, wall = timed_run(torch, lambda: engine.design(
            spec, w, cfg.dt, n_chips, method="hybrid"))
        if sol is None or not sol["report"].ok:
            log(f"[serve] cell {(period, comm, moe, n_chips, spec_name)} "
                "infeasible, skipped")
            continue
        mpf, cap = float(sol["mpf_frac"]), float(sol["battery_capacity_j"])
        tau = TAU_LADDER[1]
        if cap > 0:
            _, ok, overhead, _, _ = engine._eval_candidates(
                spec, torch.as_tensor(w.astype(np.float32), device=DEVICE),
                cfg.dt, n_chips, [(mpf, cap)] * len(TAU_LADDER),
                swing=float(w.max() - w.min()), hw=api.DEFAULT_HW,
                target_tau_s=list(TAU_LADDER))
            ok, overhead = ok.cpu().numpy(), overhead.cpu().numpy()
            if ok.any():
                tau = TAU_LADDER[int(np.flatnonzero(ok)[
                    np.argmin(overhead[ok])])]
        X.append(extract_features(spec, w, cfg.dt, n_chips))
        Y.append([mpf, cap, tau])
        cells.append({"cell": [period, comm, moe, n_chips, spec_name],
                      "mpf_frac": mpf, "battery_capacity_j": cap,
                      "target_tau_s": tau, "hybrid_s": wall})
    if not X:
        raise AssertionError("[serve] no feasible training cell")
    return np.stack(X), np.asarray(Y, np.float32), cells


def predictor_part(torch, api):
    """(a): the training set, 400 epochs on the card, a save and load
    equal bit for bit, and the card's predictions against the same
    params' CPU forward."""
    import numpy as np
    from repro_torch.serve.warmstart import WarmStartPredictor, train_warmstart
    t0 = time.perf_counter()
    X, Y, cells = predictor_dataset(torch, api)
    data_s = time.perf_counter() - t0
    (pred, hist), train_s = timed_run(
        torch, lambda: train_warmstart(X, Y, epochs=SERVE_EPOCHS))
    losses = hist["loss"]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[serve] the predictor's loss did not fall: "
                             f"{losses[0]} -> {losses[-1]}")
    ckpt = os.path.join(HERE, "build", "phase20_warmstart")
    pred.save(ckpt)
    again = WarmStartPredictor.load(ckpt)
    if not np.array_equal(again.predict_normalized(X),
                          pred.predict_normalized(X)):
        raise AssertionError("[serve] the loaded predictor differs from the "
                             "saved one")
    cpu = WarmStartPredictor(tree_to(pred.params, "cpu"),
                             tree_to(pred.norm, "cpu"), pred.meta)
    card, host = pred.predict_normalized(X), cpu.predict_normalized(X)
    rel = float(np.abs(card - host).max() / np.abs(host).max())
    if not rel <= PREDICT_RTOL:
        raise AssertionError(f"[serve] card vs CPU predictions {rel:.3g} "
                             f"apart (rtol {PREDICT_RTOL})")
    res = {"cells": cells, "n_train": len(X), "dataset_s": data_s,
           "epochs": SERVE_EPOCHS, "train_s": train_s, "loss0": losses[0],
           "loss": losses[-1], "card_vs_cpu_rel": rel}
    log("[serve] (a) predictor: " + json.dumps(res))
    return pred, cpu, res


def design_part(torch, api, pred):
    """(b): serve_bench's design problem by ``hybrid`` and ``warmstart``,
    each cold and warm; the two agree on feasibility and both answers
    pass their hard re-validation."""
    from repro_torch.core import engine
    period, comm, n_chips, spec_name = SERVE_DESIGN
    cfg = api.WaveformConfig(**SERVE_WAVE)
    w, spec = host_problem(api, period, comm, False, n_chips, spec_name, cfg)
    res = {}
    sols = {}
    for method, kw in (("hybrid", {}), ("warmstart", {"warmstart": pred})):
        for tag in ("cold", "warm"):
            sols[method], res[f"{method}_{tag}_s"] = timed_run(
                torch, lambda: engine.design(spec, w, cfg.dt, n_chips,
                                             method=method, **kw))
    h, ws = sols["hybrid"], sols["warmstart"]
    if (h is None) != (ws is None):
        raise AssertionError("[serve] hybrid and warmstart disagree on "
                             "feasibility")
    if h is None or not (h["report"].ok and ws["report"].ok):
        raise AssertionError("[serve] a design failed its hard "
                             "re-validation")
    res.update(warmstart_path=ws["aux"]["warmstart_path"],
               samples=len(w),
               hybrid={k: h[k] for k in ("mpf_frac", "battery_capacity_j",
                                         "energy_overhead")},
               warmstart={k: ws[k] for k in ("mpf_frac", "battery_capacity_j",
                                             "energy_overhead")})
    log("[serve] (b) design: " + json.dumps(res))
    return res


def serve_queries(api):
    tls = study_timelines(api)
    return [{"workload": tls[name], "workload_name": name, "n_chips": n,
             "spec": s} for name in tls for n in FLEETS for s in SPEC_NAMES]


def cell_request(api):
    """A dry-run cell file written here, and the request that names it."""
    cell = {"arch": "phase20-dense", "n_chips": 8192,
            "exact": {"flops": 3.2e18, "bytes": 4.0e15},
            "collectives": {"all-reduce": 6.0e9},
            "memory": {"state_bytes_per_device": 4e9}}
    path = os.path.join(HERE, "build", "phase20_cell.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cell, f)
    return {"workload": {"cell": path}, "n_chips": 8192, "spec": "moderate"}


def same_answer(got, ref, where):
    """CPU against card: equal verdicts, recommendation and passing
    names; the numbers within ``STUDY_RTOL`` (energy_overhead also abs
    1e-6)."""
    for k in ("compliant", "recommended", "n_configs", "mean_mw",
              "raw_swing_mw"):
        if got[k] != ref[k]:
            raise AssertionError(f"[serve] {where}: {k} {got[k]} vs {ref[k]}")
    if [p["config"] for p in got["passing"]] != [
            p["config"] for p in ref["passing"]]:
        raise AssertionError(f"[serve] {where}: passing configs differ")
    worst = 0.0
    for a, b in zip(got["passing"], ref["passing"]):
        for k in ("energy_overhead", "swing_mitigated_mw"):
            atol = 1e-6 if k == "energy_overhead" else 0.0
            if abs(a[k] - b[k]) > STUDY_RTOL * abs(b[k]) + atol:
                raise AssertionError(f"[serve] {where}: {a['config']} {k} "
                                     f"{a[k]} vs {b[k]}")
            worst = max(worst, abs(a[k] - b[k]) / max(abs(b[k]), 1e-30))
    return worst


def service_part(torch, api, pred):
    """(c): the 16 queries coalesced (one Study run; the process's first
    such run on an instance of its own, then timed again on a fresh one)
    and serial on another instance, all equal; cache-hit latency; 8
    threads on one cold query; a dry-run cell through ``handle``; the
    design fallback by hybrid and by warm start on a narrowed catalog."""
    import threading
    qs = serve_queries(api)
    # the process's first queries (allocator, FFT plans) on an instance of
    # their own; then each instance starts with empty caches and memos
    first, first_s = timed_run(
        torch, lambda: api.PowerComplianceService().query_many(qs))
    co = api.PowerComplianceService()
    answers, co_s = timed_run(torch, lambda: co.query_many(qs))
    if co.stats["study_runs"] != 1 or answers != first:
        raise AssertionError(f"[serve] query_many ran {co.stats['study_runs']}"
                             " Study runs, or answered otherwise the second "
                             "time")
    serial_svc = api.PowerComplianceService()
    serial, serial_s = timed_run(torch, lambda: [
        serial_svc.query(q["workload"], q["n_chips"], q["spec"],
                         workload_name=q["workload_name"]) for q in qs])
    if serial != answers:
        raise AssertionError("[serve] coalesced answers differ from serial "
                             "ones")
    q0 = qs[0]
    hits = []
    for _ in range(CACHE_HIT_REPS):
        t0 = time.perf_counter()
        co.query(q0["workload"], q0["n_chips"], q0["spec"],
                 workload_name=q0["workload_name"])
        hits.append(time.perf_counter() - t0)
    sf = api.PowerComplianceService()
    got, errs = [None] * SF_THREADS, []

    def ask(i):
        try:
            got[i] = sf.query(q0["workload"], q0["n_chips"], q0["spec"],
                              workload_name=q0["workload_name"])
        except Exception as e:      # raised below
            errs.append(e)

    threads = [threading.Thread(target=ask, args=(i,))
               for i in range(SF_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    sf_s = time.perf_counter() - t0
    if errs or any(t.is_alive() for t in threads):
        raise AssertionError(f"[serve] single-flight threads failed: {errs}")
    if sf.stats["study_runs"] != 1 or any(g != answers[0] for g in got):
        raise AssertionError(f"[serve] {SF_THREADS} threads ran "
                             f"{sf.stats['study_runs']} Study runs or "
                             "answered otherwise")
    cell = co.handle(cell_request(api))
    if "error" in cell or cell["workload"] != "phase20-dense":
        raise AssertionError(f"[serve] the cell request failed: {cell}")
    name, n_chips, spec = FALLBACK_QUERY
    tl = study_timelines(api)[name]
    fallback = {}
    for method, kw in (("hybrid", {}), ("warmstart", {"warmstart": pred})):
        svc = api.PowerComplianceService(design_method=method, **kw,
                                         **NARROW_CATALOG)
        ans, wall = timed_run(torch, lambda: svc.query(
            tl, n_chips, spec, workload_name=name))
        d = ans["designed"]
        if d is None or ans["recommended"] != d["config"]:
            raise AssertionError(f"[serve] the {method} fallback designed "
                                 f"nothing: {ans}")
        fallback[method] = {"wall_s": wall, "mpf_frac": d["mpf_frac"],
                            "battery_capacity_j": d["battery_capacity_j"],
                            "energy_overhead": d["energy_overhead"],
                            "warmstart_path": d.get("warmstart_path")}
    verdicts = collections.Counter(
        (a["spec"], a["recommended"]) for a in answers)
    res = {"queries": len(qs), "rows": sum(a["n_scenarios"] for a in answers),
           "first_coalesced_s": first_s, "coalesced_s": co_s,
           "serial_s": serial_s,
           "cache_hit_p50_us": pctl(hits, 50) * 1e6,
           "cache_hit_p99_us": pctl(hits, 99) * 1e6,
           "singleflight": {"threads": SF_THREADS, "wall_s": sf_s,
                            "study_runs": sf.stats["study_runs"],
                            "waits": sf.stats["singleflight_waits"]},
           "cell": {k: cell[k] for k in ("workload", "compliant",
                                         "recommended", "mean_mw",
                                         "raw_swing_mw")},
           "fallback": fallback,
           "recommended": {f"{s}:{r}": c for (s, r), c in verdicts.items()}}
    log("[serve] (c) service: " + json.dumps(res))
    return answers, res


def service_cpu(api, answers):
    """(c) on the CPU: two of the 16 queries, held against the card's."""
    qs = {(q["workload_name"], q["n_chips"], q["spec"]): i
          for i, q in enumerate(serve_queries(api))}
    tls = study_timelines(api)
    svc = api.PowerComplianceService(device="cpu")
    worst, t0 = 0.0, time.perf_counter()
    for name, n_chips, spec in CPU_QUERIES:
        got = svc.query(tls[name], n_chips, spec, workload_name=name)
        worst = max(worst, same_answer(got, answers[qs[name, n_chips, spec]],
                                       f"{name} {n_chips} {spec}"))
    res = {"queries": len(CPU_QUERIES), "wall_s": time.perf_counter() - t0,
           "worst_rel": worst}
    log("[serve] (c) CPU re-run: " + json.dumps(res))
    return res


def timeline_key(text):
    """A timeline's columns but the latency (a wall-clock reading) and the
    formatted amplitude and margin (held by value, within STUDY_RTOL)."""
    return [ln.split()[:3] + ln.split()[5:6] + ln.split()[7:]
            for ln in text.splitlines()]


def watch_kwargs():
    from repro_torch import control
    return dict(replay=control.synthesize_ramp(dt=CONTROL_DT),
                n_chips=CONTROL_CHIPS, spec="moderate")


def watch_card(torch, api, pred):
    """(d) on the card: ``watch`` on the canonical ramp with the
    predictor as the redesign rung's warm start."""
    svc = api.PowerComplianceService(design_method="warmstart",
                                     warmstart=pred)
    card, wall = timed_run(torch, lambda: svc.watch(**watch_kwargs()))
    log(f"[serve] (d) watch timeline:\n{card['timeline']}")
    s = card["summary"]
    if s["n_dispatches"] < 1:
        raise AssertionError("[serve] watch dispatched nothing")
    return card, {"loop_wall_s": wall, "n_ticks": s["n_ticks"],
                  "n_dispatches": s["n_dispatches"],
                  "records": len(card["records"]),
                  "detection_lead_s": s["detection_lead_s"]}


def watch_cpu(api, pred_cpu, card):
    """(d) on the CPU: the same call gives the same records and
    timeline (but the latency column, a wall-clock reading)."""
    svc = api.PowerComplianceService(design_method="warmstart",
                                     warmstart=pred_cpu, device="cpu")
    t0 = time.perf_counter()
    cpu = svc.watch(**watch_kwargs())
    secs = time.perf_counter() - t0
    key = ("tick", "action", "level", "bin_hz")
    if ([tuple(r[k] for k in key) for r in cpu["records"]]
            != [tuple(r[k] for k in key) for r in card["records"]]
            or timeline_key(cpu["timeline"])
            != timeline_key(card["timeline"])):
        raise AssertionError(f"[serve] watch: CPU and card timelines "
                             f"differ\n{cpu['timeline']}")
    # amplitudes and margins within STUDY_RTOL of themselves, or of the
    # replay's amplitude scale where they are rounding noise (a bin the
    # stagger rung has emptied)
    replay = watch_kwargs()["replay"]
    scale = float(abs(replay.astype("float64") - replay.mean()).max())
    worst, seed_rel = 0.0, 0.0
    for c, g in zip(cpu["records"], card["records"]):
        for k in ("amplitude_w", "margin_w"):
            ref = max(abs(g[k]), scale)
            if abs(c[k] - g[k]) > STUDY_RTOL * ref:
                raise AssertionError(f"[serve] watch: {k} {c[k]} vs {g[k]} "
                                     f"at tick {c['tick']}")
            worst = max(worst, abs(c[k] - g[k]) / ref)
        if c["action"] == "dispatch:redesign":
            # the warm start's rungs are its predicted seed (MPF) and the
            # seed scaled (capacity): one float32 forward on each device,
            # within PREDICT_RTOL
            cp, gp = c["params"], g["params"]
            for k in ("mpf_frac", "battery_capacity_j"):
                gap = abs(cp[k] - gp[k]) / max(abs(gp[k]), 1e-30)
                if gap > PREDICT_RTOL:
                    raise AssertionError(f"[serve] watch: redesign at tick "
                                         f"{c['tick']}: {cp} vs {gp}")
                seed_rel = max(seed_rel, gap)
            if abs(cp["energy_overhead"] - gp["energy_overhead"]) > 1e-6:
                raise AssertionError(f"[serve] watch: redesign at tick "
                                     f"{c['tick']}: {cp} vs {gp}")
    res = {"cpu_wall_s": secs, "worst_rel": worst,
           "redesign_seed_rel": seed_rel}
    log("[serve] (d) watch on the CPU: " + json.dumps(res))
    return res


def cli_start():
    """(e): both CLI commands as subprocesses of their own, started
    together."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    return [(tag, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve.power", *argv], cwd=HERE,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for tag, argv in SERVE_CLI]


def cli_finish(procs, timeout=300):
    res = {}
    try:
        for tag, p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise AssertionError(f"[serve] CLI {tag} exited "
                                     f"{p.returncode}:\n{err[-2000:]}")
            answer = json.loads(out)
            res[tag] = {k: answer[k] for k in ("spec", "n_chips")}
            res[tag].update({k: answer[k] for k in ("compliant",
                                                    "recommended")
                             if k in answer})
            if "summary" in answer:
                res[tag]["n_ticks"] = answer["summary"]["n_ticks"]
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    log("[serve] (e) CLI: " + json.dumps(res))
    return res


def compliance_phase(torch, api, build):
    """Phase 20: the compliance service at its own full width, after
    ``benchmarks/serve_bench.py``: (a) the warm-start predictor trained on
    the card, (b) the design problem by hybrid and warm start, (c) the
    service's 16 queries coalesced and serial, its cache, single-flight, a
    dry-run cell and the design fallback, (d) ``watch`` on the ramp, (e)
    both CLI commands (subprocesses, started once the card's parts are
    done), then (c) and (d) on the CPU.  Launch counts from 0 before each
    part and read after it; the CPU's parts launch nothing."""
    t20 = time.perf_counter()
    parts = {}

    def counted(tag, fn):
        build.reset_launch_counts()
        out = fn()
        parts[tag] = build.launch_counts()
        return out

    pred, pred_cpu, a = counted("predictor", lambda: predictor_part(torch,
                                                                    api))
    b = counted("design", lambda: design_part(torch, api, pred))
    answers, c = counted("service", lambda: service_part(torch, api, pred))
    card, d = counted("watch", lambda: watch_card(torch, api, pred))
    procs = cli_start()
    try:
        c["cpu"], d["cpu"] = counted("cpu", lambda: (
            service_cpu(api, answers), watch_cpu(api, pred_cpu, card)))
    finally:
        e = cli_finish(procs)
    for tag, n in parts.items():
        log(f"[serve] launches in {tag}: " + json.dumps(n))
    counts = {k: sum(p[k] for p in parts.values()) for k in parts["cpu"]}
    missing = [nm for nm in SERVE_KERNELS if counts[nm] <= 0]
    if missing or counts.get("flash_fwd") or any(parts["cpu"].values()):
        raise AssertionError(f"[serve] launches: {missing} not launched, F "
                             f"{counts.get('flash_fwd')}, on the CPU's parts "
                             f"{parts['cpu']}")
    return {"launches": counts, "launches_by_part": parts, "predictor": a,
            "design": b, "service": c, "watch": d, "cli": e,
            "phase_s": time.perf_counter() - t20}


# ---------------------------------------------------------------------------
# phase 21: the Study on the scenario mesh, in one process and in two
# worker processes on the one card
# ---------------------------------------------------------------------------

MESH_PROCESSES = 2
MESH_STREAM5 = 64         # phase 5's grid in the workers
MESH_STREAM16 = 16        # phase 16's grid in the workers
# rows of phase 16's grid a one-process run checkpoints for the workers to
# resume: every workload in it (one padded length), the last 16 rows not
MESH_PREFIX = 112
MESH_ELEMENTS = 256 * 4096  # the all-reduce's tensor, a BLOCK multiple
MESH_TIMEOUT_S = 300
# what each worker must launch (B, C, D, A) and must not
MESH_KERNELS = ("gpu_floor", "battery", "escalation", "monitor")
MESH_ABSENT = ("sliding", "flash_fwd", "ballast", "windows", "sliding_v1",
               "gpu_floor_relaxed", "gpu_floor_relaxed_adjoint",
               "battery_relaxed", "battery_relaxed_adjoint",
               "monitor_adjoint")


# (a)'s check that a row's analysis does not depend on its batch: odd and
# even lengths, the row at several places among other rows
MESH_ANALYSIS_LENGTHS = (1500, 1501, 1875, 15001, 30000)
MESH_ANALYSIS_PLACES = (0, 1, 2, 3, 5, 31)


def analysis_places(torch, api):
    """On the card: one row analysed at ``MESH_ANALYSIS_PLACES`` of a
    32-row batch of other rows, at each of ``MESH_ANALYSIS_LENGTHS``; every
    band and spec metric must be equal bit for bit (the odd lengths take
    the complex FFT, every sum a row-aligned layout)."""
    from repro_torch.core.engine import analyze_batch
    spec = api.example_specs(JOB_MW)["moderate"]
    out = {}
    for n in MESH_ANALYSIS_LENGTHS:
        g = torch.Generator(device="cuda").manual_seed(n)
        x0 = torch.randn(n, device="cuda", generator=g) * 2e5 + 6e6
        ref, same = None, 0
        for p in MESH_ANALYSIS_PLACES:
            X = torch.randn(32, n, device="cuda", generator=g) * 2e5 + 6e6
            X[p] = x0
            a = analyze_batch(X, DT, spec)
            row = {k: v[p] for k, v in a["bands_mitigated"].items()}
            row.update({k: v[p] for k, v in a["spec_metrics"].items()})
            ref = ref or row
            bad = [k for k in ref if not torch.equal(row[k], ref[k])]
            if bad:
                raise AssertionError(f"[mesh] at length {n} a row analysed "
                                     f"at place {p} differs in {bad}")
            same += 1
        out[n] = same
    log("[mesh] (a) one row's analysis at places "
        f"{list(MESH_ANALYSIS_PLACES)} of a 32-row batch, equal at lengths "
        + json.dumps(out))
    return out


# the torch calls the analysis stopped using as they were, measured the
# same way: a batched rfft at odd and even lengths, and float32 row sums
# over contiguous rows of each column count
MESH_RAW_FFT = (1500, 1501, 1875, 2250, 3001, 15001, 15014, 37020, 90000)
MESH_RAW_SUM = (750, 751, 1501, 2001, 15001, 22501, 45001)


def raw_places(torch):
    """How a batched ``torch.fft.rfft`` and a float32 sum over a row's
    last axis treat one row placed at ``MESH_ANALYSIS_PLACES`` among other
    rows on the card: the number of distinct results of that row, per
    length (1: its place and neighbours do not matter).  Measured, not
    gated: it is what ``core/spectrum.py``'s complex FFT for odd lengths
    and ``row_aligned`` avoid."""
    out = {"rfft": {}, "sum": {}}
    for kind, sizes in (("rfft", MESH_RAW_FFT), ("sum", MESH_RAW_SUM)):
        for n in sizes:
            g = torch.Generator(device="cuda").manual_seed(n)
            x0 = torch.randn(n, device="cuda", generator=g) * 1e3 + 1e6
            seen = set()
            for p in MESH_ANALYSIS_PLACES:
                X = torch.randn(32, n, device="cuda", generator=g) * 1e3 + 1e6
                X[p] = x0
                row = (torch.fft.rfft(X, dim=-1)[p] if kind == "rfft"
                       else X.sum(-1)[p])
                seen.add(row.cpu().numpy().tobytes())
            out[kind][n] = len(seen)
    log("[mesh] (a) distinct results of one row at "
        f"{len(MESH_ANALYSIS_PLACES)} places, as torch gives them: "
        + json.dumps(out))
    return out


def mesh_payload(torch, rank, device="cuda"):
    """Rank ``rank``'s tensor for the compressed all-reduce."""
    g = torch.Generator().manual_seed(2100 + rank)
    return torch.randn(MESH_ELEMENTS, generator=g).to(device)


def save_columns(res, path):
    import pickle
    with open(path, "wb") as fh:
        pickle.dump(res.columns, fh)


def load_result(api, path):
    import pickle
    with open(path, "rb") as fh:
        return api.StudyResult(pickle.load(fh))


def keyed_rows(torch, study):
    from repro_torch.core import prng
    rows = study.rows()
    return rows, list(prng.fold_in(study.key, torch.arange(len(rows))))


def mesh_worker(torch, out_dir, resume_dir, t_launch):
    """One rank of phase 21(b): join the job (gloo: both ranks share the
    card), then phase 5's grid with ``stream=64``, phase 16's keyed grid
    with ``stream=16`` and again resumed from ``resume_dir`` (a prefix one
    process checkpointed), and one compressed all-reduce; records from
    process 0; a report from each rank with its launches, walls and merge
    seconds."""
    import numpy as np
    from repro_torch import api
    from repro_torch.core import engine
    from repro_torch.core.study import run_rows
    from repro_torch.kernels import build
    from repro_torch.parallel import collectives
    from repro_torch.parallel import distributed as D
    t0 = time.time()
    if not D.initialize():
        raise SystemExit("mesh worker launched without REPRO_DIST_*")
    rank = D.process_index()
    report = {"rank": rank, "backend": str(
        torch.distributed.get_backend()), "device": str(
        torch.cuda.current_device()), "startup_s": time.time() - t_launch,
        "init_s": time.time() - t0, "walls": {}, "calls": {}}
    merge = {"s": 0.0, "n": 0}
    gather = engine.host_allgather

    def timed_gather(*a, **kw):
        t = time.perf_counter()
        out = gather(*a, **kw)
        merge["s"] += time.perf_counter() - t
        merge["n"] += 1
        return out
    engine.host_allgather = timed_gather
    plan = D.distributed_plan()
    report["plan"] = [str(d) for d in plan.devices]
    build.reset_launch_counts()

    def step(tag, fn):
        calls = report["calls"].setdefault(tag, [])
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn(lambda d, n, e: calls.append([d, n]))
        torch.cuda.synchronize()
        report["walls"][tag] = time.perf_counter() - t
        if D.is_primary():
            save_columns(res, os.path.join(out_dir, f"{tag}.pkl"))
        return res

    study5 = build_study(api)
    study5.plan = plan
    step("phase5_stream64", lambda cb: study5.run(stream=MESH_STREAM5,
                                                  on_chunk=cb))
    study16 = build_keyed_study(api, device="cuda")
    study16.plan = plan
    step("phase16_stream16", lambda cb: study16.run(stream=MESH_STREAM16,
                                                    on_chunk=cb))
    rows, keys = keyed_rows(torch, study16)
    step("phase16_resumed", lambda cb: run_rows(
        study16.workloads, rows, study16.specs, wave_cfg=study16.wave_cfg,
        hw=study16.hw, keys=keys, stream=MESH_STREAM16, resume=resume_dir,
        sample_chips=study16.sample_chips, on_chunk=cb, plan=plan,
        device="cuda"))
    report["launches"] = build.launch_counts()
    report["merge_s"], report["merges"] = merge["s"], merge["n"]
    x = mesh_payload(torch, rank)
    torch.cuda.synchronize()
    t = time.perf_counter()
    mean, err = collectives.compressed_allreduce_mean(x, torch.zeros_like(x))
    torch.cuda.synchronize()
    report["allreduce_s"] = time.perf_counter() - t
    np.save(os.path.join(out_dir, f"allreduce_{rank}.npy"),
            mean.cpu().numpy())
    with open(os.path.join(out_dir, f"report_{rank}.json"), "w") as fh:
        json.dump(report, fh)
    D.shutdown()
    return 0


def mesh_progress_gate(reports, tag, n_rows, first=None):
    """``on_chunk`` of one step: process 0 only, every total the grid's
    rows, ending at ``done == total == n_rows``."""
    primary = reports[0]["calls"][tag]
    others = [r["calls"][tag] for r in reports[1:]]
    if any(others):
        raise AssertionError(f"[mesh] {tag}: a non-primary process reported "
                             f"progress: {others}")
    if not primary or primary[-1] != [n_rows, n_rows] or any(
            t != n_rows for _, t in primary):
        raise AssertionError(f"[mesh] {tag}: process 0's progress {primary} "
                             f"does not end at {n_rows} of {n_rows}")
    if first is not None and primary[0][0] != first:
        raise AssertionError(f"[mesh] {tag}: the resumed run's first report "
                             f"{primary[0]} is not the {first} restored rows")


def mesh_smoke_start():
    """(c): ``python -m repro_torch.parallel.distributed --smoke`` on the
    card, as a subprocess started beside (b)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.parallel.distributed", "--smoke"],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def mesh_smoke_finish(proc, t0, timeout=MESH_TIMEOUT_S):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0 or "DISTRIBUTED_SMOKE_OK" not in out:
        raise AssertionError(f"[mesh] (c) the smoke exited {proc.returncode}"
                             f":\n{out[-1000:]}\n{err[-2000:]}")
    line = next(ln for ln in out.splitlines() if "DISTRIBUTED_SMOKE_OK" in ln)
    log(f"[mesh] (c) {line} ({time.perf_counter() - t0:.1f} s)")
    return {"line": line, "wall_s": time.perf_counter() - t0}


def mesh_phase(torch, api, build, res5):
    """Phase 21: (a) phase 5's Study with ``plan=scenario_plan()`` and with
    ``shard_devices=True`` in this process, records equal to phase 5's;
    (b) one ``launch_workers`` of two processes on the one card (gloo):
    phase 5's grid (``stream=64``), phase 16's keyed grid (``stream=16``)
    and again resumed from a prefix this process checkpointed, records
    equal to this process's, progress from process 0 only, B, C, D and A
    launched in each worker and no other kernel, and a compressed
    all-reduce equal to the mean of both ranks' dequantized payloads; (c)
    the distributed smoke as a subprocess beside (b)."""
    import shutil
    import numpy as np
    from repro_torch.core.study import run_rows
    from repro_torch.parallel import collectives, distributed, scenario_plan
    t21 = time.perf_counter()
    out = {"steps": {}}

    def gate(tag, got, want):
        bad = columns_equal(got, want)
        if bad:
            raise AssertionError(f"[mesh] {tag} differs from the one-process "
                                 f"run in {bad}")

    # (a) one process, the plan's one card
    out["raw_places"] = raw_places(torch)
    out["analysis_places"] = analysis_places(torch, api)
    build.reset_launch_counts()
    for tag, kw in (("plan", {"plan": scenario_plan()}),
                    ("shard_devices", {"shard_devices": True})):
        study = build_study(api)
        for k, v in kw.items():
            setattr(study, k, v)
        got, wall = timed_run(torch, study.run)
        gate(f"(a) {tag}", got, res5)
        out["steps"][f"a_{tag}"] = wall
    # the one-process references of phase 16's grid: one-shot, and the
    # prefix the workers resume (their launches count with (a)'s, read
    # once below)
    keyed = build_keyed_study(api, device="cuda")
    res16, out["steps"]["keyed_one_shot"] = timed_run(torch, keyed.run)
    work = os.path.join(HERE, "build", "phase21")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    resume_dir = os.path.join(work, "resume")
    rows, keys = keyed_rows(torch, keyed)
    _, out["steps"]["prefix_checkpoint"] = timed_run(torch, lambda: run_rows(
        keyed.workloads, rows[:MESH_PREFIX], keyed.specs,
        wave_cfg=keyed.wave_cfg, hw=keyed.hw, keys=keys[:MESH_PREFIX],
        stream=MESH_STREAM16, resume=resume_dir,
        sample_chips=keyed.sample_chips, device="cuda"))
    out["launches"] = build.launch_counts()
    # (b) two workers on the card, (c) the smoke beside them
    t_c = time.perf_counter()
    smoke = mesh_smoke_start()
    try:
        t_b = time.perf_counter()
        done = distributed.launch_workers(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--mesh-worker", work, resume_dir, repr(time.time())],
            num_processes=MESH_PROCESSES, timeout=MESH_TIMEOUT_S)
        out["steps"]["b_launch"] = time.perf_counter() - t_b
    finally:
        out["smoke"] = mesh_smoke_finish(smoke, t_c)
    out["steps"]["c_smoke"] = out["smoke"]["wall_s"]
    for r in done:
        if r.stdout.strip():
            log("[mesh] worker stdout: " + r.stdout.strip()[-500:])
    reports = [json.load(open(os.path.join(work, f"report_{r}.json")))
               for r in range(MESH_PROCESSES)]
    for rep in reports:
        log(f"[mesh] (b) worker {rep['rank']}: backend {rep['backend']}, "
            f"card {rep['device']}, plan {rep['plan']}, start-up "
            f"{rep['startup_s']:.2f} s (init {rep['init_s']:.2f} s), walls "
            + json.dumps(rep["walls"]) + f", merges {rep['merges']} in "
            f"{rep['merge_s']:.4f} s, all-reduce {rep['allreduce_s']:.4f} s")
        log(f"[mesh] (b) worker {rep['rank']} launches: "
            + json.dumps(rep["launches"]))
        missing = [k for k in MESH_KERNELS if rep["launches"][k] <= 0]
        extra = {k: rep["launches"][k] for k in MESH_ABSENT
                 if rep["launches"].get(k)}
        if missing or extra:
            raise AssertionError(f"[mesh] worker {rep['rank']}: {missing} "
                                 f"not launched, {extra} launched")
    for tag, want in (("phase5_stream64", res5), ("phase16_stream16", res16),
                      ("phase16_resumed", res16)):
        gate(f"(b) {tag}", load_result(api, os.path.join(work, f"{tag}.pkl")),
             want)
    mesh_progress_gate(reports, "phase5_stream64",
                       len(res5) // len(SPEC_NAMES))
    mesh_progress_gate(reports, "phase16_stream16", keyed.n_rows)
    first = reports[0]["calls"]["phase16_resumed"][0][0]
    mesh_progress_gate(reports, "phase16_resumed", keyed.n_rows)
    if not 0 < first < MESH_PREFIX:
        raise AssertionError(f"[mesh] the resumed run restored {first} rows, "
                             f"not a part of the {MESH_PREFIX}-row prefix")
    deq = [collectives.quantize_roundtrip(mesh_payload(torch, r))
           for r in range(MESH_PROCESSES)]
    want = (sum(deq[1:], deq[0]) / MESH_PROCESSES).cpu().numpy()
    for r in range(MESH_PROCESSES):
        got = np.load(os.path.join(work, f"allreduce_{r}.npy"))
        if not np.array_equal(got, want):
            raise AssertionError(f"[mesh] rank {r}'s all-reduce differs from "
                                 "the mean of the dequantized payloads by "
                                 f"{np.abs(got - want).max()}")
    shutil.rmtree(work, ignore_errors=True)
    out["workers"] = [{k: rep[k] for k in (
        "rank", "backend", "startup_s", "init_s", "walls", "merge_s",
        "merges", "allreduce_s", "launches")} for rep in reports]
    out["restored_rows"] = first
    out["phase_s"] = time.perf_counter() - t21
    return out


# ---------------------------------------------------------------------------
# phase 23: training granite-3-8b on the card
# ---------------------------------------------------------------------------

# (a) granite-3-8b at its published widths, 6 of its 40 repeats (1.598 B
# params: 25.6 GB of f32 params, grads and moments, 6.4 GB more for the
# microbatches' accumulator), f32 params and bf16 compute, loss_chunk 512
TRAIN_REPEATS = 6
TRAIN_B, TRAIN_S = 4, 4096
TRAIN_MICRO = 2
TRAIN_REMAT = "full"
TRAIN_KW = dict(learning_rate=3e-4, warmup_steps=2, total_steps=8)
TRAIN_WARM = 5            # warm steps after the cold one
TRAIN_SAVE_AFTER = 3      # (c): checkpoint after step 3, restart at 4
TRAIN_PROFILE_TOP = 12
BALLAST_TRAIN_GFLOPS = 100.0  # (d): 2980 products of 256^3 a microbatch
# (b) the same widths, 1 repeat in f32, 1 x 256 tokens, loss_chunk 128
TRAIN_CPU = dict(repeats=1, B=1, S=256, loss_chunk=128, steps=2)
TRAIN_LOSS_RTOL = 1e-5    # card against CPU, each step's loss
TRAIN_GRAD_TOL = 1e-4     # step 0's gradients, of each leaf's max |g|
# (e) two gloo workers on the card: 1 repeat in bf16, 2 x 512, 2 steps
TRAIN_DP = dict(repeats=1, B=2, S=512, steps=2)
TRAIN_DP_TIMEOUT_S = 300
# (f) the launchers as subprocesses, on the card
TRAIN_LAUNCHERS = (("train", ["repro_torch.launch.train", "--reduced",
                              "--steps", "4"]),
                   ("serve", ["repro_torch.launch.serve", "--reduced"]))


def train_cfg(repeats, **kw):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(GRANITE), n_repeats=repeats, **kw)


def kept_leaves(torch, tree):
    """Copies of a tree's leaves on their device (a state's 6.4 GB of
    params fit beside a step; two states do not)."""
    from repro_torch.core.optim import tree_leaves
    return [t.detach().clone() for t in tree_leaves(tree)]


def equal_leaves(torch, tree, kept):
    from repro_torch.core.optim import tree_leaves
    leaves = tree_leaves(tree)
    return len(leaves) == len(kept) and all(
        torch.equal(a, b) for a, b in zip(leaves, kept))


def train_timed_step(torch, step, state, batch):
    sync(torch)
    t0 = time.perf_counter()
    state, m = step(state, batch)
    sync(torch)
    return state, {k: v.item() for k, v in m.items()}, time.perf_counter() - t0


def ballast_products(torch, run):
    """``run()`` once under ``torch.profiler`` with shapes recorded: its
    output, and the ``aten::mm`` calls of two [256 x 256] operands (the
    ballast's products) with their device ms."""
    from torch.profiler import ProfilerActivity, profile
    sync(torch)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if DEVICE == "cuda" else [])
    with profile(activities=acts, record_shapes=True) as prof:
        out = run()
        sync(torch)
    mm = [e for e in prof.key_averages(group_by_input_shape=True)
          if e.key == "aten::mm"
          and [list(x) for x in e.input_shapes[:2]] == [[256, 256]] * 2]
    return out, (sum(e.count for e in mm),
                 sum(getattr(e, "device_time_total", 0.0) for e in mm) / 1e3)


def train_full(torch, out):
    """(a), (d) and (c) on one model: 1 cold and TRAIN_WARM warm steps of
    granite-3-8b (TRAIN_REPEATS repeats) with a checkpoint after step
    TRAIN_SAVE_AFTER; one more step profiled, again (bitwise), with the
    ballast (bitwise, timed) and with the ballast profiled (its products
    counted); then the checkpoint restored into a fresh state and its
    steps run again, bit for bit the uninterrupted run's."""
    import dataclasses
    import shutil
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core.ballast_inject import ballast_iters
    from repro_torch.core.optim import tree_map
    from repro_torch.data import SyntheticLM
    from repro_torch.train import init_train_state, make_train_step
    cfg = train_cfg(TRAIN_REPEATS)
    tcfg = TrainConfig(**TRAIN_KW, microbatches=TRAIN_MICRO,
                       remat=TRAIN_REMAT)
    n_params = cfg.param_count()
    tokens = TRAIN_B * TRAIN_S
    t_part = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    state, init_ms = timed_once(torch, lambda: init_train_state(
        0, cfg, tcfg, device=DEVICE))
    log(f"[train] {GRANITE} x {TRAIN_REPEATS} of "
        f"{get_config(GRANITE).n_repeats} repeats: {n_params} params "
        f"({cfg.param_dtype}, compute {cfg.compute_dtype}), state drawn on "
        f"the card in {init_ms:.0f} ms, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    step = make_train_step(cfg, tcfg)
    data = SyntheticLM(cfg, batch=TRAIN_B, seq=TRAIN_S, seed=0)
    work = os.path.join(HERE, "build", "phase23_ckpt")
    shutil.rmtree(work, ignore_errors=True)
    mgr = CheckpointManager(work, keep=1, async_save=True)
    losses, gnorms, walls = [], [], []
    for i in range(1 + TRAIN_WARM):
        state, m, wall = train_timed_step(torch, step, state, data(i))
        losses.append(m["loss"])
        gnorms.append(m["grad_norm"])
        walls.append(wall)
        log(f"[train] (a) step {i}: loss {m['loss']:.6f} grad norm "
            f"{m['grad_norm']:.4f} lr {m['lr']:.3g}, {wall:.3f} s")
        if i == TRAIN_SAVE_AFTER:
            t0 = time.perf_counter()
            mgr.save(i + 1, state)          # the host copy, then a thread
            out["ckpt_host_copy_s"] = time.perf_counter() - t0
    bad = [x for x in losses + gnorms if not math.isfinite(x)]
    if bad:
        raise AssertionError(f"[train] (a) non-finite loss or grad norm: "
                             f"{losses}, {gnorms}")
    warm = sorted(walls[1:])[len(walls[1:]) // 2]
    peak = torch.cuda.max_memory_allocated() / 2**30
    flops = 6 * n_params * tokens
    out["a"] = {"repeats": TRAIN_REPEATS, "params": n_params,
                "tokens": tokens, "microbatches": TRAIN_MICRO,
                "remat": TRAIN_REMAT, "losses": losses, "grad_norms": gnorms,
                "cold_s": walls[0], "warm_s": walls[1:],
                "step_wall_s": warm, "tokens_per_s": tokens / warm,
                "flop_share": flops / warm / PEAK_FLOPS["bfloat16"],
                "peak_gib": peak}
    log(f"[train] (a) cold step {walls[0]:.3f} s; warm steps "
        f"{[round(w, 3) for w in walls[1:]]} s, median {warm:.3f} s, "
        f"{tokens / warm:.0f} tokens/s, 6 N tokens / wall = "
        f"{flops / warm / 1e12:.1f} TFLOP/s = "
        f"{100 * flops / warm / PEAK_FLOPS['bfloat16']:.2f}% of 989 "
        f"TFLOP/s; peak {peak:.2f} GiB allocated")
    out["a_s"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    # (d) and the two-run check, from the state after the last step
    nxt = data(1 + TRAIN_WARM)
    final = kept_leaves(torch, state.params)
    got = []
    wall, busy, top = profile_device(
        torch, lambda: got.append(step(state, nxt)), TRAIN_PROFILE_TOP)
    (a, ma), = got
    ref = kept_leaves(torch, a.params)
    ma = {k: v.item() for k, v in ma.items()}
    del a, got
    out["a"]["profile"] = {"wall_s": wall, "busy_s": busy,
                           "busy_share": busy / wall,
                           "top": [[ms, cnt, key[:90]]
                                   for ms, cnt, key in top]}
    out["a"]["busy_of_warm_wall"] = busy / warm
    log(f"[train] (a) one profiled step: {wall:.3f} s, device busy "
        f"{busy:.3f} s ({100 * busy / wall:.1f}% of the traced wall, "
        f"{100 * busy / warm:.1f}% of the median warm step's)")
    for ms, cnt, key in top:
        log(f"  {ms:10.3f} ms {cnt:6d}x {key[:110]}")
    b, mb, wall_b = train_timed_step(torch, step, state, nxt)
    twice = mb == ma and equal_leaves(torch, b.params, ref)
    del b
    ballast_step = make_train_step(cfg, dataclasses.replace(
        tcfg, ballast=True, ballast_gflops=BALLAST_TRAIN_GFLOPS))
    c, mc, wall_c = train_timed_step(torch, ballast_step, state, nxt)
    same = mc == ma and equal_leaves(torch, c.params, ref)
    del c
    (c, _), (n_mm, mm_ms) = ballast_products(
        torch, lambda: ballast_step(state, nxt))
    same = same and equal_leaves(torch, c.params, ref)
    del c, ref
    want = TRAIN_MICRO * ballast_iters(BALLAST_TRAIN_GFLOPS)
    out["d"] = {"gflops": BALLAST_TRAIN_GFLOPS,
                "products_per_microbatch": ballast_iters(BALLAST_TRAIN_GFLOPS),
                "products_seen": n_mm, "products_device_ms": mm_ms,
                "step_s": wall_b, "ballast_step_s": wall_c,
                "two_runs_bitwise": twice, "ballast_bitwise": same}
    log(f"[train] (d) the step again {wall_b:.3f} s (bitwise the profiled "
        f"run's: {twice}); with {BALLAST_TRAIN_GFLOPS:g} GFLOPs of ballast "
        f"a microbatch {wall_c:.3f} s (loss and params bitwise: {same}); "
        f"the profiler saw {n_mm} products of [256 x 256] bf16 (want "
        f"{want}: {ballast_iters(BALLAST_TRAIN_GFLOPS)} a microbatch x "
        f"{TRAIN_MICRO}), {mm_ms:.2f} ms on the device")
    if not (twice and same) or n_mm != want or (
            DEVICE == "cuda" and not mm_ms > 0):
        raise AssertionError("[train] (d) a repeated or ballasted step "
                             "differs, or the ballast did not run")

    out["d_s"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    # (c) the restart: the checkpoint after step TRAIN_SAVE_AFTER restored
    # into a fresh state, its steps run again
    template = tree_map(lambda _: 0, state)
    del state
    t0 = time.perf_counter()
    mgr.wait()
    out["ckpt_write_wait_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, manifest = mgr.restore_latest(
        template, shardings=tree_map(lambda _: DEVICE, template))
    sync(torch)
    restore_s = time.perf_counter() - t0
    start = int(restored.step)
    again = []
    for i in range(start, 1 + TRAIN_WARM):
        restored, m, _ = train_timed_step(torch, step, restored, data(i))
        again.append(m["loss"])
    equal = (start == TRAIN_SAVE_AFTER + 1 == manifest["step"]
             and again == losses[start:]
             and equal_leaves(torch, restored.params, final))
    del restored, final
    shutil.rmtree(work, ignore_errors=True)
    out["c_s"] = time.perf_counter() - t_part
    out["c"] = {"restored_step": start, "restore_s": restore_s,
                "losses": again, "bitwise": equal}
    log(f"[train] (c) restored step {start} in {restore_s:.1f} s (the "
        f"write's wait {out['ckpt_write_wait_s']:.1f} s), steps "
        f"{start}-{TRAIN_WARM} again: losses and params bitwise the "
        f"uninterrupted run's: {equal}")
    if not equal:
        raise AssertionError("[train] (c) the restarted run differs")


def train_cpu_job(torch, path_out):
    """(b), in a worker process (``chip_smoke.py --train-cpu OUT``) started
    before phase 17, its CPU half held until phase 23 starts: the same
    widths with 1 repeat in f32, 1 x 256 tokens, on
    the card and on the CPU from one state (drawn on the card, copied), at
    the lowest CPU priority; writes step 0's gradient gaps (before
    clipping: step 0 is ``make_train_step``'s own gradient, clip and
    AdamW, taken apart to read the gradients), each step's relative loss
    gap and the seconds as JSON.  ``train_cpu_finish`` gates them."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core.optim import tree_leaves, tree_map
    from repro_torch.data import SyntheticLM
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train import trainer
    os.nice(19)
    torch.set_num_threads(6)
    t_job = time.perf_counter()
    k = TRAIN_CPU
    cfg = train_cfg(k["repeats"], compute_dtype="float32",
                    loss_chunk=k["loss_chunk"])
    tcfg = TrainConfig(**TRAIN_KW)
    data = SyntheticLM(cfg, batch=k["B"], seq=k["S"], seed=0)
    card = init_train_state(0, cfg, tcfg, device=DEVICE)
    cpu = tree_map(lambda t: t.to("cpu", copy=True), card)
    grad_fn = trainer.make_value_and_grad(cfg, tcfg)
    step = make_train_step(cfg, tcfg)

    def first(state, dev):
        batch = {n: torch.from_numpy(v).to(dev) for n, v in data(0).items()}
        (loss, _), grads = grad_fn(state.params, batch)
        return loss.item(), grads

    # the card's half first, its gradients kept on the host, so the card
    # is freed before the CPU's half
    (loss_card, g_card), card_ms = timed_once(torch, lambda: first(
        card, DEVICE))
    # _apply clips in place
    host = [g.to("cpu", copy=True) for g in tree_leaves(g_card)]
    card, _ = trainer._apply(card, g_card, tcfg,
                             trainer.lr_schedule(0, tcfg).to(DEVICE))
    g_card = host
    card_losses = [loss_card]
    for i in range(1, k["steps"]):
        card, mc = step(card, data(i))
        card_losses.append(mc["loss"].item())
    del card
    torch.cuda.empty_cache()
    # the card is free (train_cpu_wait_card); the CPU half waits for phase
    # 23 to start (train_cpu_go)
    open(path_out + ".card", "w").close()
    while not os.path.exists(path_out + ".go"):
        time.sleep(0.5)
    t0 = time.perf_counter()
    loss_cpu, g_cpu = first(cpu, "cpu")
    cpu_grad_s = time.perf_counter() - t0
    gaps = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(g_card, tree_leaves(g_cpu))]
    cpu, _ = trainer._apply(cpu, g_cpu, tcfg, trainer.lr_schedule(0, tcfg))
    del g_card, g_cpu
    cpu_losses = [loss_cpu]
    for i in range(1, k["steps"]):
        cpu, mp = step(cpu, data(i))
        cpu_losses.append(mp["loss"].item())
    rel = [abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses)]
    with open(path_out, "w") as fh:
        json.dump({"repeats": k["repeats"], "tokens": k["B"] * k["S"],
                   "grad_gaps": gaps, "grad_gap_max": max(gaps),
                   "grad_tol": TRAIN_GRAD_TOL, "loss_rel": rel,
                   "loss_rtol": TRAIN_LOSS_RTOL, "card_grad_ms": card_ms,
                   "cpu_grad_s": cpu_grad_s,
                   "cpu_s": time.perf_counter() - t0,
                   "job_s": time.perf_counter() - t_job}, fh)
    return 0


def train_cpu_start():
    """(b)'s worker (``train_cpu_job``), started before phase 17."""
    work = os.path.join(HERE, "build", "phase23_cpu")
    os.makedirs(work, exist_ok=True)
    stem = os.path.join(work, "b")
    for ext in (".json", ".json.card", ".json.go", ".log"):
        if os.path.exists(stem + ext):
            os.remove(stem + ext)
    logf = open(stem + ".log", "w")
    job = {"stem": stem, "log": logf, "t0": time.perf_counter(),
           "proc": subprocess.Popen(
               [sys.executable, os.path.abspath(__file__), "--train-cpu",
                stem + ".json"], cwd=HERE, stdout=logf,
               stderr=subprocess.STDOUT)}
    atexit.register(stop_worker, job)
    return job


def train_cpu_wait_card(job, timeout=TRAIN_DP_TIMEOUT_S):
    """Wait until (b)'s worker has run its card half and freed the card
    (its ``.card`` file), or has ended; returns the seconds waited."""
    t0 = time.perf_counter()
    while not os.path.exists(job["stem"] + ".json.card"):
        if job["proc"].poll() is not None:
            break  # failed or done: train_cpu_finish reports it
        if time.perf_counter() - t0 > timeout:
            raise AssertionError("[train] (b)'s worker did not free the card "
                                 f"within {timeout} s")
        time.sleep(0.2)
    return time.perf_counter() - t0


def train_cpu_go(job):
    """Let (b)'s worker start its CPU half."""
    open(job["stem"] + ".json.go", "w").close()


def stop_worker(job):
    """Stop one worker process (``job["proc"]``), whatever its state, and
    close its log."""
    if job["proc"].poll() is None:
        job["proc"].kill()
    job["proc"].wait()
    job["log"].close()


def train_cpu_finish(out, job, timeout=TRAIN_DP_TIMEOUT_S):
    """(b), gated: step 0's gradients within TRAIN_GRAD_TOL of each leaf's
    max |g|, each step's loss within TRAIN_LOSS_RTOL."""
    t0 = time.perf_counter()
    try:
        rc = job["proc"].wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"[train] (b)'s worker took more than "
                             f"{timeout} s") from None
    finally:
        stop_worker(job)
    if rc != 0:
        with open(job["stem"] + ".log") as f:
            raise AssertionError(f"[train] (b)'s worker exited {rc}: "
                                 + f.read()[-2000:])
    with open(job["stem"] + ".json") as fh:
        b = json.load(fh)
    b.update(waited_s=time.perf_counter() - t0,
             worker_wall_s=time.perf_counter() - job["t0"])
    out["b"] = b
    log(f"[train] (b) card against CPU, 1 repeat in f32, 1 x 256: step 0's "
        f"gradients within {b['grad_gap_max']:.3g} of each leaf's max |g| "
        f"(tol {TRAIN_GRAD_TOL}), {len(b['grad_gaps'])} leaves; losses "
        f"within {max(b['loss_rel']):.3g} relative (tol {TRAIN_LOSS_RTOL}); "
        f"card {b['card_grad_ms']:.0f} ms a gradient, CPU "
        f"{b['cpu_grad_s']:.1f} s ({b['cpu_s']:.1f} s with the steps), in "
        f"a worker beside (a), (d) and (c), its card half before phase 23 "
        f"({b['worker_wall_s']:.1f} s from its start, waited "
        f"{b['waited_s']:.1f} s for it)")
    if b["grad_gap_max"] > TRAIN_GRAD_TOL or max(b["loss_rel"]) > \
            TRAIN_LOSS_RTOL:
        raise AssertionError("[train] (b) the CPU disagrees with the card")


def train_dp_worker(torch, out_dir, t_launch):
    """One rank of (e): join the job (gloo, both ranks on the card), take
    TRAIN_DP's steps of the int8 data-parallel step, and save its params
    and residuals (``rank_<r>.pt``) and a report of its losses and
    seconds (``rank_<r>.json``)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core.optim import tree_leaves
    from repro_torch.data import SyntheticLM
    from repro_torch.parallel import distributed as D
    from repro_torch.train import init_train_state
    from repro_torch.train.trainer import make_dp_compressed_train_step
    rep = {"startup_s": time.time() - t_launch}
    if not D.initialize(device=DEVICE):
        raise SystemExit("train worker launched without REPRO_DIST_*")
    k = TRAIN_DP
    cfg = train_cfg(k["repeats"], param_dtype="bfloat16")
    tcfg = TrainConfig(**TRAIN_KW)
    state = init_train_state(0, cfg, tcfg, device=DEVICE)
    step, init_err = make_dp_compressed_train_step(cfg, tcfg)
    err = init_err(state.params)
    data = SyntheticLM(cfg, batch=k["B"], seq=k["S"], seed=0)
    losses = []
    rep["steps_s"] = []
    for i in range(k["steps"]):
        sync(torch)
        t0 = time.perf_counter()
        state, err, m = step(state, err, data(i))
        losses.append(m["loss"].item())
        rep["steps_s"].append(time.perf_counter() - t0)
    rank = D.process_index()
    t0 = time.perf_counter()
    torch.save({n: [t.cpu() for t in tree_leaves(tree)]
                for n, tree in (("params", state.params), ("err", err))},
               os.path.join(out_dir, f"rank_{rank}.pt"))
    rep.update(rank=rank, world=D.process_count(),
               backend=str(torch.distributed.get_backend()), losses=losses,
               save_s=time.perf_counter() - t0)
    with open(os.path.join(out_dir, f"rank_{rank}.json"), "w") as fh:
        json.dump(rep, fh)
    D.shutdown()
    return 0


def train_dp_emulate(torch):
    """(e)'s one-process emulation on the card: each rank's rows'
    gradients quantized with that rank's residual, the two dequantized
    payloads summed and halved (cast to the gradient's dtype, as the
    all-reduce's mean is), clipping and AdamW; the ranks' mean loss."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core.optim import tree_leaves, tree_unflatten
    from repro_torch.data import SyntheticLM
    from repro_torch.parallel import collectives as C
    from repro_torch.train import init_train_state
    from repro_torch.train import trainer
    k = TRAIN_DP
    cfg = train_cfg(k["repeats"], param_dtype="bfloat16")
    tcfg = TrainConfig(**TRAIN_KW)
    state = init_train_state(0, cfg, tcfg, device=DEVICE)
    grad_fn = trainer.make_value_and_grad(cfg, tcfg)
    data = SyntheticLM(cfg, batch=k["B"], seq=k["S"], seed=0)
    world, per = 2, k["B"] // 2
    errs = [[torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in tree_leaves(state.params)] for _ in range(world)]
    losses = []
    for i in range(k["steps"]):
        lr = trainer.lr_schedule(state.step, tcfg).to(DEVICE)
        batch = {n: torch.from_numpy(v).to(DEVICE)
                 for n, v in data(i).items()}
        deq, loss_sum = [], 0.0
        for r in range(world):
            (loss, _), g = grad_fn(state.params, {
                n: v[r * per:(r + 1) * per] for n, v in batch.items()})
            loss_sum = loss_sum + loss
            mine = []
            for j, x in enumerate(tree_leaves(g)):
                flat = C._flat_padded(x.float() + errs[r][j])
                q, s = C._quantize_int8(flat)
                d = C._dequantize_int8(q, s)
                errs[r][j] = (flat - d)[:x.numel()].reshape(
                    x.shape).to(x.dtype).float()
                mine.append(d)
            deq.append(mine)
        mean = [((deq[0][j] + deq[1][j]) / 2.0)[:p.numel()].reshape(
            p.shape).to(p.dtype)
            for j, p in enumerate(tree_leaves(state.params))]
        state, _ = trainer._apply(state, tree_unflatten(state.params, mean),
                                  tcfg, lr)
        losses.append((loss_sum / world).item())
    return state, errs, losses


def train_dp_start(torch):
    """(e): two gloo workers on the card (as phase 21's) take TRAIN_DP's
    steps, launched from a thread; returns what ``train_dp_finish`` waits
    for."""
    import shutil
    import threading
    from repro_torch.parallel import distributed
    work = os.path.join(HERE, "build", "phase23_dp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    job = {"work": work, "t0": time.perf_counter()}

    def run():
        try:
            distributed.launch_workers(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--train-dp-worker", work, repr(time.time())],
                num_processes=2, timeout=TRAIN_DP_TIMEOUT_S)
        except BaseException as e:  # raised again by train_dp_finish
            job["error"] = e
        job["launch_s"] = time.perf_counter() - job["t0"]

    job["thread"] = threading.Thread(target=run, daemon=True)
    job["thread"].start()
    return job


def train_dp_finish(torch, out, job):
    """(e), once its workers ended (the emulation needs the card's memory
    they held): both ranks' params are equal bit for bit, and equal to
    the one-process emulation's; each rank's residual is the emulation's
    for its rows."""
    import shutil
    from repro_torch.core.optim import tree_leaves
    job["thread"].join()
    if "error" in job:
        raise job["error"]
    t0 = time.perf_counter()
    reps, saved = [], []
    for r in range(2):
        with open(os.path.join(job["work"], f"rank_{r}.json")) as fh:
            reps.append(json.load(fh))
        saved.append(torch.load(os.path.join(job["work"], f"rank_{r}.pt"),
                                weights_only=True))
    shutil.rmtree(job["work"], ignore_errors=True)
    state, errs, losses = train_dp_emulate(torch)

    def same(a, b):
        return len(a) == len(b) and all(torch.equal(x, y.cpu())
                                        for x, y in zip(a, b))

    ranks_equal = same(saved[0]["params"], saved[1]["params"])
    emulated = same(saved[0]["params"], tree_leaves(state.params)) and all(
        same(saved[r]["err"], errs[r]) for r in range(2))
    del state, errs, saved
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(reps[0]["losses"],
                                                      losses))
    out["e"] = {"world": [r["world"] for r in reps],
                "backend": reps[0]["backend"], "launch_s": job["launch_s"],
                "workers": [{k: r[k] for k in ("startup_s", "steps_s",
                                               "save_s")} for r in reps],
                "check_s": time.perf_counter() - t0,
                "losses": reps[0]["losses"], "ranks_bitwise": ranks_equal,
                "emulation_bitwise": emulated, "loss_rel_gap": loss_gap}
    log(f"[train] (e) two gloo workers on the card ({reps[0]['backend']}), "
        f"{TRAIN_DP['steps']} steps of 1 repeat in bf16 on "
        f"{TRAIN_DP['B']} x {TRAIN_DP['S']}: ranks' params bitwise "
        f"{ranks_equal}, equal to the one-process emulation (params and "
        f"each rank's residual) {emulated}, losses {reps[0]['losses']} "
        f"(emulation within {loss_gap:.3g}); the workers "
        f"{job['launch_s']:.1f} s (" + json.dumps(
            out["e"]["workers"]) + f"), the check {out['e']['check_s']:.1f}"
        " s")
    if not (ranks_equal and emulated and loss_gap <= 1e-6
            and reps[0]["losses"] == reps[1]["losses"]):
        raise AssertionError("[train] (e) the data-parallel step differs "
                             "between ranks or from its emulation")


def launchers_start():
    """(f): the train and serve launchers as subprocesses on the card
    (their default device)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    dev = [] if DEVICE == "cuda" else ["--device", DEVICE]
    return [(tag, subprocess.Popen(
        [sys.executable, "-m", *argv, *dev], cwd=HERE, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for tag, argv in TRAIN_LAUNCHERS]


def launchers_stop(procs):
    for _, p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def launchers_finish(procs, out, timeout=300):
    res = {}
    try:
        for tag, p in procs:
            so, se = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise AssertionError(f"[train] (f) launcher {tag} exited "
                                     f"{p.returncode}:\n{se[-2000:]}")
            res[tag] = [ln for ln in so.splitlines()
                        if ln.startswith(("done:", "generated"))]
    finally:
        launchers_stop(procs)
    out["f"] = res
    log("[train] (f) launchers: " + json.dumps(res))


def train_phase(torch, build, b_job):
    """Phase 23: training granite-3-8b at its published widths on the
    card: (a) full width, depth cut, with (d) the ballast and (c) the
    restart on the same model; (b) card against CPU, in ``b_job``'s worker
    (started before phase 17: its card half ends before (a), its CPU half
    runs beside (a), (d) and (c)); (e) the int8 data-parallel step on two
    gloo workers; (f) the launchers as subprocesses, started first.  No
    kernel of A-K or A' launches (none in (b)'s worker either: it is a
    process of its own, so its launches are not counted here; its path,
    ``loss_fn`` on a dense model, has no kernel)."""
    t0 = time.perf_counter()
    out = {}
    procs = launchers_start()
    try:
        # (b)'s worker, started before phase 17: its card part (about 10 GB)
        # must have ended before (a) takes the card; its CPU part runs
        # beside (a), (d) and (c)
        out["b_card_wait_s"] = train_cpu_wait_card(b_job)
        train_cpu_go(b_job)
        build.reset_launch_counts()
        train_full(torch, out)
        # (e)'s workers need the memory this process's cache holds
        torch.cuda.empty_cache()
        job = train_dp_start(torch)
        job["thread"].join()
        torch.cuda.empty_cache()
        train_dp_finish(torch, out, job)
        t = time.perf_counter()
        train_cpu_finish(out, b_job)
        out["b_s"] = time.perf_counter() - t
        counts = build.launch_counts()
    except BaseException:
        launchers_stop(procs)
        raise
    launchers_finish(procs, out)
    torch.cuda.empty_cache()
    if any(counts.values()):
        raise AssertionError(f"[train] a kernel launched on the training "
                             f"path: {counts}")
    out["launches"] = counts
    out["phase_s"] = time.perf_counter() - t0
    parts = {k: round(out[k], 1) for k in ("b_card_wait_s", "a_s", "d_s",
                                            "c_s", "b_s")}
    log(f"[train] no kernel of A-K or A' launched; phase 23: "
        f"{out['phase_s']:.1f} s (" + json.dumps(parts) + ", (e)'s "
        f"workers {out['e']['launch_s']:.1f} s from their start, its "
        f"emulation and check {out['e']['check_s']:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# phase 15: kernels G, H and I through the reference's own entry points
# ---------------------------------------------------------------------------

# the reference's own error on phase 15's traces: max |bin_power - the
# float64 recurrence| over the amplitude scale, JAX on the CPU, printed by
# `python tests/test_torch_bin_power.py` (whose test holds these digits to
# it); only a limit here: the port may be at most twice it
BIN_POWER_REF_ERR = {"600s": 3.161e-05, "600s_tail": 3.155e-05,
                     "ramp48": 7.724e-06}
BALLAST_GFLOPS = 140.0    # n_iter 1043 at the defaults m 1024, k = n 256
BALLAST_RTOL = 1e-5       # kernel G vs its plain version, of max |plain|
BALLAST_CHECK_ITERS = 32  # the dense-b and bf16 cases
GOERTZEL_OPS = 3          # f32 operations per sample and bin, kernel H
DAY_TILES = 144           # "day": the 600 s trace 144 times, 24 h at 1 kHz
LATE_KERNELS = ("ballast", "windows", "sliding_v1")


def ptxas_lines(kernel):
    return [ln.strip() for ln in kernel.ptxas_log.splitlines()
            if "registers" in ln or "spill" in ln]


def ptxas_summary(kernel):
    """Per function of ``kernel``'s library, from ``ptxas -v``: registers,
    static shared memory and spill bytes, as {mangled name: {...}}."""
    import re
    out, name = {}, None
    for ln in kernel.ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {"registers": None, "smem_static": 0,
                         "spill_stores": 0, "spill_loads": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            out[name]["smem_static"] = int(sm.group(1)) if sm else 0
    return out


def sass_counts(kernel, opcodes):
    """How many of each SASS opcode the kernel's library holds, from
    ``cuobjdump -sass`` (the CUDA toolkit's; None where it is missing)."""
    import shutil
    from repro_torch.kernels.build import nvcc_path
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(kernel.library_path())],
                         capture_output=True, text=True, timeout=300).stdout
    return sass_opcode_counts(out, opcodes)


def sass_opcode_counts(sass, opcodes):
    """Count each opcode's instructions in ``cuobjdump -sass`` text (the
    opcode without its modifiers, after an optional predicate)."""
    import re
    ops = re.findall(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     sass)
    return {op: sum(o == op for o in ops) for op in opcodes}


def bin_power_oracle_err(x, dt, win, got):
    """``bin_power``'s output ``got`` on trace ``x`` against the float64
    recurrence: max |got - oracle| over the amplitude scale (max |centred
    window|), and the windows' sample counts."""
    import numpy as np
    from repro_torch.core.spectrum import GRID_CRITICAL_HZ
    from repro_torch.kernels.goertzel import ops
    from repro_torch.kernels.goertzel.ref import (bin_power_recurrence_ref,
                                                  centred_windows)
    wnd, counts = centred_windows(x, win)
    oracle = bin_power_recurrence_ref(
        x, ops.goertzel_coef(GRID_CRITICAL_HZ, dt).numpy(), win)
    return (float(np.abs(got.cpu().numpy() - oracle).max()
                  / np.abs(wnd).max()), counts)


def check_bin_power_out(name, got, counts, K, oracle_err, ref_err):
    if oracle_err > 2.0 * ref_err:
        raise AssertionError(f"bin_power on {name} is more than twice the "
                             "reference's error from the float64 oracle")
    if got.shape != (len(counts), K) or not got.isfinite().all():
        raise AssertionError(f"bin_power on {name}: {tuple(got.shape)}")


def bin_power_case(torch, name, x, dt, win, got, call):
    """Kernel H at one trace: the launch of the path run against the plain
    version on the same windows, bit for bit (the same steps in the same
    order), and ``bin_power`` against the float64 recurrence, no worse than
    twice the reference's own error."""
    from repro_torch.kernels.goertzel import windows
    wnd_t, coef, block_w, raw = call
    plain = windows.goertzel_windows_plain(wnd_t, coef, block_w=block_w)
    scale = wnd_t.abs().max().item()
    err_w = (raw - plain).abs().max().item()
    bitwise = torch.equal(raw, plain)
    oracle_err, counts = bin_power_oracle_err(x, dt, win, got)
    ref_err = BIN_POWER_REF_ERR[name]
    K = coef.shape[0]
    log(f"bin_power {name} [n {len(x)}, win {win}, W {len(counts)}, tail "
        f"{int(counts[-1])}, K {K}], route {windows_geometry(*wnd_t.shape, K)}"
        f": kernel vs plain bitwise {bitwise} (the gate; max |diff| "
        f"{err_w:.4g} W, scale {scale:.6g} W); vs the float64 recurrence "
        f"{oracle_err:.4g} of the scale (the reference's {ref_err:.4g}, "
        f"limit {2 * ref_err:.4g})")
    if not bitwise:
        raise AssertionError(f"kernel H disagrees with its plain version on "
                             f"{name}")
    check_bin_power_out(name, got, counts, K, oracle_err, ref_err)
    return {"trace": name, "n": len(x), "win": win, "shape":
            list(wnd_t.shape) + [K], "max_abs_err": err_w,
            "bitwise": bitwise, "oracle_err": oracle_err}


def day_case(torch, traces, amps, calls):
    """Kernel H at "day", with no plain run at its 21 600 windows: the
    600 s call's windows tiled through the kernel equal that call's
    output tiled (``torch.equal``: the route at "day" against the route
    at 600 s on the same windows), and ``bin_power(day)`` no worse than
    twice the 600 s trace's reference error from the float64 recurrence
    (its windows are the 600 s trace's)."""
    x, dt, win = traces["day"]
    got_k, want = day_tiled(calls[0], traces["600s"], traces["day"])
    equal = torch.equal(got_k, want)
    oracle_err, counts = bin_power_oracle_err(x, dt, win, amps["day"])
    ref_err = BIN_POWER_REF_ERR["600s"]
    wnd_t, coef, _, _ = calls[-1]
    K = coef.shape[0]
    W0 = len(traces["600s"][0]) // win
    same_windows = torch.equal(
        wnd_t, calls[0][0][:W0].repeat(len(counts) // W0, 1))
    log(f"bin_power day [n {len(x)}, win {win}, W {len(counts)}, K {K}], "
        f"route {windows_geometry(*wnd_t.shape, K)}: the 600 s windows tiled"
        f" through the kernel vs the 600 s output tiled, bitwise {equal} "
        f"(bin_power's day windows equal the 600 s windows tiled: "
        f"{same_windows}); vs the float64 recurrence {oracle_err:.4g} of the "
        f"scale (limit {2 * ref_err:.4g}, twice the reference's on 600 s)")
    if not equal:
        raise AssertionError("kernel H on the 600 s windows tiled differs "
                             "from the 600 s output tiled")
    check_bin_power_out("day", amps["day"], counts, K, oracle_err, ref_err)
    return {"trace": "day", "n": len(x), "win": win,
            "shape": list(wnd_t.shape) + [K],
            "max_abs_err": (got_k - want).abs().max().item(),
            "tiled_bitwise": equal, "windows_equal_tiled": same_windows,
            "oracle_err": oracle_err}


def goertzel_row(torch, cases, call, dt, path_launches):
    """Kernel H's row: the 600 s trace's call timed beside its plain
    version, its bound and one matmul with a cos/sin table."""
    import numpy as np
    from repro_torch.core.spectrum import GRID_CRITICAL_HZ
    from repro_torch.kernels.goertzel import windows
    wnd_t, coef, block_w, raw = call
    W, win = wnd_t.shape
    K = coef.shape[0]
    ms = cuda_ms(torch, lambda: windows.goertzel_windows(
        wnd_t, coef, block_w=block_w), 20)
    _, plain_ms = timed_once(torch, lambda: windows.goertzel_windows_plain(
        wnd_t, coef, block_w=block_w))
    ang = (2 * np.pi * dt * np.arange(win)[:, None]
           * np.asarray(GRID_CRITICAL_HZ)[None, :])
    table = torch.as_tensor(np.concatenate([np.cos(ang), np.sin(ang)], 1),
                            dtype=torch.float32, device=wnd_t.device)

    def library():
        m = torch.matmul(wnd_t, table)
        return (2.0 / win) * torch.sqrt(m[:, :K] ** 2 + m[:, K:] ** 2)
    library_ms = cuda_ms(torch, library, 20)
    b_ms, b_by = bound(nbytes(wnd_t, coef, raw), GOERTZEL_OPS * W * win * K)
    return {"name": "goertzel_windows", "route": "cuda",
            "source": "src/repro_torch/kernels/goertzel/csrc/windows.cu",
            "replaces": "src/repro/kernels/goertzel/goertzel.py:87",
            "launches": path_launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tolerance": "bitwise (torch.equal) vs plain at the three "
                         "traces; at day the 600 s windows tiled equal the "
                         "600 s output tiled; vs the float64 recurrence at "
                         "most 2 x the "
                         "reference's CPU error (" + ", ".join(
                             f"{k} {2 * v:.4g}" for k, v in
                             BIN_POWER_REF_ERR.items()) + " of the scale, "
                         "from tests/test_torch_bin_power.py; day as 600s)",
            "shape": [W, win, K], "kernel_route":
            windows.windows_route(W, win, K).route,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "library_note": "torch.matmul of the windows with a [win, 2K] "
                            "cos/sin table, then the magnitude",
            "cases": cases,
            "ptxas": ptxas_lines(windows.WINDOWS_KERNEL)}


def sliding_v1_row(torch, xseg, tabs, got, x, dt, path_launches):
    """Kernel I against its plain version, kernel E on the same segments
    (after the warm-up scale) and the float64 oracle, with its times."""
    import numpy as np
    from repro_torch.core.spectrum import GRID_CRITICAL_HZ
    from repro_torch.core.telemetry import warmup_scale
    from repro_torch.kernels.goertzel import ops, sliding, sliding_v1
    from repro_torch.kernels.goertzel.ref import sliding_bin_power_ref
    S, win = xseg.shape
    K = tabs[0].shape[1]
    n = len(x)
    plain, plain_ms = timed_once(
        torch, lambda: sliding_v1.sliding_goertzel_v1_plain(xseg, *tabs))
    scale = xseg.abs().max().item()
    err_w = (got - plain).abs().max().item()
    cosp, sinp, rot = ops.device_tables(GRID_CRITICAL_HZ, dt, win, DEVICE)
    zeros = torch.zeros((1, K, win), device=DEVICE)
    e, _, _ = sliding.sliding_bin_power_v2(
        xseg[None], cosp, sinp, rot,
        torch.zeros(1, dtype=torch.int64, device=DEVICE), zeros, zeros)
    scaled = got * warmup_scale(torch.arange(S * win, device=DEVICE),
                                win).reshape(S, win, 1)
    e_err = (scaled - e[0]).abs().max().item()
    e_equal = torch.equal(scaled, e[0])
    amps = scaled.reshape(-1, K)[:n].double().cpu().numpy()
    oracle_err = float(np.abs(amps - sliding_bin_power_ref(
        x, dt, GRID_CRITICAL_HZ, win)).max()) / scale
    log(f"sliding_v1 [{S} x {win}, K={K}]: vs plain {err_w:.4g} W "
        f"({err_w / scale:.3g} of the scale, tol {MONITOR_TOL}); warm-up "
        f"scaled vs kernel E {e_err / scale:.3g} of the scale (bitwise "
        f"{e_equal}, the gate); vs float64 oracle {oracle_err:.3g} (tol "
        f"{ORACLE_TOL})")
    # I is E's kernel body with a scale of exactly 1, so I times the warm-up
    # scale (one f32 product, as E's last step) equals E bit for bit
    if err_w > MONITOR_TOL * scale or not e_equal or oracle_err > ORACLE_TOL:
        raise AssertionError("kernel I disagrees with its plain version, "
                             "kernel E or the float64 oracle")
    ms = cuda_ms(torch, lambda: sliding_v1.sliding_goertzel_v1(xseg, *tabs),
                 20)
    b_ms, b_by = bound(nbytes(xseg, *tabs, got), SLIDING_OPS * S * win * K)
    return {"name": "sliding_goertzel_v1", "route": "cuda",
            "source": "src/repro_torch/kernels/goertzel/csrc/sliding_v1.cu",
            "replaces": "src/repro/kernels/goertzel/goertzel.py:137",
            "launches": path_launches, "max_abs_err": err_w,
            "tolerance": f"{MONITOR_TOL} x amplitude scale",
            "err_of_scale": err_w / scale, "kernel_e_err": e_err / scale,
            "kernel_e_bitwise": e_equal,
            "oracle_err": oracle_err, "shape": [S, win, K], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "library_note": "no single PyTorch call computes every sample's "
                            "sliding windowed DFT bins",
            "ptxas": ptxas_lines(sliding_v1.SLIDING_V1_KERNEL)}


def ballast_case(torch, a, b, n_iter, tag):
    """Kernel G against its plain version (and, in f32, a float64 chain) on
    one (a, b, n_iter): the relative errors of max |plain|, its route, ms
    and TFLOP/s."""
    from repro_torch.kernels.ballast import ballast, ops
    from repro_torch.kernels.ballast.ref import ballast_ref
    got = ballast.ballast(a, b, n_iter)
    plain = ballast.ballast_plain(a, b, n_iter)
    scale = plain.abs().max().item()
    rel = (got - plain).abs().max().item() / scale
    ms = cuda_ms(torch, lambda: ballast.ballast(a, b, n_iter), 3)
    M, N = a.shape[0], b.shape[1]
    row = {"case": tag, "shape": list(a.shape) + [N],
           "dtype": "/".join(str(t.dtype).split(".")[-1] for t in (a, b)),
           "n_iter": n_iter, "route": ballast.ballast_route(N),
           "max_abs_err": (got - plain).abs().max().item(), "rel_err": rel,
           "bitwise": torch.equal(got, plain), "ms": ms,
           "tflops": ops.ballast_flops(M, a.shape[1], N, n_iter) / ms * 1e-9}
    if a.dtype == torch.float32:
        f64 = ballast_ref(a, b, n_iter, dtype=torch.float64)
        row["f64_rel_err"] = (got.double() - f64).abs().max().item() / scale
        row["plain_f64_rel_err"] = ((plain.double() - f64).abs().max().item()
                                    / scale)
    log(f"ballast {tag} {row['shape']} {row['dtype']} x{n_iter} (route "
        f"{row['route']}): vs plain {rel:.3g} of max |plain| (tol "
        f"{BALLAST_RTOL}, bitwise {row['bitwise']}); {ms:.4g} ms, "
        f"{row['tflops']:.2f} TFLOP/s"
        + (f"; vs float64 chain {row['f64_rel_err']:.3g} (plain "
           f"{row['plain_f64_rel_err']:.3g})" if "f64_rel_err" in row else ""))
    if rel > BALLAST_RTOL or not torch.isfinite(got).all():
        raise AssertionError(f"kernel G disagrees with its plain version "
                             f"({tag})")
    return row, got, plain


# one shape a route beside the burn's N = 256 (route "cluster"): [M x N]
# by [N x N], b = 0.999 Q
BALLAST_ROUTE_SHAPES = ((1024, 128), (512, 384))


def dense_multiplier(torch, N, seed):
    """0.999 Q for a random orthogonal Q [N x N] (numpy, seeded), f32 on the
    card."""
    import numpy as np
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((N, N)))
    return torch.as_tensor(0.999 * q, dtype=torch.float32, device=DEVICE)


def ballast_geometry(torch):
    """Kernel G's routes as built: for each cluster geometry (N, c) its
    dynamic shared memory a block and how many clusters the card holds
    at once; and each function's registers from ``ptxas``."""
    import ctypes
    from repro_torch.kernels.ballast import ballast
    lib = ctypes.CDLL(str(ballast.BALLAST_KERNEL.library_path()))
    lib.ballast_cluster_smem.restype = ctypes.c_longlong
    lib.ballast_cluster_occupancy.restype = ctypes.c_int
    geo = {f"N={n}, c={c}": {"smem_bytes": lib.ballast_cluster_smem(n, c),
                             "active_clusters":
                                 lib.ballast_cluster_occupancy(n, c)}
           for n, c in sorted(ballast.CLUSTER_SIZE.items())}
    regs = {name: v["registers"] for name, v in
            ptxas_summary(ballast.BALLAST_KERNEL).items()}
    return {"cluster": geo, "registers": regs}


def ballast_row(torch, gen_seed, checksum, path_launches):
    """Kernel G: the burn's a and b drawn again from its seed, the dense and
    bf16 cases, one shape a route, the burn on the streaming route against
    the cluster route, and its times against the bound and a matmul
    chain."""
    import numpy as np
    from repro_torch.kernels.ballast import ballast, ops
    from repro_torch.kernels.ballast.ref import ballast_ref
    m, k, n = BALLAST_SHAPE
    n_iter = max(int(BALLAST_GFLOPS * 1e9 / (2.0 * m * k * n)), 1)
    a, b = ops._tiles(torch.Generator(device=DEVICE).manual_seed(gen_seed),
                      m, k, n, torch.float32, DEVICE)
    burn, out, plain = ballast_case(torch, a, b, n_iter, "burn b = 0.999 I")
    plain_sum = (torch.sum(plain) * 1e-9).item()
    if (checksum != (torch.sum(out) * 1e-9).item()
            or abs(checksum - plain_sum)
            > BALLAST_RTOL * out.abs().sum().item() * 1e-9):
        raise AssertionError("ballast_burn's checksum is not its kernel's, "
                             "or disagrees with the plain version's")
    dense = dense_multiplier(torch, k, 15)
    cases = [burn,
             ballast_case(torch, a, dense, BALLAST_CHECK_ITERS,
                          "b = 0.999 Q")[0],
             ballast_case(torch, a.bfloat16(), b.bfloat16(),
                          BALLAST_CHECK_ITERS, "bf16 b = 0.999 I")[0],
             ballast_case(torch, a.bfloat16(), dense.bfloat16(),
                          BALLAST_CHECK_ITERS, "bf16 b = 0.999 Q")[0],
             ballast_case(torch, a, dense.bfloat16(), BALLAST_CHECK_ITERS,
                          "f32 a, bf16 b = 0.999 Q")[0]]
    rng = np.random.default_rng(16)
    for M, N in BALLAST_ROUTE_SHAPES:
        a_n = torch.as_tensor((rng.standard_normal((M, N)) / np.sqrt(N))
                              .astype(np.float32), device=DEVICE)
        cases.append(ballast_case(torch, a_n, dense_multiplier(torch, N, N),
                                  BALLAST_CHECK_ITERS,
                                  f"route {ballast.ballast_route(N)}, "
                                  f"b = 0.999 Q")[0])
    routes = {c["route"] for c in cases}
    if routes != {"cluster", "stream"}:
        raise AssertionError(f"kernel G's cases ran the routes {routes}")
    # the burn on the streaming route, against the cluster route's output
    stream = ballast.launch_route(a, b, n_iter, 0.999, "stream")
    stream_rel = (stream - plain).abs().max().item() / plain.abs().max().item()
    stream_equal = torch.equal(stream, out)
    log(f"ballast burn on route stream: vs plain {stream_rel:.3g} of max "
        f"|plain| (tol {BALLAST_RTOL}); bitwise equal to route cluster "
        f"{stream_equal}")
    if stream_rel > BALLAST_RTOL:
        raise AssertionError("kernel G's streaming route disagrees with its "
                             "plain version on the burn")
    timing = {"cluster": ballast_timing(torch, a, b, n_iter),
              "stream": ballast_timing(torch, a, b, n_iter, "stream")}
    ms = cuda_ms(torch, lambda: ballast.ballast(a, b, n_iter), 3)
    _, plain_ms = timed_once(torch, lambda: ballast.ballast_plain(a, b,
                                                                  n_iter))
    library_ms = cuda_ms(torch, lambda: ballast_ref(a, b, n_iter), 3)
    flops = ops.ballast_flops(m, k, n, n_iter)
    b_ms, b_by = bound(nbytes(a, b, out), flops)
    geometry = ballast_geometry(torch)
    log(f"ballast_burn(gflops={BALLAST_GFLOPS:g}): n_iter {n_iter}, "
        f"{flops:.6g} FLOPs, checksum {checksum:.9g} (plain {plain_sum:.9g});"
        f" kernel {ms:.4g} ms = {flops / ms * 1e-9:.2f} TFLOP/s (device "
        f"{timing['cluster']['device_ms']} ms; route stream "
        f"{timing['stream']['device_ms']} ms), bound {b_ms:.4g} ms by "
        f"{b_by}; geometry " + json.dumps(geometry))
    for t in timing.values():
        log(f"ballast burn, route {t['route']}: {t['event_ms']:.4g} ms by "
            f"CUDA events, {t['device_ms']} ms on the device, "
            f"{t['tflops']:.2f} TFLOP/s")
    return {"name": "ballast", "route": "cuda",
            "source": "src/repro_torch/kernels/ballast/csrc/ballast.cu",
            "replaces": "src/repro/kernels/ballast/ballast.py:33",
            "launches": path_launches, "max_abs_err": burn["max_abs_err"],
            "tolerance": f"rel {BALLAST_RTOL} of max |plain|",
            "shape": [m, k, n], "n_iter": n_iter, "flops": flops,
            "checksum": checksum, "tflops": flops / ms * 1e-9, "ms": ms,
            "device_ms": timing["cluster"]["device_ms"],
            "kernel_route": burn["route"], "routes": timing,
            "stream_route_on_burn": {"rel_err": stream_rel,
                                     "bitwise_vs_cluster": stream_equal},
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms,
            "library_note": "the n_iter-step loop of torch.matmul (TF32 off)"
                            " and the decay on the same a, b",
            "cases": cases, "geometry": geometry,
            "ptxas": ptxas_lines(ballast.BALLAST_KERNEL)}


def day_trace(w_long, tiles=DAY_TILES):
    """"day": 24 h of 1 kHz rack telemetry, the 600 s trace tiled
    ``tiles`` times; its length is a multiple of the window (4000), so
    every window of it is a window of the 600 s trace."""
    import numpy as np
    if len(w_long) % 4000:
        raise ValueError(f"day: {len(w_long)} samples are not whole windows")
    return np.tile(np.asarray(w_long), tiles)


def phase15_traces(w, dt, w_long, dt_long):
    """``bin_power``'s four traces in phase 15: (trace, dt, win) by name."""
    return {"600s": (w_long, dt_long, 4000),
            "600s_tail": (w_long[:598765], dt_long, 4000),
            "ramp48": (w, dt, 2000),
            "day": (day_trace(w_long), dt_long, 4000)}


def bin_power_calls(traces):
    """``bin_power`` on each of ``traces``, with kernel H's calls kept:
    (amplitudes by trace, ``(windows, coef, block_w, raw)`` per call)."""
    from repro_torch.core.spectrum import GRID_CRITICAL_HZ
    from repro_torch.kernels.goertzel import ops
    calls = []
    real = ops.goertzel_windows

    def spy(windows, coef, *, block_w):
        raw = real(windows, coef, block_w=block_w)
        calls.append((windows, coef, block_w, raw))
        return raw
    ops.goertzel_windows = spy
    try:
        amps = {name: ops.bin_power(x, d, GRID_CRITICAL_HZ, win=win)
                for name, (x, d, win) in traces.items()}
    finally:
        ops.goertzel_windows = real
    return amps, calls


def v1_operands(torch, w, dt, win=4000):
    """Kernel I's operands in phase 15: the float64-centred trace's
    ``[S, win]`` segments and the grid-critical bins' v1 tables."""
    from repro_torch.core.spectrum import GRID_CRITICAL_HZ
    from repro_torch.kernels.goertzel import ops
    x = torch.as_tensor(w, device=DEVICE)
    xseg = ops.segments(ops.centre(x[None]), win)[0]
    tabs = tuple(torch.as_tensor(t, device=DEVICE) for t in
                 ops.phase_tables_v1(GRID_CRITICAL_HZ, dt, win))
    return xseg, tabs


def entry_point_phase(torch, build, w, dt, w_long, dt_long):
    """Phase 15: ``bin_power`` (kernel H) on four traces, the v1 sliding
    layout (kernel I) on the 600 s trace's segments and ``ballast_burn``
    (kernel G), each once on the card with launch counts from 0; then
    each kernel against its plain version and its oracles, and timed.
    Returns the three rows of the kernels line and the path's counts."""
    from repro_torch.kernels.ballast import ops as bops
    from repro_torch.kernels.goertzel import sliding_v1
    traces = phase15_traces(w, dt, w_long, dt_long)
    xseg, tabs = v1_operands(torch, w_long, dt_long)
    seed = 15
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    amps, calls = bin_power_calls(traces)
    v1 = sliding_v1.sliding_goertzel_v1(xseg, *tabs)
    checksum = bops.ballast_burn(
        torch.Generator(device=DEVICE).manual_seed(seed),
        gflops=BALLAST_GFLOPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    log(f"[entry points] {len(traces)} bin_power calls, the v1 layout and a "
        f"{BALLAST_GFLOPS:g}-GFLOP burn: {wall:.3f} s; launches "
        + json.dumps(counts))
    want = {"windows": 4, "sliding_v1": 1, "ballast": 1}
    if any(counts[k] != want.get(k, 0) for k in counts):
        raise AssertionError(f"the entry points launched {counts}, not "
                             f"{want}")
    cases = [bin_power_case(torch, name, x, d, win, amps[name], call)
             for (name, (x, d, win)), call in zip(traces.items(), calls)
             if name != "day"]
    cases.append(day_case(torch, traces, amps, calls))
    rows = [ballast_row(torch, seed, checksum.item(), counts["ballast"]),
            goertzel_row(torch, cases, calls[0], dt_long, counts["windows"]),
            sliding_v1_row(torch, xseg, tabs, v1, w_long, dt_long,
                           counts["sliding_v1"])]
    return rows, counts


# ---------------------------------------------------------------------------

def loop_summary(clog):
    """A control run's dispatch latencies (p50 and max, ms) and detection
    lead (s)."""
    lats = clog.dispatch_latencies()
    return {"dispatches": len(lats),
            "dispatch_p50_ms": pctl(lats, 50) * 1e3 if lats else None,
            "dispatch_max_ms": max(lats) * 1e3 if lats else None,
            "detection_lead_s": clog.summary()["detection_lead_s"]}


def ad_design_calls(torch, api):
    """J's and K's first calls of the tight design at phase 5's first
    fleet on phase 18's trace (one Adam step, stopped at K's forward): the
    same inputs in any tree whose J precedes them."""
    import numpy as np
    from repro_torch.core.smoothing import battery, gpu_floor
    from repro_torch.core.waveform import job_waveform

    class Stop(Exception):
        pass

    study = build_study(api, workloads=[DESIGN_WORKLOAD])
    n_chips = study.fleets[0]
    w = job_waveform(study.workloads[DESIGN_WORKLOAD], n_chips,
                     study.wave_cfg, seed=study.seeds[0],
                     sample_chips=study.sample_chips, device=DEVICE)[1]
    got = {}
    fj, fk = gpu_floor.gpu_floor_relaxed, battery.battery_relaxed

    def keep(*a):
        return tuple(x.detach().clone() if isinstance(x, torch.Tensor)
                     else x for x in a)

    def j(*a):
        got["gpu_floor_relaxed"] = keep(*a)
        return fj(*a)

    def k(*a):
        got["battery_relaxed"] = keep(*a)
        raise Stop

    gpu_floor.gpu_floor_relaxed, battery.battery_relaxed = j, k
    try:
        api.design_gradient(dict(study.specs)["tight"], np.asarray(w), DT,
                            n_chips, steps=1, device=DEVICE)
    except Stop:
        pass
    finally:
        gpu_floor.gpu_floor_relaxed, battery.battery_relaxed = fj, fk
    return got


def ad_relaxed(torch, api):
    """``--ad``'s rows of J and K (forward and adjoint, through their
    public entries, at the design's first call tiled to 6 and 10 rows;
    event and device ms), the sha256 of each forward's outputs (equal
    digests in two trees: equal bits; the outputs are saved too, under
    ``chiprun_out/ad_jk/``), and kernel A's adjoint at [10 x 90 000]
    where the tree has it."""
    import hashlib
    from repro_torch.core.smoothing import battery, gpu_floor
    calls = ad_design_calls(torch, api)
    out, saved = {}, {}
    fns = {"gpu_floor_relaxed": gpu_floor.gpu_floor_relaxed,
           "battery_relaxed": battery.battery_relaxed}
    for name, args in calls.items():
        fn = fns[name]
        for rows in (6, 10):
            idx = torch.arange(rows, device=args[0].device) % args[0].shape[0]
            w, params = args[0][idx].contiguous(), args[1][idx].contiguous()
            rest = args[2:]
            with torch.no_grad():
                res = fn(w, params, *rest)
            res = res if isinstance(res, tuple) else (res,)
            digest = hashlib.sha256(b"".join(
                r.contiguous().cpu().numpy().tobytes() for r in res))
            saved[f"{name}_{rows}"] = tuple(r.cpu() for r in res)

            def fwd():
                with torch.no_grad():
                    fn(w, params, *rest)
            wq = w.clone().requires_grad_(True)
            pq = params.clone().requires_grad_(True)
            outs = fn(wq, pq, *rest)
            outs = outs if isinstance(outs, tuple) else (outs,)
            gen = torch.Generator(device=w.device).manual_seed(18)
            gs = [torch.randn(w.shape, generator=gen, device=w.device)
                  for _ in outs]

            def adj():
                torch.autograd.grad(outs, (wq, pq), gs, retain_graph=True)
            out[f"{name}_{rows}"] = {
                "shape": list(w.shape),
                "forward_sha256": digest.hexdigest(),
                "forward_ms": cuda_ms(torch, fwd, 5),
                "forward_device_ms": device_ms(torch, fwd,
                                               JK_DEVICE_NAME[name],
                                               repeat=5),
                "adjoint_ms": cuda_ms(torch, adj, 5),
                "adjoint_device_ms": device_ms(
                    torch, adj, JK_DEVICE_NAME[name + "_adjoint"], repeat=5)}
            log(f"[ad] {name} at {list(w.shape)}: "
                + json.dumps(out[f"{name}_{rows}"]))
    tree = "parent" if "parent" in HERE else "change"
    path = os.path.join(HERE, "chiprun_out", "ad_jk")
    os.makedirs(path, exist_ok=True)
    torch.save(saved, os.path.join(path, f"{tree}.pt"))
    from repro_torch.kernels.goertzel import monitor
    if hasattr(monitor, "monitor_adjoint"):
        study = build_study(api, workloads=[DESIGN_WORKLOAD])
        w = backstop_traces(torch, study)
        bs = api.TelemetryBackstop(amp_threshold_w=BACKSTOP_THRESHOLD_W,
                                   smooth_tau=BACKSTOP_TAU)
        a = monitor_adjoint_operands(torch, w, bs)
        got = monitor.monitor_adjoint(*a)
        ref = monitor.monitor_adjoint_plain(*a)
        out["monitor_adjoint"] = {
            "shape": list(a[1].shape),
            "rel_err": float((got - ref).abs().max() / ref.abs().max()),
            "ms": cuda_ms(torch, lambda: monitor.monitor_adjoint(*a), 5),
            "device_ms": device_ms(torch,
                                   lambda: monitor.monitor_adjoint(*a),
                                   "monitor_adjoint_kernel", repeat=5),
            "plain_ms": cuda_ms(torch,
                                lambda: monitor.monitor_adjoint_plain(*a), 2)}
        log("[ad] monitor_adjoint: " + json.dumps(out["monitor_adjoint"]))
    return out


def ad_scans(torch, repeat=2):
    """Kernels L and M where the tree has them (None where it has not): at
    each of their shapes, event ms (``repeat`` readings of 10 calls) and
    device ms, and the sha256 of each output."""
    import hashlib
    try:
        from repro_torch.kernels.scans import selective_scan, wkv6  # noqa
    except ImportError:
        return None
    out = {}
    for i, name in enumerate(SCAN_SHAPES):
        fn = scan_fns(name)[0]
        for j, (tag, shape) in enumerate(SCAN_SHAPES[name].items()):
            ops = scan_operands(torch, name, shape, 240 + 10 * i + j)
            got = fn(*ops)
            out[f"{name} {tag}"] = {
                "shape": list(shape),
                "ms": [cuda_ms(torch, lambda: fn(*ops), 10)
                       for _ in range(repeat)],
                "device_ms": device_ms(torch, lambda: fn(*ops),
                                       f"{name}_kernel", repeat=10),
                "sha256": [hashlib.sha256(g.cpu().numpy().tobytes())
                           .hexdigest() for g in got]}
            log(f"[ad] {name} {tag}: " + json.dumps(out[f"{name} {tag}"]))
    return out


def ad_main(torch) -> int:
    """``--ad``: the walls that kernels A, B, D, E and G sit on, and
    kernels A, B, D, E, G, H, I, J and K alone, for comparing two trees on
    one card (run the script of the newer tree from the root of each): the
    warm Study, the canonical loop and the 600 s replay with their device
    busy shares, the two loops' dispatch latencies and detection leads,
    and B's device time in the replay (no gate beyond the loop's
    invariants), then ``ad_measure`` at the Study's and a tick's shapes,
    ``floor_measure`` at B's three paths' shapes (bitwise against the
    plain version at the Study's and the loop's), ``ballast_measure`` at
    phase 15's burn, ``sliding_measure`` (E at its paths' shapes, A's
    Study shape and A's four variants, I and H at phase 15's shapes, H
    with its chain probe) and ``ad_relaxed`` (J and K forward and adjoint
    at the design's shapes, their forwards' digests, and kernel A's
    adjoint where the tree has it) and ``ad_scans`` (L and M at each of
    phase 24's shapes, where the tree has them).  Prints one ``{"ad": ...}``
    JSON line."""
    from repro_torch import api, control
    from repro_torch.kernels import build
    from repro_torch.kernels.ballast import ballast  # noqa: F401
    t_start = time.perf_counter()
    out = {"device": torch.cuda.get_device_name(0), "smi": nvidia_smi_line(),
           "tree": HERE, "build_s": build.build_all()}
    study = build_study(api)
    cap = Capture(torch)
    with cap:
        study.run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    study.run()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    wall, busy, _ = profile_device(torch, study.run)
    out["study"] = {"warm_s": warm, "profiled_s": wall, "busy_s": busy,
                    "busy_share": busy / wall}
    w, dt = control_trace(control)
    canon = control_phase(torch, control, api, build, w, dt, "watch_trace")
    wall, busy, _ = profile_device(
        torch, lambda: run_watch(torch, control, api, w, dt, "cuda"))
    out["loop"] = {"warm_s": canon["wall"], "profiled_s": wall,
                   "busy_s": busy, "busy_share": busy / wall,
                   **loop_summary(canon["warm_log"])}
    w_long, dt_long = control_trace(control, long=True)
    long_log, long_wall = run_watch(torch, control, api, w_long, dt_long,
                                    "cuda")
    totals = {DEVICE_NAME["gpu_floor"]: None}
    wall, busy, _ = profile_device(
        torch, lambda: run_watch(torch, control, api, w_long, dt_long,
                                 "cuda"), totals=totals)
    b_ms, b_n = totals[DEVICE_NAME["gpu_floor"]]
    out["replay_600s"] = {"wall_s": long_wall, "profiled_s": wall,
                          "busy_s": busy, "busy_share": busy / wall,
                          "gpu_floor_device_ms": b_ms,
                          "gpu_floor_launches": b_n, **loop_summary(long_log)}
    log(f"[watch_trace 600 s] kernel B: {b_n} launches, {b_ms:.4g} ms on "
        f"the device in all, of {busy * 1e3:.4g} ms busy")
    out.update(ad_measure(torch, cap.args, canon["capture"].args))
    replay_calls = floor_calls_in(torch, control, api, w_long, dt_long)
    _, study_b, _ = cap.args["gpu_floor"]
    _, loop_b, _ = canon["capture"].args["gpu_floor"]
    out["gpu_floor"] = floor_measure(torch, study_b, loop_b, replay_calls,
                                     replay_plain=False)
    out["ballast"] = ballast_measure(torch)
    out["sliding"] = sliding_measure(torch, cap.args["monitor"][1], w, dt,
                                     w_long, dt_long)
    out["relaxed"] = ad_relaxed(torch, api)
    out["scans"] = ad_scans(torch)
    out["total_s"] = time.perf_counter() - t_start
    print(json.dumps({"ad": out}), flush=True)
    return 0


# the host functions of the Study's path whose cumulative time
# ``--study-time`` reports (those a tree lacks are left out)
STUDY_HOST_FNS = ("run_rows", "stream_batches", "dispatch", "run_piece",
                  "materialize", "piece_tree", "simulate_batch",
                  "analyze_batch", "critical_band_report", "validate",
                  "spectrum", "row_aligned", "host_allgather", "concat_trees",
                  "_fill_chunk", "_to_host", "_numpy")


def study_time_main(torch, repeat=12) -> int:
    """``--study-time``: phase 5's Study warm ``repeat`` times (each wall
    synchronised), its device busy time in one profiled run, and the
    cumulative host seconds of ``STUDY_HOST_FNS`` in one run under
    ``cProfile`` (attribution only: cProfile slows the host).  For
    comparing two trees on one card, run this script from the root of
    each, in the order parent, change, change, parent.  Prints one
    ``{"study_time": ...}`` line."""
    import cProfile
    import pstats
    import statistics
    from repro_torch import api
    from repro_torch.kernels import build
    build.build_all()
    study = build_study(api)
    cold = timed_run(torch, study.run)[1]
    walls = [timed_run(torch, study.run)[1] for _ in range(repeat)]
    wall, busy, _ = profile_device(torch, study.run)
    prof = cProfile.Profile()
    prof.enable()
    timed_run(torch, study.run)
    prof.disable()
    host = {}
    for (path, _, fn), row in pstats.Stats(prof).stats.items():
        if fn in STUDY_HOST_FNS and "repro_torch" in path:
            tag = f"{os.path.basename(path)}:{fn}"
            host[tag] = round(host.get(tag, 0.0) + row[3], 6)
    out = {"tree": HERE, "smi": nvidia_smi_line(), "cold_s": cold,
           "warm_s": walls, "warm_median_s": statistics.median(walls),
           "warm_min_s": min(walls), "profiled_s": wall, "busy_s": busy,
           "host_cum_s": dict(sorted(host.items()))}
    print(json.dumps({"study_time": out}), flush=True)
    return 0


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--jk-plain"] and len(sys.argv) == 4:
        import_port()
        return jk_plain_job(torch, *sys.argv[2:])
    if sys.argv[1:2] == ["--battery-plain"] and len(sys.argv) == 4:
        import_port()
        return battery_plain_job(torch, *sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import_port()
    if sys.argv[1:] == ["--ad"]:
        return ad_main(torch)
    if sys.argv[1:] == ["--study-time"]:
        return study_time_main(torch)
    if sys.argv[1:2] == ["--cpu-subset"] and len(sys.argv) == 3:
        return cpu_subset_job(torch, sys.argv[2])
    if sys.argv[1:2] == ["--ssm-cpu"] and len(sys.argv) == 4:
        return ssm_rerun_job(torch, *sys.argv[2:])
    if sys.argv[1:2] == ["--train-cpu"] and len(sys.argv) == 3:
        return train_cpu_job(torch, sys.argv[2])
    if sys.argv[1:2] == ["--mesh-worker"] and len(sys.argv) == 5:
        return mesh_worker(torch, sys.argv[2], sys.argv[3],
                           float(sys.argv[4]))
    if sys.argv[1:2] == ["--train-dp-worker"] and len(sys.argv) == 4:
        return train_dp_worker(torch, sys.argv[2], float(sys.argv[3]))
    from repro_torch import api
    from repro_torch.kernels import build
    # the kernels that api does not import register here: F, G, H, I, L
    # and M
    from repro_torch.kernels.ballast import ballast  # noqa: F401
    from repro_torch.kernels.flash import flash  # noqa: F401
    from repro_torch.kernels.goertzel import sliding_v1, windows  # noqa: F401
    from repro_torch.kernels.scans import selective_scan, wkv6  # noqa: F401

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {name} x "
        f"{torch.cuda.device_count()}")
    log(smi)

    # 1. build all nine kernels, one nvcc per source, all started together
    secs = build.build_all()
    log("kernel build seconds: " + json.dumps(secs))
    for k in build.KERNELS:
        lines = [ln.strip() for ln in k.ptxas_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"ptxas {k.name}: " + " | ".join(lines))

    # 2. the main path: a full-size Study on the card, launch counts from 0
    study = build_study(api)
    log(study.describe() + ", device=cuda")
    cap = Capture(torch)
    build.reset_launch_counts()
    with cap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = study.run()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
    counts = build.launch_counts()
    f_counts = {"study": counts["flash_fwd"]}
    # kernels G, H and I on each earlier path: launched on none of them
    late = {"study": counts}
    launches = {"monitor": counts["monitor"], "gpu_floor": counts["gpu_floor"],
                "battery": counts["battery"],
                "escalation": counts["escalation"]}
    log("launches in the Study run: " + json.dumps(launches))
    if min(launches.values()) <= 0:
        raise AssertionError("a kernel of the main path was not launched")

    # 3-4. each kernel against its plain version at the main path's shapes
    kernels = [check_monitor(torch, cap, launches,
                             api.TelemetryBackstop().critical_hz)]
    for nm in ("gpu_floor", "battery", "escalation"):
        kernels.append(check_scan(torch, cap, launches, nm))
    for k in kernels:
        log(f"{k['name']}: {k['ms']:.4g} ms (plain {k['plain_ms']:.4g} ms, "
            f"bound {k['bound_ms']:.4g} ms by {k['bound_by']}), "
            f"{k['launches']} launches per Study")

    # 5. the Study's results, warm time and device profile
    t0 = time.perf_counter()
    res_warm = study.run()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    rows = study.n_rows
    log(f"study: cold {cold:.3f} s (argument captures included), warm "
        f"{warm:.3f} s wall, "
        f"{rows / warm:.2f} rows/s, {len(res) / warm:.2f} records/s")
    verdicts = {sp: collections.Counter(
        "pass" if r["spec_ok"] else "fail" for r in res.filter(spec=sp))
        for sp in SPEC_NAMES}
    log("verdicts: " + json.dumps(verdicts))
    hist = collections.Counter(int(v) for v in cap.max_levels)
    log("backstop max_level histogram (rows): "
        + json.dumps(dict(sorted(hist.items()))))
    if not (hist.get(0, 0) and sum(v for k, v in hist.items() if k > 0)):
        raise AssertionError("the backstop should escalate on some rows "
                             "and not on others")
    if any(a["spec_ok"] != b["spec_ok"] for a, b in zip(res, res_warm)):
        raise AssertionError("the warm run's verdicts differ from the cold")
    wall, busy, top = profile_device(torch, study.run)
    log(f"profiled run {wall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}% of the traced wall)")
    for ms, cnt, key in top:
        log(f"  {ms:10.3f} ms {cnt:6d}x {key[:110]}")
    for r in res:
        vals = [r["mean_mw"], r["swing_mitigated_mw"], r["energy_overhead"]]
        vals += list(r["metrics"].values())
        if not all(v == v and abs(v) != float("inf") for v in vals):
            raise AssertionError(f"non-finite metric in {r}")

    # 6. a subset of the same Study on the CPU (the plain versions), in a
    # worker beside the later phases; compared at the end
    subset_job = cpu_subset_start()
    for k in kernels:
        k["launches_by_path"] = {"study": k["launches"]}

    # 18, started here: the design path at full size, through kernels J
    # and K; its CPU workers (J's and K's plain versions at the full shape,
    # minutes each) run on beside phases 7-17, 19-21 and 15, and are
    # waited for and gated after phase 15
    design = design_phase(torch, api, build)
    late["design"] = design["launches"]
    log(f"phase 18, the card's part: {design['phase_s']:.1f} s")

    # 7. the control loop on the canonical ramp: cold and warm on the card
    from repro_torch import control
    w, dt = control_trace(control)
    canon = control_phase(torch, control, api, build, w, dt, "watch_trace")
    f_counts["watch_trace"] = build.launch_counts()["flash_fwd"]
    late["watch_trace"] = build.launch_counts()
    wall, busy, top = profile_device(
        torch, lambda: run_watch(torch, control, api, w, dt, "cuda"), 10)
    log(f"[watch_trace] profiled run {wall:.3f} s, device busy {busy:.4f} s"
        f" ({100 * busy / wall:.1f}% of this run's traced wall)")
    for ms, cnt, key in top:
        log(f"  {ms:10.3f} ms {cnt:6d}x {key[:110]}")
    # each kernel against its plain version at its largest call on the path
    path_rows = {}
    for nm, (_, args, kw) in sorted(canon["capture"].args.items()):
        shape, err, ok, ms, plain_ms, b_ms, b_by = kernel_vs_plain(
            torch, nm, args, kw)
        log(f"[watch_trace] {nm} at {shape}: max |kernel - plain| "
            f"{err:.4g}, {ms:.4g} ms (plain {plain_ms:.4g} ms, bound "
            f"{b_ms:.4g} ms by {b_by})")
        if not ok:
            raise AssertionError(f"{nm} disagrees with its plain version on "
                                 "the control path")
        path_rows[nm] = {"shape": shape, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by}

    # 8. a 10-minute 1 kHz replay: 600 000 samples, 1200 ticks
    w_long, dt_long = control_trace(control, long=True)
    build.reset_launch_counts()
    long_log, long_wall = run_watch(torch, control, api, w_long, dt_long,
                                    "cuda")
    long_counts = path_counts(build)
    f_counts["watch_trace_600s"] = build.launch_counts()["flash_fwd"]
    late["watch_trace_600s"] = build.launch_counts()
    report_loop("watch_trace 600 s", long_log, long_wall,
                len(w_long) * dt_long, long_counts)
    log(f"[watch_trace 600 s] loop wall {long_wall:.3f} s; "
        f"{LONG_REPLAY_WAS_S} s on the same card type before kernel C's "
        "redesign (PERF.md section 5)")
    if min(long_counts.values()) <= 0 or long_log.summary()[
            "n_dispatches"] < 1:
        raise AssertionError("the long replay launched no kernel of the path "
                             "or dispatched nothing")
    wall, busy, top = profile_device(
        torch, lambda: run_watch(torch, control, api, w_long, dt_long,
                                 "cuda"), 6)
    log(f"[watch_trace 600 s] profiled run {wall:.3f} s, device busy "
        f"{busy:.4f} s ({100 * busy / wall:.1f}% of this run's traced wall)")
    for ms, cnt, key in top:
        log(f"  {ms:10.3f} ms {cnt:6d}x {key[:110]}")

    # 9. kernel E at both counterfactual shapes, the chunked online path
    e_rows = [check_sliding(torch, w, dt), check_sliding(torch, w_long,
                                                          dt_long)]
    check_chunked(torch, w, dt)
    c_extra, c_cycles, c_ns, c_ieee = battery_phase(
        torch, canon["capture"].args["battery"], w_long, dt_long)
    # kernel B at its three paths' shapes (the replay's calls captured
    # from a run of their own, every one bitwise against the plain
    # version), on two seeded rows, in its worst case, and its chain alone
    b_extra = floor_measure(
        torch, cap.args["gpu_floor"][1], canon["capture"].args["gpu_floor"][1],
        floor_calls_in(torch, control, api, w_long, dt_long),
        replay_plain=True)
    if not b_extra["replay_calls"]["bitwise"]:
        raise AssertionError("kernel B differs from its plain version on "
                             "the 600 s replay's calls")
    b_extra["seeded"] = floor_seeded(torch)
    # kernels A and D at the Study's and a tick's shapes: device time, A
    # against E, D's chain alone, its int32 edge and chunked carry
    ad = ad_measure(torch, cap.args, canon["capture"].args)
    ad_gates(torch, cap.args, ad)
    ad["monitor_variants"] = monitor_variants(torch)
    # kernels E, I and H alone: event and device ms at each shape
    from repro_torch.kernels.goertzel.sliding import SLIDING_KERNEL
    sl = sliding_measure(torch, cap.args["monitor"][1], w, dt, w_long,
                         dt_long)
    e = {"name": "sliding_bin_power_v2", "route": "cuda",
         "source": "src/repro_torch/kernels/goertzel/csrc/sliding.cu",
         "replaces": "src/repro/kernels/goertzel/goertzel.py:250",
         "launches": canon["counts"]["sliding"],
         "tolerance": f"{MONITOR_TOL} x amplitude scale",
         "chunked_bitwise": True, **e_rows[0], "library_ms": None,
         "library_note": "no single PyTorch call computes every sample's "
                         "sliding windowed DFT bins",
         "long_replay": e_rows[1],
         "device_ms": sl["E"]["loop"]["device_ms"],
         "geometry": sl["E"]["loop"]["geometry"], "shapes": sl["E"],
         "ptxas": ptxas_lines(SLIDING_KERNEL),
         "launches_by_path": {"study": counts["sliding"]}}
    kernels.append(e)
    for k in kernels:
        nm = COUNT_NAME[k["name"]]
        k.setdefault("launches_by_path", {})
        k["launches_by_path"]["watch_trace"] = canon["counts"][nm]
        k["launches_by_path"]["watch_trace_600s"] = long_counts[nm]
        if nm in path_rows:
            k["watch_trace_call"] = path_rows[nm]
    ad_rows(kernels, ad)
    floor_row(kernels, b_extra, long_counts["gpu_floor"])
    from repro_torch.core.smoothing.battery import BATTERY_KERNEL
    c_row = next(k for k in kernels if k["name"] == "battery_scan")
    c_shapes = {"study": c_row["shape"],
                "watch_trace": c_row["watch_trace_call"]["shape"],
                **{t: r["shape"] for t, r in c_extra.items()}}
    c_row.update({
        "bitwise_shapes": c_shapes, "more_shapes": c_extra,
        "chain_cycles_per_step": c_cycles, "chain_ns_per_step": c_ns,
        "chain_clock_ghz": c_cycles / c_ns, "chain_ieee_division": c_ieee,
        # the chain's floor: its own time a step times the row's steps
        "chain_floor_ms": {t: c_ns * sh[1] / 1e6
                           for t, sh in c_shapes.items()},
        "ptxas": ptxas_summary(BATTERY_KERNEL)})
    log(f"battery_scan chain floor (ms): "
        + json.dumps(c_row["chain_floor_ms"]) + "; ptxas "
        + json.dumps(c_row["ptxas"]))
    for k in kernels:
        log(f"{k['name']}: {k['ms']:.4g} ms (plain {k['plain_ms']:.4g} ms, "
            f"bound {k['bound_ms']:.4g} ms by {k['bound_by']}), launches "
            + json.dumps(k["launches_by_path"]))

    # 10. the canonical loop on the CPU (the plain versions) against 7
    compare_cpu_loop(torch, control, api, w, dt, canon["cold_log"])
    if any(f_counts.values()):
        raise AssertionError(f"kernel F launched off the model path: "
                             f"{f_counts}")

    # 11-14. kernel F; granite-3-8b prefill on both routes, ServeEngine,
    # and a cut-depth re-run on the CPU
    t_model = time.perf_counter()
    model = model_phases(torch, build, kernels, f_counts)
    log("model: " + json.dumps(model))
    peak = max(model["prefill"]["peak_gib"],
               torch.cuda.max_memory_allocated() / 2**30)
    log(f"phases 11-14: {time.perf_counter() - t_model:.1f} s; peak "
        f"{peak:.2f} GiB allocated in phases 12-14")
    late.update(model["launches"])

    # 22. sparse experts and latent attention: dbrx-132b and
    # deepseek-v2-lite-16b at the published widths, depth cut; kernel F at
    # their prefill shapes, both routes, serving, a CPU re-run
    zoo = zoo_phase(torch, build)
    late.update(zoo["launches"])
    f_row = next(k for k in kernels if k["name"] == "flash_forward")
    f_row["zoo_cases"] = zoo["flash_cases"]
    for k in kernels:
        nm = COUNT_NAME[k["name"]]
        k["launches_by_path"].update({p: c[nm] for p, c in
                                      zoo["launches"].items()})
    log("zoo: " + json.dumps({k: v for k, v in zoo.items()
                              if k != "launches"}))

    # 24. Mamba and RWKV-6: kernels L and M, jamba-v0.1-52b and rwkv6-3b at
    # the published widths, depth cut for jamba, a CPU re-run of each
    ssm = ssm_phase(torch, build)
    late.update(ssm["launches"])
    for k in kernels:
        nm = COUNT_NAME[k["name"]]
        k["launches_by_path"].update({p: c[nm] for p, c in
                                      ssm["launches"].items()})
    log("ssm: " + json.dumps({k: v for k, v in ssm.items()
                              if k not in ("launches", "rows")}))

    # 16. the keyed Study (Firefly, CombinedMitigation, noisy telemetry),
    # chunked, resumed and on the CPU; it runs before phase 15, so that
    # phase 15's check that no earlier path launched G, H or I covers it
    keyed = keyed_study_phase(torch, api, build)
    late["keyed_study"] = keyed["launches"]
    for k in kernels:
        k["launches_by_path"]["keyed_study"] = keyed["launches"][
            COUNT_NAME[k["name"]]]
    log("keyed: " + json.dumps(keyed))
    log(f"phase 16: {keyed['phase_s']:.1f} s")

    # 23 (b), started here: its worker runs its card half beside phases
    # 17-21, then waits for phase 23 to run its CPU half beside (a)-(c)
    b_job = train_cpu_start()
    # 17. the serial reference and the batch helpers on phase 5's rows
    serial = serial_phase(torch, api, build, res)
    late["serial_reference"] = serial["launches"]
    log(f"phase 17: {serial['phase_s']:.1f} s")
    # 19. the relaxed backstop's gradient, through kernel A's adjoint
    backstop = backstop_gradient_phase(torch, api, build)
    late["backstop_gradient"] = backstop["launches"]
    log(f"phase 19: {backstop['phase_s']:.1f} s")
    # 20. the compliance service, the warm-start predictor and the CLI
    serve = compliance_phase(torch, api, build)
    late["compliance_service"] = serve["launches"]
    log("serve: " + json.dumps({k: v for k, v in serve.items()
                                if k != "launches"}))
    log(f"phase 20: {serve['phase_s']:.1f} s")
    # 21. the Study on the scenario mesh: one process, two on the card
    mesh = mesh_phase(torch, api, build, res)
    late["scenario_mesh"] = mesh["launches"]
    log("mesh: " + json.dumps({k: v for k, v in mesh.items()
                               if k != "launches"}))
    log(f"phase 21: {mesh['phase_s']:.1f} s")
    # 23. training granite-3-8b on the card (no kernel of A-K or A'); it
    # runs before phase 15, so that phase 15's check that no earlier path
    # launched G, H or I covers it
    train = train_phase(torch, build, b_job)
    late["training"] = train["launches"]
    log("train: " + json.dumps({k: v for k, v in train.items()
                                if k != "launches"}))
    for k in kernels:
        for p in ("serial_reference", "design", "backstop_gradient",
                  "compliance_service", "scenario_mesh", "training"):
            k["launches_by_path"][p] = late[p][COUNT_NAME[k["name"]]]

    # 15. kernels G, H and I through the reference's own entry points:
    # bin_power on four traces, the v1 sliding layout, ballast_burn
    t15 = time.perf_counter()
    late_rows, entry_counts = entry_point_phase(torch, build, w, dt, w_long,
                                                dt_long)
    for k in kernels:
        k["launches_by_path"]["entry_points"] = entry_counts[
            COUNT_NAME[k["name"]]]
    for r in late_rows:
        if r["name"] == "sliding_goertzel_v1":
            r.update(device_ms=sl["I"]["device_ms"],
                     geometry=sl["I"]["geometry"])
        elif r["name"] == "goertzel_windows":
            r.update(device_ms=sl["H"]["shapes"]["600s"]["device_ms"],
                     chain_floor_ms=sl["H"]["shapes"]["600s"].get(
                         "chain_floor_ms"),
                     chain=sl["H"].get("chain"), shapes=sl["H"]["shapes"],
                     day_persistent=sl["H"].get("day_persistent"))
        nm = COUNT_NAME[r["name"]]
        r["launches_by_path"] = {p: c[nm] for p, c in late.items()}
        r["launches_by_path"]["entry_points"] = entry_counts[nm]
        log(f"{r['name']}: {r['ms']:.4g} ms (plain {r['plain_ms']:.4g} ms, "
            f"bound {r['bound_ms']:.4g} ms by {r['bound_by']}, library "
            f"{r['library_ms']}), launches "
            + json.dumps(r["launches_by_path"]) + "; ptxas "
            + " | ".join(r["ptxas"]))
    off_path = {p: {nm: c[nm] for nm in LATE_KERNELS if c[nm]}
                for p, c in late.items()}
    if any(off_path.values()):
        raise AssertionError(f"kernel G, H or I launched on an earlier path:"
                             f" {off_path}")
    kernels.extend(late_rows)
    log(f"phase 15: {time.perf_counter() - t15:.1f} s")
    compare_cpu_subset(api, res, subset_job)
    battery_finish(torch, c_extra)
    t18 = time.perf_counter()
    design_finish(torch, design)
    log(f"phase 18: {design['phase_s'] + time.perf_counter() - t18:.1f} s "
        "(the card's part and the wait for its CPU workers at the end)")

    # kernels J and K: launched on the design paths (phase 18's and the
    # compliance service's fallback and predictor) and on no other
    paths = dict(late, entry_points=entry_counts)
    off_design = {p: {nm: c[nm] for nm in RELAXED if c[nm]}
                  for p, c in paths.items()
                  if p not in ("design", "compliance_service")}
    if any(off_design.values()):
        raise AssertionError(f"kernel J or K launched off the design paths: "
                             f"{off_design}")
    for r in jk_rows(design, paths):
        log(f"{r['name']}: {r['ms']:.4g} ms (device {r['device_ms']}, plain "
            f"{r['plain_ms']:.4g} ms at {r['plain_shape']}, bound "
            f"{r['bound_ms']:.4g} ms by {r['bound_by']}, chain floor "
            f"{r['chain_floor_ms']:.4g} ms), launches "
            + json.dumps(r["launches_by_path"]))
        kernels.append(r)
    # kernel A's adjoint: launched on the backstop's gradient and nowhere
    # else
    a_row = backstop["row"]
    a_row["launches_by_path"] = {p: c["monitor_adjoint"]
                                 for p, c in paths.items()}
    off_backstop = {p: c for p, c in a_row["launches_by_path"].items()
                    if c and p != "backstop_gradient"}
    if off_backstop:
        raise AssertionError(f"kernel A's adjoint launched off the relaxed "
                             f"backstop's gradient: {off_backstop}")
    log(f"monitor_adjoint: {a_row['ms']:.4g} ms (device "
        f"{a_row['device_ms']}, plain {a_row['plain_ms']:.4g} ms, bound "
        f"{a_row['bound_ms']:.4g} ms by {a_row['bound_by']}), launches "
        + json.dumps(a_row["launches_by_path"]))
    kernels.append(a_row)
    # kernels L and M: launched on jamba's and rwkv6-3b's paths of phase 24
    # and on no other
    for nm, arch in (("selective_scan", "jamba-v0.1-52b"),
                     ("wkv6", "rwkv6-3b")):
        row = ssm["rows"][nm]
        # (a worker's counts name only the kernels its process imported)
        row["launches_by_path"] = {p: c.get(nm, 0) for p, c in paths.items()}
        off = {p: c for p, c in row["launches_by_path"].items()
               if c and not p.startswith(arch + " ")}
        if off or not any(row["launches_by_path"].values()):
            raise AssertionError(f"kernel {nm} launched off {arch}'s paths "
                                 f"or on none of them: {off}")
        log(f"{nm}: {row['ms']:.4g} ms (device {row['device_ms']}, plain "
            f"{row['plain_ms']:.4g} ms, bound {row['bound_ms']:.4g} ms by "
            f"{row['bound_by']}), launches "
            + json.dumps(row["launches_by_path"]))
        kernels.append(row)

    log(f"total {time.perf_counter() - t_start:.1f} s, "
        f"{time.perf_counter() - SCRIPT_T0:.1f} s since the script started")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
