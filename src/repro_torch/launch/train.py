"""Training launcher: config-driven, fault-tolerant, power-aware
(reference: ``repro/launch/train.py``, the same flags plus ``--device``).

  * auto-resume from the newest checkpoint (bitwise: the data stream is a
    function of the step);
  * async checkpointing with retention;
  * power-aware restart: prints the stagger schedule that ramps the fleet
    in under a moderate utility spec (paper Sec. IV-A);
  * optional in-step ballast (Firefly), sized in GFLOPs.

Example (the card; ``--device cpu`` for the plain CPU run):
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
      --reduced --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ck \\
      --ckpt-every 20
"""
from __future__ import annotations

import argparse
import time

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.core.hardware import DEFAULT_HW
from repro_torch.core.optim import tree_map
from repro_torch.core.spec import example_specs
from repro_torch.core.stagger import plan_stagger
from repro_torch.data import SyntheticLM
from repro_torch.train import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ballast-gflops", type=float, default=0.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (the default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tcfg = TrainConfig(learning_rate=args.lr,
                       warmup_steps=max(args.steps // 10, 1),
                       total_steps=args.steps, microbatches=args.microbatches,
                       ballast=args.ballast_gflops > 0,
                       ballast_gflops=args.ballast_gflops)

    # power-aware ramp-in: at restart the whole fleet would slam from idle
    # to TDP; obey a stagger schedule sized for a moderate utility spec
    hw = DEFAULT_HW
    n_racks = hw.topo.racks_per_pod
    rack_w = hw.topo.chips_per_rack * hw.chip.tdp_w
    spec = example_specs(job_mw=n_racks * rack_w / 1e6)["moderate"]
    sched = plan_stagger(n_racks, rack_w, spec.time.ramp_up_w_per_s)
    print(f"[power] stagger ramp-in: {n_racks} racks over {sched.total_s:.1f}s "
          f"(rack ramp {sched.rack_ramp_w_per_s/1e3:.1f} kW/s)")

    state = init_train_state(0, cfg, tcfg, device=args.device)
    mgr = None
    start = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3, async_save=True)
        restored, manifest = mgr.restore_latest(
            state, shardings=tree_map(lambda t: t.device, state))
        if restored is not None:
            state = restored
            start = int(manifest["step"])
            print(f"[ckpt] resumed from step {start}")

    step_fn = make_train_step(cfg, tcfg)
    data = SyntheticLM(cfg, batch=args.batch, seq=args.seq, seed=0)
    t0 = time.time()
    for i in range(start, args.steps):
        state, m = step_fn(state, data(i))
        if (i + 1) % args.log_every == 0:
            print(f"step {i+1:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} lr {float(m['lr']):.2e} "
                  f"({(time.time()-t0)/(i-start+1):.2f}s/step)", flush=True)
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, state)
            print(f"[ckpt] saved step {i+1}", flush=True)
    if mgr:
        mgr.wait()
    print(f"done: {args.steps - start} steps in {time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
