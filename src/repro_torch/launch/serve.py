"""Serving launcher: batched generation with a KV cache (reference:
``repro/launch/serve.py``, the same flags plus ``--device``).

Example (the card; ``--device cpu`` for the plain CPU run):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \\
      --reduced --batch 4 --prompt-len 16 --gen 32
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.serve import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (the default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    m = Model(cfg)
    params = m.init(0, device=dev)
    eng = ServeEngine(cfg, params, max_seq=args.prompt_len + args.gen + 1,
                      batch=args.batch, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1))
    t0 = time.time()
    out = eng.generate(prompts, args.gen, temperature=args.temperature,
                       generator=torch.Generator(device=dev).manual_seed(2))
    dt = time.time() - t0
    print(f"generated {args.batch}x{args.gen} tokens in {dt:.2f}s "
          f"({args.batch*args.gen/dt:.1f} tok/s)")
    print(out[:, :16])


if __name__ == "__main__":
    main()
