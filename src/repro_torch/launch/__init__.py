"""Entry scripts (reference: ``repro/launch``): ``python -m
repro_torch.launch.train`` and ``python -m repro_torch.launch.serve``.
The reference's dry-run and its mesh and HLO helpers are not ported:
ROADMAP queue A, the dry-run launcher."""
