"""The scenario axis's shard plan: which device, and which process, holds
which rows of a Study's chunk.

The power-study engine (``repro_torch.core.engine``) is embarrassingly
parallel along its scenario axis.  A ``ScenarioShardPlan`` is an ordered
list of devices along that axis, each owned by one process (its rank in
``torch.distributed``).  A batch of B rows is padded to a multiple of the
device count by repeating its last row; each process takes its contiguous
block of the padded rows (``local_rows``) and cuts it into one shard per
device it owns (``local_shards``, ``shard_batch``).  Each shard runs on its
own device, and the per-row results are merged on the host in global row
order (``parallel/collectives.host_allgather``), the padding dropped.

Ranks own the devices in rank order, the same number each, as the
reference's process-major mesh does.  On one process the whole batch is
local, so the code path is the same either way.

The model half of the reference's ``sharding.py`` (``Plan``, ``make_plan``
and the ``*_pspecs``) belongs with the model zoo's sharding and is not
here.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def rank_card(rank: int) -> torch.device:
    """The card of ``rank`` on this host: ``cuda:(rank % device_count)``.
    Raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"rank {rank} finds no CUDA device; ask for device='cpu' to run "
            "the scenario mesh on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


@dataclasses.dataclass(frozen=True)
class ScenarioShardPlan:
    """A 1-D mesh over the scenario axis: ``devices[i]`` holds shard
    ``i`` and belongs to process ``ranks[i]``."""
    devices: Tuple[torch.device, ...]
    ranks: Tuple[int, ...]
    axis: str = "scenario"

    def __post_init__(self):
        if not self.devices or len(self.devices) != len(self.ranks):
            raise ValueError(f"a plan needs one rank a device, got "
                             f"{len(self.devices)} devices and "
                             f"{len(self.ranks)} ranks")
        procs = sorted(set(self.ranks))
        if list(self.ranks) != sorted(self.ranks) or procs != list(
                range(len(procs))):
            raise ValueError(f"ranks must run 0, 1, ... in order, got "
                             f"{self.ranks}")
        if len(self.devices) % len(procs):
            raise ValueError(f"every rank must own as many devices as the "
                             f"others, got ranks {self.ranks}")
        per = len(self.devices) // len(procs)
        if any(self.ranks.count(p) != per for p in procs):
            raise ValueError(f"every rank must own as many devices as the "
                             f"others, got ranks {self.ranks}")

    @classmethod
    def make(cls, devices: Optional[Sequence] = None, *,
             axis: str = "scenario") -> "ScenarioShardPlan":
        """A plan over ``devices`` (device names or ``torch.device``s), in
        rank order: with P processes, rank ``r`` owns the ``r``-th of P
        equal blocks.  ``None`` means every rank's card
        (``cuda:(rank % device_count)``) under ``torch.distributed``, and
        every local card in one process; it raises where there is none."""
        from repro_torch.parallel import distributed
        world = distributed.process_count()
        if devices is None:
            if world > 1:
                devs = [rank_card(r) for r in range(world)]
            else:
                devs = [rank_card(i) for i in range(
                    max(1, torch.cuda.device_count()))]
        else:
            devs = [torch.device(d) for d in devices]
        if len(devs) % world:
            raise ValueError(f"{len(devs)} devices do not split evenly over "
                             f"{world} processes")
        per = len(devs) // world
        return cls(tuple(devs), tuple(i // per for i in range(len(devs))),
                   axis)

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def n_processes(self) -> int:
        return len(set(self.ranks))

    def pad_rows(self, B: int) -> int:
        """Rows to append so ``B`` divides evenly across the shards."""
        return (-B) % self.n_shards

    def local_rows(self, B: int) -> slice:
        """The slice of a ``B``-row (shard-multiple) batch this process
        owns; the whole batch on one process."""
        from repro_torch.parallel import distributed
        procs = self.n_processes
        if procs <= 1:
            return slice(0, B)
        per = B // procs
        rank = distributed.process_index()
        return slice(rank * per, (rank + 1) * per)

    def local_devices(self) -> List[torch.device]:
        from repro_torch.parallel import distributed
        me = distributed.process_index() if self.n_processes > 1 else 0
        return [d for d, r in zip(self.devices, self.ranks) if r == me]

    def local_shards(self, B: int) -> Tuple[List[Tuple[torch.device, slice]],
                                            int]:
        """``([(device, rows)], padded_B)``: this process's shards of a
        ``B``-row batch padded to ``padded_B`` rows, each a slice of the
        padded batch and the device that computes it."""
        padded = B + self.pad_rows(B)
        rows = self.local_rows(padded)
        devs = self.local_devices()
        if not devs:
            raise RuntimeError("this process owns no device of the plan "
                               f"{self.devices} (ranks {self.ranks})")
        per = (rows.stop - rows.start) // len(devs)
        return [(d, slice(rows.start + j * per, rows.start + (j + 1) * per))
                for j, d in enumerate(devs)], padded

    def shard_batch(self, tree, B: int):
        """Pad every batched leaf (a tensor or numpy array with B leading
        rows) to a shard multiple by repeating its last row, take this
        process's rows, and put each local shard on its own device
        (numpy leaves become tensors there).  Returns ``([(device,
        shard_tree)], padded_B)``; callers drop the padding from merged
        results (``host_allgather(take=B)``).  The reference's API for a
        caller that holds batched tensors; the engine cuts its row lists
        with ``local_shards`` instead."""
        from repro_torch.parallel.collectives import tree_map
        shards, padded = self.local_shards(B)
        pad = padded - B
        return [(d, tree_map(lambda a, s=s, d=d: _put(_pad(a, pad)[s], d),
                             tree)) for d, s in shards], padded


def _pad(a, pad: int):
    if not pad:
        return a
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])
    a = np.asarray(a)
    return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])


def _put(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


@functools.lru_cache(maxsize=None)
def scenario_plan() -> ScenarioShardPlan:
    """The default plan: every local card along one "scenario" axis (every
    rank's card under ``torch.distributed``)."""
    return ScenarioShardPlan.make()
