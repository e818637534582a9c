"""Hardware constants of the *simulated* accelerator: a TPU v5e chip and
its power model.

These are model data, carried over unchanged from the reference package
so that the port synthesizes the same waveforms.  They describe the chip
the study simulates, not the device the port runs on.

Roofline triple (197 TF bf16 / 819 GB/s HBM / ~50 GB/s/link ICI) is given by
the assignment.  Power-model numbers marked (A) are stated assumptions (TPU
vendors do not publish chip TDP); numbers marked (P) come from the paper's
GB200 description and define the *feature model* (EDP=1.1x TDP, MPF<=90%).
The server-level breakdown mirrors the paper's Fig. 2 (accelerators >50% of
provisioned server power).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12       # FLOP/s   (assignment)
    hbm_bw: float = 819e9                 # B/s      (assignment)
    ici_bw_per_link: float = 50e9         # B/s/link (assignment)
    ici_links: int = 4                    # 2D torus (A)
    hbm_bytes: float = 16e9               # v5e HBM capacity
    tdp_w: float = 220.0                  # (A) chip+HBM board power
    idle_w: float = 60.0                  # (A)
    comm_w: float = 90.0                  # (A) power during ICI-bound phases
    hbm_bound_w: float = 160.0            # (A) power when HBM-bound
    edp_factor: float = 1.1               # (P) <=50 ms overshoot allowance
    edp_window_s: float = 0.050           # (P)
    mpf_max: float = 0.9                  # (P) max programmable power floor


@dataclasses.dataclass(frozen=True)
class ServerSpec:
    """Host overhead per Fig. 2 analogue: CPU+DRAM+NIC+fans+storage."""
    chips_per_host: int = 4
    host_overhead_w: float = 350.0        # (A) per host, all non-chip parts

    def overhead_per_chip_w(self) -> float:
        return self.host_overhead_w / self.chips_per_host


@dataclasses.dataclass(frozen=True)
class DatacenterTopology:
    chips_per_rack: int = 32              # v5e: 8 hosts x 4 chips
    racks_per_pod: int = 8                # 256-chip pod
    pods: int = 2
    # power-delivery conversion losses rack->utility (PSU/PDU/UPS chain)
    distribution_loss: float = 0.06       # (A)

    @property
    def chips(self) -> int:
        return self.chips_per_rack * self.racks_per_pod * self.pods


@dataclasses.dataclass(frozen=True)
class Hardware:
    chip: ChipSpec = ChipSpec()
    server: ServerSpec = ServerSpec()
    topo: DatacenterTopology = DatacenterTopology()

    def chip_share(self) -> float:
        """Fraction of server power provisioned for accelerators (Fig. 2)."""
        tot = self.chip.tdp_w + self.server.overhead_per_chip_w()
        return self.chip.tdp_w / tot


DEFAULT_HW = Hardware()
