"""Helpers of ``chip_smoke.py`` that need no card: the ``ptxas -v``
summary it prints for kernels F and C."""
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(SPEC)
SPEC.loader.exec_module(chip_smoke)

LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN11flash_wgmma18flash_wgmma_kernelILi2ELi128EEEv14CUtensorMap_stS1_PK13__nv_bfloat16PS2_iiiiiiifii' for 'sm_90a'
ptxas info    : Function properties for _ZN11flash_wgmma18flash_wgmma_kernelILi2ELi128EEEv14CUtensorMap_stS1_PK13__nv_bfloat16PS2_iiiiiiifii
    88 bytes stack frame, 184 bytes spill stores, 156 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 88 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114battery_kernelEPKfS1_fPfS2_S2_x' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114battery_kernelEPKfS1_fPfS2_S2_x
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 0 barriers, 8192 bytes smem
"""


class _Kernel:
    ptxas_log = LOG


def test_ptxas_summary_reads_registers_shared_memory_and_spills():
    out = chip_smoke.ptxas_summary(_Kernel())
    assert list(out) == [
        "_ZN11flash_wgmma18flash_wgmma_kernelILi2ELi128EEEv14CUtensorMap_stS1_"
        "PK13__nv_bfloat16PS2_iiiiiiifii",
        "_ZN12_GLOBAL__N_114battery_kernelEPKfS1_fPfS2_S2_x"]
    f, c = out.values()
    assert f == {"registers": 168, "smem_static": 0, "spill_stores": 184,
                 "spill_loads": 156}
    assert c == {"registers": 72, "smem_static": 8192, "spill_stores": 0,
                 "spill_loads": 0}


def test_ptxas_summary_of_an_empty_log_is_empty():
    class Empty:
        ptxas_log = ""
    assert chip_smoke.ptxas_summary(Empty()) == {}


def test_sass_opcode_counts_reads_opcodes_past_predicates():
    sass = """
        /*0a70*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4].tnspB, RZ, !UPT ;
        /*0a80*/                   UTMALDG.4D [UR8], [UR16] ;
        /*1a090*/              @P0  SYNCS.ARRIVE.TRANS64.RED.A1T0 RZ, [UR6], RZ ;
        /*1a0a0*/             @!UP1 HGMMA.64x64x16.F32.BF16 R56, R8, gdesc[UR12], R56 ;
        /*1a0b0*/                   MOV R1, c[0x0][0x28] ;
    """
    assert chip_smoke.sass_opcode_counts(
        sass, ("HGMMA", "UTMALDG", "SYNCS", "LDGSTS")) == {
            "HGMMA": 2, "UTMALDG": 1, "SYNCS": 1, "LDGSTS": 0}


class _Event:
    def __init__(self, key, us, count, attr="self_device_time_total"):
        self.key, self.count = key, count
        setattr(self, attr, us)


def test_kernel_device_ms_sums_the_named_kernels_over_their_launches():
    events = [
        _Event("void (anonymous namespace)::monitor_kernel(float const*)",
               300.0, 20),
        _Event("(anonymous namespace)::escalation_kernel(signed char*)",
               90.0, 10, attr="self_cuda_time_total"),
        _Event("aten::copy_", 50.0, 4),
        _Event("monitor_kernel_idle", 0.0, 3)]
    assert chip_smoke.kernel_device_ms(events, "monitor_kernel") == 0.015
    assert chip_smoke.kernel_device_ms(events, "escalation_kernel") == 0.009
    assert chip_smoke.kernel_device_ms(events, "sliding_kernel") is None


def test_chain_step_and_floor_arithmetic():
    cyc, ns = chip_smoke.chain_step(2_048_000, 1.0, 204_800)
    assert (cyc, ns) == (10.0, 1e6 / 204_800)
    floors = chip_smoke.chain_floor_ms(10.0, {"study": [240, 90000],
                                              "tick": [1, 250]})
    assert floors == {"study": 0.9, "tick": 0.0025}


def _plain_pair(seed=0, B=2, n=900, win=256, K=3):
    """Kernel A's and E's plain outputs on the same seeded operands."""
    import numpy as np
    import torch
    from repro_torch.kernels.goertzel import monitor, ops, sliding
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((B, n)).astype(np.float32))
    xseg = ops.segments(x, win)
    cosp, sinp, rot = (torch.as_tensor(t) for t in
                       ops.phase_tables((0.5, 1.0, 2.0)[:K], 0.01, win))
    zeros = torch.zeros((B, K, win))
    seg0 = torch.tensor([0, 2])[:B]
    n_live = seg0 * win + n
    thr = torch.full((B,), 0.5)
    a = monitor.sliding_monitor(xseg, cosp, sinp, rot, thr, thr, n_live,
                                seg0, zeros, zeros)
    e = sliding.sliding_bin_power_v2(xseg, cosp, sinp, rot, seg0, zeros,
                                     zeros)
    return a, e, n_live, seg0


def test_witness_compare_holds_on_the_plain_versions():
    import torch
    a, e, n_live, seg0 = _plain_pair()
    gaps, equal = chip_smoke.witness_compare(torch, a, e, n_live, seg0)
    assert equal and gaps == {"worst": 0.0, "peaks": 0.0, "nre": 0.0,
                              "nim": 0.0}


@pytest.mark.parametrize("out", [0, 2, 3, 4])
def test_witness_compare_sees_one_ulp_in_each_output(out):
    """One float32 ulp moved in A's worst, peaks, nre or nim breaks the
    bitwise verdict, and the gap names that output."""
    import torch
    a, e, n_live, seg0 = _plain_pair()
    a = list(a)
    t = a[out].clone().reshape(-1)
    i = int(t.abs().argmax())
    t[i] = torch.nextafter(t[i], torch.tensor(float("inf")))
    a[out] = t.reshape(a[out].shape)
    gaps, equal = chip_smoke.witness_compare(torch, a, e, n_live, seg0)
    name = {0: "worst", 2: "peaks", 3: "nre", 4: "nim"}[out]
    assert not equal and gaps[name] > 0
    assert all(v == 0.0 for k, v in gaps.items() if k != name)


@pytest.mark.parametrize("recorded_on,want", [(0, 0.015), (2, 0.015),
                                              (None, None)])
def test_device_ms_profiles_again_then_reports_not_measured(
        monkeypatch, recorded_on, want):
    """A profile that records no launch of the kernel is taken again (the
    third time with device activity alone); when none records one, the
    device time is None, not a failure."""
    import torch
    profiles = []

    class FakeProfile:
        def __init__(self, activities):
            self.activities = activities
            profiles.append(self)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            if len(profiles) - 1 == recorded_on:
                return [_Event("(anonymous namespace)::monitor_kernel()",
                               300.0, 20)]
            return [_Event("aten::copy_", 50.0, 4)]

    class FakeTorch:
        class cuda:
            @staticmethod
            def synchronize():
                pass

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    calls = []
    got = chip_smoke.device_ms(FakeTorch, lambda: calls.append(1),
                               "monitor_kernel", repeat=20)
    assert got == want
    assert len(profiles) == (3 if recorded_on is None else recorded_on + 1)
    assert len(calls) == 1 + 20 * len(profiles)
    if len(profiles) == 3:
        assert profiles[2].activities == [torch.profiler.ProfilerActivity.CUDA]
