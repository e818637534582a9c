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
