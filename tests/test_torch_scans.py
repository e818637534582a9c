"""The plain versions of the port's serial-scan kernels (B: GPU floor,
C: rack battery, D: escalation machine), held against the JAX reference:
B and C within 1e-5 of the trace's max |w|, D exactly.

Run as a script, it prints the worst gap of B's and C's outputs in units
of max |w|: the readings behind ROADMAP queue C.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_scans.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import telemetry as jtel  # noqa: E402
from repro.core import waveform as jwf  # noqa: E402
from repro.core.engine import stack_mitigations  # noqa: E402
from repro.core.phases import synthetic_timeline  # noqa: E402
from repro.core.smoothing import (GpuPowerSmoothing,  # noqa: E402
                                  RackBattery)
from repro_torch.core import telemetry as ttel  # noqa: E402
from repro_torch.core.smoothing.base import apply_mitigation  # noqa: E402
from repro_torch.convert import from_reference_fields  # noqa: E402

TOL = 1e-5      # of max |w|
DT = 0.005


def _chip_and_dc():
    cfg = jwf.WaveformConfig(dt=DT, steps=8, jitter_s=0.02)
    tl = synthetic_timeline(1.0, 0.25, moe_notch=True)
    chip = jwf.chip_waveform_jax(jwf.phase_levels(tl, cfg), DT)
    dc = jwf.aggregate_jax(chip, 512.0, jwf.jitter_shifts(cfg, 0, 64))
    return np.asarray(chip), np.asarray(dc)


def _port(mits):
    return [from_reference_fields(type(m).__name__, dataclasses.asdict(m))
            for m in mits]


def _batched_ref(mits, w):
    """The reference's batched apply (stacked f32 parameter leaves, as its
    engine runs them)."""
    return jax.vmap(lambda m: m.apply_jax(jnp.asarray(w), DT))(
        stack_mitigations(mits))


def _floor_pair():
    """(port out, port aux, reference out, reference aux, input)."""
    chip, _ = _chip_and_dc()
    mits = [GpuPowerSmoothing(mpf_frac=m, ramp_up_w_per_s=ru,
                              ramp_down_w_per_s=rd, stop_delay_s=sd,
                              edp_cap_frac=cap)
            for m, ru, rd, sd, cap in [(0.5, 2000, 1500, 0.2, 1.0),
                                       (0.7, 1000, 1000, 2.0, 1.1),
                                       (0.9, 3000, 500, 0.05, 0.95)]]
    ref, aux_j = _batched_ref(mits, chip)
    out, aux = apply_mitigation(_port(mits),
                                torch.as_tensor(np.stack([chip] * 3)), DT)
    return out, aux, ref, aux_j, chip


def _battery_pair():
    _, dc = _chip_and_dc()
    mits = [RackBattery(capacity_j=c, max_discharge_w=p, max_charge_w=p,
                        switch_latency_s=lat, initial_soc=s0,
                        target_tau_s=tau)
            for c, p, lat, s0, tau in [(5e4, 3e4, 0.0, 0.5, 30.0),
                                       (2e4, 3e4, 0.02, 0.2, 5.0),
                                       (1e5, 1e4, 0.05, 0.9, 30.0),
                                       (0.0, 3e4, 0.0, 0.5, 30.0)]]
    ref, aux_j = _batched_ref(mits, dc)
    out, aux = apply_mitigation(_port(mits),
                                torch.as_tensor(np.stack([dc] * 4)), DT)
    return out, aux, ref, aux_j, dc


def test_gpu_floor_plain_matches_reference():
    out, aux, ref, aux_j, chip = _floor_pair()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL * np.abs(chip).max())
    np.testing.assert_allclose(aux["floor_w"].numpy(),
                               np.asarray(aux_j["floor_w"]), rtol=1e-7)
    np.testing.assert_allclose(aux["energy_overhead"].numpy(),
                               np.asarray(aux_j["energy_overhead"]),
                               rtol=1e-4)


def test_battery_plain_matches_reference():
    out, aux, ref, aux_j, dc = _battery_pair()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL * np.abs(dc).max())
    for k in ("soc_min_frac", "soc_max_frac"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(aux_j[k]),
                                   rtol=0, atol=TOL, err_msg=k)
    np.testing.assert_allclose(aux["peak_reduction_w"].numpy(),
                               np.asarray(aux_j["peak_reduction_w"]),
                               rtol=0, atol=TOL * np.abs(dc).max())


def _class_streams(seed, B=3, n=700):
    """Runs of hit/band/clear classes with sparse pad samples."""
    rng = np.random.default_rng(seed)
    cls = np.zeros((B, n), np.int8)
    for b in range(B):
        pos = 0
        while pos < n:
            run = int(rng.integers(1, 60))
            cls[b, pos:pos + run] = rng.choice([0, 1, 2], p=[0.4, 0.2, 0.4])
            pos += run
        cls[b, rng.random(n) < 0.02] = jtel.CLS_PAD
    return cls


@pytest.mark.parametrize("sustain_n,cool_n", [(1, 1), (5, 12), (30, 7)])
def test_escalation_plain_matches_reference_exactly(sustain_n, cool_n):
    cls = _class_streams(sustain_n)
    carry0 = ttel.escalation_init(len(cls))
    carry, levels = ttel.escalation_scan(
        torch.as_tensor(cls), 17, carry0, sustain_n=sustain_n,
        cool_n=cool_n)
    for b in range(len(cls)):
        (lv, ab, be, de), lj = jtel.escalation_scan(
            jnp.asarray(cls[b]), jnp.int32(17), jtel.escalation_init(),
            sustain_n=sustain_n, cool_n=cool_n)
        np.testing.assert_array_equal(levels[b].numpy(), np.asarray(lj))
        assert carry[b].tolist() == [int(lv), int(ab), int(be), int(de)]


def test_escalation_chunks_carry_exactly():
    cls = torch.as_tensor(_class_streams(4))
    kw = dict(sustain_n=5, cool_n=9)
    c_all, l_all = ttel.escalation_scan(cls, 0, ttel.escalation_init(3), **kw)
    c1, l1 = ttel.escalation_scan(cls[:, :250].contiguous(), 0,
                                  ttel.escalation_init(3), **kw)
    c2, l2 = ttel.escalation_scan(cls[:, 250:].contiguous(), 250, c1, **kw)
    assert torch.equal(torch.cat([l1, l2], 1), l_all)
    assert torch.equal(c2, c_all)


def _machine_ints(cls, carry, idx0, sustain_n, cool_n, max_level):
    """The escalation machine on Python ints (no width): the int64
    semantics the port's plain version must keep at any carry."""
    level, above, below, detect = carry
    levels = []
    for i, k in enumerate(cls):
        hit, clear, on = k == 2, k == 0, k != 3
        above = above + 1 if hit else (0 if on else above)
        below = below + 1 if clear else (0 if on else below)
        esc = hit and above >= sustain_n and level < max_level
        if esc and detect < 0:
            detect = idx0 + i
        if esc:
            level, above = level + 1, 0
        if clear and below >= cool_n and level > 0:
            level, below = level - 1, 0
        levels.append(level)
    return [level, above, below, detect], levels


EDGE = 2 ** 31


@pytest.mark.parametrize("field,start,fits", [
    (1, EDGE - 1 - 40, True), (1, EDGE - 40, False),
    (2, EDGE - 1 - 40, True), (2, EDGE - 40, False),
    (1, -EDGE, True), (1, -EDGE - 1, False),
    (0, EDGE - 1, True), (0, EDGE, False)])
def test_escalation_int32_rule_at_its_edge(field, start, fits):
    """Kernel D's range rule (``escalation_fits_int32``) where a counter's
    carry-in plus n reaches 2^31 - 1 (fits) and 2^31 (does not), or a
    carry-in leaves int32; the plain version exact against the machine on
    Python ints there.  Runs of hits then clears (max_level 0: no
    escalation resets ``above``) drive ``above`` and ``below`` to their
    carry-in plus their run."""
    n = 40
    cls = [2] * n if field == 1 else [0] * n
    carry = [0, 0, 0, -1]
    carry[field] = start
    kw = dict(sustain_n=3, cool_n=5, max_level=0)
    rule = ttel.escalation_fits_int32(torch.tensor([carry]), n, **kw)
    assert rule.tolist() == [fits]
    got_c, got_l = ttel.escalation_scan_plain(
        torch.tensor([cls], dtype=torch.int8), 9, torch.tensor([carry]), **kw)
    want_c, want_l = _machine_ints(cls, carry, 9, **kw)
    assert got_c[0].tolist() == want_c
    assert got_l[0].tolist() == [v & 0xff if v & 0x80 == 0 else
                                 (v & 0xff) - 256 for v in want_l]
    if field in (1, 2) and start > 0:
        assert want_c[field] == start + n          # the counter's top


@pytest.mark.parametrize("kw", [dict(sustain_n=EDGE, cool_n=5, max_level=3),
                                dict(sustain_n=3, cool_n=-EDGE - 1,
                                     max_level=3),
                                dict(sustain_n=3, cool_n=5, max_level=EDGE)])
def test_escalation_int32_rule_needs_the_settings_in_int32(kw):
    carry = ttel.escalation_init(2)
    assert ttel.escalation_fits_int32(carry, 10, **kw).tolist() == [False,
                                                                    False]
    kw_ok = dict(sustain_n=EDGE - 1, cool_n=-EDGE, max_level=3)
    assert ttel.escalation_fits_int32(carry, 10, **kw_ok).tolist() == [True,
                                                                       True]


hypothesis = pytest.importorskip("hypothesis")
st = hypothesis.strategies


@hypothesis.settings(max_examples=20, deadline=None, derandomize=True,
                     database=None)
@hypothesis.given(
    cls=st.lists(st.integers(0, 3), min_size=96, max_size=96),
    idx0=st.integers(0, 1000))
def test_escalation_machine_on_random_class_streams(cls, idx0):
    """The port's machine equals the reference's on arbitrary class
    streams, pads included (sustain 3, cool 2: short enough that random
    runs escalate and de-escalate)."""
    sustain_n, cool_n = 3, 2
    c = np.asarray(cls, np.int8)
    carry, levels = ttel.escalation_scan(
        torch.as_tensor(c)[None], idx0, ttel.escalation_init(1),
        sustain_n=sustain_n, cool_n=cool_n)
    (lv, ab, be, de), lj = jtel.escalation_scan(
        jnp.asarray(c), jnp.int32(idx0), jtel.escalation_init(),
        sustain_n=sustain_n, cool_n=cool_n)
    np.testing.assert_array_equal(levels[0].numpy(), np.asarray(lj))
    assert carry[0].tolist() == [int(lv), int(ab), int(be), int(de)]
    assert int(levels.max()) <= 3 and int(levels.min()) >= 0


if __name__ == "__main__":
    for name, pair in (("gpu floor", _floor_pair), ("battery", _battery_pair)):
        out, aux, ref, aux_j, w = pair()
        gap = np.abs(out.numpy() - np.asarray(ref)).max() / np.abs(w).max()
        eo = np.abs(aux["energy_overhead"].numpy()
                    - np.asarray(aux_j["energy_overhead"])).max()
        print(f"{name}: output gap {gap:.3g} of max |w|, "
              f"energy_overhead gap {eo:.3g}")
