"""``repro_torch.data.SyntheticLM`` against the reference's: the same
Philox ``(seed, step)`` stream, so each batch is equal bit for bit, with
and without ``host_slice``; and a restart at step k reads the batches of
an uninterrupted run."""
import dataclasses

import numpy as np
import pytest

from repro import configs as jcfgs
from repro.data import SyntheticLM as JSyntheticLM
from repro_torch import configs as tcfgs
from repro_torch.data import SyntheticLM


@pytest.mark.parametrize("host_slice", [None, (0, 3), (3, 2), (5, 3)])
@pytest.mark.parametrize("arch", ["granite-3-8b", "dbrx-132b"])
def test_batches_equal_the_references(arch, host_slice):
    jc = jcfgs.reduced(jcfgs.get_config(arch))
    tc = tcfgs.reduced(tcfgs.get_config(arch))
    for seed in (0, 7):
        ref = JSyntheticLM(jc, batch=8, seq=24, seed=seed,
                           host_slice=host_slice)
        got = SyntheticLM(tc, batch=8, seq=24, seed=seed,
                          host_slice=host_slice)
        for step in range(6):
            a, b = ref(step), got(step)
            assert list(a) == list(b)
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])


def test_full_vocab_and_slices_tile_the_global_batch():
    cfg = tcfgs.get_config("granite-3-8b")
    whole = SyntheticLM(cfg, batch=4, seq=64, seed=0)(3)
    parts = [SyntheticLM(cfg, batch=4, seq=64, seed=0, host_slice=(r, 2))(3)
             for r in (0, 2)]
    for k in whole:
        np.testing.assert_array_equal(
            whole[k], np.concatenate([p[k] for p in parts]))
    assert whole["tokens"].max() < cfg.vocab_size
    np.testing.assert_array_equal(whole["tokens"][:, 1:],
                                  whole["labels"][:, :-1])
    ref = JSyntheticLM(jcfgs.get_config("granite-3-8b"), batch=4, seq=64)(3)
    for k in whole:
        np.testing.assert_array_equal(whole[k], ref[k])


def test_unported_inputs_raise_naming_their_queue_item():
    cfg = dataclasses.replace(tcfgs.reduced(tcfgs.get_config(
        "granite-3-8b")), input_mode="embeddings")
    with pytest.raises(NotImplementedError, match="ROADMAP queue A"):
        SyntheticLM(cfg, batch=2, seq=8)(0)
