"""The Study comparison of test_torch_study.py in bucket mode: one batch
per waveform length, so no row is padded and the monitor sees each row's
true length."""
import pytest

pytest.importorskip("torch")

from test_torch_study import check_study_matches_reference  # noqa: E402
from test_torch_study import studies  # noqa: E402,F401  (the fixture)


def test_study_matches_reference_bucketed(studies):  # noqa: F811
    check_study_matches_reference(studies, "bucket")
