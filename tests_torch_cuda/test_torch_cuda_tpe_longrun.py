"""The two bucket ladders of ``tests/torch_ladders.py`` on the card: hosted
TPE runs whose history crosses the 32 → 1,024 buckets (and, in batches of
8, the 32 → 512 buckets), K1 once per TPE step."""

import os
import sys

import pytest

from hyperopt_tpu_torch import tpe
from hyperopt_tpu_torch.ops import ei_scores as ek

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))
from torch_ladders import (  # noqa: E402
    batched_bucket_ladder, thousand_trials_bucket_ladder)


@pytest.mark.cuda
def test_thousand_trials_bucket_ladder():
    ek.reset_launches()
    thousand_trials_bucket_ladder("cuda")
    assert ek.ei_scores.launches_by["f32"] == \
        1050 - tpe._default_n_startup_jobs


@pytest.mark.cuda
def test_batched_bucket_ladder(monkeypatch):
    ek.reset_launches()
    batches = batched_bucket_ladder("cuda", monkeypatch)
    # One K1 launch per liar step: 8 per batch past startup.
    assert ek.ei_scores.launches_by["f32"] == 8 * batches
