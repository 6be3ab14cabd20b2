"""Tests of the PyTorch port that need an NVIDIA GPU.

They live outside ``tests/`` because that directory's ``conftest.py`` sets
up JAX, which the GPU machine does not have; nothing here imports JAX or
``hyperopt_tpu``.  This directory exists only to run on the card, so a
missing card fails every test here instead of skipping it.  Run from the
repository root::

    python -m pytest tests_torch_cuda -q -p no:cacheprovider

(``chip_smoke.py`` runs it as one of its phases.)
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


@pytest.fixture(autouse=True)
def _needs_the_card():
    if not torch.cuda.is_available():
        pytest.fail("tests_torch_cuda runs on an NVIDIA GPU only: "
                    "torch.cuda.is_available() is false")
