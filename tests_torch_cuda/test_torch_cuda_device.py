"""Device mode on the card (the CPU half: ``tests/test_torch_device.py``)."""

import numpy as np
import pytest

import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import device, tpe

SPACE_QUAD = {"x": ht.hp.uniform("x", -5, 5)}


@pytest.mark.cuda
def test_capture_failure_names_the_contract():
    """On the card an objective that reads a value back breaks the capture
    and raises CaptureError with the objective contract; nothing runs on
    eagerly."""
    with pytest.raises(device.CaptureError, match="no .item()"):
        ht.fmin(lambda p: p["x"] * float(p["x"].item()), SPACE_QUAD,
                algo=tpe.suggest, max_evals=8, trials=ht.Trials(),
                rstate=np.random.default_rng(0), show_progressbar=False,
                mode="device")
