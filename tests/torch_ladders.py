"""The two bucket ladders of the port's long-run TPE tests, one copy for
the CPU (``tests/test_torch_tpe_longrun.py``) and the card
(``tests_torch_cuda/test_torch_cuda_tpe_longrun.py``, which adds its K1
launch counts).  It imports neither JAX nor the JAX package."""

import numpy as np
import torch

from hyperopt_tpu_torch import Trials, fmin, hp, tpe
from hyperopt_tpu_torch.space import compile_space


def ladder_space():
    return {"x": hp.uniform("x", -3, 3), "y": hp.normal("y", 0, 2)}


def ladder_loss(d):
    return (d["x"] - 1) ** 2 + 0.3 * d["y"] ** 2


def _algo(*a, **kw):
    return tpe.suggest(*a, n_EI_candidates=16, **kw)


def thousand_trials_bucket_ladder(device):
    """1,050 trials in one experiment: the history crosses the 32 → 1,024
    buckets with one kernel per bucket (and perhaps the 2,048 prewarm),
    and late proposals concentrate near the optimum.  Returns the
    trials."""
    space = ladder_space()
    cs = compile_space(space)
    t = Trials()
    fmin(ladder_loss, space, algo=_algo, max_evals=1050, trials=t,
         rstate=np.random.default_rng(0), show_progressbar=False,
         device=device)
    assert len(t) == 1050
    kind = torch.device(device).type
    caps = sorted({k.n_cap for k in getattr(cs, "_tpe_kernels", {}).values()
                   if k.n_cand == 16 and k.device.type == kind})
    assert caps[0] <= 32 and 1024 <= caps[-1] <= 2048, caps
    assert len(caps) <= 7, caps
    best = t.best_trial["result"]["loss"]
    assert best < 0.01, best
    late = [d["misc"]["vals"]["x"][0] for d in list(t)[-100:]]
    assert abs(np.median(late) - 1.0) < 0.5
    return t


def batched_bucket_ladder(device, monkeypatch):
    """320 trials at ``max_queue_len=8`` across the 32 → 512 buckets: every
    liar batch runs ``m = 8`` steps (the bucket sized for its fantasy
    rows), and the run stays healthy.  Returns the number of liar
    batches."""
    sizes = []
    real = tpe._batch_size_for

    def spy(n):
        m = real(n)
        sizes.append((n, m))
        return m

    monkeypatch.setattr(tpe, "_batch_size_for", spy)
    t = Trials()
    fmin(ladder_loss, ladder_space(), algo=_algo, max_evals=320,
         max_queue_len=8, trials=t, rstate=np.random.default_rng(0),
         show_progressbar=False, device=device)
    assert len(t) == 320
    batches = [m for n, m in sizes if n > 1]
    assert set(batches) == {8}, sorted(set(sizes))
    assert t.best_trial["result"]["loss"] < 0.05
    return len(batches)
