"""The port's device-resident history ring (``hyperopt_tpu_torch/history.py``),
mirroring ``tests/test_history.py``.

* Buffer equality: after appends, a bucket rollover, a fantasy overlay and
  a deleted prefix, the ring's tensors equal ``tpe._padded_history`` of
  the same history bit for bit.
* Order contract: a reordered prefix raises ``HistoryOrderError``; a
  deletion or a mid-history insert rebuilds once.
* Seeded parity: ``fmin`` with ``resident=True`` and ``resident=False``
  gives byte-equal trial histories, single and batched, with in-flight
  trials and after a deleted trial.
* Transfer contract: the steady per-trial upload is O(P) bytes, not
  O(n_cap·P).
* Multi-slot fantasy overlay: against JAX's ``history.device_history``
  bit for bit, with the rows past the bucket clipped and counted alike.
"""

import copy
from functools import partial

import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu import history as hj_hist
from hyperopt_tpu.obs.metrics import registry as hj_registry
from hyperopt_tpu_torch import history as rhist
from hyperopt_tpu_torch import tpe
from hyperopt_tpu_torch.space import compile_space
from hyperopt_tpu_torch.tpe import _padded_history

hp = ht.hp
SPACE = {
    "x": hp.uniform("x", -5, 5),
    "lr": hp.loguniform("lr", -4, 0),
    "c": hp.choice("c", [
        {"kind": 0},
        {"kind": 1, "depth": hp.quniform("depth", 1, 8, 1)},
    ]),
}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _obj(p):
    loss = p["x"] ** 2 + abs(np.log(p["lr"]) + 2.0)
    if p["c"]["kind"] == 1:
        loss += 0.1 * p["c"]["depth"]
    return float(loss)


def _run(resident, seed, max_evals, trials=None, **fmin_kw):
    t = trials if trials is not None else ht.Trials()
    ht.fmin(_obj, SPACE, algo=partial(tpe.suggest, n_EI_candidates=24,
                                      resident=resident),
            max_evals=max_evals, trials=t, rstate=np.random.default_rng(seed),
            show_progressbar=False, device="cpu", **fmin_kw)
    return t


def _assert_parity(t_a, t_b):
    cs = compile_space(SPACE)
    ha, hb = t_a.history(cs), t_b.history(cs)
    for k in ("vals", "active", "loss"):
        np.testing.assert_array_equal(ha[k], hb[k])


class _T:   # weakref-able stand-in for a Trials object
    pass


def _h(rng, n, p, tids=None):
    vals = rng.standard_normal((n, p)).astype(np.float32)
    active = rng.random((n, p)) < 0.8
    vals[~active] = 0.0
    loss = rng.standard_normal(n).astype(np.float32)
    ok = rng.random(n) < 0.9
    loss[~ok] = np.inf
    tids = np.arange(n) if tids is None else tids
    return dict(vals=vals, active=active, loss=loss, ok=ok,
                tids=np.asarray(tids, np.int64))


def _ring(trials, cs, h, cap, fant=None):
    return rhist.device_history(trials, cs, h, cap, fantasies=fant,
                                device="cpu")


def _check(trials, cs, h, cap, fant=None):
    got = _ring(trials, cs, h, cap, fant)
    if fant is not None:
        pv, pa, lie = fant
        h = dict(vals=np.concatenate([h["vals"], pv]),
                 active=np.concatenate([h["active"], pa]),
                 loss=np.concatenate([h["loss"],
                                      np.full(len(pv), lie, np.float32)]),
                 ok=np.concatenate([h["ok"], np.ones(len(pv), bool)]))
    for g, w in zip(got, _padded_history(h, cap)):
        assert g.dtype == torch.as_tensor(w).dtype
        np.testing.assert_array_equal(g.numpy(), w)


def _grown(rng, h, n):
    """``h`` with ``n - len(h)`` more rows after its own."""
    p = h["vals"].shape[1]
    more = _h(rng, n - len(h["tids"]), p, tids=np.arange(len(h["tids"]), n))
    return {k: np.concatenate([h[k], more[k]]) for k in h}


def test_append_rollover_overlay_and_rebuild_equal_padded_history(rng):
    trials, cs, p = _T(), object(), 4
    h = _h(rng, 5, p)
    r0, a0 = rhist.rebuilds, rhist.append_hits
    _check(trials, cs, h, 32)                       # cold: one rebuild
    assert rhist.rebuilds == r0 + 1
    h8 = _grown(rng, h, 8)
    b0 = rhist.upload_bytes
    _check(trials, cs, h8, 32)                      # delta append
    assert rhist.append_hits == a0 + 1 and rhist.rebuilds == r0 + 1
    assert rhist.upload_bytes - b0 == 3 * rhist._row_bytes(p)

    fant = (rng.standard_normal((2, p)).astype(np.float32),
            np.ones((2, p), bool), np.float32(0.25))
    _check(trials, cs, h8, 32, fant)                # overlay on a copy
    _check(trials, cs, h8, 32)                      # ... the ring is clean

    b0 = rhist.upload_bytes
    rhist.pregrow(trials, cs, 64, device="cpu")     # rollover pad-copy
    _check(trials, cs, h8, 32)                      # a view of the first 32
    h40 = _grown(rng, h8, 40)
    _check(trials, cs, h40, 64)                     # appends past row 32
    assert rhist.rebuilds == r0 + 1
    assert rhist.upload_bytes - b0 == 32 * rhist._row_bytes(p)

    _check(trials, cs, h40, 128)                    # growth on the request
    assert rhist.rebuilds == r0 + 1

    bad = {k: v[1:] for k, v in h40.items()}        # deleted first row
    _check(trials, cs, bad, 64)
    assert rhist.rebuilds == r0 + 2


def test_forget_drops_state_and_bumps_generation(rng):
    trials, cs = _T(), object()
    h = _h(rng, 3, 2)
    r0, g0 = rhist.rebuilds, rhist.generation(trials)
    _check(trials, cs, h, 32)
    rhist.forget(trials)
    assert rhist.generation(trials) == g0 + 1
    _check(trials, cs, h, 32)
    assert rhist.rebuilds == r0 + 2


def test_fantasies_that_do_not_fit_raise(rng):
    """Fantasy rows past the bucket are clipped and counted, as in the JAX
    package (they raised here before the multi-slot overlay); history rows
    that do not fit the bucket still raise."""
    trials, cs = _T(), object()
    h = _h(rng, 30, 2)
    fant = (np.ones((3, 2), np.float32), np.ones((3, 2), bool), 0.5)
    c0 = rhist.fantasy_clipped
    vals, _, loss, ok = _ring(trials, cs, h, 32, fant)
    assert rhist.fantasy_clipped == c0 + 1
    np.testing.assert_array_equal(vals[30:].numpy(), np.ones((2, 2)))
    assert loss[30:].tolist() == [0.5, 0.5] and ok[30:].all()
    with pytest.raises(ValueError):
        _ring(trials, cs, _h(rng, 40, 2), 32)


def _jax_ring(trials, cs, h, cap, fant):
    out = hj_hist.device_history(trials, cs, h, cap, fantasies=fant)
    return [np.asarray(a) for a in out]


def _jax_clipped():
    return hj_registry().snapshot()["counters"].get(
        "history.fantasy_clipped", 0.0)


def _slots(rng, sizes, p):
    return [(rng.standard_normal((m, p)).astype(np.float32),
             rng.random((m, p)) < 0.7, np.float32(rng.standard_normal()))
            for m in sizes]


@pytest.mark.parametrize("sizes", [(10, 8, 20), (16, 8, 5), (3, 30)])
def test_multi_slot_overlay_matches_jax(rng, sizes):
    """1,000 rows in the 1,024 bucket and 2 to 3 fantasy slots, the last
    running past the bucket (or starting past it): the same tensors as
    JAX's ``history.device_history`` bit for bit, and the same count of
    clipped rows."""
    p, n, cap = 5, 1000, 1024
    h = _h(rng, n, p)
    slots = _slots(rng, sizes, p)
    room = cap - n
    clipped = max(0, sum(sizes) - room)
    cj, ct = _jax_clipped(), rhist.fantasy_clipped
    want = _jax_ring(hj.Trials(), object(), h, cap, slots)
    got = _ring(ht.Trials(), object(), h, cap, slots)
    assert _jax_clipped() - cj == rhist.fantasy_clipped - ct == clipped > 0
    for g, w in zip(got, want):
        assert g.dtype == torch.as_tensor(w).dtype
        np.testing.assert_array_equal(g.numpy(), w)
    # The ring itself stays clean for the next append.
    _check(ht.Trials(), object(), h, cap)


def test_single_slot_overlay_is_unchanged(rng):
    """One slot as a tuple or a one-element list: the single-slot result
    the ring gave before (``_padded_history`` of the rows and the
    fantasies), equal to JAX's."""
    p, n, cap = 5, 1000, 1024
    h = _h(rng, n, p)
    (fant,) = _slots(rng, (7,), p)
    trials, cs = _T(), object()
    _check(trials, cs, h, cap, fant)
    single = [t.numpy() for t in _ring(trials, cs, h, cap, fant)]
    listed = [t.numpy() for t in _ring(trials, cs, h, cap, [fant])]
    want = _jax_ring(hj.Trials(), object(), h, cap, fant)
    for a, b, w in zip(single, listed, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, w)


def test_reorder_raises_loudly(rng):
    trials, cs = _T(), object()
    h = _h(rng, 6, 3)
    _ring(trials, cs, h, 16)
    swapped = {k: v.copy() for k, v in h.items()}
    swapped["tids"][2], swapped["tids"][4] = h["tids"][4], h["tids"][2]
    with pytest.raises(rhist.HistoryOrderError):
        _ring(trials, cs, swapped, 16)


@pytest.mark.parametrize("tids_after", [[0, 2, 3, 4, 6, 8], [2, 4, 6, 8]])
def test_insert_or_deletion_rebuilds_without_raising(rng, tids_after):
    trials, cs = _T(), object()
    _ring(trials, cs, _h(rng, 5, 3, tids=[0, 2, 4, 6, 8]), 16)
    r0 = rhist.rebuilds
    h = _h(rng, len(tids_after), 3, tids=tids_after)
    _check(trials, cs, h, 16)
    assert rhist.rebuilds == r0 + 1


def test_seeded_parity_single_with_rollover():
    # 40 evals cross the 32 -> 64 bucket boundary past startup.
    _assert_parity(_run(False, 11, 40), _run(True, 11, 40))


def test_seeded_parity_batched():
    _assert_parity(_run(False, 12, 44, max_queue_len=4),
                   _run(True, 12, 44, max_queue_len=4))


def test_seeded_parity_with_inflight_trials():
    """NEW trials in the log enter as fantasy rows: an overlay on a copy in
    the ring, a host concat otherwise; the proposals are the same."""
    base = _run(True, 13, 26)
    cs = compile_space(SPACE)
    cs.device = "cpu"
    domain = ht.Domain(_obj, cs)
    pending = tpe.suggest(base.new_trial_ids(3), domain, base, 5,
                          n_EI_candidates=24)
    base.insert_trial_docs(pending)
    base.refresh()
    assert len(base.inflight(cs)[0]) == 3
    got = [tpe.suggest_batch(base.new_trial_ids(n), domain, base, 9,
                             n_EI_candidates=24, resident=r)[0]
           for n in (1, 4) for r in (True, False)]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[2], got[3])


def test_prefix_mismatch_falls_back_and_stays_correct():
    t = _run(True, 14, 30)
    with t._lock:
        del t._dynamic_trials[7]
    t.refresh()
    docs = copy.deepcopy(list(t._dynamic_trials))
    r0 = rhist.rebuilds
    t = _run(True, 77, 34, trials=t)
    assert rhist.rebuilds == r0 + 1
    t2 = _run(False, 77, 34, trials=ht.trials_from_docs(docs))
    _assert_parity(t2, t)


def test_cold_loop_rebuilds_at_most_once():
    # 44 evals = 20 startup + 24 TPE steps: the first step rebuilds (first
    # touch), the other 23 append.
    r0, a0 = rhist.rebuilds, rhist.append_hits
    _run(True, 31, 44)
    assert rhist.rebuilds - r0 <= 1
    assert rhist.append_hits - a0 == 23


def test_steady_state_upload_is_o_p():
    """Once warm, each trial uploads one row (P·4 vals + P active + 5 for
    loss and ok), not the whole n_cap·(5P + 5)-byte bucket."""
    t = _run(True, 21, 40)
    b0, r0 = rhist.upload_bytes, rhist.rebuilds
    _run(True, 22, 60, trials=t)
    delta = rhist.upload_bytes - b0
    assert rhist.rebuilds == r0
    p = compile_space(SPACE).n_params
    assert delta == 20 * rhist._row_bytes(p), delta
