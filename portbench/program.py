"""What the benchmark takes from the program (``hyperopt_tpu_torch``): its
public entry points, its trial documents and its registry counters.  The
drivers reach the program through here only; the reference never does.
"""

from __future__ import annotations

import numpy as np

import hyperopt_tpu_torch as ho
from hyperopt_tpu_torch import base, hp, tpe
from hyperopt_tpu_torch.obs import metrics as _metrics
from hyperopt_tpu_torch.space import compile_space


Trials = ho.Trials
Domain = base.Domain
DONE = base.JOB_STATE_DONE
fmin = ho.fmin

#: Registry counters the per-layer metrics read (their deltas over the
#: measured window).
COUNTERS = ("suggest.dispatch_ms", "history.upload_bytes")


def build_space(builder, n_dims):
    """The program's space from a space builder (``spaces/<name>.py``)."""
    return builder.build(hp, n_dims)


def compiled(space):
    return compile_space(space)


def counters():
    """The registry counters of :data:`COUNTERS`, now."""
    reg = _metrics.registry()
    return {name: reg.counter(name).value for name in COUNTERS}


def history_docs(ps, vals, live, loss, tids):
    """Finished trial documents (``state`` DONE, ``status`` ok) for rows of a
    plain history: ``vals``/``live`` ``{label: array[n]}``, ``loss[n]``."""
    docs = []
    for i, tid in enumerate(tids):
        doc = base.new_trial_doc(int(tid))
        idxs, vd = {}, {}
        for p in ps:
            lab = p["label"]
            if live[lab][i]:
                v = float(vals[lab][i])
                idxs[lab] = [int(tid)]
                vd[lab] = [int(round(v)) if p["kind"] in
                           ("choice", "uniformint") else v]
            else:
                idxs[lab], vd[lab] = [], []
        doc["misc"]["idxs"], doc["misc"]["vals"] = idxs, vd
        doc["state"] = base.JOB_STATE_DONE
        doc["result"] = {"loss": float(loss[i]), "status": base.STATUS_OK}
        docs.append(doc)
    return docs


def trials_with(docs):
    """A fresh ``Trials`` holding ``docs`` (each copied one level deep)."""
    trials = Trials()
    trials.insert_trial_docs([dict(d, misc=dict(d["misc"])) for d in docs])
    trials.refresh()
    return trials


def plain_rows(ps, docs):
    """Trial documents as a plain history in tid order: ``{"tids", "vals":
    {label: f32[n]}, "active": {label: bool[n]}, "loss": f32[n] (as the
    program's history holds it), "raw_loss": f64[n] (as recorded), "ok":
    bool[n], "done": bool[n]}``; a missing value reads 0, a missing loss
    +inf."""
    docs = sorted(docs, key=lambda d: d["tid"])
    n = len(docs)
    vals = {p["label"]: np.zeros(n, np.float32) for p in ps}
    live = {p["label"]: np.zeros(n, bool) for p in ps}
    loss = np.full(n, np.inf, np.float32)
    raw = np.full(n, np.inf, np.float64)
    ok = np.zeros(n, bool)
    done = np.zeros(n, bool)
    for i, d in enumerate(docs):
        mv = d["misc"]["vals"]
        for lab in vals:
            v = mv.get(lab) or []
            if v:
                vals[lab][i] = v[0]
                live[lab][i] = True
        done[i] = d["state"] == base.JOB_STATE_DONE
        res = d.get("result") or {}
        if done[i] and res.get("status") == base.STATUS_OK \
                and res.get("loss") is not None \
                and np.isfinite(res["loss"]):
            loss[i] = raw[i] = res["loss"]
            ok[i] = True
    return {"tids": np.asarray([d["tid"] for d in docs], np.int64),
            "vals": vals, "active": live, "loss": loss, "raw_loss": raw,
            "ok": ok, "done": done}


def labels(cs):
    """The program's column labels, in its column order."""
    return [p.label for p in cs.params]


__all__ = ["COUNTERS", "DONE", "Domain", "Trials", "build_space",
           "compiled", "counters", "fmin",
           "history_docs", "labels", "plain_rows",
           "tpe", "trials_with"]
