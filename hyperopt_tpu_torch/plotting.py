"""Matplotlib views of an experiment, after the fact.

Counterpart of ``hyperopt_tpu/plotting.py``: ``main_plot_history`` (loss by
trial), ``main_plot_histogram`` (the losses' distribution) and
``main_plot_vars`` (loss against each parameter), from the dense history.
matplotlib is imported at the first plot, not with the package (nothing
on the card's path needs it), with the Agg backend when no display is set.
"""

from __future__ import annotations

import os

import numpy as np

from .base import JOB_STATE_DONE, STATUS_OK, Trials


def _plt():
    import matplotlib

    if not os.environ.get("DISPLAY") and os.name != "nt":
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _ok_losses(trials: Trials):
    xs, ys = [], []
    for t in trials:
        r = t["result"]
        if t["state"] == JOB_STATE_DONE and r.get("status") == STATUS_OK \
                and r.get("loss") is not None:
            xs.append(t["tid"])
            ys.append(float(r["loss"]))
    return np.asarray(xs), np.asarray(ys)


def main_plot_history(trials, do_show=True, status_colors=None,
                      title="Loss History"):
    """Loss vs trial id, with the running best overlaid
    (reference: plotting.py::main_plot_history)."""
    plt = _plt()
    xs, ys = _ok_losses(trials)
    fig, ax = plt.subplots()
    ax.scatter(xs, ys, s=12, alpha=0.6, label="trial loss")
    if len(ys):
        ax.plot(xs, np.minimum.accumulate(ys), color="C1", lw=1.5,
                label="best so far")
        best = ys.min()
        ax.axhline(best, ls=":", color="C1", alpha=0.5)
    ax.set_xlabel("trial")
    ax.set_ylabel("loss")
    ax.set_title(title)
    ax.legend()
    if do_show:
        plt.show()
    return ax


def main_plot_histogram(trials, do_show=True, title="Loss Histogram"):
    """Histogram of finished-trial losses
    (reference: plotting.py::main_plot_histogram)."""
    plt = _plt()
    _, ys = _ok_losses(trials)
    fig, ax = plt.subplots()
    ax.hist(ys, bins=min(30, max(3, len(ys) // 3 or 3)))
    ax.set_xlabel("loss")
    ax.set_ylabel("count")
    ax.set_title(title)
    if do_show:
        plt.show()
    return ax


def main_plot_vars(trials, domain=None, space=None, do_show=True,
                   colorize_best=10, columns=5):
    """Per-hyperparameter scatter of value vs loss — the at-a-glance
    sensitivity view (reference: plotting.py::main_plot_vars).

    One panel per parameter; the ``colorize_best`` lowest-loss trials are
    highlighted.  Conditional parameters only show trials where they were
    active (ragged idxs/vals in the reference; the activity mask here).
    """
    plt = _plt()
    if domain is not None:
        cs = domain.cs
    elif space is not None:
        from .space import compile_space
        cs = compile_space(space)
    else:
        raise ValueError("pass domain= or space=")
    h = trials.history(cs)
    ok = h["ok"]
    loss = h["loss"]
    best_cut = np.sort(loss[ok])[:colorize_best][-1] if ok.any() else np.inf

    n = cs.n_params
    cols = min(columns, max(n, 1))
    rows = -(-n // cols) if n else 1
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 2.5 * rows),
                             squeeze=False)
    for spec in cs.params:
        ax = axes[spec.pid // cols][spec.pid % cols]
        m = ok & h["active"][:, spec.pid]
        v = h["vals"][m, spec.pid]
        l = loss[m]
        is_best = l <= best_cut
        ax.scatter(v[~is_best], l[~is_best], s=8, alpha=0.5)
        ax.scatter(v[is_best], l[is_best], s=14, color="C1")
        ax.set_title(spec.label, fontsize=9)
        if spec.is_log:
            ax.set_xscale("log")
    for i in range(n, rows * cols):
        axes[i // cols][i % cols].axis("off")
    fig.tight_layout()
    if do_show:
        plt.show()
    return axes
