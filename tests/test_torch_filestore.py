"""The PyTorch port's file store against hyperopt_tpu's.

Mirrors ``tests/test_parallel.py::TestFileStore`` case by case on the
port (worker threads where the JAX test uses threads, worker processes
through ``python -m hyperopt_tpu_torch.parallel.filestore`` where it uses
processes, everything on the CPU), and adds:

* the layout across packages: a store written by JAX's ``FileTrials``
  reads back through the port's with the same tids, states, results and
  misc, and the reverse;
* the fault schedule as a worker argument.

This module imports JAX only inside the cross-package test: the worker
processes import it to unpickle ``_quad``.
"""

import os
import pickle
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import JOB_STATE_DONE, JOB_STATE_ERROR, JOB_STATE_NEW
from hyperopt_tpu_torch import Trials, fmin, hp, rand
from hyperopt_tpu_torch.base import Domain
from hyperopt_tpu_torch.parallel import FileTrials, FileWorker
from hyperopt_tpu_torch.parallel.filestore import _FileAttachments

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _quad_space():
    return {"x": hp.uniform("x", -5, 5)}


def _quad(d):
    return (d["x"] - 3.0) ** 2


def _domain(fn=_quad):
    dom = Domain(fn, _quad_space())
    dom.cs.device = CPU
    return dom


def _worker_env():
    return dict(os.environ, PYTHONPATH=f"{ROOT}:{ROOT / 'tests'}",
                OMP_NUM_THREADS="1")


def _cli(root, *extra):
    return [sys.executable, "-m", "hyperopt_tpu_torch.parallel.filestore",
            "--root", root, "--exp-key", "e1", *extra]


def test_workers_drain_queue(tmp_path):
    root = str(tmp_path)
    dom = _domain()
    ft = FileTrials(root, exp_key="e1")
    workers = [FileWorker(root, exp_key="e1", domain=dom,
                          poll_interval=0.01, reserve_timeout=5)
               for _ in range(3)]
    threads = [threading.Thread(target=w.run) for w in workers]
    for th in threads:
        th.start()
    fmin(_quad, _quad_space(), algo=rand.suggest, max_evals=24, trials=ft,
         rstate=np.random.default_rng(0), show_progressbar=False,
         device=CPU)
    for th in threads:
        th.join()
    ft.refresh()
    assert len(ft) == 24
    assert all(d["state"] == JOB_STATE_DONE for d in ft)
    assert all(d["owner"] for d in ft)


def test_atomic_claim_no_double_evaluation(tmp_path):
    root = str(tmp_path)
    dom = _domain()
    ft = FileTrials(root, exp_key="e1")
    ft.insert_trial_docs(rand.suggest(ft.new_trial_ids(10), dom, ft, 0))
    counts = {}
    lock = threading.Lock()

    class CountingWorker(FileWorker):
        def run_one(self):
            doc = self.trials.reserve(self.owner)
            if doc is None:
                return False
            with lock:
                counts[doc["tid"]] = counts.get(doc["tid"], 0) + 1
            doc["state"] = JOB_STATE_DONE
            doc["result"] = {"status": "ok", "loss": 1.0}
            self.trials.write_result(doc, owner=self.owner)
            return True

    ws = [CountingWorker(root, exp_key="e1", domain=dom, poll_interval=0.005,
                         reserve_timeout=1) for _ in range(6)]
    threads = [threading.Thread(target=w.run) for w in ws]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert sorted(counts) == list(range(10))
    assert all(c == 1 for c in counts.values()), counts


def test_atomic_claim_across_processes(tmp_path):
    """The exclusive-create claim holds across OS processes: the union of
    the trials three worker processes win is the job set, each once."""
    root = str(tmp_path)
    dom = _domain()
    ft = FileTrials(root, exp_key="e1")
    ft.save_domain(dom)
    ft.insert_trial_docs(rand.suggest(ft.new_trial_ids(30), dom, ft, 0))
    procs = [subprocess.Popen(
        _cli(root, "--reserve-timeout", "3", "--poll-interval", "0.01"),
        env=_worker_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for _ in range(3)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
    ft.refresh()
    assert len(ft) == 30
    assert all(d["state"] == JOB_STATE_DONE for d in ft)
    for d in ft:
        with open(ft._claim_path(d["tid"])) as f:
            assert f.read() == d["owner"]


def test_requeue_stale_and_ownership_fencing(tmp_path):
    root = str(tmp_path)
    dom = _domain()
    ft = FileTrials(root, exp_key="e1")
    ft.insert_trial_docs(rand.suggest(ft.new_trial_ids(1), dom, ft, 0))
    a = FileWorker(root, exp_key="e1", domain=dom)
    doc_a = a.trials.reserve(a.owner)
    assert doc_a is not None
    time.sleep(0.1)
    assert ft.requeue_stale(timeout=0.05) == 1
    ft.refresh()
    assert ft.trials[0]["state"] == JOB_STATE_NEW
    b = FileWorker(root, exp_key="e1", domain=dom)
    assert b.run_one() is True
    doc_a["state"] = JOB_STATE_DONE
    doc_a["result"] = {"status": "ok", "loss": 999.0}
    assert a.trials.write_result(doc_a, owner=a.owner) is False
    ft.refresh()
    assert ft.trials[0]["result"]["loss"] != 999.0


def test_worker_failure_isolation(tmp_path):
    root = str(tmp_path)

    def boom(d):
        raise RuntimeError("boom")

    dom = _domain(boom)
    ft = FileTrials(root, exp_key="e1")
    ft.insert_trial_docs(rand.suggest(ft.new_trial_ids(5), dom, ft, 0))
    w = FileWorker(root, exp_key="e1", domain=dom, poll_interval=0.01,
                   reserve_timeout=0.5, max_consecutive_failures=3)
    assert w.run() == 0
    ft.refresh()
    assert sum(1 for d in ft if d["state"] == JOB_STATE_ERROR) == 3


def test_cli_worker_subprocess(tmp_path):
    """The worker's entry point (``hyperopt-tpu-torch-worker``) evaluates
    jobs from the pickled domain."""
    root = str(tmp_path)
    dom = _domain()
    ft = FileTrials(root, exp_key="e1")
    ft.save_domain(dom)
    ft.insert_trial_docs(rand.suggest(ft.new_trial_ids(4), dom, ft, 0))
    proc = subprocess.run(
        _cli(root, "--reserve-timeout", "2", "--poll-interval", "0.05"),
        env=_worker_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    ft.refresh()
    assert all(d["state"] == JOB_STATE_DONE for d in ft)


class _NoTensors(pickle.Unpickler):
    """Refuses every torch tensor or storage in a pickle."""

    def find_class(self, module, name):
        if module.startswith("torch"):
            raise AssertionError(f"the pickle holds {module}.{name}")
        return super().find_class(module, name)


def test_domain_pickles_with_kernel_laden_shared_space(tmp_path):
    """The compiled space is shared (``compile_space`` memoizes): the
    sharded kernels (with their mesh and process groups), the anneal and
    TPE kernels and the sampler's device constants on it must not ride
    the domain's pickle, which then holds no tensor at all, so a worker
    without a card loads a domain saved by a driver on one."""
    import torch.distributed as dist

    from hyperopt_tpu_torch import anneal, dispatch
    from hyperopt_tpu_torch.parallel import sharded_suggest

    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        mesh = dispatch.default_mesh(device_type=CPU)
        fmin(_quad, _quad_space(),
             algo=lambda *a: sharded_suggest(*a, mesh=mesh,
                                             n_EI_candidates=512),
             max_evals=25, trials=Trials(), rstate=np.random.default_rng(0),
             show_progressbar=False, device=CPU)
        fmin(_quad, _quad_space(), algo=anneal.suggest, max_evals=3,
             trials=Trials(), rstate=np.random.default_rng(0),
             show_progressbar=False, device=CPU)
    finally:
        if own:
            dist.destroy_process_group()
    dom = _domain()
    assert dom.cs._dispatch_kernels and dom.cs._dev_consts
    assert dom.cs._anneal_kernels
    ft = FileTrials(str(tmp_path), exp_key="e1")
    ft.save_domain(dom)
    dom2 = ft.load_domain()
    assert dom2.evaluate({"x": 1.0}, None)["loss"] == 4.0
    with open(os.path.join(ft._exp_dir, "domain.pkl"), "rb") as f:
        _NoTensors(f).load()
    vals, act = pickle.loads(pickle.dumps(dom)).cs.sample(
        4, generator=torch.Generator().manual_seed(0), device=CPU)
    assert tuple(vals.shape) == (4, 1)


def test_durable_attachments(tmp_path):
    root = str(tmp_path)

    def with_blob(d):
        return {"loss": d["x"] ** 2, "status": "ok",
                "attachments": {"blob": b"weights" + b"!" * 64,
                                "meta": {"nested": [1, 2.5, "s"]}}}

    dom = _domain(with_blob)
    ft = FileTrials(root, exp_key="e1")
    ft.insert_trial_docs(rand.suggest(ft.new_trial_ids(2), dom, ft, 0))
    w = FileWorker(root, exp_key="e1", domain=dom, poll_interval=0.01,
                   reserve_timeout=0.5)
    assert w.run() == 2
    ft.refresh()
    for doc in ft:
        att = ft.trial_attachments(doc)
        assert "blob" in att
        assert att["blob"].startswith(b"weights")
        assert att["meta"]["nested"] == [1, 2.5, "s"]
    ft2 = FileTrials(root, exp_key="e1")
    assert ft2.trial_attachments(ft2[0])["blob"].startswith(b"weights")
    ft.attachments["exp-note"] = "hello"
    assert ft2.attachments["exp-note"] == "hello"


def test_attachment_mapping_semantics(tmp_path):
    att = _FileAttachments(str(tmp_path / "att"))
    assert len(att) == 0 and list(att) == []
    att["plain"] = 1
    att["with/slash and space"] = {"v": 2}
    att["ATTACH::7::unicode-ключ"] = "v3"
    assert set(att) == {"plain", "with/slash and space",
                        "ATTACH::7::unicode-ключ"}
    assert att["with/slash and space"] == {"v": 2}
    assert "plain" in att and "missing" not in att
    with pytest.raises(KeyError):
        att["missing"]
    del att["plain"]
    assert "plain" not in att and len(att) == 2
    with pytest.raises(KeyError):
        del att["plain"]
    att.clear()
    assert len(att) == 0


def test_delete_all_wipes_store(tmp_path):
    root = str(tmp_path)
    dom = _domain()
    ft = FileTrials(root, exp_key="e1")
    ft.insert_trial_docs(rand.suggest(ft.new_trial_ids(3), dom, ft, 0))
    ft.attachments["note"] = 1
    ft.delete_all()
    assert len(ft) == 0 and "note" not in ft.attachments
    ft2 = FileTrials(root, exp_key="e1")
    assert len(ft2) == 0
    assert ft2.new_trial_ids(1) == [0]
    ft.attachments["post"] = 2
    assert FileTrials(root, exp_key="e1").attachments["post"] == 2


def test_resume_by_exp_key(tmp_path):
    root = str(tmp_path)
    dom = _domain()
    ft = FileTrials(root, exp_key="e1")
    ft.insert_trial_docs(rand.suggest(ft.new_trial_ids(3), dom, ft, 0))
    ft2 = FileTrials(root, exp_key="e1")
    assert len(ft2._dynamic_trials) == 3
    assert ft2.new_trial_ids(2) == [3, 4]
    assert len(FileTrials(root, exp_key="e2")) == 0


def test_fault_schedule_is_a_worker_argument(tmp_path):
    """``FileWorker(faults=)`` arms the schedule for the worker's run: one
    injected ``worker.evaluate`` fault, retried once in place."""
    from hyperopt_tpu_torch import faults

    root = str(tmp_path)
    dom = _domain()
    ft = FileTrials(root, exp_key="e1")
    ft.insert_trial_docs(rand.suggest(ft.new_trial_ids(3), dom, ft, 0))
    w = FileWorker(root, exp_key="e1", domain=dom, poll_interval=0.01,
                   reserve_timeout=0.3, max_trial_retries=1,
                   faults="worker.evaluate=1.0:1", faults_seed=3)
    try:
        assert w.run() == 3
        assert faults.injection_counts()["worker.evaluate"] == {
            "calls": 4, "fired": 1}
    finally:
        faults.clear()
    ft.refresh()
    assert all(d["state"] == JOB_STATE_DONE for d in ft)
    assert sorted(d["misc"].get("fail_count", 0) for d in ft) == [0, 0, 1]


def _canon(docs):
    """A store's documents without the parts each package stamps its own
    way (none are expected): what a reader compares."""
    keys = ("tid", "state", "result", "misc", "exp_key", "owner",
            "book_time", "refresh_time", "spec", "version")
    return [{k: d.get(k) for k in keys} for d in docs]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_store_layout_crosses_packages(tmp_path, writer):
    """Trials written (suggested, claimed, finished, one failed, one left
    NEW) by one package's ``FileTrials`` read back through the other's
    with the same tids, states, results and misc."""
    import hyperopt_tpu as hj
    from hyperopt_tpu.parallel import FileTrials as FileTrialsJ

    root = str(tmp_path)
    pkgs = {"jax": (hj, FileTrialsJ), "torch": (ht, FileTrials)}
    wp, WFT = pkgs[writer]
    rp, RFT = pkgs["torch" if writer == "jax" else "jax"]
    dom = wp.base.Domain(_quad, {"x": wp.hp.uniform("x", -5, 5),
                                 "c": wp.hp.choice("c", [1, 2, 3])})
    if writer == "torch":
        dom.cs.device = CPU
    ft = WFT(root, exp_key="e1")
    ft.insert_trial_docs(wp.rand.suggest(ft.new_trial_ids(5), dom, ft, 4))
    for k in range(4):
        doc = ft.reserve(f"w{k}")
        if k == 3:
            doc["state"] = wp.JOB_STATE_ERROR
            doc["misc"]["error"] = ["RuntimeError", "boom"]
        else:
            doc["state"] = wp.JOB_STATE_DONE
            doc["result"] = {"status": "ok", "loss": 0.5 * k}
        assert ft.write_result(doc, owner=f"w{k}")
    ft.attachments["note"] = {"k": [1, 2]}
    ft.refresh()
    back = RFT(root, exp_key="e1")
    assert back.tids == ft.tids == [0, 1, 2, 3, 4]
    assert _canon(back.trials) == _canon(ft.trials)
    assert [d["state"] for d in back] == [2, 2, 2, 3, 0]
    assert back.attachments["note"] == {"k": [1, 2]}
    assert back.new_trial_ids(1) == [5]
    assert [back.owns(d, f"w{d['tid']}") for d in back][:4] == [True] * 4
