"""The PyTorch port's multi-process glue against hyperopt_tpu's.

Mirrors ``tests/test_multihost.py``: ``initialize()`` brings up a
world-1 gloo group and its ``(dp, sp)`` mesh on the CPU (in this process,
and over TCP in a process of its own), the driver and worker roles run as
real processes over a shared file store, a service URL routes both roles
through the network store (``NetTrials``/``NetWorker``; the exchange
passes the ``rpc.send`` fault point; a driver and a worker drain a run
over a ``StoreServer``), and a mesh of more than one rank handed to
``run_driver`` raises ``ValueError`` (two gloo ranks).
"""

import os
import socket
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hyperopt_tpu_torch import JOB_STATE_DONE, dispatch, hp
from hyperopt_tpu_torch.parallel import (FileTrials, FileWorker, NetTrials,
                                         multihost)

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def own_world():
    """This test brings the process group up itself; it is torn down
    after."""
    assert not dist.is_initialized()
    yield
    dispatch.clear_default_mesh()
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(script, timeout=180):
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(script)],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))


def _space():
    return {"x": hp.uniform("x", -5, 5), "y": hp.choice("y", [0.0, 1.0])}


def _objective(cfg):
    return (cfg["x"] - 2.0) ** 2 + cfg["y"]


class TestSingleProcess:
    def test_initialize_registers_a_world1_gloo_mesh(self, own_world):
        mesh = multihost.initialize(device=CPU)
        assert dist.get_backend() == "gloo"
        assert mesh.mesh_dim_names == ("dp", "sp")
        assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"
        assert dispatch.active_mesh() is mesh
        assert multihost.is_coordinator()
        # A group that is up is kept.
        again = multihost.initialize(device=CPU)
        assert dispatch._mesh_key(again) == dispatch._mesh_key(mesh)

    def test_initialize_over_tcp_in_its_own_process(self):
        port = _free_port()
        r = _run(f"""
            import torch.distributed as dist
            from hyperopt_tpu_torch import dispatch
            from hyperopt_tpu_torch.parallel import multihost
            mesh = multihost.initialize(init_method="tcp://127.0.0.1:{port}",
                                        world_size=1, rank=0, device="cpu")
            assert dist.get_world_size() == 1 and multihost.is_coordinator()
            assert dispatch.active_mesh() is mesh
            print("DISTRIBUTED_OK", tuple(mesh.shape))
        """)
        assert "DISTRIBUTED_OK (1, 1)" in r.stdout, r.stderr[-2000:]

    def test_run_driver_defaults_to_the_one_rank_mesh(self, own_world,
                                                       tmp_path):
        """No mesh and no group: the driver brings up its own world of
        one, and its TPE trials are sharded suggests."""
        from hyperopt_tpu_torch.obs.metrics import registry

        root = str(tmp_path / "store")
        FileTrials(root, exp_key="mh")
        worker = FileWorker(root, exp_key="mh", poll_interval=0.01,
                            reserve_timeout=3)
        th = threading.Thread(target=worker.run)
        th.start()
        c0 = registry().snapshot()["counters"].get("dispatch.sharded", 0)
        try:
            best = multihost.run_driver(
                _objective, _space(), store_root=root, exp_key="mh",
                max_evals=22, n_EI_candidates=64,
                rstate=np.random.default_rng(0), show_progressbar=False,
                device=CPU)
        finally:
            th.join()
        assert "x" in best
        assert dist.is_initialized() and dist.get_world_size() == 1
        sharded = registry().snapshot()["counters"]["dispatch.sharded"] - c0
        assert sharded == 2           # the two trials past startup
        ft = FileTrials(root, exp_key="mh")
        assert len(ft) == 22 and all(d["owner"] for d in ft)


class TestDriverWorkerRoles:
    def test_driver_and_worker_subprocesses(self, tmp_path):
        """One driver process (sharded suggest and enqueue over the store)
        and one worker process (evaluate)."""
        root = str(tmp_path / "store")
        worker = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(f"""
                from hyperopt_tpu_torch.parallel import multihost
                n = multihost.run_worker({root!r}, exp_key="mh",
                                         reserve_timeout=10.0,
                                         poll_interval=0.05)
                print("WORKER_DONE", n)
            """)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT),
                               OMP_NUM_THREADS="1"))
        try:
            driver = _run(f"""
                import numpy as np
                from hyperopt_tpu_torch import hp
                from hyperopt_tpu_torch.parallel import multihost

                def objective(cfg):
                    return (cfg["x"] - 2.0) ** 2 + cfg["y"]

                space = {{"x": hp.uniform("x", -5, 5),
                          "y": hp.choice("y", [0.0, 1.0])}}
                mesh = multihost.initialize(device="cpu")
                best = multihost.run_driver(
                    objective, space, store_root={root!r}, exp_key="mh",
                    max_evals=24, mesh=mesh, n_EI_candidates=64,
                    rstate=np.random.default_rng(0), device="cpu",
                    show_progressbar=False)
                assert "x" in best
                print("DRIVER_DONE", best["x"])
            """)
            assert "DRIVER_DONE" in driver.stdout, (
                driver.stdout[-2000:] + driver.stderr[-2000:])
        finally:
            try:
                out, _ = worker.communicate(timeout=90)
            except subprocess.TimeoutExpired:
                worker.kill()
                out, _ = worker.communicate()
        assert "WORKER_DONE" in out, out[-2000:]
        assert int(out.strip().splitlines()[-1].split()[-1]) == 24
        ft = FileTrials(root, exp_key="mh")
        losses = [loss for loss in ft.losses() if loss is not None]
        assert len(ft) == 24 and len(losses) == 24
        assert min(losses) < 10.0

    def test_multi_rank_mesh_is_refused_by_the_driver(self, tmp_path):
        port = _free_port()
        script = textwrap.dedent(f"""
            import sys
            import torch.distributed as dist
            from hyperopt_tpu_torch import dispatch, hp
            from hyperopt_tpu_torch.parallel import multihost
            rank = int(sys.argv[1])
            mesh = multihost.initialize(init_method="tcp://127.0.0.1:{port}",
                                        world_size=2, rank=rank,
                                        device="cpu")
            assert tuple(mesh.shape) == (1, 2)
            assert multihost.is_coordinator() == (rank == 0)
            try:
                multihost.run_driver(lambda d: d["x"],
                                     {{"x": hp.uniform("x", 0, 1)}},
                                     store_root={str(tmp_path)!r},
                                     max_evals=4, mesh=mesh)
            except ValueError as e:
                assert "mesh of one rank" in str(e)
                print("REFUSED", rank)
            dist.barrier()
            dist.destroy_process_group()
        """)
        procs = [subprocess.Popen(
            [sys.executable, "-c", script, str(r)], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        outs = [p.communicate(timeout=120)[0] for p in procs]
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0 and f"REFUSED {r}" in out, out[-2000:]


class TestServiceUrl:
    def test_service_url_discriminates_transport(self):
        assert multihost._is_service_url("http://store:8080")
        assert multihost._is_service_url("https://store")
        assert not multihost._is_service_url("/mnt/shared/exp")
        assert not multihost._is_service_url("gcs/exp")

    @pytest.mark.parametrize("role", ["driver", "worker"])
    def test_url_routes_to_the_network_store(self, role, monkeypatch):
        """A URL store_root builds the network store's client (with the
        driver's ``token`` and ``retries``), a path the file store's."""
        from hyperopt_tpu_torch.parallel import filestore, netstore

        created = []

        class _Stop(Exception):
            pass

        def fake(kind):
            def make(root, exp_key="default", **kw):
                created.append((kind, root, exp_key, kw))
                raise _Stop
            return make

        monkeypatch.setattr(netstore, "NetTrials", fake("net"))
        monkeypatch.setattr(netstore, "NetWorker", fake("net"))
        monkeypatch.setattr(filestore, "FileTrials", fake("file"))
        monkeypatch.setattr(filestore, "FileWorker", fake("file"))
        for root in ("http://127.0.0.1:9/", "/mnt/shared/exp"):
            with pytest.raises(_Stop):
                if role == "driver":
                    multihost.run_driver(_objective, _space(),
                                         store_root=root, exp_key="mh",
                                         max_evals=4, token="tok",
                                         retries=2)
                else:
                    multihost.run_worker(root, exp_key="mh", token="tok")
        if role == "driver":
            assert created == [
                ("net", "http://127.0.0.1:9/", "mh",
                 {"token": "tok", "retries": 2}),
                ("file", "/mnt/shared/exp", "mh", {})]
        else:
            assert created == [
                ("net", "http://127.0.0.1:9/", "mh", {"token": "tok"}),
                ("file", "/mnt/shared/exp", "mh", {"token": "tok"})]

    def test_exchange_crosses_rpc_send_fault_point(self):
        """The netstore-routed driver passes the ``rpc.send`` fault point
        before any socket IO: with it armed at probability 1 and no
        retries, the first exchange verb dies with the injected fault as
        the cause."""
        from hyperopt_tpu_torch import faults
        from hyperopt_tpu_torch.exceptions import (InjectedFault,
                                                   NetstoreUnavailable)

        faults.configure({"rpc.send": 1.0})
        try:
            with pytest.raises(NetstoreUnavailable) as ei:
                multihost.run_driver(_objective, _space(),
                                     store_root="http://127.0.0.1:9/",
                                     max_evals=4, retries=0,
                                     show_progressbar=False, verbose=False)
            assert isinstance(ei.value.__cause__, InjectedFault)
        finally:
            faults.clear()

    def test_driver_and_worker_over_a_store_server(self, tmp_path,
                                                   own_world):
        """``run_driver`` on a token-protected ``StoreServer`` URL with a
        ``run_worker`` thread: every trial DONE, evaluated once, by the
        worker."""
        from hyperopt_tpu_torch.parallel import StoreServer

        srv = StoreServer(str(tmp_path / "store"), token="tok")
        srv.start()
        out = {}

        def worker():
            out["n"] = multihost.run_worker(srv.url, exp_key="mh",
                                            token="tok", poll_interval=0.01,
                                            reserve_timeout=3.0)

        t = threading.Thread(target=worker)
        t.start()
        try:
            mesh = multihost.initialize(device=CPU)
            best = multihost.run_driver(
                _objective, _space(), store_root=srv.url, exp_key="mh",
                max_evals=24, mesh=mesh, n_EI_candidates=64, token="tok",
                rstate=np.random.default_rng(0), device=CPU,
                show_progressbar=False)
        finally:
            t.join(timeout=60)
            nt = NetTrials(srv.url, exp_key="mh", token="tok")
            srv.shutdown()
        assert not t.is_alive() and out["n"] == 24
        assert "x" in best
        assert len(nt) == 24 and len({d["tid"] for d in nt}) == 24
        assert all(d["state"] == JOB_STATE_DONE and d["owner"] for d in nt)
        assert len({d["owner"] for d in nt}) == 1
