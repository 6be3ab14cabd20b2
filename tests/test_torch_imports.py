"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and ``chip_smoke.py``, ``graft_entry_torch.py``, the card's tests
(``tests_torch_cuda/`` and the ladders they share, ``tests/torch_ladders.py``)
and the port's examples (``examples_torch/``) neither; and it reads none of the JAX package's environment switches
(their prefix appears nowhere in its sources)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "hyperopt_tpu_torch").rglob("*.py")) \
    + sorted((ROOT / "tests_torch_cuda").glob("*.py")) \
    + sorted((ROOT / "examples_torch").glob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "chip_ei_ab.py",
       ROOT / "graft_entry_torch.py", ROOT / "tests" / "torch_ladders.py"]
FORBIDDEN = ("jax", "jaxlib", "hyperopt_tpu")
# The JAX package's environment switches; the port's are arguments and
# setters.
ENV_PREFIX = "HYPEROPT_TPU_"


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES
                         + sorted((ROOT / "hyperopt_tpu_torch").rglob("*.cu")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_environment_switch_in_source(path):
    text = path.read_text()
    if path.suffix == ".py":
        consts = [n.value for n in ast.walk(ast.parse(text))
                  if isinstance(n, ast.Constant) and isinstance(n.value, str)
                  and ENV_PREFIX in n.value]
        assert not consts, f"{path.name} names {consts}"
    assert ENV_PREFIX not in text, f"{path.name} mentions {ENV_PREFIX}"


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'hyperopt_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import hyperopt_tpu_torch, hyperopt_tpu_torch.convert, chip_smoke\n"
        "import graft_entry_torch\n"
        "import hyperopt_tpu_torch.ops.ei_scores, hyperopt_tpu_torch.history\n"
        "import hyperopt_tpu_torch.device, hyperopt_tpu_torch.fleet\n"
        "import hyperopt_tpu_torch.obs, hyperopt_tpu_torch.obs.devtel\n"
        "import hyperopt_tpu_torch.obs.trace, hyperopt_tpu_torch.faults\n"
        "import hyperopt_tpu_torch.pipeline, hyperopt_tpu_torch.parallel\n"
        "import hyperopt_tpu_torch.qmc, hyperopt_tpu_torch.criteria\n"
        "import hyperopt_tpu_torch.rdists, hyperopt_tpu_torch.pyll_shim\n"
        "import hyperopt_tpu_torch.graphviz, hyperopt_tpu_torch.plotting\n"
        "import hyperopt_tpu_torch.utils, hyperopt_tpu_torch.pyll\n"
        "import hyperopt_tpu_torch.anneal, hyperopt_tpu_torch.mix\n"
        "import hyperopt_tpu_torch.atpe, hyperopt_tpu_torch.backends\n"
        "import hyperopt_tpu_torch.backends.contract\n"
        "import hyperopt_tpu_torch.backends._codec\n"
        "import hyperopt_tpu_torch.backends.gp, hyperopt_tpu_torch.backends.es\n"
        "import hyperopt_tpu_torch.dispatch, hyperopt_tpu_torch.utils.tracing\n"
        "import hyperopt_tpu_torch.parallel.sharded\n"
        "import hyperopt_tpu_torch.parallel.filestore\n"
        "import hyperopt_tpu_torch.parallel.multihost\n"
        "import hyperopt_tpu_torch.obs.timeseries\n"
        "import hyperopt_tpu_torch.obs.slo, hyperopt_tpu_torch.obs.export\n"
        "import hyperopt_tpu_torch.wire, hyperopt_tpu_torch.parallel.netstore\n"
        "import hyperopt_tpu_torch.service\n"
        "import hyperopt_tpu_torch.service.tenancy\n"
        "import hyperopt_tpu_torch.service.cluster\n"
        "import hyperopt_tpu_torch.service.store\n"
        "import hyperopt_tpu_torch.service.wal\n"
        "import hyperopt_tpu_torch.service.server\n"
        "import hyperopt_tpu_torch.service.replica\n"
        "import hyperopt_tpu_torch.service.router\n"
        "import hyperopt_tpu_torch.service.autoscaler\n"
        "import hyperopt_tpu_torch.show, hyperopt_tpu_torch.analysis\n"
        "import hyperopt_tpu_torch.analysis.__main__\n"
        "sys.path.insert(0, 'tests_torch_cuda')\n"
        "import conftest, test_torch_cuda_device, test_torch_cuda_ei_scores\n"
        "import test_torch_cuda_fleet, test_torch_cuda_obs\n"
        "import test_torch_cuda_pipeline, test_torch_cuda_tpe_rest\n"
        "import test_torch_cuda_backends, test_torch_cuda_dispatch\n"
        "import test_torch_cuda_netstore, test_torch_cuda_service\n"
        "import test_torch_cuda_contract, test_torch_cuda_tpe_longrun\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'hyperopt_tpu.'))"
        " for m in sys.modules if sys.modules[m] is not None)\n"
        "assert 'matplotlib' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
