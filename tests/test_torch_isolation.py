"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU.

- an AST scan of every module under ``src/repro_torch/``, of
  ``chip_smoke.py`` and of the port's entry scripts
  (``examples/torch/*.py``, ``tools/substrate_matrix_torch.py``) finds
  no import of ``jax``, ``repro``, ``msgpack``
  or ``ml_dtypes`` (the last two are not on the machine with the card);
- a fresh interpreter that imports the port (and builds nothing) has
  none of them in ``sys.modules``;
- the entry points (``engine.run``, ``engine.sweep``,
  ``run_population``, ``run_async_simulation``, the serial oracle,
  ``launch.mesh.make_learner_mesh``, the LM's) resolve ``device=None``
  to the CUDA card and raise where there is none, and so does each entry
  script's ``main([])``.
"""
import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import device as tdevice
from repro_torch.core import engine as teng
from repro_torch.core.learners import LearnerConfig
from repro_torch.core.protocol import ProtocolConfig
from repro_torch.core.simulation import run_linear_simulation
from repro_torch.launch.mesh import make_learner_mesh
from repro_torch.population import PopulationSpec, run_population
from repro_torch.runtime import AsyncProtocolConfig, run_async_simulation

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
# msgpack and ml_dtypes: the machine with the card has neither (the
# checkpoint format is written by the port's own codec)
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes")


def _entry_scripts():
    return (sorted((ROOT / "examples" / "torch").glob("*.py"))
            + [ROOT / "tools" / "substrate_matrix_torch.py"])


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + _entry_scripts())


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_sources_import_no_jax_and_no_repro():
    files = _port_files()
    assert len(files) > 10
    bad = [(p.relative_to(ROOT).as_posix(), root) for p in files
           for root in _imported_roots(p) if root in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert\n"
        "from repro_torch.core import engine, substrate\n"
        "from repro_torch.kernels import ops, fused, quadform, ref, rff, _build\n"
        "from repro_torch.kernels import flash, gram\n"
        "from repro_torch import configs, models\n"
        "from repro_torch.models import attention, layers, transformer\n"
        "import repro_torch.serving.lm\n"
        "from repro_torch.data import streams\n"
        "from repro_torch import serving, runtime, telemetry\n"
        "from repro_torch.runtime import (async_protocol, harness, nodes,\n"
        "                                 transport)\n"
        "from repro_torch.core import criterion\n"
        "from repro_torch import population\n"
        "from repro_torch.population import availability, sim\n"
        "from repro_torch.telemetry import monitor\n"
        "import repro_torch.launch\n"
        "from repro_torch.launch import mesh, serve\n"
        "from repro_torch.core import simulation, protocol\n"
        "from repro_torch import checkpoint, optim, tree\n"
        "from repro_torch.telemetry import probe\n"
        "from repro_torch.launch import train\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'msgpack', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "assert _build._LIB is None, 'importing built the kernels'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert tdevice.resolve(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.resolve(None)
    X = np.zeros((3, 2, 4), np.float32)
    Y = np.ones((3, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.run(LearnerConfig(algo="linear_sgd", dim=4),
                 ProtocolConfig(kind="periodic", period=2), X, Y)
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.sweep(LearnerConfig(algo="linear_sgd", dim=4),
                   [ProtocolConfig(kind="periodic", period=2)], X, Y)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_population(PopulationSpec(m_total=2),
                       LearnerConfig(algo="linear_sgd", dim=4),
                       ProtocolConfig(kind="periodic", period=2), X, Y)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_async_simulation(LearnerConfig(algo="linear_sgd", dim=4),
                             AsyncProtocolConfig(kind="periodic", period=2),
                             X, Y)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_linear_simulation(LearnerConfig(algo="linear_sgd", dim=4),
                              ProtocolConfig(kind="periodic", period=2), X, Y)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_learner_mesh(2)
    assert tdevice.resolve("cpu").type == "cpu"


@pytest.mark.parametrize("path", _entry_scripts(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_entry_scripts_default_to_cuda_and_raise_without_it(path):
    spec = importlib.util.spec_from_file_location(
        f"_entry_{path.stem}", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        script.main([])


def test_lm_entry_points_default_to_cuda_and_raise_without_it():
    from repro_torch.configs import get
    from repro_torch.models import build
    from repro_torch.serving.lm import LMServingEngine

    cfg = get("qwen2_5_3b").smoke()
    api = build(cfg)
    if torch.cuda.is_available():
        params = api.init(0)
        assert params["embed"]["table"].device.type == "cuda"
        assert LMServingEngine(cfg, params).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_caches(1, 4)
    params = api.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        LMServingEngine(cfg, params)
    assert LMServingEngine(cfg, params, device="cpu").device.type == "cpu"


def test_resolving_a_device_turns_tf32_off():
    tdevice.resolve("cpu")
    flags = tdevice.precision_flags()
    assert flags["cuda.matmul.allow_tf32"] is False
    assert flags["cudnn.allow_tf32"] is False
