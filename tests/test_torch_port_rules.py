"""Rules of the port: it imports neither JAX nor the JAX package, and its
entry points run on the GPU unless told otherwise."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from difformer_tpu_torch import DIFFormer, FullBatchTrainer, GraphData
from difformer_tpu_torch.utils.device import resolve_device
import torch_port_helpers  # noqa: F401  (sets torch's threads)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "difformer_tpu_torch"


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import difformer_tpu_torch, difformer_tpu_torch.train, "
        "difformer_tpu_torch.kernels, difformer_tpu_torch.utils.weights, "
        "difformer_tpu_torch.utils.config, "
        "difformer_tpu_torch.train.checkpoint, difformer_tpu_torch.cli, "
        "difformer_tpu_torch.sweep, difformer_tpu_torch.data.loaders, "
        "difformer_tpu_torch.utils.logger, "
        "difformer_tpu_torch.utils.profiling, "
        "difformer_tpu_torch.utils.debug, "
        "difformer_tpu_torch.train.minibatch, difformer_tpu_torch.native, "
        "difformer_tpu_torch.train.temporal, difformer_tpu_torch.nn.temporal, "
        "difformer_tpu_torch.nn.gnns, "
        "difformer_tpu_torch.data.temporal_loaders, "
        "difformer_tpu_torch.nn.difformer_v2, "
        "difformer_tpu_torch.train.graph_level, "
        "difformer_tpu_torch.data.batching, difformer_tpu_torch.data.particle, "
        "difformer_tpu_torch.data.smiles, difformer_tpu_torch.data.plbind, "
        "difformer_tpu_torch.data.pyg_interop\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'flax', 'optax', 'orbax', "
        "'difformer_tpu.')) "
        "or m == 'difformer_tpu')\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("forbidden", ["jax", "flax", "optax", "orbax",
                                       "difformer_tpu"])
def test_no_source_imports(forbidden):
    sources = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 10
    for path in sources:
        for name in _imports(path):
            assert name.split(".")[0] != forbidden, (path, name)


def _no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device(monkeypatch):
    _no_gpu(monkeypatch)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")


def test_entry_points_without_device_raise_without_gpu(monkeypatch):
    _no_gpu(monkeypatch)
    x = np.zeros((4, 3), np.float32)
    ei = np.array([[0, 1, 2], [1, 2, 3]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DIFFormer(3, 8, 2, kernel="sigmoid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphData.from_numpy(x, ei)
    g = GraphData.from_numpy(x, ei, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        g.to()
    model = DIFFormer(3, 8, 2, kernel="sigmoid", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FullBatchTrainer(model, g, np.zeros(4, np.int64))
    # the graph-level track
    from difformer_tpu_torch.nn.difformer_v2 import (
        DIFFormerV2,
        GraphLevelModel,
    )
    from difformer_tpu_torch.train.graph_level import GraphLevelTrainer

    with pytest.raises(RuntimeError, match="device='cpu'"):
        DIFFormerV2(3, 8, 8)
    enc = DIFFormerV2(3, 8, 8, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphLevelModel(enc)
    head = GraphLevelModel(enc, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphLevelTrainer(head, [(x, ei, 1.0)])
    GraphLevelTrainer(head, [(x, ei, 1.0)], device="cpu")
