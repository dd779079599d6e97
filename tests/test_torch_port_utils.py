"""The port's loggers, sweep runner, profiling and debugging helpers
(difformer_tpu_torch/utils/{logger,profiling,debug}.py, sweep.py) against
the JAX package's: the same printed lines and files, the same grids and
parameter counts.
"""

import json

import jax
import numpy as np
import pytest
import torch

from difformer_tpu import sweep as jax_sweep
from difformer_tpu.data.graph import GraphData as JGraph
from difformer_tpu.nn.difformer import DIFFormer as JDIFFormer
from difformer_tpu.utils import debug as jax_debug
from difformer_tpu.utils import logger as jax_logger
from difformer_tpu.utils import profiling as jax_profiling
from difformer_tpu_torch import DIFFormer, sweep
from difformer_tpu_torch.data import random_graph
from difformer_tpu_torch.utils import debug, logger, profiling
import torch_port_helpers  # noqa: F401  (sets torch's threads)

ROWS = [(0.5, 0.4, 0.3, 1.2), (0.6, 0.7, 0.65, 0.9), (0.8, 0.6, 0.7, 0.8)]


def fill(lg, runs=2):
    for run in range(runs):
        for row in ROWS:
            lg.add_result(run, tuple(v + 0.01 * run for v in row))
    return lg


@pytest.mark.parametrize("select_by", ["valid", "loss"])
def test_run_logger_prints_and_writes_the_same(tmp_path, capsys, select_by):
    paths = [tmp_path / "ours.jsonl", tmp_path / "theirs.jsonl"]
    printed, stats = [], []
    for module, path in zip((logger, jax_logger), paths):
        lg = fill(module.RunLogger(2, select_by=select_by,
                                   jsonl_path=str(path)))
        summaries = [lg.print_statistics(run) for run in range(2)]
        stats.append((summaries, lg.print_statistics(), lg.statistics()))
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and "All runs: test" in printed[0]
    assert stats[0] == stats[1]
    rows = [[json.loads(line) for line in p.read_text().splitlines()]
            for p in paths]
    for a, b in zip(*rows):
        assert set(a) == set(b)
        assert {k: v for k, v in a.items() if k != "t"} == {
            k: v for k, v in b.items() if k != "t"}
    assert len(rows[0]) == 2 * len(ROWS)


def test_simple_logger_prints_the_same(capsys):
    out = []
    for module in (logger, jax_logger):
        lg = module.SimpleLogger("sweep", ("lr", "wd"), num_values=2)
        for run in range(3):
            lg.add_result(run, (0.01, 0.0), (0.5 + 0.1 * run, 0.4))
            lg.add_result(run, (0.1, 5e-4), (0.6, 0.5 + 0.05 * run))
        shown = lg.display()
        out.append((capsys.readouterr().out, lg.get_best(2),
                    {k: [v.tolist() for v in vs] for k, vs in shown.items()}))
        with pytest.raises(ValueError):
            lg.add_result(0, (1,), (0.1, 0.2))
    assert out[0] == out[1]


def test_save_result_writes_the_same_csv(tmp_path):
    args = {"lr": 0.01, "method": "difformer", "dropout": 0.2}
    for module, name in ((logger, "ours"), (jax_logger, "theirs")):
        for mean in (0.5, 0.61234):
            module.save_result(str(tmp_path / name / "r.csv"), args,
                               {"test_mean": mean, "test_std": 0.01})
    assert ((tmp_path / "ours" / "r.csv").read_text()
            == (tmp_path / "theirs" / "r.csv").read_text())


def test_parse_grid():
    specs = ["weight_decay=0.0,5e-4", "hidden_channels=8,16",
             "kernel=simple,sigmoid", "dropout=0"]
    assert sweep.parse_grid(specs) == jax_sweep.parse_grid(specs)
    assert sweep.parse_grid(None) == {}


def test_run_sweep_writes_a_row_per_combination(tmp_path, capsys):
    rows = sweep.main(["--dataset", "synthetic-80-300-6-3", "--grid",
                       "hidden_channels=4,8", "--grid", "dropout=0.0",
                       "--epochs", "2", "--runs", "1", "--result_dir",
                       str(tmp_path)], device="cpu")
    assert [r["hidden_channels"] for r in rows] == [4, 8]
    lines = (tmp_path / "synthetic-80-300-6-3" / "difformer.csv").read_text(
        ).splitlines()
    assert lines[0].split(",")[-2:] == ["test_mean", "test_std"]
    assert len(lines) == 3
    assert "[sweep] best:" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [{}, {"use_weight": False},
                                   {"use_bn": False, "num_heads": 2}])
def test_count_parameters_matches_the_jax_count(flags):
    x, ei, _ = random_graph(30, 90, 7, 3, seed=1)
    kw = dict(num_layers=3, **flags)
    jm = JDIFFormer(hidden_channels=16, out_channels=3, **kw)
    jg = JGraph.from_numpy(x, ei)
    params = jm.init(jax.random.PRNGKey(0), jg.node_feat, jg.senders,
                     jg.receivers)["params"]
    model = DIFFormer(7, 16, 3, device="cpu", **kw)
    expect = jax_profiling.count_parameters(params)
    assert profiling.count_parameters(model) == expect
    assert profiling.count_parameters(model.state_dict()) == expect
    assert profiling.count_parameters(
        jax.tree_util.tree_map(np.asarray, params)) == expect


def test_throughput_meter(monkeypatch):
    clock = iter([10.0, 12.0, 12.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    meter = profiling.ThroughputMeter(edges_per_step=100, layers=2)
    meter.step()
    meter.step(3)
    assert meter.summary() == {"steps": 4, "seconds": 2.0,
                               "steps_per_s": 2.0, "edges_per_s": 400.0}
    assert json.loads(meter.report())["steps"] == 4
    monkeypatch.undo()
    assert set(meter.summary()) == set(
        jax_profiling.ThroughputMeter(1).summary())


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_device_memory_stats_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory_stats() == {}


def test_detect_anomaly_raises_on_a_nan_backward():
    x = torch.tensor([-1.0], requires_grad=True)
    torch.sqrt(x).sum().backward()  # NaN gradient, no error outside
    assert torch.isnan(x.grad).all()
    with pytest.raises(RuntimeError, match="nan"):
        with debug.detect_anomaly():
            torch.sqrt(x).sum().backward()


def test_assert_all_finite_names_the_leaf():
    tree = {"a": {"b": np.ones(3, np.float32),
                  "c": np.array([1.0, np.nan], np.float32)},
            "n": np.arange(3)}
    for module in (debug, jax_debug):
        with pytest.raises(FloatingPointError) as e:
            module.assert_all_finite(tree, "params")
        assert str(e.value) == "non-finite values in params['a']['c']"
    torch_tree = {"w": [torch.ones(2), torch.tensor([float("inf")])]}
    with pytest.raises(FloatingPointError, match=r"tree\['w'\]\[1\]"):
        debug.assert_all_finite(torch_tree)
    model = DIFFormer(3, 4, 2, num_layers=1, device="cpu")
    debug.assert_all_finite(model)
    with torch.no_grad():
        model.fcs[1].bias[0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"\['fcs.1.bias'\]"):
        debug.assert_all_finite(model.state_dict(), "")
    debug.assert_all_finite({"i": torch.arange(3), "f": 1.5})


def test_checkify_step_names_the_first_non_finite_output():
    step = debug.checkify_step(lambda a: {"loss": a.sum(), "out": 1 / a})
    err, out = step(torch.ones(3))
    assert err is None and out["loss"] == 3
    err, out = step(torch.tensor([1.0, 0.0]))
    assert err == "non-finite value in output['out']"
    assert torch.isinf(out["out"]).any()
