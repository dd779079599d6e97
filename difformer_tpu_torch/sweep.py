"""Hyperparameter sweeps, as ``difformer_tpu/sweep.py``: the
reference's ``run_hyper_search.sh`` grids (``node classification/
run_hyper_search.sh:1-21``: wd × dropout × hidden × layers) as a grid of
``run_node_task`` runs on the GPU, written as ``save_result``'s CSV
(``logger.py:70-79``).

Usage:
  python -m difformer_tpu_torch.sweep --dataset synthetic-500-2000-16-3 \
      --grid weight_decay=0.0,5e-4 --grid dropout=0.0,0.2 --epochs 50
"""

from __future__ import annotations

import argparse
import itertools
import os

import numpy as np

from difformer_tpu_torch.cli import run_node_task
from difformer_tpu_torch.utils.config import make_config
from difformer_tpu_torch.utils.logger import save_result


def parse_grid(specs):
    """``["key=v1,v2", ...]`` -> {key: [v1, v2]}, each value an int, a
    float or else a string."""
    grid = {}
    for spec in specs or []:
        key, _, vals = spec.partition("=")
        parsed = []
        for v in vals.split(","):
            for cast in (int, float):
                try:
                    parsed.append(cast(v))
                    break
                except ValueError:
                    continue
            else:
                parsed.append(v)
        grid[key] = parsed
    return grid


def run_sweep(dataset, grid, *, base_overrides=None, result_dir="results",
              device=None):
    """Run every combination of ``grid`` on ``device`` (the GPU unless told
    otherwise); append each one's test mean and std to
    ``result_dir/dataset/method.csv``. Returns the rows."""
    keys = sorted(grid)
    rows = []
    for combo in itertools.product(*(grid[k] for k in keys)):
        overrides = dict(zip(keys, combo))
        cfg = make_config(dataset, **{**(base_overrides or {}), **overrides})
        res = run_node_task(cfg, device=device)
        tests = np.asarray([r["test"] for r in res])
        stats = {"test_mean": tests.mean(), "test_std": tests.std()}
        args_row = {
            "method": cfg.method, "kernel": cfg.kernel,
            "weight_decay": cfg.weight_decay, "dropout": cfg.dropout,
            "num_layers": cfg.num_layers, "alpha": cfg.alpha,
            "hidden_channels": cfg.hidden_channels, **overrides,
        }
        save_result(
            os.path.join(result_dir, dataset, f"{cfg.method}.csv"),
            args_row, stats,
        )
        rows.append({**args_row, **stats})
        print(f"[sweep] {overrides} -> {stats}")
    best = max(rows, key=lambda r: r["test_mean"])
    print(f"[sweep] best: {best}")
    return rows


def main(argv=None, *, device=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="synthetic-500-2000-16-3")
    p.add_argument("--grid", action="append", default=[])
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--runs", type=int, default=None)
    p.add_argument("--method", default=None)
    p.add_argument("--result_dir", default="results")
    args = p.parse_args(argv)
    base = {}
    if args.epochs is not None:
        base["epochs"] = args.epochs
    if args.runs is not None:
        base["runs"] = args.runs
    if args.method is not None:
        base["method"] = args.method
    base.setdefault("rand_split", True)
    return run_sweep(args.dataset, parse_grid(args.grid),
                     base_overrides=base, result_dir=args.result_dir,
                     device=device)


if __name__ == "__main__":
    main()
