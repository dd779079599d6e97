"""Run logging, a copy of ``difformer_tpu/utils/logger.py`` (numpy), with
the same printed lines and the same CSV and JSONL files. It replaces the
reference's four diverged Logger copies (``node classification/
logger.py:3-79`` et al.).

Per-run epoch rows are ``(train, valid, test[, valid_loss])``; statistics
select the epoch by the largest valid metric (or the smallest valid loss)
and report the mean and std over runs, as the reference's
``print_statistics``. ``jsonl_path`` adds a JSON line per result.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

import numpy as np


class RunLogger:
    def __init__(self, runs: int, *, select_by: str = "valid",
                 jsonl_path: Optional[str] = None):
        self.results: List[List[tuple]] = [[] for _ in range(runs)]
        self.select_by = select_by  # 'valid' (argmax metric) | 'loss' (argmin)
        self.jsonl_path = jsonl_path
        self._t0 = time.time()

    def add_result(self, run: int, result):
        """result = (train, valid, test[, valid_loss])"""
        self.results[run].append(tuple(float(x) for x in result))
        if self.jsonl_path:
            os.makedirs(os.path.dirname(self.jsonl_path) or ".", exist_ok=True)
            with open(self.jsonl_path, "a") as f:
                row = {
                    "run": run,
                    "epoch": len(self.results[run]) - 1,
                    "train": self.results[run][-1][0],
                    "valid": self.results[run][-1][1],
                    "test": self.results[run][-1][2],
                    "t": time.time() - self._t0,
                }
                if len(self.results[run][-1]) > 3:
                    row["valid_loss"] = self.results[run][-1][3]
                f.write(json.dumps(row) + "\n")

    def best_epoch(self, run: int) -> int:
        r = np.asarray(self.results[run])
        if self.select_by == "loss" and r.shape[1] > 3:
            return int(np.argmin(r[:, 3]))
        return int(np.argmax(r[:, 1]))

    def run_summary(self, run: int):
        r = np.asarray(self.results[run])
        e = self.best_epoch(run)
        return {
            "best_epoch": e,
            "train": r[e, 0],
            "valid": r[e, 1],
            "test": r[e, 2],
            "highest_train": float(r[:, 0].max()),
            "highest_valid": float(r[:, 1].max()),
        }

    def statistics(self):
        """mean±std of the chosen-epoch test metric over runs."""
        tests = []
        valids = []
        for run in range(len(self.results)):
            if not self.results[run]:
                continue
            s = self.run_summary(run)
            tests.append(s["test"])
            valids.append(s["valid"])
        tests = np.asarray(tests)
        valids = np.asarray(valids)
        return {
            "test_mean": float(tests.mean()),
            "test_std": float(tests.std()),
            "valid_mean": float(valids.mean()),
            "valid_std": float(valids.std()),
            "runs": len(tests),
        }

    def print_statistics(self, run: Optional[int] = None):
        if run is not None:
            s = self.run_summary(run)
            print(
                f"Run {run + 1:02d}: best epoch {s['best_epoch']}, "
                f"train {100 * s['train']:.2f}, valid {100 * s['valid']:.2f}, "
                f"test {100 * s['test']:.2f}"
            )
            return s
        s = self.statistics()
        print(
            f"All runs: test {100 * s['test_mean']:.2f} ± "
            f"{100 * s['test_std']:.2f} (over {s['runs']} runs)"
        )
        return s


class SimpleLogger:
    """Hyperparameter-keyed result aggregator (reference ``SimpleLogger``,
    ``physical particle/logger.py:103-153``): results are stored per
    ``(run, args-tuple)``, aggregated as mean±std over runs per args
    setting, with ``get_best`` ranking settings by the mean of the last
    value column. Values are reported ×100 like the reference."""

    def __init__(self, desc: str, param_names, num_values: int = 2):
        self.desc = desc
        self.param_names = tuple(param_names)
        self.num_values = num_values
        self.results: dict = {}        # run -> {args: values}
        self.used_args: List[tuple] = []

    def add_result(self, run: int, args, values):
        args = tuple(args)
        values = tuple(float(v) for v in values)
        if len(args) != len(self.param_names):
            raise ValueError("args must match param_names")
        if len(values) != self.num_values:
            raise ValueError(f"expected {self.num_values} values")
        self.results.setdefault(run, {})[args] = values
        if args not in self.used_args:
            self.used_args.append(args)

    def _stats(self, args):
        rows = 100.0 * np.asarray(
            [r[args] for r in self.results.values() if args in r])
        # sample std over runs (ddof=1) like torch.std; 0 for a single run
        std = rows.std(axis=0, ddof=1) if rows.shape[0] > 1 \
            else np.zeros(rows.shape[1])
        return rows.mean(axis=0), std

    def get_best(self, top_k: int = 1):
        ranked = sorted(self.used_args,
                        key=lambda a: self._stats(a)[0][-1], reverse=True)
        return ranked[:top_k]

    def display(self, args=None):
        disp = self.used_args if args is None else args
        if len(disp) > 1:
            print(f"{self.desc} {self.param_names}, "
                  f"{len(self.results)} runs")
        out = {}
        for a in disp:
            mean, std = self._stats(a)
            out[a] = (mean, std)
            res = " -> ".join(f"{m:.2f} ± {s:.2f}"
                              for m, s in zip(mean, std))
            print(f"Args {list(map(str, a))}: {res}")
        return out


def save_result(path: str, args_dict: dict, stats: dict):
    """CSV appender (reference ``save_result``, logger.py:70-79)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_header = not os.path.exists(path)
    keys = sorted(args_dict.keys())
    with open(path, "a") as f:
        if write_header:
            f.write(",".join(keys + ["test_mean", "test_std"]) + "\n")
        f.write(
            ",".join(str(args_dict[k]) for k in keys)
            + f",{stats['test_mean']:.4f},{stats['test_std']:.4f}\n"
        )
