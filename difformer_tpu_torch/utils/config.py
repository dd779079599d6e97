"""Unified config and per-dataset presets: a copy of
``difformer_tpu/utils/config.py`` (pure Python), kept here so the port
imports nothing of the JAX package. Fields for options the port does not run
yet (mini-batch, temporal, graph-level, sharding, sparse layouts) are kept so
that a config reads the same in both packages.

The JAX package's note: it supersedes the four diverged ``parse.py`` flag sets
(``node classification/parse.py:13-76``, ``image and text/parse.py:5-145``,
``spatial-temporal/parse.py:5-131``, ``physical particle/parse.py:5-119``)
and the run.sh matrices with one dataclass tree + per-dataset presets.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Config:
    # experiment
    dataset: str = "cora"
    sub_dataset: str = ""
    data_dir: str = "data"
    method: str = "difformer"
    task: str = "node"              # node | set | temporal | graph
    seed: int = 123
    runs: int = 1
    cpu: bool = False

    # splits (reference parse.py:21-29)
    rand_split: bool = False
    rand_split_class: bool = False
    label_num_per_class: int = 20
    valid_num: int = 500
    test_num: int = 1000
    train_prop: float = 0.5
    valid_prop: float = 0.25
    metric: str = "acc"             # acc | rocauc | f1 | mse

    # model (parse.py:38-56)
    hidden_channels: int = 32
    num_layers: int = 2
    num_heads: int = 1
    kernel: str = "simple"          # simple | sigmoid
    alpha: float = 0.5
    use_bn: bool = True
    use_residual: bool = True
    use_graph: bool = True
    use_weight: bool = True
    use_source: bool = False
    graph_weight: float = -1.0
    # zoo extras
    gat_heads: int = 2
    out_heads: int = 1
    hops: int = 2
    lp_alpha: float = 0.1
    gpr_alpha: float = 0.1
    appnp_k: int = 10

    # set-encoder track (image and text/parse.py)
    knn_k: int = 5
    manireg: float = 1.0     # Laplacian-reg weight for --method manireg

    # temporal track
    train_ratio: float = 0.5
    val_ratio: float = 0.25
    early_stopping: int = 20
    special_treat: str = "none"     # none | knn | dense
    temporal_mode: str = "auto"     # auto: wikimath incremental, else cumulative

    # graph track
    graph_pooling: str = "mean"
    max_nodes: Optional[int] = None
    max_edges: Optional[int] = None

    # training (parse.py:30-37)
    lr: float = 0.01
    weight_decay: float = 5e-4
    dropout: float = 0.5
    epochs: int = 500
    batch_size: int = 10000
    use_minibatch: bool = False

    # util (parse.py:57-76)
    display_step: int = 50
    eval_step: int = 1
    save_model: bool = False
    eval_only: bool = False         # ckpt-eval harness (test_large_dataset.py)
    ckpt_path: str = ""
    model_dir: str = "models"
    save_result: bool = False
    result_dir: str = "results"
    protocol: str = "semi"

    # execution
    n_shards: int = 1               # >1 → node-sharded training over a mesh
    balance_edges: bool = False     # degree-balanced shard boundaries
    use_ell: bool = True            # scatter-free ELL SpMM for the GCN branch
    spmm: str = ""                  # '' (use_ell) | coo | ell | bsr (MXU
    #                                 block-sparse hybrid, ops/bsr.py)
    bsr_tile: int = 256
    reorder: str = ""               # '' | rcm | bfs | degree | community
    #                                 node reordering for gather locality /
    #                                 BSR block density
    jk_type: str = "max"            # gcnjk/gatjk aggregation: max|cat|lstm
    dcrnn_filters: int = 1          # DCRNN diffusion filter size K
    #                                 (spatial-temporal parse.py:103)
    directed: bool = False          # skip symmetrization only (to_undirected;
    #                                 self-loop removal/re-addition always
    #                                 runs, matching reference main.py:71-76;
    #                                 symmetrization is also skipped for
    #                                 ogbn-proteins regardless)
    print_prop: bool = False        # print predicted class proportions at
    #                                 display steps (main.py:149-151)
    spmm_first: object = "auto"     # GCN branch as (ÂX)Wv: gathers F+1-wide
    #                                 rows instead of H·D. "auto" (default)
    #                                 enables it when H·D ≥ 2·(F+1) — the
    #                                 measured-win regime (2.9–4.0× at H=8,
    #                                 BENCH_NOTES r3) — so a default CLI run
    #                                 on a multi-head shape gets the rewrite
    #                                 without hand-flags. Deviation from
    #                                 reference operation order is float-
    #                                 reassociation only (equivalence tested,
    #                                 tests/test_models.py); pass False for
    #                                 exact reference order
    fuse_head_mean: object = "auto"  # head-mean folded into the attention
    #                                 contraction + linear GCN branch (no
    #                                 [N,H,D] branch outputs; value factored
    #                                 through the key aggregates — round 5,
    #                                 1.35x at the clustered H=8 headline).
    #                                 "auto" fuses at H>1; H=1 keeps exact
    #                                 reference order. Float-reassociation
    #                                 deviation only (equivalence tested);
    #                                 pass false for reference order.
    epoch_block: int = 8            # full-batch trainer: epochs per jitted
    #                                 lax.scan block (device-side eval; falls
    #                                 back to the per-epoch loop when the run
    #                                 needs per-epoch host access — see
    #                                 FullBatchTrainer.fit). 0/1 = per-epoch
    layout: str = ""                # shard layout: '' (contiguous) |
    #                                 balanced | locality (community reorder
    #                                 + min-cut snap, parallel/partition)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# Per-dataset presets distilled from the reference run.sh matrices
# (node classification/run.sh:4-77, image and text/run.sh, spatial-temporal/
# run.sh, physical particle/run.sh) — see BASELINE.md for the table.
# Each preset is the exact DIFFormer-s row of the reference's run.sh
# (kernel-specific variants differ only in flags the user passes on top).
# Flags absent from a run.sh line fall back to that track's parse.py
# defaults (node/image-text: store_true booleans default False, dropout 0.0).
PRESETS = {
    # node classification/run.sh:4-6
    "cora": dict(rand_split_class=True, label_num_per_class=20, metric="acc",
                 hidden_channels=64, num_layers=8, lr=0.001,
                 weight_decay=0.01, dropout=0.2, epochs=500, runs=5,
                 seed=123),
    # run.sh:15-17
    "citeseer": dict(rand_split_class=True, label_num_per_class=20,
                     metric="acc", hidden_channels=64, num_layers=4,
                     lr=0.001, weight_decay=1.0, dropout=0.2, epochs=500,
                     runs=5, seed=123),
    # run.sh:26-28
    "pubmed": dict(rand_split_class=True, label_num_per_class=20,
                   metric="acc", hidden_channels=64, num_layers=8, lr=0.001,
                   weight_decay=1e-4, dropout=0.2, epochs=500, runs=5,
                   seed=123),
    # run.sh:37-39 (--use_bn IS passed; dropout = parse.py default 0.0)
    "ogbn-proteins": dict(metric="rocauc", hidden_channels=64, num_layers=3,
                          lr=0.01, weight_decay=0.0, dropout=0.0,
                          use_minibatch=True, batch_size=10000, epochs=1000,
                          eval_step=9, runs=5, seed=123),
    # run.sh:42-44 (random 50/25/25 splits)
    "pokec": dict(rand_split=True, metric="acc", hidden_channels=128,
                  num_layers=3, lr=0.01, weight_decay=0.0, dropout=0.0,
                  use_minibatch=True, batch_size=100000, epochs=500,
                  eval_step=9, runs=5, seed=123),
    # run.sh:47-50 (film: NO --use_graph)
    "film": dict(metric="acc", use_graph=False, hidden_channels=64,
                 num_layers=2, lr=0.001, weight_decay=0.1, dropout=0.5,
                 epochs=300, seed=42, runs=5),
    # run.sh:57-60 (squirrel: no --use_bn/--use_residual)
    "squirrel": dict(metric="acc", graph_weight=0.8, use_bn=False,
                     use_residual=False, hidden_channels=64, num_layers=2,
                     lr=0.01, weight_decay=1e-4, dropout=0.5, epochs=300,
                     seed=42, runs=10),
    # run.sh:67-70
    "chameleon": dict(metric="acc", graph_weight=0.7, use_bn=False,
                      use_residual=False, hidden_channels=128, num_layers=2,
                      lr=0.01, weight_decay=1e-4, dropout=0.2, epochs=300,
                      seed=42, runs=10),
    # image and text/run.sh:7-10 (NO --use_graph: pure set encoder; the kNN
    # graph only serves methods that do pass use_graph)
    "stl10": dict(task="set", rand_split_class=True, valid_num=1000,
                  test_num=-1, use_graph=False, hidden_channels=400,
                  num_layers=2, knn_k=5, lr=5e-4, weight_decay=0.1,
                  dropout=0.0, epochs=600, runs=5, seed=123),
    # run.sh:25-28
    "cifar10": dict(task="set", rand_split_class=True, valid_num=1000,
                    test_num=-1, use_graph=False, hidden_channels=300,
                    num_layers=2, knn_k=5, lr=1e-4, weight_decay=0.1,
                    dropout=0.0, epochs=600, runs=5, seed=123),
    # run.sh:45-48
    "20news": dict(task="set", rand_split_class=True, valid_num=1000,
                   test_num=-1, use_graph=False, hidden_channels=300,
                   num_layers=2, knn_k=5, lr=5e-4, weight_decay=0.1,
                   dropout=0.0, epochs=600, runs=5, seed=42),
    # spatial-temporal/run.sh:4-6 (s w/ graph)
    "chickenpox": dict(task="temporal", metric="mse", hidden_channels=4,
                       num_layers=2, lr=0.01, weight_decay=0.0, dropout=0.2,
                       early_stopping=20, seed=123),
    # run.sh:20-22
    "covid": dict(task="temporal", metric="mse", hidden_channels=4,
                  num_layers=2, lr=0.01, weight_decay=0.0, dropout=0.2,
                  seed=123),
    # run.sh:34-36
    "wikimath": dict(task="temporal", metric="mse", hidden_channels=4,
                     num_layers=2, lr=0.005, weight_decay=0.0, dropout=0.0,
                     temporal_mode="incremental", seed=123),
    # physical particle/run.sh:2-6
    "actstrack": dict(task="graph", metric="rocauc", rand_split_class=True,
                      hidden_channels=64, num_layers=2, batch_size=1024,
                      lr=0.0015, weight_decay=1e-3, dropout=0.4,
                      graph_pooling="mean", epochs=150, runs=3, seed=42,
                      train_prop=0.5, valid_prop=0.25, display_step=10),
    # run.sh:15-19
    "tau3mu": dict(task="graph", metric="rocauc", rand_split_class=True,
                   hidden_channels=64, num_layers=2, batch_size=8192,
                   lr=0.015, weight_decay=5e-5, dropout=0.3,
                   graph_pooling="mean", epochs=100, runs=3, seed=42,
                   train_prop=0.5, valid_prop=0.25, display_step=10),
    # run.sh:29-33
    "synmol": dict(task="graph", metric="rocauc", rand_split_class=True,
                   hidden_channels=64, num_layers=2, batch_size=8192,
                   lr=0.01, weight_decay=1e-4, dropout=0.3, alpha=0.3,
                   graph_pooling="mean", epochs=150, runs=3, seed=42,
                   train_prop=0.5, valid_prop=0.25, display_step=10),
}


def make_config(dataset: str, **overrides) -> Config:
    cfg = Config(dataset=dataset)
    preset = PRESETS.get(dataset, {})
    cfg = cfg.replace(**preset)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
