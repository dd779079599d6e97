"""Smoke run of difformer_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each printing its results on lines of its own; any failure exits
non-zero before the last line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off for matmul and cuDNN.
2. build: compile the CUDA kernels from ``difformer_tpu_torch/csrc``, one
   ``nvcc`` for each source, all at once.
3. kernels: every kernel against its plain PyTorch version on the card,
   under the one tolerance rule of
   ``difformer_tpu_torch/kernels/tolerance.py``, which is shown to fail an
   output of zeros or of misplaced rows: the flash sigmoid attention of
   DIFFormer-a (forward with and without normalisation, dq, dk/dv) at four
   shapes, with the split S of each kernel's loop axis and the blocks it
   launches; and the GCN branch's CSR SpMM K1, forward and transposed, at
   seven shapes from Cora's to Pokec's size (at Pokec's, with uniform and
   with power-law degrees), at float32 and at bfloat16 (the model at
   ``compute_dtype="bfloat16"``: bf16 x and out, f32 sums), with its split
   schedule of heavy rows, its device kernels a call, two calls
   bit-equal, and cuSPARSE's time for the same product beside it; K1's
   device kernels a call are counted in the CUDA graph of one call. Each
   with its time, its bound (x and out at the type's bytes) and (K1) the
   gather floor. Then K1-dval, the gradient of K1 with respect to its edge
   values (GAT's attention), every head in one call, at GAT's plans on the
   slice's graph (one head and two heads of 64) and on cifar10's kNN graph
   (W = 300), at Pokec's size with power-law degrees (W = 64) and on a
   graph with a hub row far above K1's split threshold (two heads of 64):
   against its plain version, shown to fail a wrong output, one device
   kernel a call, two calls bit-equal, timed by CUDA-graph replay beside
   its bound, its x-gather floor and ``torch.sparse.sampled_addmm``'s time
   (a call a head, summed).
4. slice: the cora preset as DIFFormer-a (hidden 64, 8 layers, 1 head) on a
   synthetic graph of Cora's size, trained with ``FullBatchTrainer.fit``;
   checks the losses, that every kernel ran as often as the path needs, and
   the logits against the same model through the plain versions; times a
   train step and an eval forward, and breaks the train step's device time
   down by operation with torch.profiler.
5. slice-s: the same for the main path, the cora preset as DIFFormer-s
   (``kernel="simple"``), whose one kernel is K1; the step's profile must
   show no sort and no ``index_add_``.
6. slice-s-h8: the cora preset at 8 heads, where every "auto" rewrite is
   on (head mean fused, Wv factored, spmm_first with K1 at width 65), for
   a few steps, with the logits against the plain version; then the same
   steps with ``remat=True``: the same losses bit for bit, and K1's
   forward once more a layer (the spmm_first branch's recomputation).
7. slice-s-graph and 8. slice-graph: cora-s and cora-a trained by the
   epoch-block fit (``fit(epoch_block=10)``: the train step and the eval
   captured as CUDA graphs and replayed), against the per-epoch fit of an
   identically built trainer in the same process: the same best epoch,
   losses and split metrics within rtol 1e-5 (and whether bit-equal), every
   kernel launched as often as the loop's path needs (counted at capture,
   times the replays), host ms per epoch and peak memory of both paths, and
   the device idle share of a replayed block and of a loop epoch.
   slice-s-bf16-graph and slice-bf16-graph: the same two at
   ``compute_dtype="bfloat16"``, and the trained bf16 model's logits
   against the same weights at f32 (within ``BF16_LOGIT_SHARE`` of the
   largest logit), ms per epoch and peak memory beside the f32 phases'.
8b. sharded-s (run after slice-graph): the main path cut across ranks
   (``difformer_tpu_torch/parallel/``): K1 on a rectangular plan (the
   halo exchange's conv of rank 1 of the slice's graph cut 4 ways, N_loc
   rows over the N_loc + S·B rows of [own ‖ halo]) forward and transposed
   against its plain version, two calls bit-equal, timed by CUDA-graph
   replay beside its bound and cuSPARSE; then the cora preset at dropout
   0 trained 5 Adam steps by the sharded step under NCCL at world size 1
   on this card, in the three exchanges (all-gather, halo, overlapped
   halo), from the weights of an unsharded ``FullBatchTrainer`` built in
   the same process, whose eager steps each run must follow (losses and
   final logits within rtol 1e-3 / atol 1e-4, and whether bit-equal);
   the same three with 2 and 4 gloo
   ranks sharing this card, and flavour 2b (the locality layout,
   spmm_first at 2 heads) against its own unsharded run: each rank's K1
   launches (its plans' products x layers x steps each way), ms a step
   (ranks sharing one card, not a scaling number), halo rows, collective
   bytes a layer; the NCCL runs' last step under the profiler (no sort,
   no index_add_; device and host time by operation); a JSON line of the
   phase (gloo takes the CUDA tensors of all four collectives: the port
   stages nothing through the host).
8d. sharded-a-bsr (run after distributed): the ring sigmoid attention and
   the node-sharded block-sparse hybrid: the cora preset as DIFFormer-a
   through ``DistributedTrainer`` at one NCCL rank, captured (20 epochs at
   dropout 0 under the logit rule against the unsharded captured fit from
   the same weights, 100 within 10 x the witness's drift), K2-K4 launched
   layers x ring steps a step and an eval; eager steps on 2 and 4 gloo
   ranks sharing the card against the unsharded steps; K2-K4 at the ring's
   step (N_loc = L = 1354) against their plain versions; K7 on rank 1's
   shard of bench.py's clustered graph cut in two and on the whole graph
   at one rank (int8 counts with their row and column scales, f32 values;
   W = 64 and 65) against its plain version, timed beside its bound,
   the plain version and cuSPARSE BSR; bench.py's model with
   ``spmm="bsr"`` at one NCCL rank, captured, against the unsharded
   trainer on its hybrid, its epoch time and idle share; the command line
   with --kernel sigmoid --spmm bsr --n_shards 2 on 2 gloo ranks against
   the unsharded command line's losses. Its references are made before
   phase sharded-s, and its rank cases run in the spawns of sharded-s
   (gloo) and distributed (NCCL), two spawns fewer.
8e. dp-tp (run after distributed): data and tensor parallelism. The
   actstrack preset's model (hidden 64, 2 layers) at dropout 0 on 1024
   stand-in graphs, ``make_dp_train_step`` at one NCCL rank (1024 graphs)
   and on 2 and 4 gloo ranks sharing the card (512 and 256 each), on the
   edge list (K1) and on the dense plan, 5 steps each against the
   unsharded graph-level step under the same rule (the trainer's model,
   Adam and packing, one batch a shard, the BCE sums over the whole
   count, one Adam step); the cora preset at 8 heads as DIFFormer-s
   (every "auto" rewrite on) and DIFFormer-a, ``make_tp_train_step`` at
   one NCCL rank (T = 1), on 2 gloo ranks (T = 2) and on the 2 x 2 graph x
   model grid of 4 gloo ranks, 5 steps against the unsharded eager steps
   (losses and final logits within rtol 1e-3 / atol 1e-4; the logits of
   DIFFormer-a's grid held to the same steps in float64, as the float32
   ones leave the rule there, and the ring alone, at weight decay 0, to
   the unsharded steps at that decay: TP_RING_DECAY); each rank's K1
   and K2-K4 launches, ms a step (ranks sharing one card, not a scaling
   number); K2-K4 at a T = 2 rank's shape (N = L = 2708, H = 4, M = D =
   64) against their plain versions, timed beside their bound. Its
   references are made before phase sharded-s, and its rank cases run in
   the spawns of sharded-s (gloo) and distributed (NCCL).
9. kernels-wide (run right after the kernels phase): K2-K4 on their wide
   path at the set track's widths, M = D = 300 and 400 at N = L = 15000
   (f32 with and without a key mask, and bf16), each against its plain
   version on the same inputs, two calls bit-equal, with device times,
   bound (FP32 and 3xTF32) and split.
9b. ell-bsr-kernels (run after kernels-wide): the sparse layouts' kernels
   against their plain versions under the "spmm" rule (shown to fail a
   wrong output), two calls bit-equal, the device kernels a call counted
   from a CUDA graph (K6 one, two where its split plan cuts a hub bucket;
   for K7 one, two where its split plan cuts a hub row tile, one more
   where x is staged to rows of 16 bytes, and K6 adding the residual):
   the ELL kernel K6 in both directions at
   Cora's graph (W = 64 and spmm_first's 65) and at bench.py's three
   graphs (N = 131072, E = 4.19 M: clustered SBM, Pareto-alpha-2 power
   law, uniform; W = 64), f32 and bf16 x, with its gather floor, its
   combine (K1's, on the power law's split hub buckets) alone on its
   partials, and a sweep of its split threshold T on the power law; the
   block kernel K7 on the
   clustered graph at T = 256 with f32, bf16 and int8-count blocks, at
   T = 128, and at W = 65 and 300, f32 and bf16 x, and on the
   degree-sorted power-law graph's bucketed int8 layout (its hub row tile
   split, and the combine kernel alone on its partials, at W = 64, 65 and
   300 and at bf16, beside torch.sum's time for its sums); each beside its
   bound (K7: FP32 and tensor cores), its plain version and cuSPARSE (CSR
   for K6, BSR for K7, the count scale folded in); each layout's
   device footprint; and this card's cost model (``ops/bsr.py``
   ``_EDGE_EQUIV_BYTES`` and ``_BUCKETED_BREAKEVEN_SCALE``) measured from
   K1's time per edge at Pokec's size and K7's per block.
10. cli: the cora preset unchanged (DIFFormer-s, 500 epochs, 5 runs) through
   ``difformer_tpu_torch.cli.main`` on Planetoid raw files written for the
   slice's synthetic graph, its GCN branch on the default ELL layout (K6,
   no K1); again with --kernel sigmoid (K2-K4 and K6), with --reorder rcm
   and with --spmm coo (K1), each cut to 1 run (the script's time limit);
   then --save_model cut to 50 epochs and 1 run,
   and --eval_only, which must give the saved run's metrics. Each run's
   test accuracy above chance, its kernels launched, host seconds of load
   and preprocess and of the fit, ms per epoch.
10b. spmm-layouts: bench.py's three graphs, each through ``choose_spmm``
   with this card's cost model (its election, coverage and the densest
   tiles printed), the elected layout built as the command line builds it
   (on the clustered graph also the padded hybrid with its intra-community
   tiles dense, on the power law the degree-sorted bucketed hybrid whose
   hub row tile K7 splits, whatever the election), and bench.py's model
   (3-layer DIFFormer-s, hidden 64, 112 outputs; NLL over 112 classes)
   trained 10 epochs
   through ``FullBatchTrainer``'s graph fit (K6, K7 captured) and the
   per-epoch loop, bit-equal, and against K1's graph fit from the same
   weights within rtol 1e-3; steady ms per epoch (replayed) beside K1's.
10c. cli-layouts: --spmm bsr, bsr-sorted and auto on the cora preset's
   files (1 of its 5 runs), and --spmm auto on bench.py's clustered graph
   written as a Pokec file (the pokec preset full-batch, 20 epochs; the
   command line symmetrises it, doubling its tiles' edges), which must
   elect bsr: each run's kernels (K7, and K6 where a residual) and test
   accuracy.
11. cli-set: the cifar10 preset unchanged (hidden 300, 2 layers, no graph,
   600 epochs, 5 runs) on stand-in embeddings [15000, 512]; then
   --kernel sigmoid --use_graph true cut to 20 epochs and 1 run (K6 on the
   kNN graph's default ELL layout and the wide K2-K4), with the kNN
   graph's host seconds.
12. zoo-cora: every method of the baseline zoo (mlp, manireg, gcn, gat,
   sgc, link, mixhop, gcnjk with --jk_type max, cat and lstm, gatjk, h2gcn,
   appnp, gprgnn, lp, multilp) through the command line at the cora
   preset's widths (hidden 64, 8 layers), cut to 20 epochs and 1 run: each
   one's test metric, fit ms per epoch and peak memory, its kernels (K1 in
   both directions for the trained graph models, K1's forward alone for
   label propagation, none for the MLPs, K1-dval for GAT and GATJK and no
   other; K1-dval once a GAT layer in a captured train step, whatever its
   heads); GCN and GAT again through the per-epoch loop, held against their
   graph fits (best epoch, losses and metrics within rtol 1e-5).
13. zoo-cifar10: GCN and GAT (2 heads) on the cifar10 preset (hidden 300,
   2 layers, the set track's kNN graph) on the stand-in embeddings, cut to
   5 epochs: ms per epoch and peak memory.
14. minibatch-pokec: the pokec preset (mini-batch training, batch 100000,
   hidden 128, 3 layers) through the command line on a stand-in
   ``pokec.mat`` of Pokec's size (1,632,803 nodes, 30,622,564 power-law
   edges, 65 features, 2 classes), cut to 3 epochs and 1 run: each chunk's
   step replayed as a CUDA graph; the first epoch again through the
   per-chunk loop, bit-equal; the native library loaded; host seconds of
   load and preprocess and of the chunk plans, ms per epoch and per chunk
   step for both paths, the device idle share, the chunks with heavy rows;
   K1's replays equal to layers x chunks x epochs in each direction.
   minibatch-pokec-remat: the pokec preset's trainer on the same stand-in
   with the model at bf16, one epoch with ``remat=True`` and one without:
   K1's replays against the remat-aware count, K1's bf16 capacity launch
   on the chunk with the most segments, peak memory and ms per chunk
   step of both, and the chunk losses of both compared.
   minibatch-zoo: the baseline zoo in node chunks, ``--dataset pokec
   --method gcn`` and ``--method gat`` (2 heads) through the command line
   on the same stand-in, the preset unchanged (hidden 128, 3 layers, batch
   100000, BatchNorm) but cut to 2 epochs and 1 run: each chunk's step on
   the model's own chunk plan (GCN's ``gcn_norm`` with self-loops, GAT's
   edges and loops with their maps and incidences) replayed as a CUDA
   graph; the test metric in [0, 1]; K1's (and K1-dval's) replays equal
   to the captured step's count, which the model's layers give, times the
   chunk steps; the full graph's logits against the plain versions; the
   best state's BatchNorm statistics those of its epoch; the first epoch
   again through the loop, bit-equal; host ms of an epoch's plans, ms per
   chunk step and per steady epoch, the idle share, peak memory; K1's
   capacity launch on GCN's chunk plan and K1-dval's on GAT's, against
   their plain versions, cuSPARSE and ``sampled_addmm``.
15. minibatch-proteins: ``MiniBatchTrainer`` at ogbn-proteins' shape
   (132,534 nodes, 79,122,504 directed edges with hubs of thousands, 8
   features, 112 binary tasks, BCE and ROC-AUC, batch 10000, hidden 64, 3
   layers), 3 epochs: the same numbers, the host's share of the epoch in
   view.
16. temporal-chickenpox and temporal-wikimath: the temporal presets
   through the command line on stand-in JSON files of the published
   shapes (chickenpox: 20 nodes, 102 edges, 522 weeks, cumulative mode;
   wikimath: 1,068 nodes, 27,079 weighted edges, 731 days, incremental),
   cut to 3 epochs: DIFFormer on both, MPNN-LSTM on chickenpox, DCRNN with
   K = 3 on wikimath; each epoch's steps and evals replayed as CUDA
   graphs, K1's replays against the model's count, the same fit through
   the per-snapshot loop bit-equal, ms per epoch, the capture's seconds
   and the graphs' kernel nodes.

17. graph-level: the graph-level (particle) track at the actstrack
   preset's full width (DIFFormer-v2 with the mean-pooling head, hidden
   64, 2 layers, dropout 0.4, batch 1024) on 4096 stand-in graphs of
   ActsTrack's processed shapes (100 ± 20 hits, 9 + 3 features, kNN k = 5
   with self loops on positions on the unit sphere), with each kernel: 3
   epochs of ``GraphLevelTrainer`` on CUDA graphs and the same 3 in the
   eager loop, bit-equal; the dense plan, as the probe picks it, with no
   kernel of the port on that path; ms per steady train step (replayed
   and eager), graphs per second, ms per epoch with the evals, capture
   seconds and kernel nodes, idle share, peak memory, and the top kernels
   of a replayed step.
18. graph-level-plans: one batch of that stand-in through the three conv
   plans (dense, gather table, edge list): logits and gradients agree
   within rtol 1e-4 / atol 1e-5; K1's device kernels in a captured train
   step on the edge-list plan (4, none split); each plan's conv alone,
   forward and backward, with K1 against its plain version and cuSPARSE;
   then one epoch on the edge-list plan, whose K1 launches are the JSON
   line's "graph-level" rows'.
18b. capture-repeat: the actstrack preset's sigmoid trainer (the dense
   plan) captures its train step 10 times (cut from 30 for the script's
   time limit) while its packing threads
   allocate pinned buffers: no capture is invalidated (the trainers
   capture in thread-local mode).
19. cli-actstrack: ``python -m difformer_tpu_torch.cli --dataset
   actstrack`` on a stand-in processed cache of 3000 graphs, cut to 3
   epochs and 1 run, with each kernel: the cache read (no fallback), fit
   ms per epoch, test ROC-AUC.

The minibatch-pokec phase also holds K1 as the trainer launches it (the
chunk's plan packed at a fixed capacity, counts read on the device) on the
trainer's own chunk with the most segments against its plain version, and
bit-equal to the exact-count launch, and times it.

Then one JSON line with every kernel's numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. It needs a CUDA device and
the repository around it; it imports nothing of JAX. Without ``pandas`` or
``yaml`` it runs all the same: the graph-level phases read and write the
processed cache with numpy alone.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
import unittest.mock

import numpy as np
import torch

import difformer_tpu_torch  # noqa: F401  (fails before any output outside the repository)

# Published peaks of one H100 SXM (dense): FP32 outside the tensor cores and
# bf16 tensor-core rate, in operations per second; HBM3 bytes per second.
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12

# (N, L, H, M, D, dtype, masked): the slice's shape, ragged edges with a key
# mask, bf16 with four heads, and pubmed's size
SHAPES = [
    (2708, 2708, 1, 64, 64, torch.float32, False),
    (1000, 1300, 2, 32, 48, torch.float32, True),
    (4096, 4096, 4, 64, 64, torch.bfloat16, False),
    (19717, 19717, 1, 64, 64, torch.float32, False),
]
SOURCE = "difformer_tpu_torch/csrc/sigmoid_attention.cu"
PALLAS = "difformer_tpu/kernels/pallas_sigmoid_attention.py"
REPLACES = {
    "sigmoid_attention_fwd": f"{PALLAS}:154",
    "sigmoid_attention_dq": f"{PALLAS}:340",
    "sigmoid_attention_dkv": f"{PALLAS}:359",
}
# K1, the CSR SpMM of the GCN branch: one kernel, launched over the forward
# CSR and over the transposed one (the backward), counted apart
SPMM_SOURCE = "difformer_tpu_torch/csrc/spmm.cu"
SPMM_REPLACES = "difformer_tpu/ops/graph_ops.py:107"
SPMM_NAMES = ("csr_spmm", "csr_spmm_transposed")
# K1-dval, the gradient of K1 with respect to its edge values (GAT's
# attention): XLA's autodiff of GAT's feat[senders] * att in the JAX package
DVAL_NAME = "csr_spmm_dval"
DVAL_REPLACES = "difformer_tpu/nn/gnns.py:183"
# the K1-dval shapes of the JSON line, by label, with the suffix of their
# names
DVAL_JSON = {"cora": "", "cora h2": " cora h2", "cifar10": " cifar10",
             "pokec power-law": " pokec power-law", "hub": " hub"}
# the K1 shapes of the JSON line, by label, with the suffix of their names
SPMM_JSON = {"cora": "", "pokec": " pokec",
             "pokec power-law": " pokec power-law"}
# Pokec's size (the pokec preset's graph, 1,632,803 nodes and 30,622,564
# edges) at its hidden width
POKEC_NODES, POKEC_EDGES = 1_632_803, 30_622_564
# the power-law graph of Pokec's size: node ids drawn as floor(N·u^2) of a
# uniform u, so a node's degree falls as its rank^(-1/2)
POWER_LAW_EXPONENT = 2
PLAIN_EDGE_CHUNK = 1 << 22  # the plain version's messages at Pokec's size
EPOCHS = 20
H8_STEPS = 3
GRAPH_BLOCK = 10  # epoch_block of the graph phases (eval every epoch)
GRAPH_RTOL = 1e-5
GRAPH_TOP = 15  # kernels of a replayed block's profile to print
# K2-K4 on their wide path at the set track's widths (hidden 300 for cifar10
# and 20news, 400 for stl10, one head), N = L = 15000 (cifar10's cut)
WIDE_SHAPES = [
    (15000, 15000, 1, 300, 300, torch.float32, False),
    (15000, 15000, 1, 300, 300, torch.float32, True),
    (15000, 15000, 1, 400, 400, torch.float32, False),
    (15000, 15000, 1, 400, 400, torch.float32, True),
    (15000, 15000, 1, 300, 300, torch.bfloat16, False),
]
WIDE_JSON = WIDE_SHAPES[0]  # the shape of the JSON line's wide rows
# cifar10 as load_image_text reads it: 15000 rows (its cut) of ResNet-18
# embeddings (512 wide), 10 classes
CIFAR10_NODES, CIFAR10_WIDTH, CIFAR10_CLASSES = 15000, 512, 10
# device launches per train step of the slices with the host-stepped
# (non-capturable) Adam of commit dad714c, for comparison
HOST_ADAM_LAUNCHES = {"slice": 498, "slice-s": 938}


def say(*parts):
    print(*parts, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, target_ms=100.0, max_iters=50):
    """Mean device time of ``fn`` in ms from CUDA events, after warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = max(3, min(max_iters, int(target_ms / max(
        start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def replay_ms(fn, calls=20, reps=5):
    """Device time in ms of one call of ``fn``, from CUDA events around
    replays of a CUDA graph of ``calls`` calls (the median of ``reps``): no
    host time between the calls, and nothing the profiler can drop. ``fn``
    must be capturable."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return sorted(times)[reps // 2]


def profile_window(fn, calls, rows=False):
    """(device ms, device operations) per call of ``fn`` over one
    torch.profiler session of ``calls`` calls, after one unprofiled call:
    the device's own kernels, copies and sets, without annotations. With
    ``rows``, also each kernel's (ms per call, launches per call, name),
    longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    total = (sum(e.self_device_time_total for e in events) / 1e3 / calls,
             sum(e.count for e in events) / calls)
    if not rows:
        return total
    return total, sorted(((e.self_device_time_total / 1e3 / calls,
                           e.count / calls, e.key) for e in events),
                         reverse=True)


def device_profile(fn, calls=20):
    """(device ms, device operations) of one call of ``fn``
    (:func:`profile_window`). Unlike :func:`cuda_ms` the time leaves out
    the device's idle gaps, which set the event time of a call whose
    kernels take a few microseconds and whose host side takes tens. The
    profiler now and then returns no device operation at all: such a
    session is run again after a pause, with twice the calls, up to five
    sessions. If none records any, the time is :func:`cuda_ms`'s, idle
    gaps included, the operations are None (not measured), and a line
    says so."""
    for attempt in range(5):
        ms, count = profile_window(fn, calls << attempt)
        if count > 0:
            return ms, count
        time.sleep(0.2)
    ms = cuda_ms(fn)
    say(f"the profiler recorded no device operation in five sessions: "
        f"{ms:.4f} ms from CUDA events (idle gaps included), device "
        f"operations not measured")
    return ms, None


def device_ms(fn, calls=20):
    """Device time in ms of one call of ``fn`` (:func:`device_profile`)."""
    return device_profile(fn, calls)[0]


def attention_work(name, n, l, h, m, d, dtype):
    """(flops, bytes) of one call of attention kernel ``name``: each input
    read once and each output written once; the N·L·H sigmoids are not
    counted."""
    e = torch.tensor([], dtype=dtype).element_size()
    qkv = (n * m + l * m + l * d) * h * e
    grads_in = (n * d + n) * h * 4
    if name == "sigmoid_attention_fwd":
        flops = 2 * n * l * h * (m + d + 1)
        nbytes = qkv + n * h * d * e + n * h * 4
    elif name == "sigmoid_attention_dq":
        flops = 2 * n * l * h * (2 * m + d)
        nbytes = qkv + grads_in + n * h * m * e
    else:
        flops = 2 * n * l * h * (2 * m + 2 * d)
        nbytes = qkv + grads_in + l * h * (m + d) * e
    return flops, nbytes


def bound_ms(name, n, l, h, m, d, dtype):
    """(least time for the work in ms, "bytes" or "operations"): the larger
    of :func:`attention_work`'s bytes over the HBM rate and flops over the
    peak rate for the dtype."""
    flops, nbytes = attention_work(name, n, l, h, m, d, dtype)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                        else "operations")


# Dense TF32 rate of one H100 SXM's tensor cores, and the wide kernels that
# run on them, all three (mma.sync TF32: three passes at float32 inputs,
# 3xTF32, one at bfloat16, whose values TF32 holds exactly)
PEAK_TF32 = 495e12
TENSOR_CORE_WIDE = ("sigmoid_attention_fwd", "sigmoid_attention_dq",
                    "sigmoid_attention_dkv")


def tensor_bound_ms(name, n, l, h, m, d, dtype):
    """(least time in ms, what it assumes) of a wide kernel at the rate of
    the instructions it multiplies with: :func:`bound_ms`'s operations at
    the TF32 rate, times three passes at float32 inputs, against the same
    bytes; for a kernel on FFMA, :func:`bound_ms` itself."""
    if name not in TENSOR_CORE_WIDE:
        return bound_ms(name, n, l, h, m, d, dtype)[0], "FFMA at 67 TFLOP/s"
    flops, nbytes = attention_work(name, n, l, h, m, d, dtype)
    passes = 3 if dtype == torch.float32 else 1
    return (1e3 * max(nbytes / PEAK_BYTES, passes * flops / PEAK_TF32),
            f"{passes}xTF32 at 495 TFLOP/s")


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"phase device: {smi} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")
    say(f"phase device: allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from difformer_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    info = build.build_info
    say(f"phase build: {', '.join(info['paths'])} built in "
        f"{info['seconds']:.1f} s (cached={info['cached']}, load "
        f"{time.perf_counter() - t0:.1f} s)")
    name, spills = None, "?"
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            say(f"  ptxas: {line.split(':', 1)[-1].strip()}")
        if "spill stores" in line:
            spills = line.split("bytes spill stores")[0].split(",")[-1].strip()
        wide = re.search(r"(sigattn_\w+_wide_kernel)I(f|13__nv_bfloat16)",
                         line)
        # K1-dval's <V, P, U> and the K7 combine's <type, V> instances
        dval = re.search(r"csr_spmm_dval_kernelILi(\d)ELi(\d)ELi(\d)E",
                         line)
        combine = re.search(r"bsr_combine_kernelI(f|13__nv_bfloat16)Li(\d)E",
                            line)
        if wide:
            name = f"{wide[1]}<{'float' if wide[2] == 'f' else 'bf16'}>"
        elif dval:
            name = (f"csr_spmm_dval_kernel<V={dval[1]}, P={dval[2]}, "
                    f"U={dval[3]}>")
        elif combine:
            name = (f"bsr_combine_kernel<"
                    f"{'float' if combine[1] == 'f' else 'bf16'}, "
                    f"V={combine[2]}>")
        elif "registers" in line and name:
            registers = line.split("Used")[1].split("registers")[0].strip()
            say(f"phase build: {name}: {registers} registers, {spills} "
                f"bytes spilled")
            name = None


def attention_case(n, l, h, m, d, dtype, masked, seed, scale=1.0):
    """q, k, v, a key mask (or None) and an output cotangent on the card;
    q and k are ``scale`` times standard normal."""
    g = torch.Generator().manual_seed(seed)
    q = (scale * torch.randn((n, h, m), generator=g)).to("cuda", dtype)
    k = (scale * torch.randn((l, h, m), generator=g)).to("cuda", dtype)
    v = torch.randn((l, h, d), generator=g).to("cuda", dtype)
    mask = None
    if masked:
        mask = (torch.rand(l, generator=g) > 0.3).float()
        mask[0] = 1.0
        mask = mask.cuda()
    cot = torch.randn((n, h, d), generator=g).cuda()
    return q, k, v, mask, cot


def assert_rejects(label, ref, kind, den=None, scale=None):
    """The comparison must fail an output of zeros and one whose rows are
    each moved one place down: a check that passes either cannot tell a
    wrong kernel from a right one at this shape."""
    from difformer_tpu_torch.kernels.tolerance import assert_close

    for wrong, what in ((torch.zeros_like(ref), "zeros"),
                        (ref.roll(1, 0), "rows moved one place")):
        try:
            assert_close(label, wrong, ref, kind, den, scale)
        except AssertionError:
            continue
        raise AssertionError(f"{label}: the tolerance passes {what}")


def phase_kernels():
    """Each kernel against its plain version under the rule of
    ``kernels/tolerance.py``: float32 at the JAX package's tolerances, the
    unnormalized numerator per unit of its row's denominator, bfloat16
    relative to the largest reference value. Each comparison is shown to
    fail a wrong output of the same shape. Times from CUDA events at every
    shape, and at the slice's shape also the device time
    (:func:`device_ms`), which the JSON line reports for every kernel."""
    from difformer_tpu_torch.kernels import sigmoid_attention as K
    from difformer_tpu_torch.kernels.tolerance import assert_close

    rows = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for idx, (n, l, h, m, d, dtype, masked) in enumerate(SHAPES):
        q, k, v, mask, g = attention_case(n, l, h, m, d, dtype, masked, idx)
        label = (f"N={n} L={l} H={h} M={m} D={d} "
                 f"{str(dtype).split('.')[-1]}{' mask' if masked else ''}")

        out, den = K.sigmoid_attention_fwd(q, k, v, mask)
        r_out, r_den = K.sigmoid_attention_fwd_plain(q, k, v, mask)
        e_fwd = max(assert_close(f"fwd out {label}", out, r_out, "out"),
                    assert_close(f"fwd den {label}", den, r_den, "den"))
        num, den_u = K.sigmoid_attention_fwd(q, k, v, mask, normalize=False)
        r_num, r_den_u = K.sigmoid_attention_fwd_plain(q, k, v, mask,
                                                       normalize=False)
        e_unnorm = max(
            assert_close(f"fwd num {label}", num, r_num, "num", den=r_den_u),
            assert_close(f"fwd den (unnormalized) {label}", den_u, r_den_u,
                         "den"))

        # cotangents as the normalized op's backward derives them
        dnum = g / den[..., None]
        dden = -(g * out.float()).sum(-1) / den
        dq = K.sigmoid_attention_dq(q, k, v, mask, dnum, dden)
        r_dq = K.sigmoid_attention_dq_plain(q, k, v, mask, dnum, dden)
        e_dq = assert_close(f"dq {label}", dq, r_dq, "grad")
        dk, dv = K.sigmoid_attention_dkv(q, k, v, mask, dnum, dden)
        r_dk, r_dv = K.sigmoid_attention_dkv_plain(q, k, v, mask, dnum, dden)
        e_dkv = max(assert_close(f"dk {label}", dk, r_dk, "grad"),
                    assert_close(f"dv {label}", dv, r_dv, "grad"))
        for name, ref, kind, den_ref in (
                ("out", r_out, "out", None), ("den", r_den, "den", None),
                ("num", r_num, "num", r_den_u), ("dq", r_dq, "grad", None),
                ("dk", r_dk, "grad", None), ("dv", r_dv, "grad", None)):
            assert_rejects(f"{name} {label}", ref, kind, den_ref)
        torch.cuda.synchronize()

        cases = {
            "sigmoid_attention_fwd": (
                e_fwd, lambda: K.sigmoid_attention_fwd(q, k, v, mask),
                lambda: K.sigmoid_attention_fwd_plain(q, k, v, mask)),
            "sigmoid_attention_dq": (
                e_dq,
                lambda: K.sigmoid_attention_dq(q, k, v, mask, dnum, dden),
                lambda: K.sigmoid_attention_dq_plain(q, k, v, mask, dnum,
                                                     dden)),
            "sigmoid_attention_dkv": (
                e_dkv,
                lambda: K.sigmoid_attention_dkv(q, k, v, mask, dnum, dden),
                lambda: K.sigmoid_attention_dkv_plain(q, k, v, mask, dnum,
                                                      dden)),
        }
        unnorm_ms = cuda_ms(
            lambda: K.sigmoid_attention_fwd(q, k, v, mask, normalize=False))
        grids = {}
        for name in cases:
            per_split, splits, chunk = K.split_plan(name, n, l, h, m, d, sms)
            grids[name] = (f" | S={splits} ({chunk} loop tiles each), "
                           f"{per_split * splits} blocks")
        for name, (err, kernel, plain) in cases.items():
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            bound, bound_by = bound_ms(name, n, l, h, m, d, dtype)
            device = ""
            if idx == 0:
                # the JSON line's times are device times, as K1's
                dev_ms, dev_plain_ms = device_ms(kernel), device_ms(plain)
                rows[name] = dict(max_abs_err=err, ms=dev_ms,
                                  plain_ms=dev_plain_ms, bound_ms=bound,
                                  bound_by=bound_by)
                device = (f" | device {dev_ms:.4f} ms, plain "
                          f"{dev_plain_ms:.4f} ms")
            say(f"phase kernels: {name:22s} {label:40s} max_abs_err "
                f"{err:.3e} | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
                f"bound {bound:.4f} ms by {bound_by} "
                f"({100 * bound / ms:.1f}% of the kernel's time)"
                f"{device}{grids[name]}")
        say(f"phase kernels: sigmoid_attention_fwd normalize=False "
            f"{label:40s} max_abs_err {e_unnorm:.3e} | kernel "
            f"{unnorm_ms:.4f} ms{grids['sigmoid_attention_fwd']}")
        del q, k, v, mask, g, out, den, num, den_u, dq, dk, dv
        del r_out, r_den, r_num, r_den_u, r_dq, r_dk, r_dv
        torch.cuda.empty_cache()
    return rows


def cudart():
    """The CUDA runtime library that PyTorch loaded, through ctypes (the
    toolkit's where a name alone does not find it)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for name in ("libcudart.so.12", "libcudart.so",
                 f"{home}/lib64/libcudart.so"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.cudaGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_size_t)]
        lib.cudaGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                             ctypes.POINTER(ctypes.c_int)]
        return lib
    raise RuntimeError("libcudart was not found")


CUDA_GRAPH_NODE_KERNEL = 0  # cudaGraphNodeTypeKernel


def graph_kernels(fn):
    """(kernel nodes, all nodes) of the CUDA graph that one call of ``fn``
    captures: the device kernels a call launches, counted from the graph
    itself (cudaGraphGetNodes, cudaGraphNodeGetType), not by the profiler
    or the wrappers. ``fn`` must be capturable (no host sync); the graph is
    never replayed."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    kinds = graph_node_kinds(graph)
    del graph
    return kinds.count(CUDA_GRAPH_NODE_KERNEL), len(kinds)


def graph_node_kinds(graph):
    """The node types of a captured ``torch.cuda.CUDAGraph`` made with
    ``keep_graph=True`` (cudaGraphGetNodes, cudaGraphNodeGetType)."""
    lib, raw = cudart(), ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed: CUDA error {rc}")

    check(lib.cudaGraphGetNodes(raw, None, ctypes.byref(count)),
          "cudaGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    check(lib.cudaGraphGetNodes(raw, nodes, ctypes.byref(count)),
          "cudaGraphGetNodes")
    kinds = []
    for node in nodes[:count.value]:
        kind = ctypes.c_int(-1)
        check(lib.cudaGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind)),
              "cudaGraphNodeGetType")
        kinds.append(kind.value)
    return kinds


def spmm_bound_ms(n, e, w, x_rows=None, elem=4):
    """(least time in ms, "bytes" or "operations", compulsory bytes) of one
    K1 product: the ``x_rows`` rows of x that some edge gathers (all ``n``
    unless given) and out once each at ``elem`` bytes an element (4 at
    float32, 2 at bfloat16), int32 columns, float32 values and int32 row
    pointers; 2·E·W flops at the FP32 rate (K1 sums in float32 at either
    type)."""
    x_rows = n if x_rows is None else x_rows
    nbytes = (n + x_rows) * w * elem + (2 * e + n + 1) * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES, 2 * e * w / PEAK_OPS[torch.float32]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations", nbytes)


def spmm_gather_floor_ms(n, e, w):
    """The gather floor of one K1 product in ms, a diagnostic beside its
    bound: every gathered row x[col[e]] (E·W floats), out, col, val and
    row_ptr, each moved once from HBM with no reuse in L2. K1 can beat it
    only where L2 holds rows that many edges gather."""
    return 1e3 * (e * w + n * w + 2 * e + n + 1) * 4 / PEAK_BYTES


def cora_graph(f=1433):
    """The slice's synthetic graph of Cora's size (numpy)."""
    from difformer_tpu_torch.data import random_graph, standard_preprocess

    x, ei, y = random_graph(2708, 10556, f, 7, seed=42, homophily=0.8)
    return x, standard_preprocess(ei, 2708), y


def spmm_shapes():
    """(label, plan, W, plain edge chunk) at K1's seven shapes, one at a
    time: the slice's graph at the widths the model gives K1 (64; 65 under
    spmm_first; 8 heads of 64 unfused), a ragged graph (unsorted edges,
    edge_mask, edge_weight, empty rows of both CSRs), a graph of PubMed's
    size, and two of Pokec's, whose edges are drawn on the card: one with
    uniform senders and receivers (every row near the mean degree, 18.8)
    and one with power-law in- and out-degrees, where one group of lanes
    walks a row of tens of thousands of edges."""
    from difformer_tpu_torch.data import random_graph, standard_preprocess
    from difformer_tpu_torch.ops.graph_ops import build_csr_plan

    def plan_of(ei, n, weight=None, mask=None):
        t = lambda a: None if a is None else torch.as_tensor(a, device="cuda")
        return build_csr_plan(t(ei[0]), t(ei[1]), n, t(weight), t(mask))

    _, ei, _ = cora_graph()
    cora = plan_of(ei, 2708)
    yield "cora", cora, 64, None
    yield "cora spmm_first", cora, 65, None
    yield "cora H=8 unfused", cora, 8 * 64, None
    del cora
    rng = np.random.default_rng(5)
    n, e = 1000, 6000
    ei = np.stack([rng.integers(0, 950, e), rng.integers(0, 900, e)])
    yield ("ragged", plan_of(ei, n, rng.uniform(0.2, 2.0, e).astype(
        np.float32), rng.random(e) > 0.2), 48, None)
    _, ei, _ = random_graph(19717, 44324, 500, 3, seed=7, homophily=0.8)
    yield "pubmed", plan_of(standard_preprocess(ei, 19717), 19717), 64, None
    g = torch.Generator("cuda").manual_seed(11)
    n, e = POKEC_NODES, POKEC_EDGES
    senders = torch.randint(0, n, (e,), device="cuda", generator=g)
    receivers = torch.randint(0, n, (e,), device="cuda", generator=g)
    receivers = receivers.sort().values
    plan = build_csr_plan(senders, receivers, n)
    del senders, receivers
    yield "pokec", plan, 128, PLAIN_EDGE_CHUNK
    del plan
    senders = power_law_nodes(n, e, g)
    receivers = power_law_nodes(n, e, g).sort().values
    plan = build_csr_plan(senders, receivers, n)
    del senders, receivers
    yield "pokec power-law", plan, 128, PLAIN_EDGE_CHUNK


def power_law_nodes(n, e, g, exponent=POWER_LAW_EXPONENT):
    """``e`` node ids on the card, rank ``floor(n·u^a)`` of a uniform u
    (a = ``exponent``), so the rank-i node is drawn with probability
    ((i+1)/n)^(1/a) − (i/n)^(1/a) (at a = 2, √(i+1) − √i over √n); the
    ranks are shuffled over the ids."""
    u = torch.rand(e, device="cuda", generator=g, dtype=torch.float64)
    rank = (n * u.pow_(exponent)).long().clamp_(max=n - 1)
    return torch.randperm(n, device="cuda", generator=g)[rank]


def library_spmm(row_ptr, col, val, n, dtype=torch.float32):
    """cuSPARSE's CSR SpMM through one PyTorch call, for its time; the
    values in ``dtype``, as the call takes them of x's type."""
    a = torch.sparse_csr_tensor(row_ptr, col, val.to(dtype), size=(n, n))
    return lambda x: torch.sparse.mm(a, x)


def phase_spmm_kernels():
    """K1 forward (the receivers' CSR) and transposed (the senders' CSR,
    the backward) against its plain version at every shape, at float32 and
    at bfloat16 (bf16 x and out, f32 sums, one rounding: the model at
    ``compute_dtype="bfloat16"``), each comparison shown to fail a wrong
    output and two calls shown bit-equal; the split schedule (T, heavy
    rows, segments) and the device kernels a call, counted in the CUDA
    graph of one call (:func:`graph_kernels`), which must be one without
    heavy rows and two with them (the segments' combine), at every shape
    and type; kernel, plain and cuSPARSE device times
    (:func:`device_profile`) beside the bound (x and out at the type's
    bytes) and the gather floor, and the kernel's event time
    (:func:`cuda_ms`, which the host's launch rate sets at the small
    shapes). Where cuSPARSE refuses the type through ``torch.sparse.mm``,
    the row prints its error and has no library time. Returns the JSON
    rows of the shapes in ``SPMM_JSON``, the bf16 rows named with a
    " bf16" suffix."""
    from difformer_tpu_torch.kernels import spmm as K1
    from difformer_tpu_torch.kernels.tolerance import assert_close

    rows = {}
    for idx, (label, plan, w, chunk) in enumerate(spmm_shapes()):
        n, e = plan.num_nodes, plan.num_edges
        g = torch.Generator("cuda").manual_seed(100 + idx)
        x32 = torch.randn((n, w), device="cuda", generator=g)
        floor = spmm_gather_floor_ms(n, e, w)
        for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, " bf16")):
            x = x32.to(dtype)
            elem = x.element_size()
            bound, bound_by, nbytes = spmm_bound_ms(n, e, w, elem=elem)
            for name, (ptr, col, val), split in zip(SPMM_NAMES, (
                    (plan.row_ptr, plan.col, plan.val),
                    (plan.t_row_ptr, plan.t_col, plan.t_val)),
                    (plan.split, plan.t_split)):
                transposed = name == "csr_spmm_transposed"
                kernel = lambda: K1.csr_spmm(  # noqa: E731
                    x, ptr, col, val, split=split, transposed=transposed)
                plain = lambda: K1.csr_spmm_plain(  # noqa: E731
                    x, ptr, col, val, edge_chunk_size=chunk)
                out, ref = kernel(), plain()
                scale = K1.csr_spmm_abs(x, ptr, col, val,
                                        edge_chunk_size=chunk)
                tag = f"{name}{suffix} {label} N={n} E={e} W={w}"
                err = assert_close(tag, out, ref, "spmm", scale=scale)
                assert_rejects(tag, ref, "spmm", scale=scale)
                if not torch.equal(out, kernel()):
                    raise AssertionError(f"{tag}: two calls differ")
                try:
                    library = library_spmm(ptr, col, val, n, dtype)
                    lib_err = (library(x).float() - ref.float()).abs().max()
                    library_note = f"(max_abs_err {lib_err.item():.3e})"
                except RuntimeError as ex:
                    library = None
                    library_note = (f"refused {str(dtype)[6:]}: "
                                    f"{str(ex).splitlines()[0][:160]}")
                most = int((ptr[1:] - ptr[:-1]).max())
                del out, ref, scale
                torch.cuda.synchronize()
                event_ms = cuda_ms(kernel)
                expect = 2 if split.num_heavy else 1
                kernels, nodes = graph_kernels(kernel)
                for _ in range(3):  # a session now and then drops one event
                    ms, profiled = device_profile(kernel)
                    if profiled in (kernels, None):
                        break
                plain_ms = device_ms(plain)
                library_ms = (None if library is None
                              else device_ms(lambda: library(x)))
                profiled = "none" if profiled is None else f"{profiled:g}"
                lib_ms = ("none" if library_ms is None
                          else f"{library_ms:.4f} ms")
                say(f"phase kernels: {tag:57s} max_abs_err {err:.3e}, two "
                    f"calls bit-equal | largest degree {most}, "
                    f"T={split.threshold}: {split.num_heavy} heavy rows, "
                    f"{split.num_segments} segments | kernel {ms:.4f} ms in "
                    f"{kernels} device kernels a call ({nodes} graph nodes; "
                    f"the profiler's count {profiled}; events "
                    f"{event_ms:.4f} ms) | plain {plain_ms:.4f} ms | "
                    f"cuSPARSE {lib_ms} {library_note} | bound "
                    f"{bound:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB; "
                    f"{100 * bound / ms:.1f}% of the kernel's time) | "
                    f"gather floor {floor:.4f} ms at float32 "
                    f"({e * w * 4 / 1e9:.4f} GB of gathered rows; "
                    f"{100 * floor / ms:.1f}% of the kernel's time)")
                if kernels != expect or nodes != expect:
                    raise AssertionError(f"{tag}: {kernels} device kernels "
                                         f"in {nodes} graph nodes a call, "
                                         f"expected {expect}")
                if label in SPMM_JSON:
                    rows[f"{name}{SPMM_JSON[label]}{suffix}"] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=bound_by,
                        library_ms=library_ms)
                del library
            del x
        del plan, x32
        torch.cuda.empty_cache()
    return rows, phase_dval_kernels()


def knn_plan_standin(n=CIFAR10_NODES, k=5):
    """The set track's graph on cifar10's stand-in embeddings, as the
    command line builds it (k = 5 nearest rows, the row itself among them,
    symmetrised, self loops once), with the kNN taken on the card."""
    from difformer_tpu_torch.data import standard_preprocess

    x = torch.as_tensor(cifar10_embeddings(num=n)[0], device="cuda")
    nbrs = torch.cdist(x, x).topk(k, largest=False).indices.cpu().numpy()
    ei = np.stack([nbrs.reshape(-1), np.repeat(np.arange(n), k)])
    return standard_preprocess(ei, n)


def dval_shapes():
    """(label, plan, H, D, plain edge chunk) of K1-dval, one at a time:
    GAT's plans (the edges with a self-loop on every node, receiver order)
    on the slice's graph of Cora's size at a head's width of the cora
    preset (64), one head and the zoo's 2 heads in one call, and on the set
    track's kNN graph of cifar10's stand-in at the cifar10 preset's (300);
    the power-law graph of Pokec's size at W = 64; and a graph with a hub
    row of 30 % of its 2 M edges, far above K1's split threshold, at 2
    heads of 64. Each plan's values take a gradient (``value_grad``; a
    package from before that flag, timed by ``time_kernels.py --root``,
    builds every plan so)."""
    import inspect

    from difformer_tpu_torch.nn.gnns import gat_plan
    from difformer_tpu_torch.ops.graph_ops import build_spmm_plan

    kw = ({"value_grad": True} if "value_grad" in
          inspect.signature(build_spmm_plan).parameters else {})
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    _, ei, _ = cora_graph()
    plan = gat_plan(t(ei[0]), t(ei[1]), 2708).plan
    yield "cora", plan, 1, 64, None
    yield "cora h2", plan, 2, 64, None
    ei = knn_plan_standin()
    yield ("cifar10", gat_plan(t(ei[0]), t(ei[1]), CIFAR10_NODES).plan,
           1, 300, None)
    g = torch.Generator("cuda").manual_seed(12)
    n, e = POKEC_NODES, POKEC_EDGES
    plan = build_spmm_plan(None, power_law_nodes(n, e, g),
                           power_law_nodes(n, e, g), n, **kw)
    yield "pokec power-law", plan, 1, 64, PLAIN_EDGE_CHUNK
    del plan
    n, e = 200_000, 2_000_000
    senders = torch.randint(0, n, (e,), device="cuda", generator=g)
    receivers = torch.where(
        torch.rand(e, device="cuda", generator=g) < 0.3, 7,
        torch.randint(0, n, (e,), device="cuda", generator=g))
    yield ("hub", build_spmm_plan(None, senders, receivers, n, **kw), 2, 64,
           PLAIN_EDGE_CHUNK)


def dval_bound_ms(n, e, h, d):
    """(least time in ms, "bytes" or "operations", compulsory bytes) of one
    K1-dval call: dout and x [N, H, D] read once, the row pointers and the
    columns of the E edges read once and dval [E, H] written once, all 4
    bytes an element; 2·E·H·D flops at the FP32 rate."""
    nbytes = (2 * n * h * d + n + 1 + e + e * h) * 4
    t_bytes = nbytes / PEAK_BYTES
    t_ops = 2 * e * h * d / PEAK_OPS[torch.float32]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations", nbytes)


def dval_gather_floor_ms(e, h, d):
    """The x-gather floor of one K1-dval call in ms: every edge's x row,
    E·H·D·4 bytes, read from HBM (no L2 or L1 reuse)."""
    return 1e3 * e * h * d * 4 / PEAK_BYTES


def library_dval(plan, g, x):
    """``torch.sparse.sampled_addmm`` on the plan's CSR, one call a head
    on that head's [N, D] copies of g and x: the same values,
    ``<g[row, h], x[col, h]>`` at each stored entry."""
    n = plan.num_nodes
    a = torch.sparse_csr_tensor(plan.row_ptr, plan.col,
                                torch.zeros(plan.num_edges, device="cuda"),
                                size=(n, n))
    heads = [(g[:, h].contiguous(), x[:, h].t().contiguous())
             for h in range(g.shape[1])] if g.dim() == 3 else [(g, x.t())]
    return lambda: [torch.sparse.sampled_addmm(a, gh, xh, beta=0.0)
                    for gh, xh in heads]


def dval_inputs(n, heads, d, seed):
    """dout and x of K1-dval as the path hands them over: [N, D] for one
    head, else [N, H, D] views of the head-concatenated [N, H·D] rows (the
    GAT layer's feat and its output's gradient), read in place."""
    gen = torch.Generator("cuda").manual_seed(seed)
    g = torch.randn((n, heads * d), device="cuda", generator=gen)
    x = torch.randn((n, heads * d), device="cuda", generator=gen)
    if heads == 1:
        return g, x
    return g.view(n, heads, d), x.view(n, heads, d)


def phase_dval_kernels():
    """K1-dval (``csrc/spmm.cu`` ``csr_spmm_dval_kernel``), every head in one
    call, against its plain version at :func:`dval_shapes`, under the
    "spmm" rule with each value's scale its sum of |dout·x|, shown to fail a
    wrong output, two calls bit-equal, one device kernel a call (counted in
    the CUDA graph of one call); its time by replays of a CUDA graph of 20
    calls (the profiler drops kernels of microseconds), the plain
    version's and ``sampled_addmm``'s (a call a head, summed) by events,
    beside its bound and its x-gather floor. Returns the JSON rows of the
    shapes in ``DVAL_JSON``."""
    from difformer_tpu_torch.kernels import spmm as K1
    from difformer_tpu_torch.kernels.tolerance import assert_close

    rows = {}
    for idx, (label, plan, heads, d, chunk) in enumerate(dval_shapes()):
        n, e = plan.num_nodes, plan.num_edges
        g, x = dval_inputs(n, heads, d, 200 + idx)
        kernel = lambda: K1.csr_spmm_dval(  # noqa: E731
            g, x, plan.rows, plan.col, row_ptr=plan.row_ptr,
            split=plan.dval_split)
        plain = lambda: K1.csr_spmm_dval_plain(  # noqa: E731
            g, x, plan.rows, plan.col, edge_chunk_size=chunk)
        out, ref = kernel(), plain()
        scale = K1.csr_spmm_dval_abs(g, x, plan.rows, plan.col,
                                     edge_chunk_size=chunk)
        tag = f"{DVAL_NAME} {label} N={n} E={e} H={heads} D={d}"
        err = assert_close(tag, out, ref, "spmm", scale=scale)
        assert_rejects(tag, ref, "spmm", scale=scale)
        if not torch.equal(out, kernel()):
            raise AssertionError(f"{tag}: two calls differ")
        try:
            library = library_dval(plan, g, x)
            got = torch.stack([v.values() for v in library()], -1)
            lib_err = (got.view(ref.shape) - ref).abs().max().item()
            library_note = f"(max_abs_err {lib_err:.3e})"
            del got
        except RuntimeError as ex:
            library = None
            library_note = f"refused: {str(ex).splitlines()[0][:160]}"
        del out, ref, scale
        torch.cuda.synchronize()
        kernels, nodes = graph_kernels(kernel)
        ms = replay_ms(kernel)
        profiled, _ = device_profile(kernel)
        plain_ms = cuda_ms(plain)
        library_ms = None if library is None else cuda_ms(library)
        bound, bound_by, nbytes = dval_bound_ms(n, e, heads, d)
        floor = dval_gather_floor_ms(e, heads, d)
        lib_ms = ("none" if library_ms is None
                  else f"{library_ms:.4f} ms")
        split = plan.dval_split
        say(f"phase kernels: {tag:64s} split: {split.num_heavy} heavy rows "
            f"in {split.num_segments} segments (T={split.threshold}) | "
            f"max_abs_err {err:.3e}, two calls bit-equal | kernel "
            f"{ms:.4f} ms (CUDA graph of 20 calls; profiler "
            f"{profiled:.4f} ms) in {kernels} device kernels a call "
            f"({nodes} graph nodes) | plain {plain_ms:.4f} ms | "
            f"sampled_addmm, {heads} call(s) {lib_ms} {library_note} | "
            f"bound {bound:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB; "
            f"{100 * bound / ms:.1f}% of the kernel's time) | x-gather "
            f"floor {floor:.4f} ms ({100 * floor / ms:.1f}% of the "
            f"kernel's time)")
        if kernels != 1 or nodes != 1:
            raise AssertionError(f"{tag}: {kernels} device kernels in "
                                 f"{nodes} graph nodes a call, expected 1")
        if label in DVAL_JSON:
            rows[f"{DVAL_NAME}{DVAL_JSON[label]}"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=library_ms)
        del g, x, plan, library
        torch.cuda.empty_cache()
    return rows


class PlainSpmm:
    """K1's autograd Function with the plain version in its place, for a
    reference forward on the card: per-head values (GAT's messages) a
    head at a time, and the edges ``edge_chunk_size`` at a time where the
    call asks for none (the zoo's full-graph eval at Pokec's size, whose
    [E, W] messages would not fit at once)."""

    def __init__(self, edge_chunk_size=None):
        self.edge_chunk_size = edge_chunk_size

    def apply(self, x, fwd, bwd, edge_chunk_size, values=None, maps=None,
              dval_split=None):
        from difformer_tpu_torch.kernels.spmm import csr_spmm_plain

        chunk = edge_chunk_size or self.edge_chunk_size
        if values is None:
            return csr_spmm_plain(x, *fwd[:3], edge_chunk_size=chunk)
        vals = values.reshape(values.shape[0], -1).t()[:, maps[0]]
        return torch.stack([csr_spmm_plain(x[:, h], fwd[0], fwd[1], vals[h],
                                           edge_chunk_size=chunk)
                            for h in range(x.shape[1])], 1)


def plain_attention(qs, ks, vs, *, key_mask=None):
    """The model's attention through the plain version (forward only)."""
    from difformer_tpu_torch.kernels import sigmoid_attention as K

    if vs.shape[1] != qs.shape[1]:
        vs = vs.expand(-1, qs.shape[1], -1)
    return K.sigmoid_attention_fwd_plain(qs, ks, vs, key_mask)[0]


def launch_counts():
    """Every kernel's launches since the last reset, by wrapper name (K1-dval
    apart: :func:`dval_count`)."""
    from difformer_tpu_torch.kernels import bsr as K7
    from difformer_tpu_torch.kernels import ell as K6
    from difformer_tpu_torch.kernels import sigmoid_attention as K
    from difformer_tpu_torch.kernels import spmm as K1

    return {**K.LAUNCHES, **K1.LAUNCHES, **K6.LAUNCHES, **K7.LAUNCHES}


def dval_count():
    """K1-dval's launches since the last reset (a count of its own)."""
    from difformer_tpu_torch.kernels import spmm as K1

    return K1.DVAL_LAUNCHES[DVAL_NAME]


def check_no_dval(phase, what):
    """Raise if K1-dval launched since the last reset: ``what``'s edge
    values take no gradient."""
    if dval_count():
        raise AssertionError(f"phase {phase}: {what} launched K1-dval "
                             f"{dval_count()} times; its values take no "
                             f"gradient")


def reset_launch_counts():
    from difformer_tpu_torch.kernels import bsr as K7
    from difformer_tpu_torch.kernels import ell as K6
    from difformer_tpu_torch.kernels import sigmoid_attention as K
    from difformer_tpu_torch.kernels import spmm as K1

    for kernels in (K, K1, K6, K7):
        kernels.reset_launch_counts()


def through_plain_versions(edge_chunk_size=None):
    """A context in which the model runs every kernel's plain version (K1's
    streaming ``edge_chunk_size`` edges at a time where a call asks for
    no chunks)."""
    import difformer_tpu_torch.nn.difformer as difformer_module
    from difformer_tpu_torch.ops import graph_ops

    stack = contextlib.ExitStack()
    stack.enter_context(unittest.mock.patch.object(
        difformer_module, "sigmoid_attention", plain_attention))
    stack.enter_context(unittest.mock.patch.object(
        graph_ops, "CsrSpmm", PlainSpmm(edge_chunk_size)))
    return stack


def in_float64():
    """A context in which the model computes in float64 where its kernels
    take float32 and bfloat16 only: its sigmoid attention the dense form
    (``ops/sigmoid_attention.py:sigmoid_attention_dense``) and its GCN
    products an ``index_add`` over the GCN values of the edges, in the
    input's dtype."""
    import difformer_tpu_torch.nn.difformer as difformer_module
    from difformer_tpu_torch.ops.graph_ops import gcn_norm_weights_masked
    from difformer_tpu_torch.ops.sigmoid_attention import (
        sigmoid_attention_dense)

    def gcn(x, senders, receivers, edge_weight=None, *, num_nodes=None,
            edge_mask=None, **_):
        n = x.shape[0] if num_nodes is None else num_nodes
        w = gcn_norm_weights_masked(senders, receivers, n, edge_weight,
                                    edge_mask).to(x.dtype)
        msg = x.index_select(0, senders.long()) * w.reshape(
            (-1,) + (1,) * (x.dim() - 1))
        return x.new_zeros((n,) + tuple(x.shape[1:])).index_add(
            0, receivers.long(), msg)

    stack = contextlib.ExitStack()
    stack.enter_context(unittest.mock.patch.object(
        difformer_module, "sigmoid_attention",
        lambda q, k, v, key_mask=None: sigmoid_attention_dense(
            q, k, v, key_mask=key_mask)))
    stack.enter_context(unittest.mock.patch.object(difformer_module,
                                                   "gcn_conv", gcn))
    return stack


def exact_reference(cfg, params, steps):
    """:func:`sharded_reference`'s steps from ``params`` in float64: the
    weights, the features and Adam in float64, the model
    :func:`in_float64`. Returns the logits after the steps, numpy
    float64."""
    from difformer_tpu_torch.train.optim import torch_adam

    trainer, split, n, _ = make_slice(cfg)
    state = trainer.init_state(0, init_params=params)
    state.model.double()
    trainer.graph.node_feat = trainer.graph.node_feat.double()
    state.optimizer = torch_adam(state.model.parameters(), cfg.lr,
                                 cfg.weight_decay)
    mask = torch.as_tensor(np.isin(np.arange(n), split["train"]),
                           device="cuda")
    with in_float64():
        for _ in range(steps):
            trainer.train_step(state, None, mask)
        logits = trainer.forward_eval(state).cpu().numpy()
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return logits


def preset_model(cfg, f, c, **model_kw):
    """DIFFormer as the command line builds it for preset ``cfg`` (``f``
    features, ``c`` outputs) on the card, with the model options
    ``model_kw`` (``compute_dtype``, ``remat``), which the command line
    does not set."""
    from difformer_tpu_torch import DIFFormer

    return DIFFormer(
        f, cfg.hidden_channels, c, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, kernel=cfg.kernel, alpha=cfg.alpha,
        dropout=cfg.dropout, use_bn=cfg.use_bn,
        use_residual=cfg.use_residual, use_weight=cfg.use_weight,
        use_graph=cfg.use_graph, graph_weight=cfg.graph_weight,
        use_source=cfg.use_source, spmm_first=cfg.spmm_first,
        fuse_head_mean=cfg.fuse_head_mean, seed=cfg.seed, device="cuda",
        **model_kw)


def remat_recomputed(cfg, f):
    """K1 forward launches that remat adds to a train step of preset
    ``cfg`` on ``f`` features: one a layer where the graph branch is
    spmm_first (its region keeps K1's product for the matmul after it, so
    the backward re-runs it), none on the plain branch (it keeps no tensor;
    K1's backward needs only the plan)."""
    on = cfg.spmm_first
    if on == "auto":
        on = cfg.num_heads * cfg.hidden_channels >= 2 * (f + 1)
    return cfg.num_layers if on and cfg.use_graph and cfg.use_weight else 0


def make_slice(cfg, **model_kw):
    """(trainer, split, N, C) of the cora preset ``cfg`` on the slice's
    synthetic graph of Cora's size, at full width and depth; ``model_kw``
    adds options of the model (``compute_dtype``, ``remat``)."""
    from difformer_tpu_torch import FullBatchTrainer, GraphData
    from difformer_tpu_torch.data import class_rand_splits

    x, ei, y = cora_graph()
    (n, f), c = x.shape, int(y.max()) + 1
    split = class_rand_splits(y, cfg.label_num_per_class, rng=cfg.seed)
    graph = GraphData.from_numpy(x, ei, device="cuda")
    model = preset_model(cfg, f, c, **model_kw)
    trainer = FullBatchTrainer(model, graph, y, lr=cfg.lr,
                               weight_decay=cfg.weight_decay, seed=cfg.seed,
                               device="cuda")
    say(f"phase {cfg.kernel} slice: cora preset: N={n} "
        f"E={graph.num_edges} F={f} C={c} kernel={cfg.kernel} "
        f"hidden={cfg.hidden_channels} layers={cfg.num_layers} "
        f"heads={cfg.num_heads} dropout={cfg.dropout} lr={cfg.lr} "
        f"wd={cfg.weight_decay} spmm_first={cfg.spmm_first} "
        f"fuse_head_mean={cfg.fuse_head_mean}"
        f"{''.join(f' {k}={v}' for k, v in model_kw.items())}")
    return trainer, split, n, c


def check_logits(phase, trainer, state, n, c):
    """Logits through the kernels against the same model through the plain
    versions, on the card."""
    logits = trainer.forward_eval(state)
    with through_plain_versions():
        ref = trainer.forward_eval(state)
    if logits.shape != (n, c):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    torch.testing.assert_close(logits, ref, rtol=1e-3, atol=1e-4)
    say(f"phase {phase}: logits kernel vs plain max_abs_err "
        f"{(logits - ref).abs().max().item():.3e}")


def time_steps(phase, trainer, state, split, n, steps=20):
    """Host-clock ms of a train step and an eval forward (synchronised),
    and peak memory while training; then the step's device time by
    kernel. Returns the profile's rows."""
    train_mask = torch.as_tensor(
        np.isin(np.arange(n), split["train"]), device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    for _ in range(3):
        trainer.train_step(state, gen, train_mask)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(state, gen, train_mask)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.forward_eval(state)
    torch.cuda.synchronize()
    eval_ms = 1e3 * (time.perf_counter() - t0) / steps
    say(f"phase {phase}: train step {step_ms:.3f} ms | eval forward "
        f"{eval_ms:.3f} ms | peak memory {peak_mib:.1f} MiB (train)")
    return profile_steps(lambda: trainer.train_step(state, gen, train_mask),
                         step_ms, phase)


def run_slice(phase, cfg, expect):
    """Drive the path: ``FullBatchTrainer.fit`` for EPOCHS epochs with the
    launch counts set to 0 just before and read just after; check the
    losses, the launches and the logits; time and profile the step.
    Returns (launches, profile rows)."""
    trainer, split, n, c = make_slice(cfg)
    reset_launch_counts()
    t0 = time.perf_counter()
    best = trainer.fit(split, epochs=EPOCHS, eval_step=1)[0]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = launch_counts()

    losses = best["losses"]
    say(f"phase {phase}: fit {EPOCHS} epochs in {fit_s:.2f} s; losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; best epoch {best['epoch']} "
        f"train {best['train']:.4f} valid {best['valid']:.4f} "
        f"test {best['test']:.4f}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    say(f"phase {phase}: launches {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")

    state = trainer.init_state(0)
    check_logits(phase, trainer, state, n, c)
    return launches, time_steps(phase, trainer, state, split, n)


def expected_launches(layers, attention):
    """Launches of a 20-epoch fit: each layer runs its attention and its
    graph branch forward in every train step and every eval, and their
    backward in every train step."""
    fwd, bwd = 2 * layers * EPOCHS, layers * EPOCHS
    sig = fwd if attention else 0
    return {"sigmoid_attention_fwd": sig,
            "sigmoid_attention_dq": sig // 2,
            "sigmoid_attention_dkv": sig // 2,
            "csr_spmm": fwd, "csr_spmm_transposed": bwd,
            **dict.fromkeys(ELL_PATH + (ELL_COMBINE,) + BSR_PATH
                            + (BSR_COMBINE,), 0)}


def phase_slice():
    """DIFFormer-a: K2–K4 in the attention, K1 in the GCN branch."""
    from difformer_tpu_torch.utils.config import make_config

    cfg = make_config("cora", kernel="sigmoid")
    return run_slice("slice", cfg, expected_launches(cfg.num_layers, True))[0]


def phase_slice_s():
    """DIFFormer-s, the main path: K1 in the GCN branch, the linear
    attention in torch matmuls. The step must do no sort and no
    ``index_add_`` (the plan is built once, at the trainer's start)."""
    from difformer_tpu_torch.utils.config import make_config

    cfg = make_config("cora")
    launches, rows = run_slice("slice-s", cfg,
                               expected_launches(cfg.num_layers, False))
    found = [key for _, _, key in rows
             if "sort" in key.lower() or "indexfunc" in key.lower()]
    say(f"phase slice-s: sort or index_add_ kernels in the step: "
        f"{found or 'none'}")
    if found:
        raise AssertionError(f"the step sorts or scatters: {found}")
    return launches


def phase_slice_s_h8():
    """The cora preset at 8 heads: fused head mean, Wv factored through the
    key aggregates, spmm_first (K1 at F+1 = 65). A few train steps, then
    the logits against the plain versions."""
    from difformer_tpu_torch.ops import graph_ops
    from difformer_tpu_torch.utils.config import make_config

    cfg = make_config("cora", num_heads=8)
    trainer, split, n, c = make_slice(cfg)
    state = trainer.init_state(0)
    train_mask = torch.as_tensor(
        np.isin(np.arange(n), split["train"]), device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    widths = []
    real = graph_ops.CsrSpmm

    def recording(x, fwd, bwd, edge_chunk_size):
        widths.append(x.shape[1])
        return real.apply(x, fwd, bwd, edge_chunk_size)

    reset_launch_counts()
    with unittest.mock.patch.object(
            graph_ops, "CsrSpmm", unittest.mock.Mock(apply=recording)):
        losses = [trainer.train_step(state, gen, train_mask)[1].item()
                  for _ in range(H8_STEPS)]
    torch.cuda.synchronize()
    launches = launch_counts()
    layers = cfg.num_layers
    expect = dict(expected_launches(layers, False),
                  csr_spmm=layers * H8_STEPS,
                  csr_spmm_transposed=layers * H8_STEPS)
    say(f"phase slice-s-h8: {H8_STEPS} steps, losses {losses}; K1 widths "
        f"{sorted(set(widths))}; launches {launches} (expected {expect})")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if launches != expect or set(widths) != {cfg.hidden_channels + 1}:
        raise AssertionError("the spmm_first path did not run through K1")
    check_logits("slice-s-h8", trainer, state, n, c)
    time_steps("slice-s-h8", trainer, state, split, n, steps=5)

    # remat: the same steps from the same weights and dropout stream; the
    # spmm_first branch keeps K1's product for its matmul, so the backward
    # re-runs its forward K1 once a layer (the plain graph branch keeps
    # nothing and re-runs nothing: tests/test_torch_port_bf16.py)
    trainer, split, n, c = make_slice(cfg, remat=True)
    state = trainer.init_state(0)
    gen = torch.Generator("cuda").manual_seed(0)
    reset_launch_counts()
    remat = [trainer.train_step(state, gen, train_mask)[1].item()
             for _ in range(H8_STEPS)]
    torch.cuda.synchronize()
    launches = launch_counts()
    expect = dict(expect, csr_spmm=2 * layers * H8_STEPS)
    say(f"phase slice-s-h8: remat: losses {remat} (bit-equal to the "
        f"steps without: {remat == losses}); launches {launches} (expected "
        f"{expect}: the forward K1 again in each layer's backward)")
    if remat != losses or launches != expect:
        raise AssertionError("remat changed the losses or K1's launches")


class RowLog:
    """A ``fit`` logger: every eval's (train, valid, test)."""

    def __init__(self):
        self.rows = []

    def add_result(self, run, result):
        self.rows.append(result)


def largest_rel_diff(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def host_ms(fn, reps=3):
    """The median host-clock ms of ``fn`` ending in a synchronise."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def fit_path(cfg, epoch_block, **model_kw):
    """Build the cora preset ``cfg`` and fit it for EPOCHS epochs with an
    eval every epoch; the fit's host-clock seconds, and its peak memory
    allocated and reserved (the caching allocator's segments, which hold a
    CUDA graph's memory pool) above what was allocated and reserved before
    the trainer was built (``held_mib``: above all cuBLAS's workspaces of
    the streams used so far, which no trainer frees)."""
    gc.collect()  # an earlier trainer's graphs (a trainer-runner cycle)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    held_reserved = torch.cuda.memory_reserved()
    trainer, split, n, c = make_slice(cfg, **model_kw)
    log = RowLog()
    reset_launch_counts()
    t0 = time.perf_counter()
    best = trainer.fit(split, epochs=EPOCHS, eval_step=1,
                       epoch_block=epoch_block, logger=log)[0]
    torch.cuda.synchronize()
    return dict(trainer=trainer, split=split, n=n, best=best,
                rows=np.asarray(log.rows, np.float64),
                fit_s=time.perf_counter() - t0, held_mib=held / 2**20,
                peak_mib=(torch.cuda.max_memory_allocated() - held) / 2**20,
                reserved_mib=(torch.cuda.max_memory_reserved()
                              - held_reserved) / 2**20,
                counted=launch_counts())


def phase_graph(phase, cfg, attention, **model_kw):
    """The epoch-block fit (CUDA graphs) of the cora preset ``cfg`` (with
    the model options ``model_kw``) against the per-epoch fit of an
    identically built trainer in this process. Returns the graph path's
    launches, its trainer, the steady ms per epoch of both paths and their
    peak memory."""
    loop = fit_path(cfg, 0, **model_kw)
    graph = fit_path(cfg, GRAPH_BLOCK, **model_kw)
    runner = graph["trainer"].epoch_runner
    if runner is None:
        raise AssertionError("the epoch-block fit did not run")
    lb, gb = loop["best"], graph["best"]
    say(f"phase {phase}: best epoch loop {lb['epoch']} graph {gb['epoch']}; "
        f"valid {lb['valid']:.6f} / {gb['valid']:.6f}; losses "
        f"{gb['losses'][0]:.4f} -> {gb['losses'][-1]:.4f}")
    if gb["epoch"] != lb["epoch"]:
        raise AssertionError("the graph fit picked another best epoch")
    for what, a, b in (("losses", gb["losses"], lb["losses"]),
                       ("split metrics", graph["rows"], loop["rows"])):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.shape != b.shape or not np.all(np.isfinite(a)):
            raise AssertionError(f"{what}: shapes {a.shape} {b.shape} or "
                                 f"non-finite values")
        rel = largest_rel_diff(a, b)
        say(f"phase {phase}: {what} graph vs loop largest relative "
            f"difference {rel:.3e} (bit-equal: "
            f"{bool(np.array_equal(a, b))})")
        if not rel <= GRAPH_RTOL:
            raise AssertionError(f"{what} differ by {rel:.3e} > {GRAPH_RTOL}")

    launches = runner.launches()
    expect = expected_launches(cfg.num_layers, attention)
    for name, g in runner.graphs.items():
        captured = {k: v for k, v in g["captured"].items() if v}
        say(f"phase {phase}: {name} graph captured {captured} x "
            f"{g['replays']} replays")
    say(f"phase {phase}: launches (captured x replays) {launches} "
        f"(expected {expect}); the wrappers counted {graph['counted']} "
        f"(warm-up and capture) against the loop's {loop['counted']}")
    if launches != expect or loop["counted"] != expect:
        raise AssertionError("launch counts differ from the path's")

    # steady state: a replayed block of GRAPH_BLOCK epochs (a step and an
    # eval each), and an epoch of the per-epoch loop, on the host clock and
    # under the profiler
    def block():
        runner.rewind()
        runner.block(GRAPH_BLOCK, 1)

    trainer, split, n = loop["trainer"], loop["split"], loop["n"]
    state = trainer.init_state(0)
    gen = torch.Generator("cuda").manual_seed(0)
    mask = torch.as_tensor(np.isin(np.arange(n), split["train"]),
                           device="cuda")

    def loop_epoch():
        _, loss = trainer.train_step(state, gen, mask)
        float(loss)
        trainer.evaluate(state, split)

    per_epoch = {"graph": host_ms(block) / GRAPH_BLOCK,
                 "loop": host_ms(loop_epoch)}
    busy, by_kernel = {}, {}
    busy["graph"], by_kernel["graph"] = profile_window(block, 1, rows=True)
    busy["loop"] = profile_window(loop_epoch, 3)
    for path, run in (("loop", loop), ("graph", graph)):
        ms = per_epoch[path]
        dev_ms, ops = busy[path]
        if path == "graph":
            dev_ms, ops = dev_ms / GRAPH_BLOCK, ops / GRAPH_BLOCK
        idle = (f"idle {100 * (1 - dev_ms / ms):.1f}%" if ops > 0 else
                "the profiler saw no device operation (idle not measured)")
        say(f"phase {phase}: {path}: fit {1e3 * run['fit_s'] / EPOCHS:.3f} "
            f"ms per epoch over the {EPOCHS}-epoch fit (capture included); "
            f"steady {ms:.3f} ms per epoch (a step and an eval); device "
            f"{dev_ms:.4f} ms over {ops:g} device operations per epoch, "
            f"{idle}; peak memory {run['peak_mib']:.1f} MiB allocated, "
            f"{run['reserved_mib']:.1f} MiB reserved (above "
            f"{run['held_mib']:.1f} MiB held before the trainer)")
    dev_ms = busy["graph"][0]
    for ms, count, key in by_kernel["graph"][:GRAPH_TOP]:
        say(f"phase {phase} replay profile: {ms / GRAPH_BLOCK:9.4f} ms/epoch "
            f"{100 * ms / dev_ms:5.1f}% x{count / GRAPH_BLOCK:<6g} "
            f"{key[:100]}")
    return dict(launches=launches, trainer=graph["trainer"],
                ms=per_epoch, peak_mib={"loop": loop["peak_mib"],
                                        "graph": graph["peak_mib"]})


# the largest |bf16 - f32| difference of the cora preset's logits allowed,
# as a share of the largest f32 logit: bf16 keeps 8 bits of mantissa and
# the 8 layers add their roundings (0.8 % and 1.4 % measured on the CPU
# for the two kernels after a few epochs)
BF16_LOGIT_SHARE = 0.05


def phase_graph_bf16(phase, cfg, attention, f32):
    """:func:`phase_graph` at ``compute_dtype="bfloat16"``, then the
    trained bf16 model's logits against the same weights in an f32 model
    (within ``BF16_LOGIT_SHARE`` of the largest f32 logit, and the argmax
    of at least 99 % of the nodes the same), and ms per epoch and peak
    memory beside the f32 phase's (``f32``, :func:`phase_graph`'s
    result). Returns the bf16 path's launches."""
    from difformer_tpu_torch import DIFFormer

    res = phase_graph(phase, cfg, attention, compute_dtype="bfloat16")
    trainer = res["trainer"]
    model = trainer.model
    twin = DIFFormer(
        trainer.graph.node_feat.shape[1], cfg.hidden_channels,
        model.fcs[1].out_features, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, kernel=cfg.kernel, alpha=cfg.alpha,
        dropout=cfg.dropout, use_bn=cfg.use_bn,
        use_residual=cfg.use_residual, use_weight=cfg.use_weight,
        use_graph=cfg.use_graph, graph_weight=cfg.graph_weight,
        use_source=cfg.use_source, spmm_first=cfg.spmm_first,
        fuse_head_mean=cfg.fuse_head_mean, device="cuda")
    twin.load_state_dict(model.state_dict())
    g = trainer.graph
    model.eval()
    twin.eval()
    with torch.no_grad():
        got = model(g.node_feat, g.senders, g.receivers, plan=trainer.plan)
        ref = twin(g.node_feat, g.senders, g.receivers, plan=trainer.plan)
    if got.dtype != torch.float32 or not torch.isfinite(got).all():
        raise AssertionError(f"bf16 logits {got.dtype}, finite "
                             f"{bool(torch.isfinite(got).all())}")
    diff = (got - ref).abs().max().item()
    top = ref.abs().max().item()
    agree = (got.argmax(1) == ref.argmax(1)).float().mean().item()
    say(f"phase {phase}: trained bf16 logits against the same weights at "
        f"f32: max_abs_err {diff:.4e} = {100 * diff / top:.2f}% of the "
        f"largest f32 logit {top:.4f} (bound {100 * BF16_LOGIT_SHARE:.0f}%)"
        f"; argmax the same on {100 * agree:.2f}% of the nodes")
    if diff > BF16_LOGIT_SHARE * top or agree < 0.99:
        raise AssertionError(f"bf16 logits off the f32 model's: {diff} of "
                             f"{top}, argmax agreement {agree}")
    for path in ("graph", "loop"):
        say(f"phase {phase}: {path}: steady {res['ms'][path]:.3f} ms per "
            f"epoch at bf16 against {f32['ms'][path]:.3f} at f32; peak "
            f"memory {res['peak_mib'][path]:.1f} MiB against "
            f"{f32['peak_mib'][path]:.1f} MiB")
    return res["launches"]


# ---------------------------------------------------------------------------
# kernels-wide: K2-K4 at the set track's widths
# ---------------------------------------------------------------------------

SHARDED_STEPS = 5
SHARDED_WORLDS = (2, 4)
SHARDED_FLAVOURS = ("gather", "halo", "overlap")
# K1 on the rectangular plan of the halo exchange (rank 1 of the 4-rank
# halo partition of the slice's graph): the JSON line's rows
SHARDED_JSON = " halo"


def sharded_model_kw(cfg, f, c):
    """``parallel/api.py:train_sharded``'s model arguments for preset
    ``cfg`` (as :func:`preset_model` builds it) on ``f`` features and
    ``c`` outputs."""
    return dict(in_channels=f, hidden_channels=cfg.hidden_channels,
                out_channels=c, num_layers=cfg.num_layers,
                num_heads=cfg.num_heads, kernel=cfg.kernel, alpha=cfg.alpha,
                dropout=cfg.dropout, use_bn=cfg.use_bn,
                use_residual=cfg.use_residual, use_weight=cfg.use_weight,
                use_graph=cfg.use_graph, graph_weight=cfg.graph_weight,
                use_source=cfg.use_source, spmm_first=cfg.spmm_first,
                fuse_head_mean=cfg.fuse_head_mean)


def sharded_reference(cfg, steps, phase="sharded-s", params=None):
    """The unsharded run the sharded ones follow: the trainer of
    :func:`make_slice` (preset ``cfg``), its weights (``params``, a params
    tree, where given) as a params tree, then ``steps`` eager train
    steps, each timed (host clock, synchronised; the median of the steps
    after the first is printed). Returns (params, train mask, losses,
    logits after the steps), numpy."""
    from difformer_tpu_torch.utils.weights import params_from_torch_state_dict

    trainer, split, n, _ = make_slice(cfg)
    state = trainer.init_state(0, init_params=params)
    params = params_from_torch_state_dict(state.model.state_dict())
    train_mask = np.isin(np.arange(n), split["train"])
    mask_t = torch.as_tensor(train_mask, device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.train_step(state, gen, mask_t)[1])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    say(f"phase {phase}: the unsharded eager step (heads "
        f"{cfg.num_heads}, spmm_first {cfg.spmm_first}): "
        f"{float(np.median(times[1:])):.2f} ms (host clock, median of "
        f"steps 2-{steps})")
    logits = trainer.forward_eval(state).cpu().numpy()
    return (params, train_mask, torch.stack(losses).cpu().numpy(), logits)


def sharded_partitions(world, x, ei, y, train_mask):
    """{flavour: the partition it runs on} of the slice's graph on
    ``world`` shards: all-gather, halo (the overlap split dropped), the
    overlapped halo, and flavour 2b's locality layout (with its node
    perm)."""
    from difformer_tpu_torch.parallel import locality_layout, partition_graph

    kw = dict(labels=y, label_mask=train_mask)
    halo = partition_graph(x, ei, world, build_halo=True, **kw)
    perm, n_loc = locality_layout(ei, x.shape[0], world)
    return {"gather": partition_graph(x, ei, world, **kw),
            "halo": halo.without_overlap(), "overlap": halo,
            "locality": partition_graph(x, ei, world, build_halo=True,
                                        node_perm=perm,
                                        nodes_per_shard=n_loc, **kw)}, perm


def check_sharded_run(tag, flavour, sg, perm, outs, ref, layers,
                      phase="sharded-s"):
    """Hold one sharded run (every rank's ``train_sharded`` result) to the
    unsharded reference under the logit rule, and each rank's K1 launches
    to its plans' products × layers × steps in each direction. Returns
    (K1 launches summed over the ranks, whether the losses and logits are
    bit-equal to the reference's)."""
    _, _, ref_losses, ref_logits = ref
    logits = np.concatenate([o["logits"] for o in outs])
    logits = (logits[perm] if perm is not None
              else logits[sg.node_mask.reshape(-1)])
    losses = outs[0]["losses"]
    if logits.shape != ref_logits.shape or not np.isfinite(logits).all():
        raise AssertionError(f"{tag}: logits {logits.shape}, finite "
                             f"{np.isfinite(logits).all()}")
    torch.testing.assert_close(torch.from_numpy(losses),
                               torch.from_numpy(ref_losses), rtol=1e-3,
                               atol=1e-4)
    torch.testing.assert_close(torch.from_numpy(logits),
                               torch.from_numpy(ref_logits), rtol=1e-3,
                               atol=1e-4)
    bit_equal = (np.array_equal(losses, ref_losses)
                 and np.array_equal(logits, ref_logits))
    total = dict.fromkeys(SPMM_NAMES, 0)
    for rank, out in enumerate(outs):
        if out["jax_loaded"]:
            raise AssertionError(f"{tag}: rank {rank} imported JAX")
        want = SHARDED_STEPS * layers * out["products"]
        if out["products"] < 1 or any(out["launches"][name] != want
                                      for name in SPMM_NAMES):
            raise AssertionError(
                f"{tag}: rank {rank} launched K1 {out['launches']}, "
                f"expected {want} each way ({out['products']} products a "
                f"layer)")
        for name in SPMM_NAMES:
            total[name] += out["launches"][name]
    step_ms = max(o["step_ms"] for o in outs)
    say(f"phase {phase}: {tag} {flavour}: losses {losses[0]:.6f} -> "
        f"{losses[-1]:.6f} (unsharded {ref_losses[0]:.6f} -> "
        f"{ref_losses[-1]:.6f}); logits max_abs_err "
        f"{np.abs(logits - ref_logits).max():.3e}, bit-equal "
        f"{bit_equal} | K1 a rank: {outs[0]['products']} products a layer, "
        f"{[o['launches']['csr_spmm'] for o in outs]} forward, "
        f"{[o['launches']['csr_spmm_transposed'] for o in outs]} "
        f"transposed | {step_ms:.2f} ms a step (host clock, median, slowest "
        f"rank; ranks sharing one card, not a scaling number) | set-up "
        f"{max(o['setup_s'] for o in outs):.1f} s, the case "
        f"{max(o['total_s'] for o in outs):.1f} s")
    return total, bit_equal


def library_rect_spmm(row_ptr, col, val, rows, cols):
    """cuSPARSE's CSR SpMM of a rows × cols matrix through one PyTorch
    call, for its time."""
    a = torch.sparse_csr_tensor(row_ptr, col, val, size=(rows, cols))
    return lambda x: torch.sparse.mm(a, x)


def phase_sharded_kernel(x, ei, y, train_mask, w=64):
    """K1 on a rectangular plan, the halo exchange's conv of rank 1 of the
    slice's graph cut 4 ways (N_loc rows over the N_loc + S·B rows of
    [own ‖ halo]) (:func:`rect_kernel_rows`). Returns the JSON rows."""
    from difformer_tpu_torch.parallel import partition_graph
    from difformer_tpu_torch.parallel.api import rank_plan

    sg = partition_graph(x, ei, 4, labels=y, label_mask=train_mask,
                         build_halo=True).without_overlap()
    plan = rank_plan(sg.rank_graph(1, "cuda"), None).conv
    return rect_kernel_rows(
        "sharded-s", plan, SHARDED_JSON,
        lambda n_in, n_out, rows, cols: (
            f"halo rank 1 of 4: {n_out} x {n_in} (N_loc = {rows}, S·B = "
            f"{cols - rows})"), w=w)


def rect_kernel_rows(phase, plan, suffix, label, w=64):
    """K1 on the rectangular plan ``plan`` forward and transposed, against
    its plain version under the "spmm" rule (shown to fail a wrong
    output), two calls bit-equal, timed by CUDA-graph replay beside its
    bound, its plain version's and cuSPARSE's device time; ``label(n_in,
    n_out, rows, cols)`` names the product. Returns the JSON rows, named
    with ``suffix``."""
    from difformer_tpu_torch.kernels import spmm as K1
    from difformer_tpu_torch.kernels.tolerance import assert_close

    rows, cols, e = plan.num_nodes, plan.num_cols, plan.num_edges
    g = torch.Generator("cuda").manual_seed(71)
    rows_out = {}
    for name, (ptr, col, val), split, n_in, n_out in zip(
            SPMM_NAMES, ((plan.row_ptr, plan.col, plan.val),
                         (plan.t_row_ptr, plan.t_col, plan.t_val)),
            (plan.split, plan.t_split), (cols, rows), (rows, cols)):
        transposed = name == "csr_spmm_transposed"
        xin = torch.randn((n_in, w), device="cuda", generator=g)
        kernel = lambda: K1.csr_spmm(  # noqa: E731
            xin, ptr, col, val, split=split, transposed=transposed)
        plain = lambda: K1.csr_spmm_plain(xin, ptr, col, val)  # noqa: E731
        out, ref = kernel(), plain()
        scale = K1.csr_spmm_abs(xin, ptr, col, val)
        tag = f"{name} {label(n_in, n_out, rows, cols)} E={e} W={w}"
        err = assert_close(tag, out, ref, "spmm", scale=scale)
        assert_rejects(tag, ref, "spmm", scale=scale)
        if not torch.equal(out, kernel()):
            raise AssertionError(f"{tag}: two calls differ")
        # x's rows that some edge gathers, as the other K1 rows count them
        # (not the halo's padding slots, which no edge reads)
        bound, bound_by, nbytes = spmm_bound_ms(
            n_out, e, w, x_rows=int(torch.unique(col).numel()))
        library = library_rect_spmm(ptr, col, val, n_out, n_in)
        lib_err = (library(xin) - ref).abs().max().item()
        ms = replay_ms(kernel)
        plain_ms = device_ms(plain)
        library_ms = device_ms(lambda: library(xin))
        say(f"phase {phase}: {tag:70s} max_abs_err {err:.3e}, two calls "
            f"bit-equal | kernel {ms:.4f} ms (CUDA-graph replay) | plain "
            f"{plain_ms:.4f} ms | cuSPARSE {library_ms:.4f} ms (max_abs_err "
            f"{lib_err:.3e}) | bound {bound:.4f} ms by {bound_by} "
            f"({nbytes / 1e6:.3f} MB; {100 * bound / ms:.1f}% of the "
            f"kernel's time)")
        rows_out[f"{name}{suffix}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=bound_by, library_ms=library_ms)
    return rows_out


def phase_sharded_s(extra=()):
    """The main path cut across ranks (ROADMAP.md queue A item 10a):
    (a) K1 on a rectangular halo plan (:func:`phase_sharded_kernel`);
    (b) the cora preset (dropout 0, so that runs can follow one another)
    trained ``SHARDED_STEPS`` Adam steps by the sharded step
    (``parallel/api.py``) under NCCL at world size 1 on this card, in
    the three exchanges (all-gather, halo, overlapped halo), from the
    weights of an unsharded ``FullBatchTrainer`` built here, whose eager
    steps they must follow (losses and final logits within rtol 1e-3 /
    atol 1e-4); (c) the same with 2 and 4 gloo ranks sharing this card,
    and flavour 2b (the locality layout, spmm_first at 2 heads) against
    its own unsharded run. Each rank's K1 launches are its plans'
    products × layers × steps each way. ``extra``: cases of another phase
    (each with its ``world``, or a ``grid`` of every rank) run in the same
    gloo spawn, one spawn of
    ranks fewer. Returns (the JSON rows of (a), K1's launches of the 4-rank
    halo run summed over its ranks, the NCCL run's host ms a step by
    exchange, each extra case's results on its ranks)."""
    from difformer_tpu_torch.parallel.launch import run_ranks
    from difformer_tpu_torch.parallel.rank_checks import run_checks
    from difformer_tpu_torch.parallel.sharded_ops import (
        collective_bytes_per_layer)
    from difformer_tpu_torch.utils.config import make_config

    t0 = time.perf_counter()
    x, ei, y = cora_graph()
    (n, f), c = x.shape, int(y.max()) + 1
    cfg = make_config("cora", dropout=0.0)
    cfg_2b = make_config("cora", dropout=0.0, num_heads=2, spmm_first=True)
    ref = sharded_reference(cfg, SHARDED_STEPS)
    ref_2b = sharded_reference(cfg_2b, SHARDED_STEPS)
    train_mask = ref[1]
    rows = phase_sharded_kernel(x, ei, y, train_mask)
    say(f"phase sharded-s: references and K1 at "
        f"{time.perf_counter() - t0:.1f} s")
    layers = cfg.num_layers

    def case(sg, params, kw, profile=False):
        return dict(kind="train", sg=sg, params=params, model_kw=kw,
                    steps=SHARDED_STEPS, lr=cfg.lr,
                    weight_decay=cfg.weight_decay, profile=profile)

    kw, kw_2b = sharded_model_kw(cfg, f, c), sharded_model_kw(cfg_2b, f, c)
    parts, _ = sharded_partitions(1, x, ei, y, train_mask)
    t1 = time.perf_counter()
    outs = run_ranks(run_checks, 1, "nccl", "cuda",
                     [case(parts[fl], ref[0], kw, profile=True)
                      for fl in SHARDED_FLAVOURS])
    say(f"phase sharded-s: nccl, 1 rank: {time.perf_counter() - t1:.1f} s "
        f"in run_ranks")
    bits, eager_ms = {}, {}
    for i, fl in enumerate(SHARDED_FLAVOURS):
        out = outs[0][i]
        eager_ms[fl] = out["step_ms"]
        _, bits[f"nccl 1 {fl}"] = check_sharded_run(
            "nccl, 1 rank", fl, parts[fl], None, [out], ref, layers)
        # the plans are built before the first step: no sort and no
        # index_add_ in a step (as phase slice-s checks the unsharded one)
        prof = out["profile"]
        found = [name for name, _, _ in prof["device"]
                 if "sort" in name.lower() or "indexfunc" in name.lower()]
        # the idle share of the profiled step itself, and of the device
        # time over the median of the steps the profiler did not slow
        say(f"phase sharded-s: nccl 1 {fl}: the last step under the "
            f"profiler: {prof['host_ms']:.2f} ms host clock, "
            f"{prof['device_ms']:.3f} ms of device time in "
            f"{sum(n for _, _, n in prof['device'])} operations (idle "
            f"{100 * (1 - prof['device_ms'] / prof['host_ms']):.1f} % of "
            f"this profiled step; "
            f"{100 * (1 - prof['device_ms'] / out['step_ms']):.1f} % of the "
            f"unprofiled steps' median {out['step_ms']:.2f} ms); "
            f"sort or index_add_: {found or 'none'}")
        say(f"phase sharded-s: nccl 1 {fl}: device "
            + "; ".join(f"{name[:48]} {ms:.3f} ms x{n}"
                        for name, ms, n in prof["device"][:8]))
        say(f"phase sharded-s: nccl 1 {fl}: host "
            + "; ".join(f"{name[:40]} {ms:.2f} ms x{n}"
                        for name, ms, n in prof["host"][:8]))
        if not prof["device"] or found:
            raise AssertionError(f"the sharded step ({fl}) sorts or "
                                 f"scatters, or its profile is empty: "
                                 f"{found}")

    # one spawn of the most ranks; the smaller worlds run on its first
    # ranks (rank_checks.run_checks' "world"), the others waiting
    flavours = SHARDED_FLAVOURS + ("locality",)
    cases, parted = [], {}
    for world in SHARDED_WORLDS:
        parts, perm = parted[world] = sharded_partitions(world, x, ei, y,
                                                         train_mask)
        cases += [dict(case(parts[fl], ref_2b[0] if fl == "locality"
                            else ref[0], kw_2b if fl == "locality" else kw),
                       world=world) for fl in flavours]
    base = len(cases)
    t1 = time.perf_counter()
    every = run_ranks(run_checks, max(SHARDED_WORLDS), "gloo", "cuda",
                      cases + list(extra))
    say(f"phase sharded-s: gloo, {max(SHARDED_WORLDS)} ranks: "
        f"{time.perf_counter() - t1:.1f} s in run_ranks (with "
        f"{len(extra)} cases of another phase)")
    # a case on a grid runs on every rank
    extra_results = [[o[base + i] for o in every[:case.get("world",
                                                           len(every))]]
                     for i, case in enumerate(extra)]
    halo_launches = None
    for w, world in enumerate(SHARDED_WORLDS):
        parts, perm = parted[world]
        outs = [o[w * len(flavours):(w + 1) * len(flavours)]
                for o in every[:world]]
        for i, fl in enumerate(flavours):
            sg = parts[fl]
            total, bits[f"gloo {world} {fl}"] = check_sharded_run(
                f"gloo, {world} ranks on one card", fl, sg,
                perm if fl == "locality" else None, [o[i] for o in outs],
                ref_2b if fl == "locality" else ref, layers)
            width = (f + 1) if fl == "locality" else cfg.hidden_channels
            heads = 1 if fl == "locality" else cfg.num_heads
            halo_rows = (None if sg.send_mask is None
                         else int(sg.send_mask.sum()))
            wire = collective_bytes_per_layer(sg, feat_dim=width,
                                              num_heads=heads)
            say(f"phase sharded-s: gloo {world} {fl}: halo rows {halo_rows} "
                f"(B = {sg.halo_width}), collective bytes a layer {wire} "
                f"(rows of width {width})")
            if world == 4 and fl == "halo":
                halo_launches = total
    # gloo ran all_reduce, all_gather, reduce_scatter and all_to_all on
    # CUDA tensors above (the port stages nothing through the host itself)
    say(json.dumps({"phase": "sharded-s", "torch": torch.__version__,
                    "gloo_on_cuda_tensors": ["all_reduce", "all_gather",
                                             "reduce_scatter", "all_to_all"],
                    "staged_through_host_by_the_port": None,
                    "bit_equal_to_unsharded": bits}))
    say(f"phase sharded-s: done in {time.perf_counter() - t0:.1f} s")
    return rows, halo_launches, eager_ms, extra_results


# phase distributed: the distributed trainer (train/distributed.py)
DIST_EPOCHS = 100  # the fits' epochs (an eval each, blocks of GRAPH_BLOCK)
# the fits whose final logits are held to the unsharded fit's under the
# logit rule (as the graph phases' EPOCHS), and the eager gloo fit on the
# card. The runs' sums differ in order (PERF.md §6), and training carries
# the differences on: over DIST_EPOCHS they grow past the rule. The
# witness: the unsharded fit with its GCN products associated the other way
# ((ÂX)W, spmm_first=True), the same weights, drifts from it as far; the
# sharded fit's 100-epoch logits are held within DIST_DRIFT_FACTOR times
# that drift
DIST_EXACT_EPOCHS = 20
DIST_DRIFT_FACTOR = 10.0
DIST_CLI_EPOCHS = 10  # the command line's runs on gloo ranks (spawns dominate)
DIST_LAYOUTS = ("contiguous", "balanced", "locality")
# the largest |test accuracy| difference allowed between the sharded and
# the unsharded fit at the preset's dropout (other dropout streams: the
# masks differ, the accuracies only by chance; 0.05 of 1000 test nodes)
DIST_MARGIN = 0.05
# K1 on the NCCL rank's internal plan: the JSON line's rows
DIST_JSON = " distributed"


def distributed_references(cfg, epochs, params=None):
    """The unsharded captured fits the distributed ones follow: the trainer
    of :func:`make_slice` (preset ``cfg``) fitted with
    ``fit(epoch_block=GRAPH_BLOCK)`` for each count of ``epochs``, every
    fit from ``params`` (a params tree; by default the trainer's
    ``init_state(0)`` weights). Returns one (params, split, summary, final
    logits, the split's train mask) for each count."""
    from difformer_tpu_torch.utils.weights import params_from_torch_state_dict

    trainer, split, n, _ = make_slice(cfg)
    if params is None:
        params = params_from_torch_state_dict(
            trainer.init_state(0).model.state_dict())
    out = []
    for count in epochs:
        best = trainer.fit(split, epochs=count, eval_step=1,
                           epoch_block=GRAPH_BLOCK, init_params=params)[0]
        logits = trainer.forward_eval(
            trainer.epoch_runner.state).cpu().numpy()
        out.append((params, split, best, logits,
                    np.isin(np.arange(n), split["train"])))
    return out


def logit_drift(a, b):
    """(max |a - b|, the entries outside the logit rule rtol 1e-3 / atol
    1e-4 with ``b`` the reference)."""
    diff = np.abs(a - b)
    return float(diff.max()), int((diff > 1e-4 + 1e-3 * np.abs(b)).sum())


def check_distributed_fit(tag, case, index, ref, layers, epochs, hold,
                          phase="distributed"):
    """Hold fit ``index`` of a distributed run (``rank_checks.fit_check``'s
    result ``case``, one rank) to its unsharded reference of as many
    epochs, by ``hold``: "logits" (dropout 0) the losses and the final
    logits under the logit rule, a number (dropout 0) the losses under the
    rule and the final logits within DIST_DRIFT_FACTOR times that drift
    (the witness's), "accuracy" (dropout > 0) finite losses and the test
    accuracy within DIST_MARGIN; and K1's
    launches: the plan's products × layers × (steps + evals) forward and ×
    steps transposed. Prints what it found before it raises. Returns K1's
    launches."""
    _, _, best, logits, _ = ref
    out = case["fits"][index]
    products = case["products"]
    got = out["summaries"][0]
    losses, want = np.asarray(got["losses"]), np.asarray(best["losses"])
    evals = len(out["rows"])
    want_k1 = {"csr_spmm": products * layers * (epochs + evals),
               "csr_spmm_transposed": products * layers * epochs}
    k1 = {k: out["launches"][k] for k in SPMM_NAMES}
    if hold == "accuracy":
        detail = (f"test accuracy {got['test']:.4f} against "
                  f"{best['test']:.4f} unsharded (margin {DIST_MARGIN})")
    else:
        drift, outside = logit_drift(out["logits"], logits)
        detail = (f"losses max_abs_err {np.abs(losses - want).max():.3e} "
                  f"(bit-equal {np.array_equal(losses, want)}), final "
                  f"logits max_abs_err {drift:.3e}, {outside} of "
                  f"{logits.size} outside the logit rule")
        if hold not in ("logits", "accuracy"):
            detail += (f" (limit {DIST_DRIFT_FACTOR:g} x the witness's "
                       f"{hold:.3e})")
    say(f"phase {phase}: {tag}: losses {losses[0]:.6f} -> "
        f"{losses[-1]:.6f} (unsharded {want[0]:.6f} -> {want[-1]:.6f}); "
        f"{detail}; best epoch {got['epoch']} (unsharded {best['epoch']}); "
        f"captured {out['captured']}, graphs {out['graphs']}; K1 {k1} = "
        f"{products} products x {layers} layers x ({epochs} steps + "
        f"{evals} evals) forward, x {epochs} steps transposed; fit "
        f"{out['fit_s']:.2f} s")
    if case["jax_loaded"]:
        raise AssertionError(f"{tag}: the rank imported JAX")
    if losses.shape != want.shape or not np.isfinite(losses).all():
        raise AssertionError(f"{tag}: losses {losses}")
    if hold == "accuracy":
        if abs(got["test"] - best["test"]) > DIST_MARGIN:
            raise AssertionError(f"{tag}: test accuracy off")
    else:
        torch.testing.assert_close(torch.from_numpy(losses),
                                   torch.from_numpy(want), rtol=1e-3,
                                   atol=1e-4)
    if hold == "logits":
        torch.testing.assert_close(torch.from_numpy(out["logits"]),
                                   torch.from_numpy(logits), rtol=1e-3,
                                   atol=1e-4)
    elif hold != "accuracy" and drift > DIST_DRIFT_FACTOR * hold:
        raise AssertionError(f"{tag}: the final logits drifted {drift:.3e}, "
                             f"past {DIST_DRIFT_FACTOR:g} x the witness's "
                             f"{hold:.3e}")
    if k1 != want_k1:
        raise AssertionError(f"{tag}: K1 launches {k1}, expected {want_k1}")
    return k1


def phase_distributed(unsharded_ms, eager_ms, tmp, extra=()):
    """The distributed trainer (``train/distributed.py``, ROADMAP.md queue
    A item 10d): (a) one NCCL rank at the cora preset's full width, the
    epoch-block fit with its step and eval captured as CUDA graphs
    (collectives included), from the weights of an unsharded
    ``FullBatchTrainer`` whose own captured fit it follows: at dropout 0
    the losses and final logits under the logit rule after
    DIST_EXACT_EPOCHS epochs, after DIST_EPOCHS the losses under the rule
    and the logits within DIST_DRIFT_FACTOR times the witness's drift (the
    unsharded fit with its sums reordered), at the preset's dropout 0.2
    finite losses and the test accuracy within DIST_MARGIN;
    K1's launches as captured x replays; ms per epoch, device ms and idle
    share of replayed epochs beside the eager sharded step's
    (``eager_ms``, phase sharded-s) and the unsharded captured epoch's
    (``unsharded_ms``, phase slice-s-graph); K1 on the rank's internal plan
    against its plain version (the JSON rows); (b) ``cli.main(["--dataset",
    "cora", "--n_shards", "2", ...], backend="gloo")`` on ranks sharing
    this card, for each layout, its losses under the rule against the
    unsharded command line's at dropout 0; (c) a gloo trainer (a gloo
    group of the NCCL rank) does not capture (and a gloo collective in a
    capture raises), and an NCCL capture that fails raises, and the gloo
    fit follows the unsharded one as (a) does at dropout 0. ``extra``:
    cases of another phase run in the same NCCL spawn (one spawn fewer).
    Returns (the JSON rows, K1's launches of (a) at dropout 0.2, the extra
    cases' results)."""
    from difformer_tpu_torch import cli
    from difformer_tpu_torch.parallel import partition_graph
    from difformer_tpu_torch.parallel.api import rank_plan
    from difformer_tpu_torch.parallel.launch import run_ranks
    from difformer_tpu_torch.parallel.rank_checks import run_checks
    from difformer_tpu_torch.utils.config import make_config

    t0 = time.perf_counter()
    x, ei, y = cora_graph()
    (n, f), c = x.shape, int(y.max()) + 1
    cfg0, cfg = make_config("cora", dropout=0.0), make_config("cora")
    ref0_short, ref0 = distributed_references(
        cfg0, (DIST_EXACT_EPOCHS, DIST_EPOCHS))
    (witness,) = distributed_references(
        make_config("cora", dropout=0.0, spmm_first=True), (DIST_EPOCHS,),
        params=ref0[0])
    drift, outside = logit_drift(witness[3], ref0[3])
    (ref,) = distributed_references(cfg, (DIST_EPOCHS,))
    layers = cfg.num_layers
    w_losses = np.abs(np.asarray(witness[2]["losses"])
                      - np.asarray(ref0[2]["losses"])).max()
    say(f"phase distributed: unsharded captured fits at "
        f"{time.perf_counter() - t0:.1f} s: test {ref0[2]['test']:.4f} "
        f"(dropout 0, {DIST_EPOCHS} epochs), {ref0_short[2]['test']:.4f} "
        f"({DIST_EXACT_EPOCHS}), {ref[2]['test']:.4f} (dropout "
        f"{cfg.dropout}, {DIST_EPOCHS}); the witness (spmm_first=True, the "
        f"same weights, dropout 0, {DIST_EPOCHS} epochs): losses "
        f"max_abs_err {w_losses:.3e}, final logits max_abs_err {drift:.3e} "
        f"from the unsharded fit, {outside} of {ref0[3].size} outside the "
        f"logit rule")
    if not drift > 0:
        raise AssertionError("the witness's sums were not reordered")

    def case(kind, c_, r, **kw):
        return dict(kind=kind, x=x, ei=ei, y=y, split=r[1],
                    model_kw=sharded_model_kw(c_, f, c),
                    trainer_kw=dict(lr=c_.lr, weight_decay=c_.weight_decay,
                                    seed=c_.seed), **kw)

    fit_kw = dict(epochs=DIST_EPOCHS, eval_step=1, epoch_block=GRAPH_BLOCK)
    short_kw = dict(fit_kw, epochs=DIST_EXACT_EPOCHS)
    t1 = time.perf_counter()
    # both dropout-0 fits start from the same init_state(0) weights; the
    # gloo cases run eagerly on a gloo group of the same rank, on the card
    nccl = run_ranks(run_checks, 1, "nccl", "cuda", [
        case("fit", cfg0, ref0, fits=[short_kw, fit_kw],
             init_params=ref0[0]),
        case("fit", cfg, ref, fits=[fit_kw], init_params=ref[0],
             timing=True, block=GRAPH_BLOCK),
        # the other phase's captures before the failing one
        *extra,
        case("capture_fault", cfg0, ref0),
        case("fit", cfg0, ref0_short, init_params=ref0_short[0],
             fits=[short_kw], backend="gloo"),
        case("capture_fault", cfg0, ref0, backend="gloo")])[0]
    say(f"phase distributed: nccl, 1 rank (and gloo on the same card): "
        f"{time.perf_counter() - t1:.1f} s in run_ranks (with {len(extra)} "
        f"cases of another phase)")
    extra_results = nccl[2:2 + len(extra)]
    nccl = nccl[:2] + nccl[2 + len(extra):]
    check_distributed_fit("nccl 1 rank, dropout 0", nccl[0], 0, ref0_short,
                          layers, DIST_EXACT_EPOCHS, "logits")
    check_distributed_fit("nccl 1 rank, dropout 0", nccl[0], 1, ref0,
                          layers, DIST_EPOCHS, drift)
    launches = check_distributed_fit(
        f"nccl 1 rank, dropout {cfg.dropout}", nccl[1], 0, ref, layers,
        DIST_EPOCHS, "accuracy")
    if not all(out["captured"] for c_ in nccl[:2] for out in c_["fits"]):
        raise AssertionError("the NCCL fits did not capture their graphs")
    timed = nccl[1]
    idle = 100 * (1 - timed["device_ms"] / timed["ms_per_epoch"])
    say(f"phase distributed: nccl 1 rank, replayed: {timed['ms_per_epoch']:.3f} "
        f"ms per epoch (a step and an eval, host clock, median of 3 blocks "
        f"of {GRAPH_BLOCK}); device {timed['device_ms']:.4f} ms over "
        f"{timed['ops']:g} device operations per epoch, idle {idle:.1f}% | "
        f"the eager sharded step (phase sharded-s, overlap) "
        f"{eager_ms['overlap']:.2f} ms, the unsharded replayed epoch "
        f"(phase slice-s-graph) {unsharded_ms:.3f} ms")
    say("phase distributed: nccl 1 rank, replay profile: "
        + "; ".join(f"{name[:60]} {ms:.4f} ms x{calls:g}"
                    for name, ms, calls in timed["top"]))
    fault = nccl[2]
    say(f"phase distributed: nccl capture with a barrier in the step: "
        f"raised {fault['raised']!r}; an eager all-reduce after it "
        f"{'works' if fault['eager_after'] else 'fails'}")
    if fault["raised"] is None or not fault["eager_after"]:
        raise AssertionError("a failed NCCL capture did not raise, or left "
                             "the group broken")

    # gloo on this card: eager by design, from the same weights
    gloo = nccl[3:]
    if gloo[0]["fits"][0]["captured"] or gloo[0]["fits"][0]["graphs"]:
        raise AssertionError("the gloo trainer captured a graph")
    check_distributed_fit("gloo 1 rank on the card, dropout 0 (eager)",
                          gloo[0], 0, ref0_short, layers, DIST_EXACT_EPOCHS,
                          "logits")
    say(f"phase distributed: gloo 1 rank: no graph captured; a gloo "
        f"all-reduce in a capture raised {gloo[1]['raised']!r}")
    if gloo[1]["raised"] is None:
        raise AssertionError("a gloo collective was captured")

    # the command line on gloo ranks sharing this card, each layout held
    # to the unsharded command line's run (the same split and weights) at
    # dropout 0
    write_planetoid_cora(tmp)
    base = ["--dataset", "cora", "--data_dir", tmp, "--epochs",
            str(DIST_CLI_EPOCHS), "--runs", "1", "--dropout", "0"]
    t1 = time.perf_counter()
    plain = cli.main(base)[0]
    say(f"phase distributed: cli unsharded ({DIST_CLI_EPOCHS} epochs, "
        f"dropout 0): test {plain['test']:.4f}, losses "
        f"{plain['losses'][0]:.4f} -> {plain['losses'][-1]:.4f}, "
        f"{time.perf_counter() - t1:.1f} s")
    for layout in DIST_LAYOUTS:
        t1 = time.perf_counter()
        res = cli.main(base + ["--n_shards", "2", "--layout", layout],
                       backend="gloo")
        if len(res) != 1 or not np.isfinite(res[0]["losses"]).all():
            raise AssertionError(f"--layout {layout}: {res}")
        got = np.asarray(res[0]["losses"])
        say(f"phase distributed: cli --n_shards 2 --layout {layout} "
            f"(gloo, 2 ranks on one card, {DIST_CLI_EPOCHS} epochs): test "
            f"{res[0]['test']:.4f} (unsharded {plain['test']:.4f}), losses "
            f"{got[0]:.4f} -> {got[-1]:.4f}, max_abs_err "
            f"{np.abs(got - plain['losses']).max():.3e} from the unsharded "
            f"run's, {time.perf_counter() - t1:.1f} s")
        torch.testing.assert_close(
            torch.from_numpy(got),
            torch.from_numpy(np.asarray(plain["losses"], got.dtype)),
            rtol=1e-3, atol=1e-4)

    # K1 on the NCCL rank's plan: the internal edges of a one-rank cut
    sg = partition_graph(x, ei, 1, labels=y, label_mask=ref[4],
                         build_halo=True)
    plan = rank_plan(sg.rank_graph(0, "cuda"), None).internal
    rows = rect_kernel_rows(
        "distributed", plan, DIST_JSON,
        lambda n_in, n_out, r, cols: f"nccl rank 0 of 1 internal: {n_out} "
                                     f"x {n_in}", w=cfg.hidden_channels)
    say(f"phase distributed: done in {time.perf_counter() - t0:.1f} s")
    return rows, launches, extra_results


# phase sharded-a-bsr: the ring sigmoid attention at the cora preset
# (kernel="sigmoid"), K7 on a rank's shard of bench.py's clustered graph,
# and the node-sharded hybrid under bench.py's model
RING_EXACT_EPOCHS, RING_EPOCHS = 20, 100  # as phase distributed's fits
RING_WORLDS = (2, 4)  # the eager steps on gloo ranks sharing the card
RING_JSON = " ring"  # K2-K4's JSON rows at the ring's step
RING_CLI_EPOCHS = 10
HYBRID_EPOCHS = 10
# the rectangular K7 rows: bench.py's clustered graph cut in two (rank 1's
# shard) and whole (one rank), int8 counts and f32 values, W = 64 and 65
RECT_WORLDS = (2, 1)
RECT_WIDTHS = (64, 65)
RECT_JSON = " shard"
BSR_SHARD_REPLACES = "difformer_tpu/ops/bsr.py:781"


def ring_kernel_rows(mask):
    """K2 (the raw numerator and denominator the ring sums), K3 and K4 at
    one ring step of the cora preset on 2 ranks (N_loc = L = 1354, the
    length of the shard's key mask ``mask``; H = 1, M = D = 64, f32)
    (:func:`step_kernel_rows`). Returns the JSON rows."""
    n = len(mask)
    return step_kernel_rows(
        "sharded-a-bsr", f"ring step N_loc=L={n} H=1 M=64 D=64 f32",
        RING_JSON, n, 1, mask, normalize=False)


def step_kernel_rows(phase, label, suffix, n, h, mask, normalize):
    """K2 (normalised, or the raw numerator and denominator the ring
    sums), K3 and K4 at N = L = ``n``, ``h`` heads, M = D = 64, f32, with
    the key mask ``mask`` (or none) against their plain versions under
    ``kernels/tolerance.py`` (shown to fail a wrong output), two calls
    bit-equal, timed by CUDA-graph replay beside the plain version's
    device time and the bound. Returns the JSON rows, named with
    ``suffix``."""
    from difformer_tpu_torch.kernels import sigmoid_attention as K
    from difformer_tpu_torch.kernels.tolerance import assert_close

    m, d, dtype = 64, 64, torch.float32
    q, k, v, _, g = attention_case(n, n, h, m, d, dtype, False, 22)
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.float32, device="cuda")
    num, den = K.sigmoid_attention_fwd(q, k, v, mask, normalize=False)
    r_num, r_den = K.sigmoid_attention_fwd_plain(q, k, v, mask,
                                                 normalize=False)
    errs = {"sigmoid_attention_fwd": max(
        assert_close(f"fwd num {label}", num, r_num, "num", den=r_den),
        assert_close(f"fwd den {label}", den, r_den, "den"))}
    assert_rejects(f"num {label}", r_num, "num", r_den)
    if normalize:
        out, den_n = K.sigmoid_attention_fwd(q, k, v, mask)
        r_out, r_den_n = K.sigmoid_attention_fwd_plain(q, k, v, mask)
        errs["sigmoid_attention_fwd"] = max(
            assert_close(f"fwd out {label}", out, r_out, "out"),
            assert_close(f"fwd den {label}", den_n, r_den_n, "den"))
        assert_rejects(f"out {label}", r_out, "out")
    # the cotangents of num / den, with this step's den as the whole sum
    dnum = g / den[..., None]
    dden = -(g * (num / den[..., None])).sum(-1) / den
    r_dq = K.sigmoid_attention_dq_plain(q, k, v, mask, dnum, dden)
    r_dk, r_dv = K.sigmoid_attention_dkv_plain(q, k, v, mask, dnum, dden)
    errs["sigmoid_attention_dq"] = assert_close(
        f"dq {label}", K.sigmoid_attention_dq(q, k, v, mask, dnum, dden),
        r_dq, "grad")
    dk, dv = K.sigmoid_attention_dkv(q, k, v, mask, dnum, dden)
    errs["sigmoid_attention_dkv"] = max(
        assert_close(f"dk {label}", dk, r_dk, "grad"),
        assert_close(f"dv {label}", dv, r_dv, "grad"))
    for name, ref in (("dq", r_dq), ("dk", r_dk), ("dv", r_dv)):
        assert_rejects(f"{name} {label}", ref, "grad")
    cases = {
        "sigmoid_attention_fwd": (
            lambda: K.sigmoid_attention_fwd(q, k, v, mask,
                                            normalize=normalize),
            lambda: K.sigmoid_attention_fwd_plain(q, k, v, mask,
                                                  normalize=normalize)),
        "sigmoid_attention_dq": (
            lambda: K.sigmoid_attention_dq(q, k, v, mask, dnum, dden),
            lambda: K.sigmoid_attention_dq_plain(q, k, v, mask, dnum, dden)),
        "sigmoid_attention_dkv": (
            lambda: K.sigmoid_attention_dkv(q, k, v, mask, dnum, dden),
            lambda: K.sigmoid_attention_dkv_plain(q, k, v, mask, dnum,
                                                  dden)),
    }
    rows = {}
    for name, (kernel, plain) in cases.items():
        first, second = kernel(), kernel()
        if not all(torch.equal(a, b) for a, b in zip(
                first if isinstance(first, tuple) else (first,),
                second if isinstance(second, tuple) else (second,))):
            raise AssertionError(f"{name} {label}: two calls differ")
        ms, plain_ms = replay_ms(kernel), device_ms(plain)
        bound, bound_by = bound_ms(name, n, n, h, m, d, dtype)
        masked = 0 if mask is None else int((mask == 0).sum())
        say(f"phase {phase}: {name:22s} {label} (keys masked "
            f"{masked}) max_abs_err {errs[name]:.3e}, two "
            f"calls bit-equal | kernel {ms:.4f} ms (CUDA-graph replay) | "
            f"plain {plain_ms:.4f} ms | bound {bound:.4f} ms by {bound_by} "
            f"({100 * bound / ms:.1f}% of the kernel's time) | no PyTorch "
            f"call computes it")
        rows[f"{name}{suffix}"] = dict(
            max_abs_err=errs[name], ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=bound_by, library_ms=None)
    return rows


def rect_bsr_bounds(d, w, x_dtype):
    """(least ms, "bytes" or "operations", compulsory bytes, live blocks)
    of K7 on a rank's shard ``d`` at width ``w``: the blocks that hold an
    edge (and a column index each) read once, the gathered operand's
    column tiles that some block reads, out written once, and for counts
    the row and column scales of those rows; the operations as
    :func:`bsr_bounds` counts them (the faster of the FP32 units and the
    tensor cores in TF32 passes)."""
    t = d.tile
    live = d.blocks.reshape(d.blocks.shape[0], d.blocks.shape[1], -1) \
        .ne(0).any(-1)
    blocks = int(live.sum())
    col_tiles = int(torch.unique(d.block_col[live]).numel())
    elem_x = torch.tensor([], dtype=x_dtype).element_size()
    scaled = d.inv_rows is not None
    nbytes = (blocks * (t * t * d.blocks.element_size() + 4)
              + col_tiles * t * w * elem_x + d.num_rows * w * elem_x
              + (4 * (d.num_rows + col_tiles * t) if scaled else 0))
    flops = 2 * t * t * w * blocks
    t_bytes = nbytes / PEAK_BYTES
    passes = 3 if d.blocks.dtype == torch.float32 else 2
    t_ops = min(flops / PEAK_OPS[torch.float32], passes * flops / 495e12)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations", nbytes, blocks)


def library_rect_bsr(d, x):
    """cuSPARSE's BSR product (``torch.sparse_bsr_tensor`` [rows_per,
    pad_n] @ x) of a rank shard's blocks that hold an edge, as f32 copies
    with the count scales folded in, for its time."""
    t = d.tile
    live = d.blocks.reshape(d.blocks.shape[0], d.blocks.shape[1], -1) \
        .ne(0).any(-1)
    rt = torch.arange(live.shape[0], device=x.device)[:, None] \
        .expand_as(live)[live]
    ct = d.block_col[live].long()
    v = d.blocks[live].float()
    if d.inv_rows is not None:
        v = (v * d.inv_rows.view(-1, t)[rt][:, :, None]
             * d.inv_cols.view(-1, t)[ct][:, None, :])
    order = torch.argsort(rt * (d.num_cols // t) + ct)
    crow = torch.zeros(live.shape[0] + 1, dtype=torch.int64,
                       device=x.device)
    crow[1:] = torch.bincount(rt, minlength=live.shape[0]).cumsum(0)
    a = torch.sparse_bsr_tensor(crow, ct[order], v[order].to(x.dtype),
                                size=(d.num_rows, d.num_cols))
    del v
    call = lambda: a @ x  # noqa: E731
    call()
    return call


def check_rect_k7(tag, x, d):
    """K7 on a rank's shard ``d`` of the node-sharded hybrid (``rows_per``
    rows from the gathered ``x`` [pad_n, W]; the count blocks' row and
    column scales apart) against its plain version under the "spmm" rule
    (shown to fail a wrong output), two calls bit-equal, its device
    kernels a call counted from its CUDA graph (1, one more where the
    split plan cuts, one more where x is staged), and the shard's whole
    product (K7, then K1 adding the residual) against the plain one; timed
    by CUDA-graph replay beside the plain version's and cuSPARSE BSR's
    device times and the bound. Returns the JSON row."""
    from difformer_tpu_torch.kernels import bsr as K7
    from difformer_tpu_torch.kernels import spmm as K1
    from difformer_tpu_torch.kernels.tolerance import assert_close
    from difformer_tpu_torch.ops.bsr import bsr_shard_apply

    groups, w = d.groups(), x.shape[1]
    rect = dict(num_rows=d.num_rows, row_scale=d.inv_rows,
                col_scale=d.inv_cols)
    chunks = K7.split_plan(K7.group_shapes(groups), d.tile, w,
                           K7.sm_count(x.device))
    staged = K7.staged_x(x)[0] is not x
    call = lambda: K7.bsr_spmm_blocks(x, groups, d.tile, **rect)  # noqa
    plain = lambda: K7.bsr_spmm_blocks_plain(x, groups, d.tile, **rect)  # noqa
    out, ref = call(), plain()
    sc = K7.bsr_spmm_blocks_abs(x, groups, d.tile, **rect)
    err = assert_close(tag, out, ref, "spmm", scale=sc)
    assert_rejects(tag, ref, "spmm", scale=sc)
    if not torch.equal(out, call()):
        raise AssertionError(f"{tag}: two calls differ")
    want = 1 + any(c > 1 for c in chunks) + staged
    kernels, nodes = graph_kernels(call)
    if kernels != want or nodes != want:
        raise AssertionError(f"{tag}: {kernels} device kernels in {nodes} "
                             f"graph nodes a call, expected {want}")
    whole = bsr_shard_apply(d, x)
    p = d.plan
    whole_ref = ref.float() + K1.csr_spmm_plain(x, p.row_ptr, p.col, p.val)
    whole_err = assert_close(f"{tag} with the residual", whole, whole_ref,
                             "spmm", scale=sc.float() + K1.csr_spmm_abs(
                                 x, p.row_ptr, p.col, p.val).float())
    del out, ref, sc, whole, whole_ref
    bound, bound_by, nbytes, blocks = rect_bsr_bounds(d, w, x.dtype)
    ms, plain_ms = replay_ms(call), device_ms(plain)
    library_ms = None
    try:
        lib = library_rect_bsr(d, x)
        library_ms = device_ms(lib)
        del lib
    except (RuntimeError, NotImplementedError) as ex:
        say(f"phase sharded-a-bsr: {tag}: cuSPARSE BSR refused: "
            f"{str(ex).splitlines()[0][:160]}")
    torch.cuda.empty_cache()
    slots = int(np.prod(d.block_col.shape))
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    say(f"phase sharded-a-bsr: {tag:44s} max_abs_err {err:.3e} (with the "
        f"residual {whole_err:.3e}), two calls bit-equal, {want} device "
        f"kernels a call (chunks {chunks}{', x staged' if staged else ''}) "
        f"| {d.num_rows} rows over {d.num_cols}, {slots} block slots, "
        f"{blocks} with edges | kernel {ms:.4f} ms "
        f"({1e6 * ms / max(slots, 1):.2f} ns a slot) | plain "
        f"{plain_ms:.4f} ms | cuSPARSE BSR {lib} | bound {bound:.4f} ms by "
        f"{bound_by} ({nbytes / 1e6:.2f} MB; {100 * bound / ms:.1f}% of "
        f"the kernel's time)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=library_ms)


def rect_k7_rows(s, r):
    """K7 on rank 1's shard of bench.py's clustered graph cut in two
    (rows_per 65536 over pad_n 131072, T = 256) and on the whole graph at
    one rank, int8 counts (with their scales) and f32 values
    (``scaled_int8=False``), at W = 64 and 65 (:func:`check_rect_k7`).
    Returns the JSON rows."""
    from difformer_tpu_torch.ops.bsr import build_bsr_gcn_sharded

    rows = {}
    g = torch.Generator("cuda").manual_seed(23)
    for world in RECT_WORLDS:
        for kind, int8 in (("int8", "auto"), ("f32", False)):
            t0 = time.perf_counter()
            fwd, _, rows_per = build_bsr_gcn_sharded(
                s, r, BENCH_NODES, world, tile=BSR_TILE,
                min_edges=KERNEL_MIN_EDGES, scaled_int8=int8)
            rank = world - 1
            d = fwd.rank_shard(rank, None, "cuda")
            del fwd
            build_s = time.perf_counter() - t0
            for w in RECT_WIDTHS:
                x = torch.randn((rows_per * world, w), device="cuda",
                                generator=g)
                tag = (f"bsr_spmm {kind} rank {rank} of {world} W={w}")
                rows[f"bsr_spmm{RECT_JSON} {kind} {world}r W={w}"] = \
                    check_rect_k7(tag, x, d)
                del x
            say(f"phase sharded-a-bsr: {kind} shard of {world} built in "
                f"{build_s:.2f} s (every shard, on the host)")
            del d
            torch.cuda.empty_cache()
    return rows


def ring_kernel_launches(tag, out, layers, epochs):
    """Hold a captured ring fit's K2-K4 launches (captured x replays) to
    layers x S ring steps (one rank: 1) a step and an eval (K2) and a
    step (K3, K4); returns them."""
    evals = len(out["rows"])
    got = {k: out["launches"].get(k, 0) for k in REPLACES}
    want = {"sigmoid_attention_fwd": layers * (epochs + evals),
            "sigmoid_attention_dq": layers * epochs,
            "sigmoid_attention_dkv": layers * epochs}
    say(f"phase sharded-a-bsr: {tag}: K2-K4 {got} = {layers} layers x 1 "
        f"ring step x ({epochs} steps + {evals} evals) forward, x {epochs} "
        f"steps backward; graphs {out['graphs']}")
    if got != want:
        raise AssertionError(f"{tag}: K2-K4 launched {got}, expected {want}")
    return got


def sharded_a_bsr_setup():
    """The references and the rank cases of phase sharded-a-bsr, made
    before phase sharded-s: the unsharded captured cora-a fits of
    RING_EXACT_EPOCHS and RING_EPOCHS epochs and their witness (the same
    fit with its sums reordered, ``spmm_first=True``), the unsharded eager
    cora-a steps, and bench.py's model trained on its padded hybrid,
    unsharded; ``nccl``, the ring's and the hybrid's captured fits at one
    NCCL rank (run in phase distributed's spawn), and ``gloo``, the ring's
    eager steps on 2 and 4 gloo ranks (run in phase sharded-s's spawn).
    Returns a dict of them."""
    from difformer_tpu_torch.ops.bsr import build_bsr_gcn
    from difformer_tpu_torch.parallel import partition_graph
    from difformer_tpu_torch.utils.config import make_config
    from difformer_tpu_torch.utils.weights import params_from_torch_state_dict

    t0 = time.perf_counter()
    x, ei, y = cora_graph()
    (n, f), c = x.shape, int(y.max()) + 1
    cfg = make_config("cora", kernel="sigmoid", dropout=0.0)
    ref_short, ref = distributed_references(cfg, (RING_EXACT_EPOCHS,
                                                  RING_EPOCHS))
    (witness,) = distributed_references(
        make_config("cora", kernel="sigmoid", dropout=0.0, spmm_first=True),
        (RING_EPOCHS,), params=ref[0])
    drift, outside = logit_drift(witness[3], ref[3])
    eager = sharded_reference(cfg, SHARDED_STEPS)
    say(f"phase sharded-a-bsr: unsharded cora-a references: test "
        f"{ref[2]['test']:.4f} ({RING_EPOCHS} epochs, dropout 0); the "
        f"witness (spmm_first=True) drifts {drift:.3e} from it, {outside} "
        f"of {ref[3].size} logits outside the rule")

    # bench.py's model on its clustered graph, unsharded on its hybrid
    xb, s, r = bench_graph("clustered")
    nb = BENCH_NODES
    rng = np.random.default_rng(1)
    yb = rng.integers(0, BENCH_CLASSES, nb)
    perm = rng.permutation(nb)
    split_b = {"train": perm[:nb // 2], "valid": perm[nb // 2:3 * nb // 4],
               "test": perm[3 * nb // 4:]}
    trainer = layout_trainer(xb, s, r, yb, build_bsr_gcn(s, r, nb,
                                                         tile=BSR_TILE))
    params_b = params_from_torch_state_dict(
        trainer.init_state(0).model.state_dict())
    best_b = trainer.fit(split_b, epochs=HYBRID_EPOCHS, eval_step=1,
                         epoch_block=GRAPH_BLOCK, init_params=params_b)[0]
    logits_b = trainer.forward_eval(trainer.epoch_runner.state).cpu().numpy()
    hybrid_ms = steady_epoch_ms(trainer.epoch_runner, GRAPH_BLOCK)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase sharded-a-bsr: unsharded bench.py model on its padded "
        f"hybrid (T = {BSR_TILE}): losses {best_b['losses'][0]:.6f} -> "
        f"{best_b['losses'][-1]:.6f}, {hybrid_ms:.3f} ms a steady epoch "
        f"replayed; references in {time.perf_counter() - t0:.1f} s")

    fit_kw = dict(epochs=RING_EPOCHS, eval_step=1, epoch_block=GRAPH_BLOCK)
    nccl = [
        dict(kind="fit", x=x, ei=ei, y=y, split=ref[1],
             model_kw=sharded_model_kw(cfg, f, c),
             trainer_kw=dict(lr=cfg.lr, weight_decay=cfg.weight_decay,
                             seed=cfg.seed),
             fits=[dict(fit_kw, epochs=RING_EXACT_EPOCHS), fit_kw],
             init_params=ref[0], timing=True, block=GRAPH_BLOCK),
        dict(kind="fit", x=xb, ei=np.stack([s, r]), y=yb, split=split_b,
             model_kw=dict(in_channels=BENCH_FEATURES,
                           hidden_channels=BENCH_HIDDEN,
                           out_channels=BENCH_CLASSES,
                           num_layers=BENCH_LAYERS, dropout=0.0),
             trainer_kw=dict(lr=1e-2, weight_decay=0.0, loss="nll",
                             metric="acc", seed=5, spmm="bsr",
                             bsr_tile=BSR_TILE),
             fits=[dict(epochs=HYBRID_EPOCHS, eval_step=1,
                        epoch_block=GRAPH_BLOCK)],
             init_params=params_b, timing=True, block=GRAPH_BLOCK)]
    # eager steps on gloo ranks sharing the card, on the all-gather
    # partition, from the unsharded eager steps' weights
    sgs = {world: partition_graph(x, ei, world, labels=y,
                                  label_mask=eager[1])
           for world in RING_WORLDS}
    gloo = [dict(kind="train", world=world, sg=sgs[world], params=eager[0],
                 model_kw=sharded_model_kw(cfg, f, c), steps=SHARDED_STEPS,
                 lr=cfg.lr, weight_decay=cfg.weight_decay)
            for world in RING_WORLDS]
    return dict(cfg=cfg, ref_short=ref_short, ref=ref, drift=drift,
                eager=eager, sgs=sgs, best_b=best_b, logits_b=logits_b,
                hybrid_ms=hybrid_ms, s=s, r=r, nccl=nccl, gloo=gloo)


def phase_sharded_a_bsr(tmp, setup, nccl, gloo):
    """ROADMAP.md queue A item 10b, the ring sigmoid attention and the
    node-sharded block-sparse hybrid (the module's docstring), on the
    references and the results of :func:`sharded_a_bsr_setup`'s cases
    (``nccl`` from phase distributed's spawn, ``gloo`` from phase
    sharded-s's): (a) the cora preset as DIFFormer-a through
    ``DistributedTrainer`` at one NCCL rank, captured, against the
    unsharded captured fit from the same weights (RING_EXACT_EPOCHS epochs
    under the logit rule, RING_EPOCHS within DIST_DRIFT_FACTOR x the
    witness's drift), K2-K4's launches; eager steps on 2 and 4 gloo ranks
    sharing the card against the unsharded steps; (b) K2-K4 at the ring's
    step; (c) K7 on a rank's shard of bench.py's clustered graph; (d)
    bench.py's model with ``spmm="bsr"`` at one NCCL rank, captured,
    against the unsharded trainer on its hybrid, with its epoch time and
    idle share; (e) the command line with --kernel sigmoid --spmm bsr
    --n_shards 2 on 2 gloo ranks against the unsharded command line.
    Returns (the JSON rows, the launches of the captured ring fit, those
    of the captured hybrid fit)."""
    from difformer_tpu_torch import cli

    t0 = time.perf_counter()
    cfg, layers = setup["cfg"], setup["cfg"].num_layers
    ring, hybrid = nccl
    check_distributed_fit("ring, nccl 1 rank", ring, 0, setup["ref_short"],
                          layers, RING_EXACT_EPOCHS, "logits",
                          phase="sharded-a-bsr")
    check_distributed_fit("ring, nccl 1 rank", ring, 1, setup["ref"], layers,
                          RING_EPOCHS, setup["drift"], phase="sharded-a-bsr")
    launches_ring = ring_kernel_launches("ring, nccl 1 rank",
                                         ring["fits"][1], layers,
                                         RING_EPOCHS)
    for tag, case in (("ring", ring), ("hybrid", hybrid)):
        if not all(out["captured"] for out in case["fits"]):
            raise AssertionError(f"{tag}: the NCCL fit did not capture")
        idle = 100 * (1 - case["device_ms"] / case["ms_per_epoch"])
        say(f"phase sharded-a-bsr: {tag}, nccl 1 rank, replayed: "
            f"{case['ms_per_epoch']:.3f} ms per epoch (a step and an eval, "
            f"host clock, median of 3 blocks of {GRAPH_BLOCK}); device "
            f"{case['device_ms']:.4f} ms over {case['ops']:g} device "
            f"operations per epoch, idle {idle:.1f}%; top: "
            + "; ".join(f"{name[:50]} {ms:.4f} ms x{calls:g}"
                        for name, ms, calls in case["top"][:6]))

    # the hybrid at full width against the unsharded trainer's
    out = hybrid["fits"][0]
    nb = BENCH_NODES
    losses = np.asarray(out["summaries"][0]["losses"])
    want_b = np.asarray(setup["best_b"]["losses"])
    logits_b = setup["logits_b"]
    drift_b, outside_b = logit_drift(out["logits"][:nb], logits_b)
    evals = len(out["rows"])
    launches_hybrid = {k: out["launches"].get(k, 0)
                       for k in BSR_PATH + (BSR_COMBINE,) + SPMM_NAMES}
    want_launches = {"bsr_spmm": BENCH_LAYERS * (HYBRID_EPOCHS + evals),
                     "bsr_spmm_transposed": BENCH_LAYERS * HYBRID_EPOCHS,
                     "csr_spmm": BENCH_LAYERS * (HYBRID_EPOCHS + evals),
                     "csr_spmm_transposed": BENCH_LAYERS * HYBRID_EPOCHS}
    say(f"phase sharded-a-bsr: hybrid, nccl 1 rank, bench.py's model on "
        f"the clustered graph (spmm='bsr', T = {BSR_TILE}): losses "
        f"{losses[0]:.6f} -> {losses[-1]:.6f} (unsharded {want_b[0]:.6f} -> "
        f"{want_b[-1]:.6f}), max_abs_err {np.abs(losses - want_b).max():.3e};"
        f" final logits max_abs_err {drift_b:.3e}, {outside_b} of "
        f"{logits_b.size} outside the logit rule; launches "
        f"{launches_hybrid} (K7 and K1's residual, {BENCH_LAYERS} layers x "
        f"({HYBRID_EPOCHS} steps + {evals} evals) / x {HYBRID_EPOCHS} "
        f"steps); the unsharded steady epoch {setup['hybrid_ms']:.3f} ms; "
        f"fit {out['fit_s']:.2f} s")
    torch.testing.assert_close(torch.from_numpy(losses),
                               torch.from_numpy(want_b), rtol=1e-3,
                               atol=1e-4)
    torch.testing.assert_close(torch.from_numpy(out["logits"][:nb]),
                               torch.from_numpy(logits_b), rtol=1e-3,
                               atol=1e-4)
    if {k: launches_hybrid[k] for k in want_launches} != want_launches:
        raise AssertionError(f"hybrid: launches {launches_hybrid}, expected "
                             f"{want_launches}")

    # eager steps on gloo ranks sharing the card
    for case, outs in zip(setup["gloo"], gloo):
        world = case["world"]
        check_sharded_run(f"ring, gloo {world} ranks", "gather",
                          case["sg"], None, outs, setup["eager"], layers,
                          phase="sharded-a-bsr")
        want = SHARDED_STEPS * layers * world
        for rank, o in enumerate(outs):
            k2 = {k: o["launches"].get(k, 0) for k in REPLACES}
            if set(k2.values()) != {want}:
                raise AssertionError(f"ring, gloo {world}: rank {rank} K2-K4 "
                                     f"{k2}, expected {want} each")
        say(f"phase sharded-a-bsr: ring, gloo {world} ranks: K2-K4 "
            f"{SHARDED_STEPS} steps x {layers} layers x {world} ring steps "
            f"= {want} each on every rank")

    # the kernels at the ring's step and on a rank's shard
    rows = ring_kernel_rows(setup["sgs"][2].node_mask[0])
    rows.update(rect_k7_rows(setup["s"], setup["r"]))
    say(f"phase sharded-a-bsr: kernels at {time.perf_counter() - t0:.1f} s")

    # the command line on 2 gloo ranks sharing the card, against the
    # unsharded command line with the same flags
    write_planetoid_cora(tmp)
    base = ["--dataset", "cora", "--data_dir", tmp, "--epochs",
            str(RING_CLI_EPOCHS), "--runs", "1", "--dropout", "0",
            "--kernel", "sigmoid", "--spmm", "bsr", "--bsr_tile", "64"]
    t1 = time.perf_counter()
    plain = cli.main(base)[0]
    plain_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    res = cli.main(base + ["--n_shards", "2"], backend="gloo")
    if len(res) != 1 or not np.isfinite(res[0]["losses"]).all():
        raise AssertionError(f"cli --n_shards 2: {res}")
    got = np.asarray(res[0]["losses"])
    say(f"phase sharded-a-bsr: cli --kernel sigmoid --spmm bsr --bsr_tile "
        f"64 --n_shards 2 (gloo, 2 ranks on one card, {RING_CLI_EPOCHS} "
        f"epochs): test {res[0]['test']:.4f} (unsharded {plain['test']:.4f}, "
        f"{plain_s:.1f} s), losses {got[0]:.4f} -> {got[-1]:.4f}, "
        f"max_abs_err {np.abs(got - plain['losses']).max():.3e} from the "
        f"unsharded run's, {time.perf_counter() - t1:.1f} s")
    torch.testing.assert_close(
        torch.from_numpy(got),
        torch.from_numpy(np.asarray(plain["losses"], got.dtype)), rtol=1e-3,
        atol=1e-4)
    say(f"phase sharded-a-bsr: done in {time.perf_counter() - t0:.1f} s")
    return rows, launches_ring, launches_hybrid


# phase dp-tp: data parallelism over padded graph batches and tensor
# parallelism over heads (parallel/data_parallel.py, tensor_parallel.py)
DP_WORLDS = (1, 2, 4)        # one NCCL rank; gloo ranks sharing the card
DP_PLANS = ("edges", "dense")
TP_LAYOUTS = ("nccl-1", "gloo-2", "grid-2x2")
TP_HEADS = 8                 # slice-s-h8's model: every "auto" rewrite on
TP_JSON = " tp"              # K2-K4's JSON rows at a TP rank's shape
# DIFFormer-a at TP_HEADS heads with the preset's weight decay: the
# unsharded float32 steps end SHARDED_STEPS Adam steps farther from the
# same steps in float64 (exact_reference) than the logit rule allows, and
# the node-sharded ring, whose attention sums over keys are cut across
# ranks, ends within the rule of the float64 steps but not of the float32
# ones; at weight decay 0 the ring follows the float32 steps within the
# rule (PERF.md §6).
# So the grid (preset decay) is held to the float64 steps under the
# rule, the node-sharded ring alone runs at decay 0 and is held to the
# float32 steps at decay 0 under the rule, and every other run to the
# unsharded float32 steps
TP_RING_DECAY = 0.0


def dp_model_kw(f):
    """The actstrack preset's model (:func:`graph_level_trainer`'s) at
    dropout 0 as ``data_parallel.dp_model`` takes it."""
    from difformer_tpu_torch.utils.config import make_config

    cfg = make_config("actstrack")
    return dict(in_channels=f, hidden_channels=cfg.hidden_channels,
                out_channels=cfg.hidden_channels, num_layers=cfg.num_layers,
                kernel=cfg.kernel, alpha=cfg.alpha, dropout=0.0,
                use_bn=cfg.use_bn, use_residual=cfg.use_residual,
                use_weight=cfg.use_weight, use_graph=cfg.use_graph,
                graph_weight=cfg.graph_weight,
                graph_pooling=cfg.graph_pooling)


def dp_reference(graphs, params, world, plan, steps):
    """The unsharded graph-level step under the data-parallel rule: the
    actstrack preset's ``GraphLevelTrainer`` model and Adam (dropout 0)
    from ``params``, its batches of ``len(graphs) / world`` graphs on
    ``plan`` packed as the trainer packs them
    (``graph_level.batch_layout``, through ``data_parallel.device_batch``);
    each eager step sums the BCE of its ``world`` batches over their graph
    count, then one Adam step. Returns (losses, logits [len(graphs)] after
    the steps in eval mode, host ms a step, the median after the
    first)."""
    import dataclasses

    from difformer_tpu_torch.data.batching import batch_iterator, dense_adj
    from difformer_tpu_torch.parallel.data_parallel import (device_batch,
                                                            dp_forward)
    from difformer_tpu_torch.train.graph_level import bce_sum_count

    b = len(graphs) // world
    trainer = graph_level_trainer(graphs, "simple", use_graphs=False,
                                  batch=b, dropout=0.0)
    state = trainer.init_state(0, init_params=params)
    batches = []
    for batch in batch_iterator(graphs, np.arange(len(graphs)), b,
                                max_nodes=trainer.max_nodes,
                                max_edges=trainer.max_edges):
        if plan == "dense":
            batch = dataclasses.replace(batch, dense_adj=dense_adj(batch))
        batches.append(device_batch(batch, "cuda"))
    if any(db.layout.plan != plan for db in batches):
        raise AssertionError(f"the reference's plan is not {plan}")
    model, opt = state.model, state.optimizer
    count = float(sum(db.views["graph_mask"].sum().item() for db in batches))
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.train()
        opt.zero_grad(set_to_none=True)
        total = 0.0
        for db in batches:
            s, _ = bce_sum_count(dp_forward(model, db), db.views["labels"],
                                 db.views["graph_mask"] != 0)
            (s / count).backward()
            total = total + s.detach()
        opt.step()
        losses.append(total / count)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    model.eval()
    with torch.no_grad():
        logits = [dp_forward(model, db) for db in batches]
    return (torch.stack(losses).cpu().numpy(),
            torch.cat(logits).cpu().numpy(), float(np.median(times[1:])))


def dp_tp_setup():
    """The references and the rank cases of phase dp-tp, made before phase
    sharded-s: (a) data parallelism: the actstrack preset's model at
    dropout 0 on ``ACTSTRACK_BATCH`` stand-in graphs cut into 1, 2 and 4
    shards, each on both conv plans (``shard_batches``), from one set of
    weights, with the unsharded reference of each (:func:`dp_reference`);
    (b) tensor parallelism: the cora preset at ``TP_HEADS`` heads as
    DIFFormer-s (every "auto" rewrite on) and DIFFormer-a, its unsharded
    eager steps (:func:`sharded_reference`) and the partition of the
    2 × 2 grid's graph axis (the overlapped halo); for DIFFormer-a also
    the same steps in float64 (:func:`exact_reference`), the steps at
    weight decay ``TP_RING_DECAY`` and the node-sharded ring alone on that
    partition at that decay (``api.train_sharded``, 2 ranks, every head on
    each).
    ``nccl``: the cases at one NCCL rank (phase distributed's spawn);
    ``gloo``: those on 2 gloo ranks and on the grid of 4 (phase
    sharded-s's spawn), then the ring's."""
    from difformer_tpu_torch.parallel import partition_graph
    from difformer_tpu_torch.parallel.data_parallel import (dp_model,
                                                            shard_batches)
    from difformer_tpu_torch.utils.config import make_config
    from difformer_tpu_torch.utils.weights import v2_params_from_state_dict

    t0 = time.perf_counter()
    graphs = actstrack_standin(ACTSTRACK_BATCH, seed=17)
    f = graphs[0][0].shape[1]
    kw = dp_model_kw(f)
    params = v2_params_from_state_dict(
        {k: v.cpu().numpy() for k, v in dp_model(kw, "cpu").state_dict()
         .items()})
    max_nodes = max(g[0].shape[0] for g in graphs)
    max_e = max(g[1].shape[1] for g in graphs)
    dp = {}
    for world in DP_WORLDS:
        for plan in DP_PLANS:
            b = ACTSTRACK_BATCH // world
            stacked = next(iter(shard_batches(
                graphs, np.arange(ACTSTRACK_BATCH), b, world,
                max_nodes=max_nodes, max_edges=b * max_e,
                dense_plan=plan == "dense")))
            dp[world, plan] = dict(
                ref=dp_reference(graphs, params, world, plan, SHARDED_STEPS),
                case=dict(kind="dp", stacked=stacked, params=params,
                          model_kw=kw, steps=SHARDED_STEPS,
                          lr=make_config("actstrack").lr,
                          weight_decay=make_config("actstrack").weight_decay,
                          **({} if world == 1 else dict(world=world))))
            say(f"phase dp-tp: the unsharded graph-level step under the "
                f"data-parallel rule, {world} batch(es) of {b} graphs, "
                f"{plan} plan: {dp[world, plan]['ref'][2]:.2f} ms a step "
                f"(host clock, median of steps 2-{SHARDED_STEPS})")

    x, ei, y = cora_graph()
    (n, f_), c = x.shape, int(y.max()) + 1
    tp = {}
    for kernel in ("simple", "sigmoid"):
        cfg = make_config("cora", dropout=0.0, num_heads=TP_HEADS,
                          kernel=kernel)
        ref = sharded_reference(cfg, SHARDED_STEPS, phase="dp-tp")
        extra = {}
        if kernel == "sigmoid":
            exact = exact_reference(cfg, ref[0], SHARDED_STEPS)
            extra = dict(exact=exact, ref_ring=sharded_reference(
                make_config("cora", dropout=0.0, num_heads=TP_HEADS,
                            kernel=kernel, weight_decay=TP_RING_DECAY),
                SHARDED_STEPS, phase=f"dp-tp (weight decay "
                f"{TP_RING_DECAY:g})", params=ref[0]))
            say(f"phase dp-tp: {kernel} at {TP_HEADS} heads: the float32 "
                f"steps' logits from the float64 steps' (max_abs_err, "
                f"entries of {ref[3].size} outside the rule): "
                f"{logit_drift(ref[3], exact)}")
        common = dict(kind="tp", params=ref[0],
                      model_kw=sharded_model_kw(cfg, f_, c),
                      steps=SHARDED_STEPS, lr=cfg.lr,
                      weight_decay=cfg.weight_decay)
        graph = (x, ei, y, ref[1])
        sg = partition_graph(x, ei, 2, labels=y, label_mask=ref[1],
                             build_halo=True)
        tp[kernel] = dict(cfg=cfg, ref=ref, sg=sg, **extra, cases={
            "nccl-1": dict(common, graph=graph),
            "gloo-2": dict(common, graph=graph, world=2),
            "grid-2x2": dict(common, sg=sg, grid=(2, 2))})
    ring = dict(tp["sigmoid"]["cases"]["grid-2x2"], kind="train", world=2,
                weight_decay=TP_RING_DECAY)
    del ring["grid"]
    say(f"phase dp-tp: references in {time.perf_counter() - t0:.1f} s")
    return dict(
        dp=dp, tp=tp, layers=make_config("cora").num_layers,
        dp_layers=kw["num_layers"],
        nccl=[dp[1, p]["case"] for p in DP_PLANS]
        + [tp[k]["cases"]["nccl-1"] for k in tp],
        gloo=[dp[w, p]["case"] for w in DP_WORLDS[1:] for p in DP_PLANS]
        + [tp[k]["cases"][t] for k in tp for t in TP_LAYOUTS[1:]] + [ring])


def check_dp_run(tag, outs, ref, layers, plan):
    """Hold one data-parallel run (every rank's ``train_dp`` result) to its
    unsharded reference under the logit rule (losses, and the logits of
    the shards in rank order), and each rank's K1 launches to layers x
    steps each way on the edge list, none on the dense plan. Returns each
    rank's launches."""
    losses = outs[0]["losses"]
    logits = np.concatenate([o["logits"] for o in outs])
    ref_losses, ref_logits, ref_ms = ref
    if logits.shape != ref_logits.shape or not np.isfinite(logits).all():
        raise AssertionError(f"{tag}: logits {logits.shape}")
    for got, want in ((losses, ref_losses), (logits, ref_logits)):
        torch.testing.assert_close(torch.from_numpy(got),
                                   torch.from_numpy(want), rtol=1e-3,
                                   atol=1e-4)
    want = SHARDED_STEPS * layers if plan == "edges" else 0
    for rank, out in enumerate(outs):
        if out["jax_loaded"] or out["plan"] != plan:
            raise AssertionError(f"{tag}: rank {rank} imported JAX or ran "
                                 f"the {out['plan']} plan")
        if any(out["launches"].get(name, 0) != want for name in SPMM_NAMES):
            raise AssertionError(f"{tag}: rank {rank} launched K1 "
                                 f"{out['launches']}, expected {want} each "
                                 f"way")
    say(f"phase dp-tp: dp {tag}, {plan} plan: losses {losses[0]:.6f} -> "
        f"{losses[-1]:.6f} (unsharded {ref_losses[0]:.6f} -> "
        f"{ref_losses[-1]:.6f}, max_abs_err "
        f"{np.abs(losses - ref_losses).max():.3e}); logits max_abs_err "
        f"{np.abs(logits - ref_logits).max():.3e} | K1 a rank "
        f"{[o['launches'].get('csr_spmm', 0) for o in outs]} forward, "
        f"{[o['launches'].get('csr_spmm_transposed', 0) for o in outs]} "
        f"transposed | {max(o['step_ms'] for o in outs):.2f} ms a step "
        f"(host clock, median, slowest rank; ranks sharing one card, not a "
        f"scaling number; unsharded {ref_ms:.2f}) | set-up "
        f"{max(o['setup_s'] for o in outs):.1f} s")
    return [o["launches"] for o in outs]


def hold_split_sums(tag, logits, setup):
    """Hold the final logits of a DIFFormer-a run on the ring (the grid) to
    the float64 steps under the logit rule (``TP_RING_DECAY``'s comment);
    returns its distances from them and from the float32 steps for the
    print."""
    ref, exact = setup["ref"][3], setup["exact"]
    got, outside = logit_drift(logits, ref)
    far, far_out = logit_drift(logits, exact)
    text = (f"logits max_abs_err {far:.3e} from the float64 steps, "
            f"{far_out} of {ref.size} outside the rule (the float32 steps "
            f"{logit_drift(ref, exact)[0]:.3e}, "
            f"{logit_drift(ref, exact)[1]} outside); {got:.3e} from the "
            f"float32 steps, {outside} outside")
    torch.testing.assert_close(torch.from_numpy(logits.astype(np.float64)),
                               torch.from_numpy(exact), rtol=1e-3,
                               atol=1e-4, msg=lambda m: f"{tag}: {text}\n{m}")
    return text


def check_tp_run(tag, kernel, outs, setup, layers):
    """Hold one tensor-parallel run (every rank's ``train_tp`` result) to
    the unsharded eager steps: the losses under the logit rule, the final
    logits under it too, or, where DIFFormer-a's attention runs on the
    ring (a graph axis), to the float64 steps (:func:`hold_split_sums`);
    and each rank's
    launches: K1 its products x layers x steps each way; with the sigmoid
    kernel K2, K3 and K4 layers x steps x the ring's steps (the graph
    axis's size). Returns the launches summed over the ranks."""
    _, _, ref_losses, ref_logits = setup["ref"]
    losses = outs[0]["losses"]
    graph_ranks = 1 + max(o["graph_rank"] for o in outs)
    rows = np.concatenate([o["logits"] for o in sorted(
        (o for o in outs if o["model_rank"] == 0),
        key=lambda o: o["graph_rank"])])
    real = setup["sg"].node_mask.reshape(-1)
    logits = rows if graph_ranks == 1 else rows[real]
    if logits.shape != ref_logits.shape or not np.isfinite(logits).all():
        raise AssertionError(f"{tag}: logits {logits.shape}")
    torch.testing.assert_close(torch.from_numpy(losses),
                               torch.from_numpy(ref_losses), rtol=1e-3,
                               atol=1e-4)
    if kernel == "sigmoid" and graph_ranks > 1:
        held = hold_split_sums(f"tp {tag}, {kernel}", logits, setup)
    else:
        torch.testing.assert_close(torch.from_numpy(logits),
                                   torch.from_numpy(ref_logits), rtol=1e-3,
                                   atol=1e-4)
        held = (f"logits max_abs_err "
                f"{np.abs(logits - ref_logits).max():.3e}")
        if "exact" in setup:
            held += (f" (from the float64 steps, with the entries outside "
                     f"the rule: {logit_drift(logits, setup['exact'])})")
    total = {}
    for rank, out in enumerate(outs):
        want = {name: SHARDED_STEPS * layers * out["products"]
                for name in SPMM_NAMES}
        if kernel == "sigmoid":
            want.update({name: SHARDED_STEPS * layers * graph_ranks
                         for name in REPLACES})
        if out["jax_loaded"] or any(out["launches"].get(k, 0) != v
                                    for k, v in want.items()):
            raise AssertionError(f"{tag}: rank {rank} launched "
                                 f"{out['launches']}, expected {want}")
        for k, v in out["launches"].items():
            total[k] = total.get(k, 0) + v
    say(f"phase dp-tp: tp {tag}, {kernel} at {TP_HEADS} heads: losses "
        f"{losses[0]:.6f} -> {losses[-1]:.6f} (unsharded "
        f"{ref_losses[0]:.6f} -> {ref_losses[-1]:.6f}, max_abs_err "
        f"{np.abs(losses - ref_losses).max():.3e}); {held} | launches a "
        f"rank "
        f"{[o['launches'] for o in outs]} | "
        f"{max(o['step_ms'] for o in outs):.2f} ms a step (host clock, "
        f"median, slowest rank; ranks sharing one card, not a scaling "
        f"number) | set-up {max(o['setup_s'] for o in outs):.1f} s")
    return total


def phase_dp_tp(setup, nccl, gloo):
    """ROADMAP.md queue A item 10c on the results of :func:`dp_tp_setup`'s
    cases (``nccl`` from phase distributed's spawn, ``gloo`` from phase
    sharded-s's): (a) the data-parallel step (``make_dp_train_step``) of
    the actstrack preset's model at dropout 0, ``SHARDED_STEPS`` steps on
    1024 graphs as one NCCL rank's batch, two gloo ranks' of 512 and four
    of 256, on the edge list (K1) and on the dense plan, each against the
    unsharded graph-level step under the same rule (losses and logits
    within rtol 1e-3 / atol 1e-4); (b) the head-sharded step
    (``make_tp_train_step``) of the cora preset at ``TP_HEADS`` heads, as
    DIFFormer-s and -a, at one NCCL rank (T = 1), on 2 gloo ranks (T = 2)
    and on the 2 × 2 graph × model grid of 4 gloo ranks, against the
    unsharded eager steps (:func:`check_tp_run`; the node-sharded ring
    alone at weight decay ``TP_RING_DECAY`` to the steps at that decay);
    each rank's K1 and K2–K4 launches
    and ms a step; (c) K2–K4 at a T = 2 rank's shape (N = L = 2708, H = 4, M = D =
    64) against their plain versions, timed beside their bound. Returns
    (the JSON rows of (c), the K2–K4 launches of the T = 2 DIFFormer-a run
    summed over its ranks)."""
    t0 = time.perf_counter()
    nccl_dp, nccl_tp = nccl[:len(DP_PLANS)], nccl[len(DP_PLANS):]
    n_dp = len(DP_PLANS) * (len(DP_WORLDS) - 1)
    gloo_dp, gloo_tp, ring = gloo[:n_dp], gloo[n_dp:-1], gloo[-1]
    runs = {(1, p): out for p, out in zip(DP_PLANS, nccl_dp)}
    runs.update({key: out for key, out in zip(
        [(w, p) for w in DP_WORLDS[1:] for p in DP_PLANS], gloo_dp)})
    for (world, plan), outs in runs.items():
        check_dp_run("nccl, 1 rank" if world == 1 else
                     f"gloo, {world} ranks on one card", outs,
                     setup["dp"][world, plan]["ref"], setup["dp_layers"],
                     plan)
    tp_runs = {(k, "nccl-1"): out for k, out in zip(setup["tp"], nccl_tp)}
    tp_runs.update({key: out for key, out in zip(
        [(k, t) for k in setup["tp"] for t in TP_LAYOUTS[1:]], gloo_tp)})
    launches = None
    sig = setup["tp"]["sigmoid"]
    ring_logits = np.concatenate([o["logits"] for o in ring])[
        sig["sg"].node_mask.reshape(-1)]
    _, _, want_losses, want_logits = sig["ref_ring"]
    for got, want in ((ring[0]["losses"], want_losses),
                      (ring_logits, want_logits)):
        torch.testing.assert_close(torch.from_numpy(got),
                                   torch.from_numpy(want), rtol=1e-3,
                                   atol=1e-4)
    say(f"phase dp-tp: the node-sharded ring alone on the grid's partition "
        f"(2 gloo ranks, {TP_HEADS} heads each) at weight decay "
        f"{TP_RING_DECAY:g}: losses max_abs_err "
        f"{np.abs(ring[0]['losses'] - want_losses).max():.3e}, logits "
        f"max_abs_err, entries outside the rule "
        f"{logit_drift(ring_logits, want_logits)} from the unsharded steps "
        f"at that decay")
    for (kernel, layout), outs in tp_runs.items():
        total = check_tp_run(layout, kernel, outs, setup["tp"][kernel],
                             setup["layers"])
        if kernel == "sigmoid" and layout == "gloo-2":
            launches = total
    rows = step_kernel_rows(
        "dp-tp", f"T = 2 rank N=L=2708 H={TP_HEADS // 2} M=D=64 f32",
        TP_JSON, 2708, TP_HEADS // 2, None, normalize=True)
    say(f"phase dp-tp: done in {time.perf_counter() - t0:.1f} s (its rank "
        f"cases ran in the spawns of phases sharded-s and distributed)")
    return rows, launches


def phase_kernels_wide():
    """K2-K4 on their wide path (M or D above ``NARROW_WIDTH``) at the set
    track's shapes, each against its plain version on the same inputs under
    ``kernels/tolerance.py``, each comparison shown to fail a wrong output
    and two calls shown bit-equal: the device times (:func:`device_ms`) of
    kernel and plain version, the FP32 operation bound (the JSON rows'
    ``bound_ms``), the bound at the rate of the instructions the kernel
    multiplies with (:func:`tensor_bound_ms`: TF32 tensor cores) and the
    split chosen. q and k are scaled so that
    q·k has unit variance, which keeps the scores off the sigmoid's flat
    ends. The unnormalized numerator is checked at float32 only: at
    bfloat16 inputs, a one-ulp change of q·k flips s's bfloat16 rounding
    now and then, which moves a raw sum of L terms by more than the float32
    rule allows (``out``, normalised, is held to the bfloat16 rule).
    Returns the JSON rows of ``WIDE_JSON``."""
    from difformer_tpu_torch.kernels import sigmoid_attention as K
    from difformer_tpu_torch.kernels.tolerance import assert_close

    rows = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for idx, shape in enumerate(WIDE_SHAPES):
        n, l, h, m, d, dtype, masked = shape
        if not K.is_wide(m, d):
            raise AssertionError(f"{shape} is not on the wide path")
        q, k, v, mask, g = attention_case(n, l, h, m, d, dtype, masked,
                                          100 + idx, scale=m ** -0.25)
        label = (f"N={n} L={l} H={h} M={m} D={d} "
                 f"{str(dtype).split('.')[-1]}{' mask' if masked else ''}")
        out, den = K.sigmoid_attention_fwd(q, k, v, mask)
        r_out, r_den = K.sigmoid_attention_fwd_plain(q, k, v, mask)
        errs = {"sigmoid_attention_fwd": max(
            assert_close(f"wide out {label}", out, r_out, "out"),
            assert_close(f"wide den {label}", den, r_den, "den"))}
        checks = [("out", r_out, "out", None), ("den", r_den, "den", None)]
        if dtype == torch.float32:
            num, _ = K.sigmoid_attention_fwd(q, k, v, mask, normalize=False)
            r_num, _ = K.sigmoid_attention_fwd_plain(q, k, v, mask,
                                                     normalize=False)
            errs["sigmoid_attention_fwd"] = max(
                errs["sigmoid_attention_fwd"],
                assert_close(f"wide num {label}", num, r_num, "num",
                             den=r_den))
            checks.append(("num", r_num, "num", r_den))
            del num, r_num
        dnum = g / den[..., None]
        dden = -(g * out.float()).sum(-1) / den
        dq = K.sigmoid_attention_dq(q, k, v, mask, dnum, dden)
        r_dq = K.sigmoid_attention_dq_plain(q, k, v, mask, dnum, dden)
        errs["sigmoid_attention_dq"] = assert_close(f"wide dq {label}", dq,
                                                    r_dq, "grad")
        dk, dv = K.sigmoid_attention_dkv(q, k, v, mask, dnum, dden)
        r_dk, r_dv = K.sigmoid_attention_dkv_plain(q, k, v, mask, dnum, dden)
        errs["sigmoid_attention_dkv"] = max(
            assert_close(f"wide dk {label}", dk, r_dk, "grad"),
            assert_close(f"wide dv {label}", dv, r_dv, "grad"))
        checks += [("dq", r_dq, "grad", None), ("dk", r_dk, "grad", None),
                   ("dv", r_dv, "grad", None)]
        for name, ref, kind, den_ref in checks:
            assert_rejects(f"wide {name} {label}", ref, kind, den_ref)
        again = (*K.sigmoid_attention_fwd(q, k, v, mask),
                 K.sigmoid_attention_dq(q, k, v, mask, dnum, dden),
                 *K.sigmoid_attention_dkv(q, k, v, mask, dnum, dden))
        for name, first, second in zip(("out", "den", "dq", "dk", "dv"),
                                       (out, den, dq, dk, dv), again):
            if not torch.equal(first, second):
                raise AssertionError(f"wide {name} {label}: two calls differ")
        del again
        del out, r_out, r_den, dq, r_dq, dk, r_dk, dv, r_dv, checks
        torch.cuda.empty_cache()

        calls = {
            "sigmoid_attention_fwd": (
                lambda: K.sigmoid_attention_fwd(q, k, v, mask),
                lambda: K.sigmoid_attention_fwd_plain(q, k, v, mask)),
            "sigmoid_attention_dq": (
                lambda: K.sigmoid_attention_dq(q, k, v, mask, dnum, dden),
                lambda: K.sigmoid_attention_dq_plain(q, k, v, mask, dnum,
                                                     dden)),
            "sigmoid_attention_dkv": (
                lambda: K.sigmoid_attention_dkv(q, k, v, mask, dnum, dden),
                lambda: K.sigmoid_attention_dkv_plain(q, k, v, mask, dnum,
                                                      dden)),
        }
        for name, (kernel, plain) in calls.items():
            per_split, splits, chunk = K.split_plan(name, n, l, h, m, d, sms)
            ms, plain_ms = device_ms(kernel, calls=3), device_ms(plain,
                                                                 calls=3)
            bound, bound_by = bound_ms(name, n, l, h, m, d, dtype)
            tc, instr = tensor_bound_ms(name, n, l, h, m, d, dtype)
            say(f"phase kernels-wide: {name:22s} {label:40s} max_abs_err "
                f"{errs[name]:.3e} | device {ms:.4f} ms | plain "
                f"{plain_ms:.4f} ms | bound {bound:.4f} ms by {bound_by} "
                f"({100 * bound / ms:.1f}% of the kernel's time) | "
                f"{instr}: {tc:.4f} ms ({100 * tc / ms:.1f}%) | S={splits}"
                f" ({chunk} loop tiles each), {per_split * splits} blocks")
            if shape == WIDE_JSON:
                rows[f"{name} wide"] = dict(
                    max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=bound_by, library_ms=None)
        del q, k, v, mask, g, dnum, dden, calls
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# cli and cli-set: the command line, end to end
# ---------------------------------------------------------------------------

def write_planetoid_cora(root, num_nodes=2708, num_edges=10556,
                         feat_dim=1433, classes=7):
    """Planetoid raw files (``ind.cora.*``, the layout ``load_planetoid``
    reads) under ``root/Planetoid/cora/raw`` for
    ``random_graph(num_nodes, num_edges, feat_dim, classes, seed=42,
    homophily=0.8)``, its features made 0/1 (x > 1) as Cora's bag of words
    is. The split is Cora's: 140 labelled rows (``x``, ``y``), the first
    ``num_nodes - 1000`` rows in ``allx``, the last 1000 (or a third of a
    smaller graph) in ``tx`` with their ids in ``test.index``. Returns
    (features, edge_index as written, labels)."""
    import os
    import pickle

    import scipy.sparse as sp

    from difformer_tpu_torch.data import random_graph

    x, ei, y = random_graph(num_nodes, num_edges, feat_dim, classes,
                            seed=42, homophily=0.8)
    x = (x > 1.0).astype(np.float32)
    onehot = np.eye(classes)[y]
    n_test = min(1000, num_nodes // 3)
    n_all = num_nodes - n_test
    n_train = min(140, n_all)
    raw = os.path.join(root, "Planetoid", "cora", "raw")
    os.makedirs(raw, exist_ok=True)
    adjacency = {i: [] for i in range(num_nodes)}
    for src, dst in ei.T:
        adjacency[int(src)].append(int(dst))
    parts = {"x": sp.csr_matrix(x[:n_train]), "y": onehot[:n_train],
             "allx": sp.csr_matrix(x[:n_all]), "ally": onehot[:n_all],
             "tx": sp.csr_matrix(x[n_all:]), "ty": onehot[n_all:],
             "graph": adjacency}
    for part, obj in parts.items():
        with open(os.path.join(raw, f"ind.cora.{part}"), "wb") as f:
            pickle.dump(obj, f)
    np.savetxt(os.path.join(raw, "ind.cora.test.index"),
               np.arange(n_all, num_nodes), fmt="%d")
    written = np.asarray([(s, t) for s in adjacency for t in adjacency[s]],
                         np.int64).reshape(-1, 2).T
    return x, written, y


def cifar10_embeddings(num=CIFAR10_NODES, dim=CIFAR10_WIDTH,
                       classes=CIFAR10_CLASSES, seed=0):
    """Stand-ins for cifar10's image embeddings: ``num`` rows of ``dim``
    ReLU features (non-negative, as a ResNet's pooled output is) around
    one standard normal centre per class, with noise of 5 times its
    scale, so that 20 labels a class do not separate them all, and their
    labels."""
    noise = 5.0
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, num)
    centres = rng.normal(size=(classes, dim))
    x = np.maximum(centres[y] + noise * rng.normal(size=(num, dim)), 0.0)
    return x.astype(np.float32), y.astype(np.int64)


def write_cifar10_embeddings(root, x, y):
    """``root/cifar10_embeddings.pkl`` as ``load_image_text`` reads it."""
    import os
    import pickle

    with open(os.path.join(root, "cifar10_embeddings.pkl"), "wb") as f:
        pickle.dump((x, y), f)


# the temporal presets' datasets as torch_geometric_temporal publishes them:
# Hungary chickenpox (20 counties, 102 directed edges, 522 weekly readings)
# and Wikipedia mathematics (1,068 pages, 27,079 weighted links, 731 days)
CHICKENPOX_NODES, CHICKENPOX_EDGES, CHICKENPOX_WEEKS = 20, 102, 522
WIKIMATH_NODES, WIKIMATH_EDGES, WIKIMATH_DAYS = 1068, 27_079, 731


def _distinct_pairs(rng, n, e):
    """``e`` distinct directed pairs of ``n`` nodes (numpy [E, 2])."""
    codes = rng.choice(n * n, size=e, replace=False)
    return np.stack([codes // n, codes % n], axis=1)


def write_chickenpox_json(root, nodes=CHICKENPOX_NODES,
                          edges=CHICKENPOX_EDGES, weeks=CHICKENPOX_WEEKS,
                          seed=41):
    """``root/chickenpox.json`` as ``load_chickenpox`` reads it: a stand-in
    of the published shapes (``edges`` [E, 2], ``FX`` [weeks, nodes]) with
    standardised weekly readings from a seasonal AR(1) process per
    county."""
    import os

    rng = np.random.default_rng(seed)
    fx = np.zeros((weeks, nodes))
    season = np.sin(2 * np.pi * np.arange(weeks) / 52.0)
    for t in range(1, weeks):
        fx[t] = 0.7 * fx[t - 1] + 0.5 * season[t] + 0.4 * rng.normal(
            size=nodes)
    fx = (fx - fx.mean()) / fx.std()
    data = {"edges": _distinct_pairs(rng, nodes, edges).tolist(),
            "FX": fx.tolist()}
    with open(os.path.join(root, "chickenpox.json"), "w") as f:
        json.dump(data, f)


def write_wikimath_json(root, nodes=WIKIMATH_NODES, edges=WIKIMATH_EDGES,
                        days=WIKIMATH_DAYS, seed=43):
    """``root/wikivital_mathematics.json`` as ``load_wikimath`` reads it: a
    stand-in of the published shapes (``edges`` [E, 2] with ``weights``,
    ``time_periods`` and each day's ``y`` [nodes]) with heavy-tailed daily
    visit counts (a log-normal level per page, a weekly cycle and noise);
    node ``nodes - 1`` has an edge, as the loader sizes the graph by the
    largest id."""
    import os

    rng = np.random.default_rng(seed)
    pairs = _distinct_pairs(rng, nodes, edges)
    pairs[0] = (nodes - 1, 0)
    level = rng.normal(5.0, 1.5, nodes)
    week = 0.2 * np.sin(2 * np.pi * np.arange(days) / 7.0)
    data = {"edges": pairs.tolist(),
            "weights": rng.integers(1, 10, edges).astype(float).tolist(),
            "time_periods": days}
    for t in range(days):
        data[str(t)] = {"y": np.round(np.exp(
            level + week[t] + 0.3 * rng.normal(size=nodes))).tolist()}
    with open(os.path.join(root, "wikivital_mathematics.json"), "w") as f:
        json.dump(data, f)


class CliRun:
    """Drives ``difformer_tpu_torch.cli.main`` once with the launch counts
    set to 0 just before and read just after; times, on the host clock,
    what comes before the trainer (load and preprocess, the model), each
    ``fit`` and the kNN graph."""

    def __init__(self, phase, argv):
        from difformer_tpu_torch import cli

        self.phase, self.argv = phase, argv
        times = self.times = {"fit_s": 0.0, "knn_s": 0.0, "epochs": 0}
        real_fit, real_knn = cli.FullBatchTrainer.fit, cli.knn_graph
        start = [0.0]

        def timed_fit(trainer, split_idx, **kw):
            if "prep_s" not in times:
                times["prep_s"] = time.perf_counter() - start[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = real_fit(trainer, split_idx, **kw)
            torch.cuda.synchronize()
            times["fit_s"] += time.perf_counter() - t0
            times["epochs"] += kw["epochs"] * kw.get("runs", 1)
            self.trainer = trainer
            return res

        def timed_knn(*args, **kw):
            t0 = time.perf_counter()
            out = real_knn(*args, **kw)
            times["knn_s"] += time.perf_counter() - t0
            return out

        stack = contextlib.ExitStack()
        stack.enter_context(unittest.mock.patch.object(
            cli.FullBatchTrainer, "fit", timed_fit))
        stack.enter_context(unittest.mock.patch.object(
            cli, "knn_graph", timed_knn))
        with stack:
            reset_launch_counts()
            start[0] = time.perf_counter()
            self.res = cli.main(argv)
            torch.cuda.synchronize()
            self.launches = launch_counts()
            self.dval = dval_count()
        self.total_s = time.perf_counter() - start[0]

    def check(self, classes, path):
        """Every run's test metric finite and above chance (1/classes);
        every kernel of ``path`` launched and no other."""
        tests = [r["test"] for r in self.res]
        say(f"phase {self.phase}: {' '.join(self.argv)} -> test "
            f"{[round(t, 4) for t in tests]}; launches {self.launches}")
        if not all(math.isfinite(t) and t > 1.0 / classes for t in tests):
            raise AssertionError(f"test metrics at or below chance "
                                 f"({1.0 / classes:.3f}): {tests}")
        off = {k: v for k, v in self.launches.items()
               if (v > 0) != (k in path)}
        if off:
            raise AssertionError(f"kernels launched against the path "
                                 f"{sorted(path)}: {off}")

    def ell_path(self):
        """The kernels of the layout the run's GCN branch took
        (:func:`layout_path`)."""
        conv = self.trainer.model.convs[0]
        return layout_path(self.trainer.model_kwargs["ell"],
                           conv.num_heads * conv.out_channels)

    def report(self, cut=""):
        t = self.times
        epochs = max(t["epochs"], 1)
        knn = f", kNN graph {t['knn_s']:.3f} s" if t["knn_s"] else ""
        say(f"phase {self.phase}: host seconds: load and preprocess "
            f"{t.get('prep_s', float('nan')):.3f} s{knn} (within it), fit "
            f"{t['fit_s']:.3f} s for {t['epochs']} epochs = "
            f"{1e3 * t['fit_s'] / epochs:.3f} ms per epoch (captures "
            f"included), whole command {self.total_s:.3f} s{cut}")


SIGMOID_PATH = ("sigmoid_attention_fwd", "sigmoid_attention_dq",
                "sigmoid_attention_dkv")
K1_PATH = ("csr_spmm", "csr_spmm_transposed")


def phase_cli(tmp):
    """The cora preset through the command line, unchanged (DIFFormer-s,
    hidden 64, 8 layers, 500 epochs, 5 runs, epoch_block 8) on Planetoid
    files of a synthetic graph of Cora's size, its GCN branch on the
    default ELL layout (K6, no K1); then with --kernel sigmoid (K2-K4 and
    K6), with --reorder rcm and with --spmm coo (K1), each cut to 1 of its
    5 runs (the script's time limit); then a --save_model run cut to 50
    epochs and 1 run, and --eval_only on what it saved. Returns the main
    path's launches (the first run)."""
    from difformer_tpu_torch.utils.config import make_config

    write_planetoid_cora(tmp)
    base = ["--dataset", "cora", "--data_dir", tmp]
    main_run = CliRun("cli", base)
    main_run.check(7, main_run.ell_path())
    main_run.report()
    check_no_dval("cli", "DIFFormer-s")
    for extra, path in ((["--kernel", "sigmoid"], SIGMOID_PATH),
                        (["--reorder", "rcm"], ()),
                        (["--spmm", "coo"], K1_PATH)):
        run = CliRun("cli", base + extra + ["--runs", "1"])
        run.check(7, path + (run.ell_path() if path != K1_PATH else ()))
        run.report("; cut to 1 of the preset's 5 runs")

    cfg = make_config("cora")
    cut = ["--epochs", "50", "--runs", "1"]
    saved = CliRun("cli", base + ["--save_model", "true", "--model_dir",
                                  tmp] + cut)
    saved.check(7, saved.ell_path())
    saved.report(f"; cut from {cfg.epochs} epochs and {cfg.runs} runs: "
                 f"save_best takes the per-epoch loop")
    evaluated = CliRun("cli", base + ["--eval_only", "true", "--model_dir",
                                      tmp] + cut)
    best, got = saved.res[-1], evaluated.res[0]
    say(f"phase cli: eval_only {got} against the saved best epoch "
        f"{best['epoch']}: train {best['train']} valid {best['valid']} "
        f"test {best['test']}")
    for split in ("train", "valid", "test"):
        if got[split] != best[split]:
            raise AssertionError(f"eval_only {split} {got[split]} != the "
                                 f"saved run's {best[split]}")
    return main_run.launches


def phase_cli_set(tmp):
    """The cifar10 preset through the command line, unchanged (hidden 300,
    2 layers, k = 5, use_graph false, 600 epochs, 5 runs) on stand-in
    embeddings [15000, 512]; then --kernel sigmoid --use_graph true, cut
    to 20 epochs and 1 run, which runs K6 on the kNN graph's ELL layout
    (the default route) and the wide K2-K4. Returns that run's launches."""
    from difformer_tpu_torch.utils.config import make_config

    x, y = cifar10_embeddings()
    write_cifar10_embeddings(tmp, x, y)
    base = ["--dataset", "cifar10", "--data_dir", tmp]
    preset = CliRun("cli-set", base)
    preset.check(CIFAR10_CLASSES, ())
    preset.report()
    cfg = make_config("cifar10")
    wide = CliRun("cli-set", base + ["--kernel", "sigmoid", "--use_graph",
                                     "true", "--epochs", "20", "--runs",
                                     "1"])
    wide.check(CIFAR10_CLASSES, wide.ell_path() + SIGMOID_PATH)
    wide.report(f"; cut from {cfg.epochs} epochs and {cfg.runs} runs")
    return wide.launches


# ---------------------------------------------------------------------------
# zoo-cora and zoo-cifar10: the baseline zoo through the command line
# ---------------------------------------------------------------------------

# every zoo method of the command line, with the JK nets' three aggregations
ZOO_RUNS = [("mlp", []), ("manireg", []), ("gcn", []), ("gat", []),
            ("sgc", []), ("link", []), ("mixhop", []),
            ("gcnjk", ["--jk_type", "max"]), ("gcnjk", ["--jk_type", "cat"]),
            ("gcnjk", ["--jk_type", "lstm"]), ("gatjk", []), ("h2gcn", []),
            ("appnp", []), ("gprgnn", []), ("lp", []), ("multilp", [])]
ZOO_EPOCHS = 20   # of the cora preset's 500 x 5 runs
ZOO_CIFAR10_EPOCHS = 5   # of the cifar10 preset's 600 x 5 runs
ZOO_GAT = ("gat", "gatjk")   # the methods whose edge values are learned


def zoo_expected(method):
    """Which kernels a zoo method's run launches: K1 forward for all but
    the MLPs, K1 transposed for the trained graph models, K1-dval for GAT
    and GATJK, no attention kernel."""
    graph = method not in ("mlp", "manireg")
    trained = graph and method not in ("lp", "multilp")
    return {"csr_spmm": graph, "csr_spmm_transposed": trained,
            DVAL_NAME: method in ZOO_GAT}


def zoo_run(phase, argv, method):
    """One zoo run through the command line: the test metric finite in
    [0, 1] (no floor: 20 epochs of an 8-layer model at the preset's lr are
    not a trained model), the kernels of :func:`zoo_expected` launched and
    no other; prints the metric, fit ms per epoch and the launches counted
    by the wrappers and, for a graph fit, replayed on the device. Returns
    (the run, {kernel: wrapper count + device replays})."""
    torch.cuda.reset_peak_memory_stats()
    run = CliRun(phase, argv)
    peak = torch.cuda.max_memory_allocated() / 2**20
    tests = [r["test"] for r in run.res]
    trainer = getattr(run, "trainer", None)
    runner = None if trainer is None else trainer.epoch_runner
    replayed = {} if runner is None else runner.launches()
    launched = {k: v + replayed.get(k, 0) for k, v in run.launches.items()}
    launched[DVAL_NAME] = run.dval + (0 if runner is None
                                      else runner.dval_launches())
    t = run.times
    per_epoch = (f"{1e3 * t['fit_s'] / t['epochs']:.3f} ms per epoch "
                 f"(captures included)" if t["epochs"] else
                 f"no training, whole command {run.total_s:.3f} s")
    say(f"phase {phase}: --method {' '.join(argv[argv.index('--method') + 1:])}"
        f" -> test {[round(x, 4) for x in tests]}, {per_epoch}, peak "
        f"memory {peak:.1f} MiB; launches (wrappers + replays) "
        f"{ {k: v for k, v in launched.items() if v} }")
    if not all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in tests):
        raise AssertionError(f"phase {phase}: test metrics {tests}")
    expect = zoo_expected(method)
    off = {k: v for k, v in launched.items()
           if (v > 0) != bool(expect.get(k, False))}
    if off:
        raise AssertionError(f"phase {phase}: --method {method} launched "
                             f"{off} against {expect}")
    if method in ZOO_GAT and runner is not None:
        check_gat_step(phase, method, trainer)
    return run, launched


def steady_epoch_ms(runner, epochs=5):
    """Host ms of one epoch (a step and an eval) of a graph fit's runner,
    replayed after the fit: a block of ``epochs`` epochs, the median of
    3, over the epochs."""
    def block():
        runner.rewind()
        runner.block(epochs, 1)

    return host_ms(block) / epochs


def check_gat_step(phase, method, trainer):
    """K1-dval's launches in one captured train step of a GAT model's
    graph fit: one for each GAT layer's backward, whatever its heads; and
    the fit's steady ms per epoch, replayed."""
    from difformer_tpu_torch.nn.gnns import GATLayer

    layers = [m for m in trainer.model.modules() if isinstance(m, GATLayer)]
    per_step = trainer.epoch_runner.graphs["step"]["captured_dval"]
    say(f"phase {phase}: --method {method}: K1-dval launches a train step "
        f"{per_step} for {len(layers)} GAT layers of "
        f"{[m.heads for m in layers]} heads; steady ms per epoch (a step "
        f"and an eval, replayed) {steady_epoch_ms(trainer.epoch_runner):.3f}")
    if per_step != len(layers):
        raise AssertionError(f"phase {phase}: --method {method}: {per_step} "
                             f"K1-dval launches a step, expected one a GAT "
                             f"layer ({len(layers)})")


def check_graph_against_loop(phase, method, graph_run, loop_run):
    """The epoch-block fit (CUDA graphs) against the per-epoch loop of the
    same command: the same best epoch, losses and split metrics within
    rtol 1e-5 (PERF.md §2); prints whether they are bit-equal."""
    a, b = graph_run.res[0], loop_run.res[0]
    same = (a["epoch"] == b["epoch"]
            and np.allclose(a["losses"], b["losses"], rtol=GRAPH_RTOL,
                            atol=0)
            and all(np.isclose(a[k], b[k], rtol=GRAPH_RTOL, atol=1e-7)
                    for k in ("train", "valid", "test")))
    # the graph fit's metrics are the device's float32, the loop's numpy's
    equal = a["losses"] == b["losses"] and a["epoch"] == b["epoch"]
    say(f"phase {phase}: --method {method} graph fit against the loop: best "
        f"epoch {a['epoch']} / {b['epoch']}, largest loss rel diff "
        f"{largest_rel_diff(a['losses'], b['losses']):.3e}, metrics "
        f"{[a[k] for k in ('train', 'valid', 'test')]} / "
        f"{[b[k] for k in ('train', 'valid', 'test')]}; losses and best "
        f"epoch bit-equal {equal}")
    if not same:
        raise AssertionError(f"phase {phase}: --method {method}'s graph fit "
                             f"and loop differ beyond rtol {GRAPH_RTOL}")


def phase_zoo_cora(tmp):
    """Every zoo method through the command line on the cora preset's
    widths (hidden 64, 8 layers, lr 1e-3, dropout 0.2, epoch_block 8) on
    Planetoid files of the slice's graph of Cora's size, cut to
    ``ZOO_EPOCHS`` epochs and 1 run; GCN and GAT again through the
    per-epoch loop (``--epoch_block 0``), held against their graph fits.
    Returns GAT's launches (K1-dval's are the JSON line's)."""
    write_planetoid_cora(tmp)
    base = ["--dataset", "cora", "--data_dir", tmp, "--epochs",
            str(ZOO_EPOCHS), "--runs", "1"]
    gat = None
    for method, extra in ZOO_RUNS:
        argv = base + ["--method", method] + extra
        run, launched = zoo_run("zoo-cora", argv, method)
        if method in ("gcn", "gat"):
            loop = CliRun("zoo-cora", argv + ["--epoch_block", "0"])
            check_graph_against_loop("zoo-cora", method, run, loop)
        if method == "gat":
            gat = launched
    return gat


def phase_zoo_cifar10(tmp):
    """GCN and GAT (2 heads) through the command line on the cifar10 preset
    (hidden 300, 2 layers, the set track's kNN graph, k = 5) on stand-in
    embeddings [15000, 512], cut to ``ZOO_CIFAR10_EPOCHS`` epochs and 1
    run: ms per epoch and peak memory. Returns GAT's launches."""
    x, y = cifar10_embeddings()
    write_cifar10_embeddings(tmp, x, y)
    base = ["--dataset", "cifar10", "--data_dir", tmp, "--epochs",
            str(ZOO_CIFAR10_EPOCHS), "--runs", "1"]
    zoo_run("zoo-cifar10", base + ["--method", "gcn"], "gcn")
    return zoo_run("zoo-cifar10", base + ["--method", "gat"], "gat")[1]


# ---------------------------------------------------------------------------
# minibatch-pokec and minibatch-proteins: MiniBatchTrainer at the presets'
# sizes, and K1's capacity launch on a Pokec chunk
# ---------------------------------------------------------------------------

POKEC_FEATURES, POKEC_CLASSES, POKEC_BATCH = 65, 2, 100_000
# the pokec preset is 500 epochs x 5 runs with an eval every 9th epoch:
# cut to 3 epochs of 1 run, which keeps the evals at epochs 0 and 2
POKEC_CUT = ["--epochs", "3", "--runs", "1"]
# ogbn-proteins' shape: nodes, features (the mean of its 8 edge features),
# binary tasks, undirected edges (each also inverted by the loader)
PROTEINS_NODES, PROTEINS_FEATURES, PROTEINS_TASKS = 132_534, 8, 112
PROTEINS_UNDIRECTED = 39_561_252
# the stand-in's degree skew: ends drawn by power_law_nodes at this
# exponent give degrees from about 460 to about 9,000 (mean 597, as the
# dataset's), so some 10000-node chunks keep rows above SPLIT_THRESHOLD
PROTEINS_EXPONENT = 1.3
PROTEINS_EPOCHS = 3  # of the preset's 1000 x 5 runs; evals at 0 and 2


def pokec_standin(seed=21):
    """(features [N, 65] float32, edge_index [2, E] int32, labels [N]
    int64) of Pokec's size, drawn on the card: power-law senders and
    receivers (:func:`power_law_nodes`), standard normal features, and two
    classes from a noisy linear rule of the features."""
    g = torch.Generator("cuda").manual_seed(seed)
    n, e = POKEC_NODES, POKEC_EDGES
    ei = torch.stack([power_law_nodes(n, e, g), power_law_nodes(n, e, g)])
    x = torch.randn((n, POKEC_FEATURES), device="cuda", generator=g)
    w = torch.randn(POKEC_FEATURES, device="cuda", generator=g)
    score = x @ w + 0.5 * w.norm() * torch.randn(n, device="cuda",
                                                  generator=g)
    return (x.cpu().numpy(), ei.int().cpu().numpy(),
            (score > 0).long().cpu().numpy())


def write_pokec_mat(root, x, ei, y):
    """``root/pokec/pokec.mat`` as ``load_pokec`` reads it."""
    import os

    from scipy.io import savemat

    os.makedirs(os.path.join(root, "pokec"), exist_ok=True)
    savemat(os.path.join(root, "pokec", "pokec.mat"),
            {"node_feat": x, "edge_index": ei, "label": y[None]})


def proteins_standin(seed=31):
    """(features [N, 8] float32, edge_index int32, labels [N, 112] int64)
    at ogbn-proteins' shape, drawn on the card: 39,561,252 pairs of
    distinct nodes with skewed degrees (both ends by
    :func:`power_law_nodes` at ``PROTEINS_EXPONENT``; a pair drawn with
    one node twice takes the next id as its second end), each in both
    directions (as the loader adds the inverses), then a self loop on
    every node (as the command line adds them); features in [0, 1) and
    112 tasks, each a linear threshold of the features."""
    g = torch.Generator("cuda").manual_seed(seed)
    n, m = PROTEINS_NODES, PROTEINS_UNDIRECTED
    s = power_law_nodes(n, m, g, PROTEINS_EXPONENT)
    r = power_law_nodes(n, m, g, PROTEINS_EXPONENT)
    r = torch.where(r == s, (r + 1) % n, r)
    loops = torch.arange(n, device="cuda")
    ei = torch.stack([torch.cat([s, r, loops]), torch.cat([r, s, loops])])
    x = torch.rand((n, PROTEINS_FEATURES), device="cuda", generator=g)
    w = torch.randn((PROTEINS_FEATURES, PROTEINS_TASKS), device="cuda",
                    generator=g)
    y = ((x - 0.5) @ w > 0).long()
    return x.cpu().numpy(), ei.int().cpu().numpy(), y.cpu().numpy()


def phase_spmm_chunk(trainer, w, seed=5, dtype=torch.float32,
                     phase="minibatch-pokec", label="pokec chunk"):
    """K1 as the mini-batch trainer launches it, on the trainer's own chunk
    with the most segments: an epoch's plans packed as ``fit`` packs them
    (induced subgraphs of the symmetrised graph with self loops, CSRs at
    the edge capacity, K1's schedule at capacity), that chunk's buffer on
    the card, forward and transposed at width ``w``, each bit-equal to the
    exact-count launch on the same CSRs cut to the chunk's edges and within
    the "spmm" rule of the plain version, the rule shown to fail a wrong
    output; CUDA-event times of both launches, the plain version and
    cuSPARSE, beside the bound (x counted by the rows some edge gathers).
    x is of ``dtype`` (the rows' names end in " bf16" at bfloat16). The
    rows are named ``label`` and the lines ``phase``'s; a zoo model's
    trainer packs its own kind of plan (GCN's: self-loops, ``gcn_norm``'s
    values). Returns the JSON rows."""
    from difformer_tpu_torch.kernels import spmm as K1
    from difformer_tpu_torch.kernels.tolerance import assert_close
    from difformer_tpu_torch.train.minibatch import chunk_plan

    batch = trainer.batch_size
    layout = trainer.layouts[batch]
    perm = np.random.default_rng(seed).permutation(trainer.n)
    packed, stats = trainer.pack_epoch(perm)
    full = [host for m, host in packed if m == batch]
    segments = [int(layout.views(h.numpy())["counts"][[1, 3]].sum())
                for h in full]
    c = int(np.argmax(segments))
    buf = full[c].to("cuda")
    plan = chunk_plan(layout, buf)
    views = layout.views(buf)
    g = torch.Generator("cuda").manual_seed(12)
    x = torch.randn((batch, w), device="cuda", generator=g).to(dtype)
    suffix = "" if dtype == torch.float32 else " bf16"
    rows = {}
    for name, prefix, cap in (("csr_spmm", "", plan.split),
                              ("csr_spmm_transposed", "t_", plan.t_split)):
        transposed = name == "csr_spmm_transposed"
        ptr = views[f"{prefix}row_ptr"]
        real = int(ptr[-1])
        col, val = views[f"{prefix}col"][:real], views[f"{prefix}val"][:real]
        split = K1.row_split(ptr)
        bound, bound_by, nbytes = spmm_bound_ms(
            batch, real, w, x_rows=int(torch.unique(col).numel()),
            elem=x.element_size())
        kernel = lambda: K1.csr_spmm(  # noqa: E731
            x, ptr, views[f"{prefix}col"], views[f"{prefix}val"], split=cap,
            transposed=transposed)
        exact_call = lambda: K1.csr_spmm(x, ptr, col, val,  # noqa: E731
                                         split=split, transposed=transposed)
        plain = lambda: K1.csr_spmm_plain(x, ptr, col, val)  # noqa: E731
        try:
            library = library_spmm(ptr, col, val, batch, dtype)
            library(x)
        except RuntimeError as ex:
            library = None
            say(f"phase {phase}: cuSPARSE through torch.sparse.mm "
                f"refused {str(dtype)[6:]}: {str(ex).splitlines()[0][:160]}")
        out, ref = kernel(), plain()
        scale = K1.csr_spmm_abs(x, ptr, col, val)
        tag = (f"{name}{suffix} {label} {c} of the trainer's epoch "
               f"N={batch} E={real} (capacity {layout.edges}) W={w}")
        err = assert_close(tag, out, ref, "spmm", scale=scale)
        assert_rejects(tag, ref, "spmm", scale=scale)
        if not torch.equal(out, exact_call()):
            raise AssertionError(f"{tag}: the capacity launch differs from "
                                 f"the exact-count launch")
        heavy, segs = cap.counts.tolist()
        if (heavy, segs) != (split.num_heavy, split.num_segments):
            raise AssertionError(f"{tag}: packed schedule ({heavy}, {segs}) "
                                 f"!= row_split's ({split.num_heavy}, "
                                 f"{split.num_segments})")
        del out, ref, scale
        # CUDA events over back-to-back calls, the two launches alternated:
        # at this shape the profiler's sessions dropped whole calls' kernels
        # (1.5 of the capacity launch's 2 a call), so its sums undercount
        cap_ms, exact_ms, cap2_ms, exact2_ms = (
            cuda_ms(f) for f in (kernel, exact_call, kernel, exact_call))
        ms = (cap_ms + cap2_ms) / 2
        plain_ms = cuda_ms(plain)
        library_ms = None if library is None else cuda_ms(lambda: library(x))
        lib_ms = "none" if library_ms is None else f"{library_ms:.4f} ms"
        say(f"phase {phase}: K1 {tag} max_abs_err {err:.3e}, "
            f"bit-equal to the exact-count launch | {heavy} heavy rows, "
            f"{segs} segments (capacity {cap.num_heavy}, "
            f"{cap.num_segments}) | CUDA events: capacity launch "
            f"{cap_ms:.4f}, {cap2_ms:.4f} ms, exact-count launch "
            f"{exact_ms:.4f}, {exact2_ms:.4f} ms (alternated) | plain "
            f"{plain_ms:.4f} ms | cuSPARSE {lib_ms} | bound "
            f"{bound:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB)")
        rows[f"{name} {label}{suffix}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=bound_by, library_ms=library_ms)
    say(f"phase {phase}: K1's chunk is the one with the most "
        f"segments of an epoch whose {trainer.n_chunks} chunks hold "
        f"{stats['segments']} segments ({stats['heavy_chunks']} with heavy "
        f"rows); segments of its full-size chunks {segments}")
    del buf, plan, views, x
    torch.cuda.empty_cache()
    return rows


def check_native():
    from difformer_tpu_torch import native

    if not native.available():
        raise AssertionError(f"the native library did not load: "
                             f"{native.load_error}")
    say(f"phase minibatch: native library loaded "
        f"({native.library_path().name})")


def steady_epochs(trainer, epochs=3, seed=7):
    """Host ms per epoch of ``epochs`` epochs as ``fit`` runs them without
    its evals: the next epoch's plans packed by a worker thread while the
    device replays this one's, and the chunk losses read once an epoch."""
    from concurrent.futures import ThreadPoolExecutor

    runner, rng = trainer.runner, np.random.default_rng(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        future = pool.submit(trainer.pack_epoch, rng.permutation(trainer.n), 0)
        for epoch in range(epochs):
            packed, _ = future.result()
            if epoch + 1 < epochs:
                future = pool.submit(trainer.pack_epoch,
                                     rng.permutation(trainer.n),
                                     (epoch + 1) % 2)
            runner.epoch(packed).cpu()
    return 1e3 * (time.perf_counter() - t0) / epochs


def chunk_timings(phase, trainer, seed=99, top=0):
    """The steady state of a trainer after its fit: one epoch of chunk
    plans packed on the host (host ms), then that epoch replayed through
    the run's graphs, and the same chunks as eager steps on exact plans
    (the loop), each on the host clock around synchronised work and under
    the profiler (device ms and operations, the idle share, and with
    ``top`` the replay's longest kernels); last, epochs as ``fit`` runs
    them, with the packing overlapped."""
    from difformer_tpu_torch.train.minibatch import pack_chunk

    runner = trainer.runner
    perm = np.random.default_rng(seed).permutation(trainer.n)
    packed, stats = trainer.pack_epoch(perm)
    chunks = trainer.n_chunks
    # the same plans packed one chunk after another, for the pool's gain
    t0 = time.perf_counter()
    bufs = trainer._host_buffers(1)
    for c, (nodes, sub) in enumerate(trainer._subgraphs(perm)):
        m = nodes.shape[0]
        pack_chunk(trainer.layouts[m], bufs[m][c if m == trainer.batch_size
                                              else 0].numpy(), nodes, sub)
    serial_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exact = [(torch.as_tensor(nodes, device="cuda"),
              trainer._exact_plan(nodes.shape[0], sub)[0])
             for nodes, sub in trainer._subgraphs(perm)]
    exact_s = time.perf_counter() - t0

    def graph_epoch():
        runner.epoch(packed)

    def loop_epoch():
        for nodes, plan in exact:
            trainer.train_step(runner.state, runner.generator, nodes, plan)

    out = {}
    for path, fn in (("graph", graph_epoch), ("loop", loop_epoch)):
        ms = host_ms(fn)
        if path == "graph" and top:
            (dev_ms, ops), rows = profile_window(fn, 1, rows=True)
            for k_ms, count, key in rows[:top]:
                say(f"phase {phase} replay profile: {k_ms / chunks:8.4f} ms "
                    f"per chunk step {100 * k_ms / dev_ms:5.1f}% "
                    f"x{count / chunks:<6g} {key[:90]}")
        else:
            dev_ms, ops = profile_window(fn, 1)
        idle = (f"idle {100 * (1 - dev_ms / ms):.1f}%" if ops > 0 else
                "the profiler saw no device operation (idle not measured)")
        out[path], out[f"{path}_device"] = ms / chunks, dev_ms
        say(f"phase {phase}: {path}: {ms:.3f} ms per epoch of {chunks} "
            f"chunks = {ms / chunks:.3f} ms per chunk step; device "
            f"{dev_ms:.3f} ms over {ops:g} device operations "
            f"({ops / chunks:g} per chunk step), {idle}")
    say(f"phase {phase}: host chunk plans of an epoch: packed at capacity "
        f"{1e3 * stats['host_s']:.1f} ms ({1e3 * stats['host_s'] / chunks:.2f}"
        f" ms per chunk), of which the induced subgraphs (one pass for all "
        f"chunks) {1e3 * stats['subgraph_s']:.1f} ms; {1e3 * serial_s:.1f} "
        f"ms with the chunks packed one after another; exact plans for the "
        f"loop {1e3 * exact_s:.1f} ms")
    out["steady"] = steady_epochs(trainer)
    say(f"phase {phase}: steady epochs as fit runs them (packing "
        f"overlapped, no eval): {out['steady']:.1f} ms per epoch")
    return out


def report_plans(phase, trainer):
    stats = trainer.plan_stats
    say(f"phase {phase}: {trainer.n_chunks} chunks of {trainer.batch_size} "
        f"(last {trainer.last_size}); edge capacity {trainer.edge_capacity}, "
        f"split capacity {trainer.layouts[trainer.batch_size].capacity}; per "
        f"epoch: host seconds of the chunk plans "
        f"{[round(s['host_s'], 3) for s in stats]}, chunks with heavy rows "
        f"{[s['heavy_chunks'] for s in stats]}, segments "
        f"{[s['segments'] for s in stats]}, most edges in a chunk "
        f"{[s['max_edges'] for s in stats]}")


def check_minibatch_result(phase, trainer, best, plain_chunk=None):
    """Finite losses that fall from the first epoch to the last (at the
    presets' lr the first steps overshoot, and 3 epochs do not reach the
    data's accuracy), finite metrics, and the full graph's logits through
    the kernels against the same weights through the plain versions (the
    plain K1 in chunks of edges, as the eval asks, or of ``plain_chunk``
    edges where it asks for none)."""
    losses = best["losses"]
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite or not falling: {losses}")
    if not all(math.isfinite(best[k]) for k in ("train", "valid", "test")):
        raise AssertionError(f"non-finite metrics: {best}")
    state = trainer.runner.state
    logits = trainer.forward_full(state)
    with through_plain_versions(plain_chunk):
        ref = trainer.forward_full(state)
    if logits.shape != ref.shape or logits.shape[0] != trainer.n:
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    torch.testing.assert_close(logits, ref, rtol=1e-3, atol=1e-4)
    say(f"phase {phase}: full-graph logits {tuple(logits.shape)} kernel vs "
        f"plain max_abs_err {(logits - ref).abs().max().item():.3e}")
    del logits, ref
    torch.cuda.empty_cache()


def check_minibatch_launches(phase, trainer, counted, layers, epochs,
                             recomputed=0):
    """K1 counted in both directions and no attention kernel; K1's device
    launches by the replays (captured x replays) equal to one a layer in
    each direction for every chunk step of the fit, and ``recomputed``
    more forward ones a step (remat re-running a layer's K1 in the
    backward). Returns the path's launches: the wrappers' counts (warm-up,
    capture and the eager evals) plus the replays'."""
    replayed = trainer.runner.launches()
    expect = layers * trainer.n_chunks * epochs
    extra = {"csr_spmm": recomputed * trainer.n_chunks * epochs}
    say(f"phase {phase}: launches counted by the wrappers {counted} "
        f"(warm-up, capture and the eager evals); replayed on the device "
        f"{replayed} (expected {expect} for each K1 direction: {layers} "
        f"layers x {trainer.n_chunks} chunks x {epochs} epochs, plus "
        f"{extra} recomputed by remat); graphs "
        f"{ {k: (v['captured']['csr_spmm'], v['replays']) for k, v in trainer.runner.graphs.items()} }"
        f" (K1 forward captured, replays)")
    off = {k: v for k, v in counted.items() if (v > 0) != (k in K1_PATH)}
    if off:
        raise AssertionError(f"kernels launched against the path "
                             f"{K1_PATH}: {off}")
    wrong = {k: v for k, v in replayed.items()
             if v != (expect + extra.get(k, 0) if k in K1_PATH else 0)}
    if wrong:
        raise AssertionError(f"replayed launches {wrong} differ from the "
                             f"path's ({expect} for each of {K1_PATH}, "
                             f"plus {extra})")
    return {k: counted[k] + replayed[k] for k in counted}


def minibatch_cli(phase, argv, record_evals=False):
    """``cli.main(argv)`` on a mini-batch route, its ``MiniBatchTrainer``
    timed on the host (load and preprocess, the trainer, fit), the launch
    counts set to 0 just before and read just after (K1-dval's under
    ``DVAL_NAME``); prints the run's result, peak memory and host seconds.
    Returns (trainer, best run, its split, launches, the model's buffers at
    each of fit's evals, recorded when ``record_evals``)."""
    from difformer_tpu_torch import cli
    from difformer_tpu_torch.train import minibatch as M

    times, made, evals = {"fit_s": 0.0}, [], []
    real_init, real_fit = M.MiniBatchTrainer.__init__, M.MiniBatchTrainer.fit
    real_eval = M.MiniBatchTrainer.evaluate
    start = [0.0]

    def timed_init(self, *args, **kw):
        times["prep_s"] = time.perf_counter() - start[0]
        t = time.perf_counter()
        real_init(self, *args, **kw)
        torch.cuda.synchronize()
        times["init_s"] = time.perf_counter() - t
        made.append(self)

    def timed_fit(self, split_idx, **kw):
        times["split"] = split_idx
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real_fit(self, split_idx, **kw)
        torch.cuda.synchronize()
        times["fit_s"] += time.perf_counter() - t
        return res

    def recorded_eval(self, state, split_idx):
        evals.append({k: v.detach().cpu().clone()
                      for k, v in state.model.named_buffers()})
        return real_eval(self, state, split_idx)

    stack = contextlib.ExitStack()
    stack.enter_context(unittest.mock.patch.object(
        M.MiniBatchTrainer, "__init__", timed_init))
    stack.enter_context(unittest.mock.patch.object(
        M.MiniBatchTrainer, "fit", timed_fit))
    if record_evals:
        stack.enter_context(unittest.mock.patch.object(
            M.MiniBatchTrainer, "evaluate", recorded_eval))
    torch.cuda.reset_peak_memory_stats()
    with stack:
        reset_launch_counts()
        start[0] = time.perf_counter()
        res = cli.main(argv)
        torch.cuda.synchronize()
        launches = launch_counts()
        launches[DVAL_NAME] = dval_count()
    peak = torch.cuda.max_memory_allocated() / 2**30
    trainer, best = made[0], res[0]
    epochs = len(best["losses"])
    say(f"phase {phase}: {' '.join(argv)} -> best epoch {best['epoch']} "
        f"train {best['train']:.4f} valid {best['valid']:.4f} test "
        f"{best['test']:.4f}; losses {best['losses']}; peak memory "
        f"{peak:.2f} GiB")
    say(f"phase {phase}: host seconds: load and preprocess "
        f"{times['prep_s']:.3f} s, the trainer (edge capacity, features and "
        f"the full graph's plan on the card) {times['init_s']:.3f} s, fit "
        f"{times['fit_s']:.3f} s for {epochs} epochs = "
        f"{1e3 * times['fit_s'] / epochs:.1f} ms per epoch (2 evals and the "
        f"captures included); cut from 500 epochs and 5 runs")
    return trainer, best, times["split"], launches, evals


def check_loop_epoch(phase, trainer, split, best):
    """The first epoch again through the per-chunk loop (``use_scan=False``,
    exact plans, eager steps): its chunk losses bit-equal to the graphs'."""
    trainer.use_scan = False
    t = time.perf_counter()
    loop = trainer.fit(split, epochs=1, eval_step=9)[0]
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t
    trainer.use_scan = True
    same = loop["chunk_losses"][0] == best["chunk_losses"][0]
    say(f"phase {phase}: first epoch through the loop in {loop_s:.3f} s (an "
        f"eval included): chunk losses bit-equal to the graphs': {same}")
    if not same:
        raise AssertionError(f"loop {loop['chunk_losses'][0]} != graphs "
                             f"{best['chunk_losses'][0]}")


def phase_minibatch_pokec(tmp):
    """The pokec preset through the command line (DIFFormer-s, hidden 128,
    3 layers, batch 100000, lr 0.01, a random 50/25/25 split) on a stand-in
    ``pokec.mat`` of Pokec's size, cut to 3 epochs and 1 run; the first
    epoch again through the loop (``use_scan=False``), whose chunk losses
    must equal the graphs' bit for bit; K1's capacity launch on the
    trainer's chunk (:func:`phase_spmm_chunk`); the steady state of both
    paths. Returns the path's launches and K1's JSON rows."""
    from difformer_tpu_torch.utils.config import make_config

    check_native()
    t0 = time.perf_counter()
    x, ei, y = pokec_standin()
    write_pokec_mat(tmp, x, ei, y)
    del x, ei, y
    say(f"phase minibatch-pokec: stand-in written in "
        f"{time.perf_counter() - t0:.1f} s: N={POKEC_NODES} "
        f"E={POKEC_EDGES} directed (power-law) F={POKEC_FEATURES} "
        f"C={POKEC_CLASSES}")
    argv = ["--dataset", "pokec", "--data_dir", tmp] + POKEC_CUT
    trainer, best, split, launches, _ = minibatch_cli("minibatch-pokec", argv)
    if launches.pop(DVAL_NAME):
        raise AssertionError("phase minibatch-pokec: DIFFormer's chunk steps "
                             "launched K1-dval; its values take no gradient")
    epochs = len(best["losses"])
    report_plans("minibatch-pokec", trainer)
    cfg = make_config("pokec")
    launches = check_minibatch_launches("minibatch-pokec", trainer, launches,
                                        cfg.num_layers, epochs)
    check_minibatch_result("minibatch-pokec", trainer, best)
    # the width the preset's model gives K1: hidden 128, one head
    rows = phase_spmm_chunk(trainer, cfg.hidden_channels * cfg.num_heads)

    check_loop_epoch("minibatch-pokec", trainer, split, best)
    chunk_timings("minibatch-pokec", trainer, top=GRAPH_TOP)
    return launches, rows, trainer, split


# ---------------------------------------------------------------------------
# minibatch-zoo: the baseline zoo's GCN and GAT through MiniBatchTrainer at
# the pokec preset, K1 on GCN's chunk plan and K1-dval on GAT's
# ---------------------------------------------------------------------------

# the pokec preset's 500 epochs x 5 runs cut to 2 epochs of 1 run: the
# evals at epochs 0 and 1
ZOO_POKEC_CUT = ["--epochs", "2", "--runs", "1"]
# edges at a time of the plain K1 in the full-graph check: the zoo's eval
# streams no edges, and Pokec's [E, 128] messages would not fit at once
ZOO_PLAIN_CHUNK = 2 * 1024 * 1024


def zoo_step_launches(model):
    """(K1's forward and transposed launches, K1-dval's) in one train step
    of a zoo model: a GCN layer one K1 each way; a GAT layer of H heads
    4 + H each way (the two score gathers, the softmax sum and its
    gather, a product a head) and one K1-dval."""
    from difformer_tpu_torch.nn.gnns import GATLayer, GCNLayer

    heads = [m.heads for m in model.modules() if isinstance(m, GATLayer)]
    k1 = sum(isinstance(m, GCNLayer) for m in model.modules()) + sum(
        4 + h for h in heads)
    return {"csr_spmm": k1, "csr_spmm_transposed": k1}, len(heads)


def check_zoo_replays(phase, method, trainer, epochs):
    """Each chunk graph's captured launches equal a train step's
    (:func:`zoo_step_launches`), no other kernel captured, and the replays
    one a chunk step: K1's and K1-dval's device launches are the step's
    times the chunk steps. Returns the replayed launches (K1-dval's under
    ``DVAL_NAME``)."""
    per_step, dval = zoo_step_launches(trainer.model)
    graphs = trainer.runner.graphs
    steps = trainer.n_chunks * epochs
    replays = sum(g["replays"] for g in graphs.values())
    replayed = trainer.runner.launches()
    replayed[DVAL_NAME] = sum(g["captured_dval"] * g["replays"]
                              for g in graphs.values())
    say(f"phase {phase}: --method {method}: a chunk step captures "
        f"{ {k: (g['captured']['csr_spmm'], g['captured']['csr_spmm_transposed'], g['captured_dval'], g['replays']) for k, g in graphs.items()} }"
        f" (K1 forward, transposed, K1-dval, replays); the model's layers "
        f"give {per_step} and {dval} K1-dval a step; replayed on the device "
        f"{ {k: v for k, v in replayed.items() if v} } over {steps} chunk "
        f"steps")
    for name, g in graphs.items():
        want = {k: per_step.get(k, 0) for k in g["captured"]}
        if g["captured"] != want or g["captured_dval"] != dval:
            raise AssertionError(
                f"phase {phase}: --method {method}'s {name} graph captured "
                f"{g['captured']} and {g['captured_dval']} K1-dval, the "
                f"model's layers give {per_step} and {dval}")
    wrong = {k: v for k, v in replayed.items()
             if v != steps * (dval if k == DVAL_NAME else per_step.get(k, 0))}
    if replays != steps or wrong:
        raise AssertionError(f"phase {phase}: --method {method}: {replays} "
                             f"replays for {steps} chunk steps, replayed "
                             f"launches off the step's count: {wrong}")
    return replayed


def zoo_dval_chunk(trainer, seed=7):
    """K1-dval as GAT's chunk step launches it: GAT's plan of the trainer's
    chunk with the most edges, packed at capacity as ``fit`` packs it
    (K1-dval's schedule at capacity with its counts read on the device),
    at the hidden layer's shape (H = 2 heads of the preset's 128), against
    the plain version on the chunk's real edges (the "spmm" rule, shown to
    fail a wrong output) and bit-equal to the exact-count launch on the
    exact plan; CUDA-event times of both launches (alternated), the plain
    version and ``sampled_addmm`` (a call a head), beside the bound on the
    real edges. Returns the JSON row."""
    from difformer_tpu_torch.kernels import spmm as K1
    from difformer_tpu_torch.kernels.tolerance import assert_close
    from difformer_tpu_torch.train.minibatch import chunk_plan

    batch = trainer.batch_size
    layout = trainer.layouts[batch]
    perm = np.random.default_rng(seed).permutation(trainer.n)
    packed, _ = trainer.pack_epoch(perm)
    chunks = trainer._subgraphs(perm)
    c = int(np.argmax([sub.shape[1] if nodes.shape[0] == batch else -1
                       for nodes, sub in chunks]))
    buf = packed[c][1].to("cuda")
    plan = chunk_plan(layout, buf).plan
    exact = trainer._exact_plan(batch, chunks[c][1])[0].plan
    e = exact.num_edges
    heads = trainer.model.conv_0.heads
    d = trainer.model.conv_0.out_channels
    g, x = dval_inputs(batch, heads, d, 300)
    kernel = lambda: K1.csr_spmm_dval(  # noqa: E731
        g, x, plan.rows, plan.col, row_ptr=plan.row_ptr,
        split=plan.dval_split)
    exact_call = lambda: K1.csr_spmm_dval(  # noqa: E731
        g, x, exact.rows, exact.col, row_ptr=exact.row_ptr,
        split=exact.dval_split)
    plain = lambda: K1.csr_spmm_dval_plain(  # noqa: E731
        g, x, exact.rows, exact.col)
    out, ref = kernel()[:e], plain()
    scale = K1.csr_spmm_dval_abs(g, x, exact.rows, exact.col)
    split = exact.dval_split
    segs = plan.dval_split.counts.tolist()
    tag = (f"{DVAL_NAME} pokec gat chunk {c} of the trainer's epoch N={batch} "
           f"E={e} (capacity {layout.edges}) H={heads} D={d}")
    err = assert_close(tag, out, ref, "spmm", scale=scale)
    assert_rejects(tag, ref, "spmm", scale=scale)
    if not torch.equal(out, exact_call()):
        raise AssertionError(f"{tag}: the capacity launch differs from the "
                             f"exact-count launch")
    if segs[1] != split.num_segments:
        raise AssertionError(f"{tag}: packed segments {segs[1]} != "
                             f"row_split's {split.num_segments}")
    library = library_dval(exact, g, x)
    del out, ref, scale
    cap_ms, exact_ms, cap2_ms, exact2_ms = (
        cuda_ms(f) for f in (kernel, exact_call, kernel, exact_call))
    ms = (cap_ms + cap2_ms) / 2
    plain_ms = cuda_ms(plain)
    library_ms = cuda_ms(library)
    bound, bound_by, nbytes = dval_bound_ms(batch, e, heads, d)
    say(f"phase minibatch-zoo: K1-dval {tag} max_abs_err {err:.3e}, "
        f"bit-equal to the exact-count launch | {split.num_heavy} heavy "
        f"rows in {split.num_segments} segments (T={split.threshold}; "
        f"capacity {plan.dval_split.num_heavy}, "
        f"{plan.dval_split.num_segments}) | CUDA events: capacity launch "
        f"{cap_ms:.4f}, {cap2_ms:.4f} ms, exact-count launch "
        f"{exact_ms:.4f}, {exact2_ms:.4f} ms (alternated) | plain "
        f"{plain_ms:.4f} ms | sampled_addmm, {heads} calls "
        f"{library_ms:.4f} ms | bound {bound:.4f} ms by {bound_by} "
        f"({nbytes / 1e6:.2f} MB)")
    del buf, plan, exact, g, x, library
    torch.cuda.empty_cache()
    return {f"{DVAL_NAME} pokec gat chunk": dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=bound_by, library_ms=library_ms)}


def zoo_minibatch_run(tmp, method):
    """``--dataset pokec --method <method>`` through the command line on
    the stand-in of phase minibatch-pokec, cut to ``ZOO_POKEC_CUT``: the
    test metric finite in [0, 1], the kernels of :func:`zoo_expected` and
    no other, the chunk graphs' launches (:func:`check_zoo_replays`), the
    full graph's logits against the plain versions, the best state's
    BatchNorm statistics those of its epoch's eval, and the first epoch
    again through the loop, bit-equal to the graphs'; host seconds, peak
    memory and the steady state (:func:`chunk_timings`). Returns (the
    trainer, its launches: the wrappers' counts plus the replays')."""
    phase = "minibatch-zoo"
    argv = (["--dataset", "pokec", "--data_dir", tmp, "--method", method]
            + ZOO_POKEC_CUT)
    trainer, best, split, counted, evals = minibatch_cli(
        phase, argv, record_evals=True)
    epochs = len(best["losses"])
    if not (math.isfinite(best["test"]) and 0.0 <= best["test"] <= 1.0):
        raise AssertionError(f"phase {phase}: --method {method}: test "
                             f"metric {best['test']}")
    report_plans(phase, trainer)
    replayed = check_zoo_replays(phase, method, trainer, epochs)
    launched = {k: v + replayed.get(k, 0) for k, v in counted.items()}
    expect = zoo_expected(method)
    off = {k: v for k, v in launched.items()
           if (v > 0) != bool(expect.get(k, False))}
    if off:
        raise AssertionError(f"phase {phase}: --method {method} launched "
                             f"{off} against {expect}")
    check_minibatch_result(phase, trainer, best, plain_chunk=ZOO_PLAIN_CHUNK)
    # the best state holds the statistics of its epoch's eval
    eval_epochs = [e for e in range(epochs) if e % 9 == 0 or e == epochs - 1]
    want = evals[eval_epochs.index(best["epoch"])]
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    if not stats or any(not torch.equal(best["params"][k], want[k])
                        for k in stats):
        raise AssertionError(f"phase {phase}: --method {method}'s best "
                             f"state does not hold the BatchNorm statistics "
                             f"of epoch {best['epoch']} ({stats})")
    say(f"phase {phase}: --method {method}: the best state (epoch "
        f"{best['epoch']}) holds that epoch's {len(stats)} BatchNorm "
        f"statistics")
    check_loop_epoch(phase, trainer, split, best)
    steady = chunk_timings(phase, trainer)
    say(f"phase {phase}: --method {method}: the steady epoch's idle share "
        f"{100 * (1 - steady['graph_device'] / steady['steady']):.1f}% "
        f"(the replayed epoch's device {steady['graph_device']:.3f} ms of "
        f"the steady epoch's {steady['steady']:.1f} ms)")
    return trainer, launched


def phase_minibatch_zoo(tmp):
    """The baseline zoo in node chunks: ``--dataset pokec --method gcn``
    (hidden 128, 3 layers, BatchNorm) and ``--method gat`` (2 heads of
    128, BatchNorm) through the command line on the stand-in ``pokec.mat``
    that phase minibatch-pokec wrote in ``tmp``, the preset unchanged but
    cut to 2 epochs and 1 run (:func:`zoo_minibatch_run`); K1's capacity
    launch on GCN's self-looped chunk plan (:func:`phase_spmm_chunk`, W =
    128) and K1-dval's on GAT's (:func:`zoo_dval_chunk`). Returns
    ({method: launches}, JSON rows)."""
    from difformer_tpu_torch.utils.config import make_config

    cfg = make_config("pokec")
    launches, rows = {}, {}
    for method in ("gcn", "gat"):
        trainer, launches[method] = zoo_minibatch_run(tmp, method)
        if method == "gcn":
            rows.update(phase_spmm_chunk(trainer, cfg.hidden_channels,
                                         phase="minibatch-zoo",
                                         label="pokec gcn chunk"))
        else:
            rows.update(zoo_dval_chunk(trainer))
        trainer.runner = None
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return launches, rows


def phase_minibatch_remat(base, split):
    """The pokec preset's trainer (on the stand-in the minibatch-pokec
    phase loaded, ``base`` its trainer, ``split`` its run's split) with the
    model at ``compute_dtype="bfloat16"``, one epoch with ``remat=True``,
    then one with ``remat=False``: each chunk step a CUDA-graph replay;
    K1's replays held to the remat-aware count; K1's bf16 capacity launch
    on the remat trainer's chunk with the most segments
    (:func:`phase_spmm_chunk`); peak memory of each fit and the steady ms
    per chunk step of each; the chunk losses with and without remat
    compared. Returns the remat run's launches and K1's bf16 chunk rows."""
    from difformer_tpu_torch.train.minibatch import MiniBatchTrainer
    from difformer_tpu_torch.utils.config import make_config

    phase = "minibatch-pokec-remat"
    cfg = make_config("pokec")
    x = base.x_dev.cpu().numpy()
    ei = np.stack([base.senders, base.receivers])
    y = base.labels_eval
    classes = int(y.max()) + 1
    recomputed = remat_recomputed(cfg, x.shape[1])
    runs, launches, rows = {}, None, {}
    for remat in (True, False):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        trainer = MiniBatchTrainer(
            preset_model(cfg, x.shape[1], classes, compute_dtype="bfloat16",
                         remat=remat), x, ei, y, batch_size=cfg.batch_size,
            lr=cfg.lr, weight_decay=cfg.weight_decay, loss="nll",
            metric=cfg.metric, seed=cfg.seed, device="cuda")
        reset_launch_counts()
        t0 = time.perf_counter()
        best = trainer.fit(split, epochs=1, eval_step=cfg.eval_step)[0]
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counted = launch_counts()
        peak = (torch.cuda.max_memory_allocated() - held) / 2**20
        if not all(math.isfinite(v) for v in best["chunk_losses"][0]):
            raise AssertionError(f"non-finite chunk losses: {best}")
        tag = f"{phase} remat={remat}"
        run_launches = check_minibatch_launches(
            tag, trainer, counted, cfg.num_layers, 1,
            recomputed=recomputed if remat else 0)
        perm = np.random.default_rng(17).permutation(trainer.n)
        packed, _ = trainer.pack_epoch(perm)
        step_ms = host_ms(lambda: trainer.runner.epoch(packed)) / len(packed)
        # one eager step on a full chunk: its peak is the activations the
        # backward keeps, which remat trades for recomputation (the fit's
        # peak is the full graph's eval)
        nodes, sub = trainer._subgraphs(perm)[0]
        plan = trainer._exact_plan(nodes.shape[0], sub)[0]
        nodes = torch.as_tensor(nodes, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        trainer.train_step(trainer.runner.state, trainer.runner.generator,
                           nodes, plan)
        torch.cuda.synchronize()
        step_peak = (torch.cuda.max_memory_allocated() - before) / 2**20
        say(f"phase {tag}: bf16, fit of 1 epoch in {fit_s:.3f} s (an eval "
            f"and the captures included); peak memory {peak:.1f} MiB "
            f"allocated above the {held / 2**20:.1f} MiB held before; an "
            f"eager chunk step's peak {step_peak:.1f} MiB above what it "
            f"found; steady {step_ms:.3f} ms per chunk step (host clock, "
            f"{len(packed)} chunks replayed); best valid {best['valid']:.4f}")
        runs[remat] = dict(losses=best["chunk_losses"][0], peak=peak,
                           step_peak=step_peak, step_ms=step_ms)
        del plan, nodes
        if remat:
            launches = run_launches
            rows = phase_spmm_chunk(trainer,
                                    cfg.hidden_channels * cfg.num_heads,
                                    dtype=torch.bfloat16)
        del trainer
    a, b = (np.asarray(runs[k]["losses"], np.float64) for k in (True, False))
    say(f"phase {phase}: chunk losses with and without remat bit-equal: "
        f"{bool(np.array_equal(a, b))} (largest difference "
        f"{np.abs(a - b).max():.3e}); peak memory of the fit "
        f"{runs[True]['peak']:.1f} MiB with remat against "
        f"{runs[False]['peak']:.1f} MiB without, of an eager chunk step "
        f"{runs[True]['step_peak']:.1f} against "
        f"{runs[False]['step_peak']:.1f} MiB; "
        f"{runs[True]['step_ms']:.3f} against {runs[False]['step_ms']:.3f} "
        f"ms per chunk step; remat re-runs {recomputed} forward K1 a step "
        f"at this preset ("
        f"{'spmm_first' if recomputed else 'the plain graph branch'})")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rows


# ---------------------------------------------------------------------------
# temporal-chickenpox and temporal-wikimath: the temporal presets through the
# command line on stand-in JSON files of the published shapes
# ---------------------------------------------------------------------------

TEMPORAL_EPOCHS = 3  # of the presets' 500 epochs x 1 run


def temporal_k1_per_pass(model):
    """(K1 forward launches of one forward, K1 transposed launches of one
    train step's backward) of a temporal model: DIFFormer one of each a
    layer; MPNN-LSTM one of each per GCN layer (2); DCRNN 2·(K−1) products
    per DConv, three DConvs, and a backward only through the candidate
    state's DConv, whose input [x ‖ h·r] carries a gradient (the gates'
    [x ‖ h] with h = 0 carries none)."""
    from difformer_tpu_torch.nn.temporal import DCRNN, MPNNLSTM

    if isinstance(model, DCRNN):
        hops = 2 * (model.conv_x_h.K - 1)
        return 3 * hops, hops
    if isinstance(model, MPNNLSTM):
        return 2, 2
    graph = bool(model.convs) and model.convs[0].use_graph
    return (model.num_layers,) * 2 if graph else (0, 0)


def graph_kernel_nodes(runner):
    """Kernel nodes of each captured graph of a ``SnapshotRunner``."""
    return {name: graph_node_kinds(g).count(CUDA_GRAPH_NODE_KERNEL)
            for name, g in runner.cuda_graphs.items()}


def phase_temporal(phase, tmp, argv):
    """A temporal preset through the command line (``argv``, cut to
    ``TEMPORAL_EPOCHS`` epochs) on the stand-in files in ``tmp``: every
    epoch's steps and evals replayed as CUDA graphs; K1's replays equal to
    the model's launches per pass times the snapshots of the fit; the same
    fit again through the per-snapshot loop, whose train and validation
    costs and test cost must equal the graphs' bit for bit; ms per epoch
    of both, the capture's seconds and the graphs' kernel nodes."""
    from difformer_tpu_torch import cli
    from difformer_tpu_torch.train import temporal as T

    made = []
    real_init, real_fit = T.TemporalTrainer.__init__, T.TemporalTrainer.fit

    def recording_init(self, *args, **kw):
        real_init(self, *args, **kw)
        made.append(self)

    def recording_fit(self, train, val, test, **kw):
        self.recorded = (train, val, test, kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_fit(self, train, val, test, **kw)
        torch.cuda.synchronize()
        self.fit_s = time.perf_counter() - t0
        self.result = res
        return res

    argv = argv + ["--data_dir", tmp, "--epochs", str(TEMPORAL_EPOCHS),
                   "--runs", "1"]
    with unittest.mock.patch.object(T.TemporalTrainer, "__init__",
                                    recording_init), \
            unittest.mock.patch.object(T.TemporalTrainer, "fit",
                                       recording_fit):
        reset_launch_counts()
        t0 = time.perf_counter()
        costs = cli.main(argv)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        counted = launch_counts()
        check_no_dval(phase, " ".join(argv))
    trainer = made[0]
    res, runner = trainer.result, trainer.runner
    train, val, test, fit_kw = trainer.recorded
    epochs = len(res["losses"])
    say(f"phase {phase}: {' '.join(argv)} -> test cost {costs.tolist()}; "
        f"{type(trainer.model).__name__}, {trainer.mode} mode, "
        f"{len(train)}/{len(val)}/{len(test)} snapshots of "
        f"{train[0].node_feat.shape[0]} nodes and "
        f"{train[0].edge_index.shape[1]} edges, {len(runner.data.plans)} "
        f"plan(s); losses {res['losses']}")
    if not (np.all(np.isfinite(res["losses"])) and np.isfinite(costs).all()):
        raise AssertionError(f"non-finite costs: {res}")
    fwd, bwd = temporal_k1_per_pass(trainer.model)
    n_tr, n_va, n_te = len(train), len(val), len(test)
    expect = {"csr_spmm": epochs * (n_tr + n_va) * fwd + n_te * fwd,
              "csr_spmm_transposed": epochs * n_tr * bwd}
    replayed = runner.launches()
    nodes = graph_kernel_nodes(runner)
    say(f"phase {phase}: graphs {sorted(runner.graphs)} captured in "
        f"{runner.capture_s:.3f} s (warm-up included), kernel nodes "
        f"{nodes}; K1 replayed {replayed} (expected {expect}: "
        f"{fwd} forward and {bwd} backward a snapshot: "
        f"{expect['csr_spmm'] / epochs:.1f} forward launches per epoch, the "
        f"test eval included); the wrappers counted {counted} (warm-up and "
        f"capture)")
    if {k: replayed[k] for k in expect} != expect or any(
            v for k, v in replayed.items() if k not in expect):
        raise AssertionError(f"K1 replays {replayed} != {expect}")

    graph_epoch_ms = 1e3 * trainer.fit_s / epochs
    steady = host_ms(lambda: (runner.train_epoch(0, n_tr).item(),
                              runner.evaluate(n_tr, n_tr + n_va).item()))
    trainer.use_scan = False
    t0 = time.perf_counter()
    loop = trainer.fit(train, val, test, **fit_kw)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    trainer.use_scan = True
    same = (loop["losses"] == res["losses"]
            and loop["val_costs"] == res["val_costs"]
            and loop["test"] == res["test"])
    say(f"phase {phase}: graphs {graph_epoch_ms:.3f} ms per epoch over "
        f"the fit (capture included), steady {steady:.3f} ms per epoch "
        f"(train and validation); loop {1e3 * loop_s / epochs:.3f} ms per "
        f"epoch over the fit; the loop's costs bit-equal to the graphs': "
        f"{same}; whole command {total_s:.3f} s (cut from 500 epochs)")
    if not same:
        raise AssertionError(f"loop {loop['losses']} {loop['val_costs']} "
                             f"{loop['test']} != graphs {res['losses']} "
                             f"{res['val_costs']} {res['test']}")
    del made, trainer, runner
    gc.collect()


def phase_temporal_all(tmp):
    """The chickenpox preset (DIFFormer, cumulative; then MPNN-LSTM) and
    the wikimath preset (DIFFormer, incremental; then DCRNN with K = 3) on
    stand-in files of their published shapes."""
    write_chickenpox_json(tmp)
    write_wikimath_json(tmp)
    phase_temporal("temporal-chickenpox", tmp, ["--dataset", "chickenpox"])
    phase_temporal("temporal-chickenpox", tmp, ["--dataset", "chickenpox",
                                                "--method", "mpnn_lstm"])
    phase_temporal("temporal-wikimath", tmp, ["--dataset", "wikimath"])
    phase_temporal("temporal-wikimath", tmp, ["--dataset", "wikimath",
                                              "--method", "dcrnn",
                                              "--dcrnn_filters", "3"])


def phase_minibatch_proteins():
    """MiniBatchTrainer called directly at ogbn-proteins' shape with the
    preset's model (DIFFormer-s, hidden 64, 3 layers, batch 10000, lr
    0.01, BCE and multi-task ROC-AUC), on a random 50/25/25 split, for 3
    epochs of 1 run; the steady state of both paths, per chunk step."""
    from difformer_tpu_torch.cli import parse_method
    from difformer_tpu_torch.data import rand_train_test_idx
    from difformer_tpu_torch.train.minibatch import MiniBatchTrainer
    from difformer_tpu_torch.utils.config import make_config

    cfg = make_config("ogbn-proteins")
    t0 = time.perf_counter()
    x, ei, y = proteins_standin()
    gen_s = time.perf_counter() - t0
    split = rand_train_test_idx(y, cfg.train_prop, cfg.valid_prop, rng=0)
    model = parse_method(cfg, PROTEINS_NODES, PROTEINS_TASKS,
                         PROTEINS_FEATURES, device="cuda")
    t0 = time.perf_counter()
    trainer = MiniBatchTrainer(
        model, x, ei, y, batch_size=cfg.batch_size, lr=cfg.lr,
        weight_decay=cfg.weight_decay, loss="bce", metric=cfg.metric,
        seed=cfg.seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    say(f"phase minibatch-proteins: N={PROTEINS_NODES} E={ei.shape[1]} "
        f"({2 * PROTEINS_UNDIRECTED} directed + self loops) "
        f"F={PROTEINS_FEATURES} tasks={PROTEINS_TASKS} hidden "
        f"{cfg.hidden_channels} layers {cfg.num_layers} batch "
        f"{cfg.batch_size}; stand-in drawn in {gen_s:.1f} s; the trainer "
        f"{init_s:.3f} s")
    del x, ei
    reset_launch_counts()
    t0 = time.perf_counter()
    best = trainer.fit(split, epochs=PROTEINS_EPOCHS, eval_step=cfg.eval_step)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = launch_counts()
    best = best[0]
    say(f"phase minibatch-proteins: fit {PROTEINS_EPOCHS} epochs in "
        f"{fit_s:.3f} s = {1e3 * fit_s / PROTEINS_EPOCHS:.1f} ms per epoch "
        f"(2 evals and the captures included; cut from "
        f"{cfg.epochs} epochs and {cfg.runs} runs); best epoch "
        f"{best['epoch']} ROC-AUC train {best['train']:.4f} valid "
        f"{best['valid']:.4f} test {best['test']:.4f}; losses "
        f"{best['losses']}")
    report_plans("minibatch-proteins", trainer)
    check_minibatch_launches("minibatch-proteins", trainer, launches,
                             cfg.num_layers, PROTEINS_EPOCHS)
    check_minibatch_result("minibatch-proteins", trainer, best)
    chunk_timings("minibatch-proteins", trainer)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()


# the graph-level (particle) track: ActsTrack's shapes (difformer_tpu/data/
# particle.py:build_actstrack) and the actstrack preset (run.sh:2-6)
ACTSTRACK_GRAPHS = 4096     # the graph-level phases' stand-in
ACTSTRACK_CLI_GRAPHS = 3000  # the cli-actstrack phase's processed cache
ACTSTRACK_BATCH = 1024      # actstrack's run.sh batch
ACTSTRACK_NODES = 100       # nodes a graph, ±20 %
ACTSTRACK_OTHER = 9         # other_features; then the 3 of pos
ACTSTRACK_K = 5             # kNN with self loops on the positions
ACTSTRACK_SIGNAL = 10       # hits of a signal graph with shifted features
GRAPH_LEVEL_EPOCHS = 3
PLAN_RTOL, PLAN_ATOL = 1e-4, 1e-5  # the three conv plans against each other


def actstrack_standin(num_graphs, seed=13):
    """Graphs of ActsTrack's processed shapes: 100 ± 20 hits, features the
    9 ``other_features`` then the 3 of ``pos`` (``particle.py:194-199,
    221``), pos on the unit sphere, kNN with k = 5 and self loops on pos;
    label 1 for half of them, whose first 10 hits have their other
    features raised by 1 (a signal the model can learn)."""
    from difformer_tpu_torch.data.transforms import knn_graph

    rng = np.random.default_rng(seed)
    spread = ACTSTRACK_NODES // 5
    graphs = []
    for _ in range(num_graphs):
        n = ACTSTRACK_NODES + int(rng.integers(-spread, spread + 1))
        y = float(rng.integers(0, 2))
        pos = rng.normal(size=(n, 3))
        pos = (pos / np.linalg.norm(pos, axis=1, keepdims=True)).astype(
            np.float32)
        other = rng.normal(size=(n, ACTSTRACK_OTHER)).astype(np.float32)
        if y:
            other[:ACTSTRACK_SIGNAL] += 1.0
        x = np.concatenate([other, pos], axis=1)
        graphs.append((x, knn_graph(pos, k=ACTSTRACK_K, include_self=True),
                       y))
    return graphs


def write_actstrack_cache(root, graphs, seed=42):
    """The processed cache that ``build_actstrack`` reads
    (``<root>/actstrack/processed/actstrack_2T_processed.npz``), written
    with the port's ``GraphListDataset.save_cache``, with the split
    ``build_actstrack`` draws (70/15/15 from ``seed``, the preset's)."""
    from difformer_tpu_torch.data.particle import GraphListDataset
    from difformer_tpu_torch.data.splits import get_random_idx_split

    ds = GraphListDataset("actstrack")
    ds.graphs = list(graphs)
    ds.extras = [{} for _ in graphs]
    ds.idx_split = get_random_idx_split(len(graphs), 0.7, 0.15, rng=seed)
    path = os.path.join(root, "actstrack", "processed",
                        "actstrack_2T_processed.npz")
    ds.save_cache(path)
    return path


def graph_level_trainer(graphs, kernel, use_graphs=True,
                        batch=ACTSTRACK_BATCH, dropout=None):
    """The actstrack preset's model (DIFFormer-v2, hidden 64, 2 layers,
    dropout 0.4 unless ``dropout`` is given, mean pooling) and
    ``GraphLevelTrainer`` (lr 1.5e-3, wd 1e-3, ROC-AUC) over ``graphs`` on
    the card, at ``batch`` graphs a batch."""
    from difformer_tpu_torch.nn.difformer_v2 import (
        DIFFormerV2,
        GraphLevelModel,
    )
    from difformer_tpu_torch.train.graph_level import GraphLevelTrainer
    from difformer_tpu_torch.utils.config import make_config

    cfg = make_config("actstrack", kernel=kernel)
    if dropout is not None:
        cfg = make_config("actstrack", kernel=kernel, dropout=dropout)
    enc = DIFFormerV2(
        graphs[0][0].shape[1], cfg.hidden_channels, cfg.hidden_channels,
        num_layers=cfg.num_layers, kernel=kernel, alpha=cfg.alpha,
        dropout=cfg.dropout, use_bn=cfg.use_bn, use_residual=cfg.use_residual,
        use_weight=cfg.use_weight, use_graph=cfg.use_graph,
        graph_weight=cfg.graph_weight, device="cuda")
    model = GraphLevelModel(enc, 1, cfg.graph_pooling, device="cuda")
    return GraphLevelTrainer(model, graphs, batch_size=batch, lr=cfg.lr,
                             weight_decay=cfg.weight_decay, metric=cfg.metric,
                             seed=cfg.seed, use_graphs=use_graphs,
                             device="cuda")


class EpochClock:
    """A ``fit`` logger: the host clock at every epoch's end (after its
    evals) and the split metrics."""

    def __init__(self):
        self.times, self.rows = [], []

    def add_result(self, run, result):
        torch.cuda.synchronize()
        self.times.append(time.perf_counter())
        self.rows.append(result)


def graph_level_fit(graphs, split, kernel, use_graphs, epochs):
    """One run of ``epochs`` epochs: the trainer, its summary, the fit's
    seconds, the steady ms per epoch (epochs after the first, evals
    included) and the peak memory above what was held before."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    trainer = graph_level_trainer(graphs, kernel, use_graphs)
    clock = EpochClock()
    reset_launch_counts()
    t0 = time.perf_counter()
    best = trainer.fit(split, epochs=epochs, logger=clock)[0]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    steady = np.diff(clock.times)
    return dict(trainer=trainer, best=best, fit_s=fit_s,
                epoch_ms=1e3 * float(steady.mean()) if steady.size else
                float("nan"), first_ms=1e3 * (clock.times[0] - t0),
                peak_mib=(torch.cuda.max_memory_allocated() - held) / 2**20,
                counted=launch_counts())


def phase_graph_level(graphs):
    """The actstrack preset's trainer at full width (batch 1024, hidden 64,
    2 layers) on the stand-in, with each kernel: 3 epochs on CUDA graphs
    and the same 3 in the eager loop, whose losses and split metrics must
    be bit-equal; the dense plan, as the probe picks it at this shape, and
    no kernel of the port on that path. Steady ms per train step (a replay
    against an eager step), graphs per second, ms per epoch with the
    evals, capture seconds and kernel nodes of each graph, the device's
    idle share and peak memory, and the top kernels of a replayed step."""
    from difformer_tpu_torch.data.splits import get_random_idx_split

    split = get_random_idx_split(len(graphs), 0.7, 0.15, rng=42)
    nodes = np.asarray([g[0].shape[0] for g in graphs])
    say(f"phase graph-level: {len(graphs)} graphs of {nodes.min()}-"
        f"{nodes.max()} nodes (mean {nodes.mean():.1f}), "
        f"{graphs[0][0].shape[1]} features, kNN k={ACTSTRACK_K}; split "
        f"{len(split['train'])}/{len(split['valid'])}/{len(split['test'])}; "
        f"batch {ACTSTRACK_BATCH}")
    for kernel in ("simple", "sigmoid"):
        phase = f"graph-level {kernel}"
        runs = {path: graph_level_fit(graphs, split, kernel, use, 
                                      GRAPH_LEVEL_EPOCHS)
                for path, use in (("graphs", True), ("loop", False))}
        g, lp = runs["graphs"], runs["loop"]
        runner = g["trainer"].runner
        plans = sorted({lay.plan for lay in runner.buffers})
        say(f"phase {phase}: plans {plans}; losses graphs "
            f"{g['best']['losses']}; loop {lp['best']['losses']}; best "
            f"epoch {g['best']['epoch']} ROC-AUC train "
            f"{g['best']['train']:.4f} valid {g['best']['valid']:.4f} test "
            f"{g['best']['test']:.4f}")
        if plans != ["dense"]:
            raise AssertionError(f"the probe picked {plans}, not the dense "
                                 f"plan")
        keys = ("losses", "train", "valid", "test", "epoch")
        same = all(g["best"][k] == lp["best"][k] for k in keys)
        say(f"phase {phase}: the loop's losses and split metrics bit-equal "
            f"to the graphs': {same}")
        if not same:
            raise AssertionError(f"graphs {g['best']} != loop {lp['best']}")
        if not all(np.isfinite(v).all() for v in g["best"]["losses"]):
            raise AssertionError("non-finite losses")
        launched = {k: v for k, v in runner.launches().items() if v}
        if launched or any(g["counted"].values()):
            raise AssertionError(f"the dense path launched {launched} "
                                 f"{g['counted']}")

        layout = next(iter(runner.buffers))
        step = runner.cuda_graphs["step dense"]

        def graph_step():
            runner.cursor.zero_()
            step.replay()

        loop_runner = lp["trainer"].runner

        def loop_step():
            loop_runner.cursor.zero_()
            loop_runner.run("step", layout)

        graph_ms, loop_ms = cuda_ms(graph_step), cuda_ms(loop_step)
        (dev_ms, ops), rows = profile_window(graph_step, 10, rows=True)
        idle = (f"idle {100 * (1 - dev_ms / graph_ms):.1f}%" if ops else
                "the profiler saw no device operation (idle not measured)")
        nodes = {name: graph_node_kinds(cg).count(CUDA_GRAPH_NODE_KERNEL)
                 for name, cg in runner.cuda_graphs.items()}
        say(f"phase {phase}: steady train step {graph_ms:.3f} ms replayed, "
            f"{loop_ms:.3f} ms eager ({1e3 * ACTSTRACK_BATCH / graph_ms:.0f} "
            f"graphs/s replayed, {1e3 * ACTSTRACK_BATCH / loop_ms:.0f} "
            f"eager); a replayed step: device {dev_ms:.4f} ms over {ops:g} "
            f"device operations, {idle}")
        for path, run in runs.items():
            say(f"phase {phase}: {path}: {run['epoch_ms']:.1f} ms per epoch "
                f"(3 train and 5 eval batches, host packing included; "
                f"first epoch {run['first_ms']:.1f} ms with "
                f"{'the captures' if path == 'graphs' else 'warm-up'}), "
                f"fit {run['fit_s']:.3f} s; peak memory "
                f"{run['peak_mib']:.1f} MiB")
        say(f"phase {phase}: captures {runner.capture_s:.3f} s (warm-up "
            f"included); kernel nodes {nodes}")
        for ms, count, key in rows[:GRAPH_TOP]:
            say(f"phase {phase} replay profile: {ms:9.4f} ms/step "
                f"{100 * ms / dev_ms:5.1f}% x{count:<5g} {key[:100]}")
        del runs, g, lp, runner, loop_runner, step
        gc.collect()
        torch.cuda.empty_cache()


def _largest_diffs(a, b):
    """(largest |a − b|, largest |a − b| − rtol·|b|) of two tensors."""
    d = (a.double() - b.double()).abs()
    return float(d.max()), float((d - PLAN_RTOL * b.double().abs()).max())


def phase_graph_level_plans(graphs):
    """One batch of the stand-in (1024 graphs) through the three conv
    plans, dense, table and edge list, with each kernel: logits and every
    parameter's gradient (eval mode, the BCE loss) against the dense
    plan's within rtol 1e-4, atol 1e-5. K1's device kernels in one
    captured train step on the edge-list plan (its launches at capture
    times its device kernels a call, counted in a CUDA graph of one call):
    2 layers x (forward + transposed) = 4, none split. Each plan's conv
    alone, forward and backward, with cuSPARSE beside K1. Then one epoch
    of the trainer on the edge-list plan, on CUDA graphs, whose K1
    launches (captured x replays) are the JSON row's. Returns the JSON
    rows of K1 at this batch and those launches."""
    from difformer_tpu_torch.data.batching import batch_iterator
    from difformer_tpu_torch.data.splits import get_random_idx_split
    from difformer_tpu_torch.kernels import spmm as K1
    from difformer_tpu_torch.kernels.tolerance import assert_close
    from difformer_tpu_torch.ops.graph_ops import _table_gather
    from difformer_tpu_torch.train.graph_level import bce_loss, model_inputs
    from difformer_tpu_torch.train.trainer import TrainState

    split = get_random_idx_split(len(graphs), 0.7, 0.15, rng=42)
    modes = {"dense": (None, None), "table": (False, None),
             "edges": (False, False)}
    for kernel in ("simple", "sigmoid"):
        tr = graph_level_trainer(graphs, kernel)
        batch = next(batch_iterator(graphs, split["train"], tr.batch_size,
                                    max_nodes=tr.max_nodes,
                                    max_edges=tr.max_edges))
        runner = tr._runner(TrainState(tr.model, None, 0), capture=False)
        got, packed = {}, {}
        for plan, (dense_mode, knn_mode) in modes.items():
            tr._dense_mode, tr._knn_mode = dense_mode, knn_mode
            layout, host, _, _ = tr.pack(batch)
            if layout.plan != plan:
                raise AssertionError(f"{plan}: packed {layout}")
            packed[plan] = layout, host
            runner.load(layout, host)
            tr.model.eval()
            tr.model.zero_grad(set_to_none=True)
            out, v = runner.forward(layout)
            bce_loss(out, v["labels"], v["graph_mask"] != 0).backward()
            got[plan] = (out.detach().clone(), {
                n: p.grad.detach().clone()
                for n, p in tr.model.named_parameters()})
        ref_out, ref_grads = got["dense"]
        for plan in ("table", "edges"):
            out, grads = got[plan]
            worst = [_largest_diffs(out, ref_out)] + [
                _largest_diffs(grads[n], ref_grads[n]) for n in ref_grads]
            big = max(w[0] for w in worst)
            excess = max(w[1] for w in worst)
            say(f"phase graph-level-plans {kernel}: {plan} plan against the "
                f"dense plan: logits and {len(ref_grads)} gradients, "
                f"largest |difference| {big:.3e} (rtol {PLAN_RTOL}, atol "
                f"{PLAN_ATOL}: largest excess over rtol·|dense| "
                f"{excess:.3e})")
            if not excess <= PLAN_ATOL:
                raise AssertionError(f"{plan} plan differs from the dense "
                                     f"plan by {excess:.3e} beyond rtol")
        del got
    # K1 in one captured train step on the edge-list plan
    layout, host = packed["edges"]
    state = tr.init_state(0)
    cap = tr._runner(state, torch.Generator("cuda").manual_seed(0),
                     capture=True)
    cap.load(layout, host)
    cap.run("step", layout)
    counts = cap.graphs["step edges"]["captured"]
    v = cap.inputs[layout]
    plan = model_inputs(layout, v)["plan"]
    n, e = plan.num_nodes, int(v["row_ptr"][-1])
    w = tr.model.encoder.out_channels
    x = torch.randn((n, w), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    per_call = {}
    for name, ptr, col, val, sp in (
            ("csr_spmm", plan.row_ptr, plan.col, plan.val, plan.split),
            ("csr_spmm_transposed", plan.t_row_ptr, plan.t_col, plan.t_val,
             plan.t_split)):
        per_call[name] = graph_kernels(lambda: K1.csr_spmm(
            x, ptr, col, val, split=sp,
            transposed=name == "csr_spmm_transposed"))[0]
    k1_kernels = sum(counts[k] * per_call[k] for k in per_call)
    step_nodes = graph_node_kinds(cap.cuda_graphs["step edges"]).count(
        CUDA_GRAPH_NODE_KERNEL)
    say(f"phase graph-level-plans: a captured train step on the edge-list "
        f"plan ({step_nodes} kernel nodes) launches K1 "
        f"{ {k: counts[k] for k in per_call} } times at "
        f"{per_call} device kernels a call (heavy rows "
        f"{v['counts'].tolist()}, capacity {layout.heavy}): {k1_kernels} "
        f"K1 device kernels a step (expected 2 layers x 2 = 4)")
    if k1_kernels != 4 or any(c != 1 for c in per_call.values()):
        raise AssertionError(f"K1 device kernels a step {k1_kernels}")
    del cap, state

    # each plan's conv alone, forward and backward, at H = 1, D = 64
    B, M = layout.batch_size, layout.max_nodes
    vals = torch.randn((n, 1, w), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(4))
    dense_v = packed["dense"][0].views(packed["dense"][1].cuda())
    table_v = packed["table"][0].views(packed["table"][1].cuda())
    A = dense_v["dense_adj"]
    v4 = vals.view(B, M, 1, w)
    convs = {
        "dense forward": lambda: torch.einsum("bmn,bnhd->bmhd", A, v4),
        "dense backward": lambda: torch.einsum("bnm,bnhd->bmhd", A, v4),
        "table forward": lambda: _table_gather(vals, table_v["idx"],
                                               table_v["w"]),
        "table backward": lambda: _table_gather(vals, table_v["ridx"],
                                                table_v["rw"]),
    }
    for label, fn in convs.items():
        say(f"phase graph-level-plans: conv alone, {label}: "
            f"{replay_ms(fn):.4f} ms (B={B}, M={M}, W={w}; a CUDA graph of "
            f"20 calls)")
    rows = {}
    for name, ptr, col, val, sp in (
            ("csr_spmm", plan.row_ptr, plan.col, plan.val, plan.split),
            ("csr_spmm_transposed", plan.t_row_ptr, plan.t_col, plan.t_val,
             plan.t_split)):
        transposed = name == "csr_spmm_transposed"
        # the plan at capacity: the columns and values past its e edges
        # are not K1's to read, nor the plain version's and cuSPARSE's
        kernel = lambda: K1.csr_spmm(  # noqa: E731
            x, ptr, col, val, split=sp, transposed=transposed)
        col, val = col[:e], val[:e]
        plain = lambda: K1.csr_spmm_plain(x, ptr, col, val)  # noqa: E731
        tag = f"{name} graph-level batch N={n} E={e} W={w}"
        out, ref = kernel(), plain()
        scale = K1.csr_spmm_abs(x, ptr, col, val)
        err = assert_close(tag, out, ref, "spmm", scale=scale)
        assert_rejects(tag, ref, "spmm", scale=scale)
        library = library_spmm(ptr, col, val, n)
        bound, bound_by, nbytes = spmm_bound_ms(
            n, e, w, x_rows=int(torch.unique(col).numel()))
        # K1 timed in a CUDA graph of calls (the profiler's sessions drop
        # kernels of a few microseconds, and the host's launches set the
        # event time of back-to-back calls); the plain version and cuSPARSE
        # read the host or allocate, so CUDA events over back-to-back calls
        ms, plain_ms = replay_ms(kernel), cuda_ms(plain)
        library_ms = cuda_ms(lambda: library(x))
        say(f"phase graph-level-plans: K1 {tag} max_abs_err {err:.3e} | "
            f"kernel {ms:.4f} ms (a CUDA graph of 20 calls; CUDA events "
            f"{cuda_ms(kernel):.4f} ms, profiler {device_ms(kernel):.4f} "
            f"ms) | plain {plain_ms:.4f} ms | cuSPARSE {library_ms:.4f} ms "
            f"(events) | bound {bound:.4f} ms by {bound_by} "
            f"({nbytes / 1e6:.2f} MB; {100 * bound / ms:.1f}% of the "
            f"kernel's time; x, {n * w * 4 / 1e6:.1f} MB, may stay in the "
            f"50 MB L2 between calls)")
        rows[f"{name} graph-level"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=bound_by, library_ms=library_ms)
    del convs, dense_v, table_v, A, v4, vals, x, packed

    # one epoch of the trainer on the edge-list plan (K1's main path here)
    tr = graph_level_trainer(graphs, "simple")
    tr._dense_mode = tr._knn_mode = False
    reset_launch_counts()
    best = tr.fit(split, epochs=1)[0]
    torch.cuda.synchronize()
    launches = tr.runner.launches()
    steps = len(best["losses"][0])
    evals = sum(-(-len(idx) // tr.batch_size) for idx in split.values())
    expect = {"csr_spmm": 2 * (steps + evals), "csr_spmm_transposed": 2 * steps}
    plans = sorted({lay.plan for lay in tr.runner.buffers})
    say(f"phase graph-level-plans: one epoch on the {plans} plan, CUDA "
        f"graphs: losses {best['losses'][0]}, ROC-AUC valid "
        f"{best['valid']:.4f}; K1 replayed {launches} (expected {expect}: "
        f"2 layers x ({steps} steps + {evals} evals) forward, 2 x {steps} "
        f"transposed)")
    if plans != ["edges"] or {k: launches[k] for k in expect} != expect:
        raise AssertionError(f"edge-list epoch: {plans} {launches}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return rows, launches


def phase_cli_actstrack(tmp):
    """``python -m difformer_tpu_torch.cli --dataset actstrack`` on a
    stand-in processed cache of 3000 graphs (the split build_actstrack
    writes), cut to 3 epochs and 1 run, with each kernel: the cache read
    (the dataset's size, no ``[warn]`` line of the synthetic fallback),
    the batch clamped to 64 as the JAX command line clamps it, fit ms per
    epoch, the test ROC-AUC."""
    import io

    from difformer_tpu_torch import cli

    t0 = time.perf_counter()
    graphs = actstrack_standin(ACTSTRACK_CLI_GRAPHS, seed=17)
    path = write_actstrack_cache(tmp, graphs)
    say(f"phase cli-actstrack: stand-in cache {path} "
        f"({os.path.getsize(path) / 2**20:.1f} MiB) written in "
        f"{time.perf_counter() - t0:.1f} s")
    real_fit = cli.GraphLevelTrainer.fit
    for kernel in ("simple", "sigmoid"):
        made = []

        def timed_fit(trainer, split_idx, **kw):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = real_fit(trainer, split_idx, **kw)
            torch.cuda.synchronize()
            made.append((trainer, time.perf_counter() - t1, kw["epochs"]))
            return res

        argv = ["--dataset", "actstrack", "--data_dir", tmp, "--epochs",
                str(GRAPH_LEVEL_EPOCHS), "--runs", "1", "--kernel", kernel]
        out = io.StringIO()
        with unittest.mock.patch.object(cli.GraphLevelTrainer, "fit",
                                        timed_fit), \
                contextlib.redirect_stdout(out):
            t1 = time.perf_counter()
            res = cli.main(argv)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t1
        lines = out.getvalue().splitlines()
        trainer, fit_s, epochs = made[0]
        test = res[0]["test"]
        say(f"phase cli-actstrack: {' '.join(argv)} -> {lines[-1]}; "
            f"{len(trainer.dataset)} graphs, batch {trainer.batch_size}, "
            f"plans {sorted({lay.plan for lay in trainer.runner.buffers})}; "
            f"fit {1e3 * fit_s / epochs:.1f} ms per epoch (captures "
            f"included), whole command {total_s:.3f} s (cut from 150 epochs "
            f"and 3 runs); test ROC-AUC {test:.4f}; losses of the last "
            f"epoch {res[0]['losses'][-1][:4]}...")
        if any("[warn]" in line for line in lines):
            raise AssertionError("the command line fell back to the "
                                 "synthetic graphs")
        if len(trainer.dataset) != ACTSTRACK_CLI_GRAPHS:
            raise AssertionError(f"{len(trainer.dataset)} graphs read")
        if trainer.batch_size != 64 or not 0.0 <= test <= 1.0:
            raise AssertionError(f"batch {trainer.batch_size}, test {test}")
        del made, trainer, res
        gc.collect()


# ---------------------------------------------------------------------------
# ell-bsr-kernels, spmm-layouts, cli-layouts: the sparse layouts of the node
# track (ELL, K6; the block-sparse hybrid, K7 and K6)
# ---------------------------------------------------------------------------

ELL_SOURCE = "difformer_tpu_torch/csrc/ell.cu"
BSR_SOURCE = "difformer_tpu_torch/csrc/bsr.cu"
ELL_REPLACES = "difformer_tpu/ops/ell.py:180"
BSR_REPLACES = {"padded": "difformer_tpu/ops/bsr.py:252",
                "bucketed": "difformer_tpu/ops/bsr.py:568"}
ELL_PATH = ("ell_spmm", "ell_spmm_transposed")
BSR_PATH = ("bsr_spmm", "bsr_spmm_transposed")
BSR_COMBINE = "bsr_spmm_combine"
ELL_COMBINE = "ell_spmm_combine"
# K6's split threshold T, swept on the power-law graph (0: no split)
ELL_THRESHOLDS = (128, 256, 384, 512, 1024, 0)
# bench.py's headline graphs (bench.py:84, build_graph :306-330) and model
# (3-layer DIFFormer-s, hidden 64, 112 binary tasks, bench.py:1-8)
BENCH_NODES, BENCH_EDGES, BENCH_FEATURES = 131072, 4 * 1024 * 1024, 64
BENCH_CLASSES, BENCH_LAYERS, BENCH_HIDDEN = 112, 3, 64
BENCH_GRAPHS = ("clustered", "powerlaw", "uniform")
BSR_TILE = 256
# the tiles the kernel checks make dense blocks of, whatever the cost model
# elects: every intra-community tile of the clustered graph (~1600 edges a
# 256 x 256 tile), at the same density at other tile sizes
KERNEL_MIN_EDGES = 256
LAYOUT_EPOCHS = 10
LAYOUT_RTOL = 1e-3  # a layout's losses against K1's (f32 sums reordered)
CAPTURE_REPEATS = 10


def bench_graph(kind, n=BENCH_NODES, e=BENCH_EDGES, f=BENCH_FEATURES,
                seed=0, comm=1024, intra=0.8):
    """bench.py's ``build_graph`` (numpy): features [n, f] and the edges
    (senders, receivers) sorted by receiver. clustered: a stochastic block
    model, communities of ``comm`` nodes holding ``intra`` of the edges;
    powerlaw: Pareto-α2 node weights on both ends (hubs of thousands);
    uniform: i.i.d. ends."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    if kind == "clustered":
        e_in = int(e * intra)
        c = rng.integers(0, n // comm, e_in)
        senders = np.concatenate(
            [c * comm + rng.integers(0, comm, e_in),
             rng.integers(0, n, e - e_in)]).astype(np.int32)
        receivers = np.concatenate(
            [(c * comm + rng.integers(0, comm, e_in)),
             rng.integers(0, n, e - e_in)]).astype(np.int32)
    elif kind == "powerlaw":
        w = rng.pareto(2.0, n) + 1.0
        p = w / w.sum()
        senders = rng.choice(n, size=e, p=p).astype(np.int32)
        receivers = rng.choice(n, size=e, p=p).astype(np.int32)
    else:
        senders = rng.integers(0, n, e).astype(np.int32)
        receivers = rng.integers(0, n, e).astype(np.int32)
    order = np.argsort(receivers, kind="stable")
    return x, senders[order], receivers[order]


def degree_sorted(s, r, n, *arrays):
    """(s, r) relabelled by ``degree_sorted_order`` and sorted by receiver,
    and node arrays in the new order."""
    from difformer_tpu_torch.ops.bsr import degree_sorted_order

    perm = degree_sorted_order(s, r, n)
    s2, r2 = perm[s].astype(np.int32), perm[r].astype(np.int32)
    order = np.argsort(r2, kind="stable")
    inv = np.argsort(perm)
    return (s2[order], r2[order]) + tuple(a[inv] for a in arrays)


def layout_bytes(obj):
    """Device bytes of a layout's tensors (its host tables left out)."""
    if obj is None:
        return 0
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(layout_bytes(t) for t in obj)
    import dataclasses

    if dataclasses.is_dataclass(obj):
        return sum(layout_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


def ell_bound_ms(n, e, w, elem=4):
    """(least ms, "bytes" or "operations", bytes) of one K6 product over a
    graph of ``e`` edges: x and out once at ``elem`` bytes, an index and a
    value an edge, a row index a node; 2·E·W flops at the FP32 rate."""
    nbytes = 2 * n * w * elem + 8 * e + 4 * n
    t_bytes, t_ops = nbytes / PEAK_BYTES, 2 * e * w / PEAK_OPS[torch.float32]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations", nbytes)


def ell_gather_floor_ms(n, e, w, elem=4):
    """The gather floor of one K6 product in ms, a diagnostic beside its
    bound: every gathered row x[idx] of a real slot (E·W elements), out,
    idx, val, rows and pads, each moved once from HBM with no reuse in L2.
    K6 goes below it only where L2 keeps the rows that many slots
    gather."""
    return 1e3 * ((e + n) * w * elem + 8 * e + 12 * n) / PEAK_BYTES


def bsr_work(d, w, elem_x):
    """(dense blocks, flops, compulsory bytes) of one K7 product over ``d``
    at width ``w``: the blocks that hold an edge, each read once and
    multiplied against a [T, W] slice of x (2·T²·W flops), x and out once
    at ``elem_x`` bytes, a column index a block and the scale where
    counts."""
    blocks = sum(int((b.reshape(b.shape[0], b.shape[1], -1) != 0)
                     .any(-1).sum()) for b, _, _ in d.groups()
                 if b is not None)
    elem_b = next((b.element_size() for b, _, _ in d.groups()
                   if b is not None), 4)
    t = d.tile
    n = d.num_nodes
    flops = 2 * t * t * w * blocks
    nbytes = (blocks * (t * t * elem_b + 4) + 2 * n * w * elem_x
              + (4 * n if getattr(d, "inv_scale", None) is not None else 0))
    return blocks, flops, nbytes


def bsr_bounds(d, w, x_dtype):
    """(least ms, "bytes" or "operations", compulsory bytes; least ms on the
    FP32 units; least ms on the tensor cores; blocks) of one K7 product:
    the least time is the larger of the bytes' and the operations', the
    operations on whichever unit is faster: the FP32 units at 67 TFLOP/s,
    or the tensor cores with f32's precision, TF32 at 495 TFLOP/s in 3
    passes (f32 blocks and x) or 2 (one operand a bf16 value or a count),
    bf16 at 989 in 1 (bf16 x and bf16 or count blocks)."""
    blocks, flops, nbytes = bsr_work(d, w, torch.tensor(
        [], dtype=x_dtype).element_size())
    t_bytes = nbytes / PEAK_BYTES
    t_fp32 = flops / PEAK_OPS[torch.float32]
    f32_blocks = any(b.dtype == torch.float32 for b, _, _ in d.groups()
                     if b is not None)
    if x_dtype == torch.float32:
        t_tc = (3 if f32_blocks else 2) * flops / 495e12
    else:
        t_tc = 2 * flops / 495e12 if f32_blocks else flops / 989e12
    t_ops = min(t_fp32, t_tc)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations", nbytes,
            1e3 * max(t_bytes, t_fp32), 1e3 * max(t_bytes, t_tc), blocks)


def library_bsr(d, x):
    """cuSPARSE's BSR product (``torch.sparse_bsr_tensor @ x``) of a
    layout's blocks that hold an edge (padded or bucketed), as copies in
    x's dtype with the count scale of int8 blocks folded in (each block
    times scale[row] scale[column]), on x padded to whole tiles; None where
    the call refuses them (it is timed only)."""
    t, n, w = d.tile, d.num_nodes, x.shape[1]
    ntr = -(-n // t)
    scale = getattr(d, "inv_scale", None)
    if scale is not None:
        tiled = torch.zeros(ntr * t, device=x.device)
        tiled[:n] = scale
        tiled = tiled.view(ntr, t)
    rows, cols, vals = [], [], []
    for blocks, bcol, tiles in d.groups():
        if blocks is None:
            continue
        live = blocks.reshape(blocks.shape[0], blocks.shape[1], -1) \
            .ne(0).any(-1)
        tile_rows = (torch.arange(live.shape[0], device=x.device)
                     if tiles is None else tiles.long())
        rt, ct = tile_rows[:, None].expand_as(live)[live], bcol[live].long()
        v = blocks[live].float()
        if scale is not None:
            v = v * tiled[rt][:, :, None] * tiled[ct][:, None, :]
        rows.append(rt)
        cols.append(ct)
        vals.append(v.to(x.dtype))
    rt, ct, v = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    order = torch.argsort(rt * ntr + ct)
    crow = torch.zeros(ntr + 1, dtype=torch.int64, device=x.device)
    crow[1:] = torch.bincount(rt, minlength=ntr).cumsum(0)
    a = torch.sparse_bsr_tensor(crow, ct[order], v[order],
                                size=(ntr * t, ntr * t))
    del v, vals
    xp = torch.zeros((ntr * t, w), dtype=x.dtype, device=x.device)
    xp[:n] = x
    call = lambda: a @ xp  # noqa: E731
    call()
    return call


def check_k6(tag, x, ell, transposed, csr):
    """K6 against its plain version on ``x``: the "spmm" rule (shown to
    fail a wrong output), two calls bit-equal, one device kernel a call, or
    two where its plan splits a bucket (counted in its CUDA graph); the
    kernel's device time by CUDA-graph replay (:func:`replay_ms`), the
    plain version's and cuSPARSE CSR's (``csr``: the same matrix's row_ptr,
    col, val) by the profiler, beside the bound and the gather floor.
    Returns the JSON row, and the combine's (:func:`check_ell_combine`)
    where the plan splits, else None."""
    from difformer_tpu_torch.kernels import ell as K6
    from difformer_tpu_torch.kernels.tolerance import assert_close

    n, w = x.shape
    call = lambda: K6.ell_spmm_rows(x, ell, transposed=transposed)  # noqa
    plain = lambda: K6.ell_spmm_plain(x, ell)  # noqa: E731
    out, ref = call(), plain()
    scale = K6.ell_spmm_abs(x, ell)
    err = assert_close(tag, out, ref, "spmm", scale=scale)
    assert_rejects(tag, ref, "spmm", scale=scale)
    if not torch.equal(out, call()):
        raise AssertionError(f"{tag}: two calls differ")
    del out, ref, scale
    split = ell.split.partials > 0
    kernels, nodes = graph_kernels(call)
    if kernels != 1 + split or nodes != 1 + split:
        raise AssertionError(f"{tag}: {kernels} device kernels in {nodes} "
                             f"graph nodes a call, expected {1 + split}")
    e = int((ell.val != 0).sum())
    bound, bound_by, nbytes = ell_bound_ms(n, e, w, x.element_size())
    floor = ell_gather_floor_ms(n, e, w, x.element_size())
    ms, plain_ms = replay_ms(call), device_ms(plain)
    try:
        library = library_spmm(*csr, n, x.dtype)
        library_ms = device_ms(lambda: library(x))
    except RuntimeError as ex:
        library_ms = None
        say(f"phase ell-bsr-kernels: {tag}: cuSPARSE refused: "
            f"{str(ex).splitlines()[0][:160]}")
    widths = ell.bucket_sizes
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    pads = int(ell.pads[:, 1].sum())
    plan = (f"T = {ell.split.threshold}: chunks {ell.split.chunks}, "
            f"{ell.split.rows.numel()} split rows, {ell.split.partials} "
            f"partial rows" if split else f"T = {ell.split.threshold}: "
            f"nothing split")
    say(f"phase ell-bsr-kernels: {tag:52s} max_abs_err {err:.3e}, two calls "
        f"bit-equal, {1 + split} device kernels a call | {len(widths)} "
        f"buckets, widths {widths[0]}..{widths[-1]}, {ell.num_slots} slots "
        f"for {e} edges, {pads} padded slots skipped | {plan} | kernel "
        f"{ms:.4f} ms | plain {plain_ms:.4f} ms | cuSPARSE CSR {lib} | "
        f"bound {bound:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB; "
        f"{100 * bound / ms:.1f}% of the kernel's time) | gather floor "
        f"{floor:.4f} ms ({100 * floor / ms:.1f}%)")
    combine = check_ell_combine(tag, x, ell, transposed) if split else None
    return (dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                 bound_by=bound_by, library_ms=library_ms), combine)


def check_ell_combine(tag, x, ell, transposed):
    """K6's combine (K1's ``csr_spmm_combine``) alone, on the partials K6's
    kernel wrote for ``x``, against its plain version (the "spmm" rule over
    the sums of |partials|; bit-equal expected: the same f32 adds in the
    same order); its time by CUDA-graph replay, the plain version's by the
    profiler; bound: the partials read once, the split rows written once,
    their nodes and offsets read (bytes). Library: one
    ``torch.segment_reduce`` summing each split row's chunks (ragged, at
    ``seg_ptr``), without the scatter into out, held to the plain sums under
    the same rule and timed by the profiler. Returns the JSON row."""
    from difformer_tpu_torch.kernels import ell as K6
    from difformer_tpu_torch.kernels.tolerance import assert_close

    out, partial = K6.ell_spmm_split(x, ell, transposed=transposed)
    call = lambda: K6.ell_spmm_combine(partial, out, ell)  # noqa: E731
    plain = lambda: K6.ell_spmm_combine_plain(  # noqa: E731
        partial, out, ell)
    library = lambda: torch.segment_reduce(  # noqa: E731
        partial, "sum", offsets=ell.split.seg_ptr, axis=0)
    ref = plain()
    got = call().clone()
    sc = K6.ell_spmm_combine_plain(partial.abs(), out.abs(), ell)
    err = assert_close(f"{tag} combine", got, ref, "spmm", scale=sc)
    if not torch.equal(got, call()):
        raise AssertionError(f"{tag} combine: two calls differ")
    rows = ell.split.rows.long()
    zero = torch.zeros_like(out, dtype=torch.float32)
    assert_close(
        f"{tag} combine, segment_reduce", library(),
        K6.ell_spmm_combine_plain(partial, zero, ell)[rows], "spmm",
        scale=K6.ell_spmm_combine_plain(partial.abs(), zero, ell)[rows])
    h, w = ell.split.rows.numel(), x.shape[1]
    nbytes = 4 * partial.numel() + h * w * x.element_size() + 4 * (2 * h + 1)
    bound = 1e3 * nbytes / PEAK_BYTES
    ms, plain_ms = replay_ms(call), device_ms(plain)
    library_ms = device_ms(library)
    say(f"phase ell-bsr-kernels: {tag} combine: max_abs_err {err:.3e} "
        f"({'bit-equal' if torch.equal(got, ref) else 'not bit-equal'} to "
        f"the plain version), two calls bit-equal | {ell.split.partials} "
        f"partial rows of {h} split rows | kernel {ms:.4f} ms | plain "
        f"{plain_ms:.4f} ms | library {library_ms:.4f} ms (one "
        f"torch.segment_reduce over the chunks, without the scatter into "
        f"out) | bound {bound:.4f} ms by bytes "
        f"({nbytes / 1e6:.2f} MB; {100 * bound / ms:.1f}%)")
    del out, partial, ref, got, sc
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", library_ms=library_ms)


def sweep_ell_threshold(tag, x, ell, transposed):
    """K6's device time (CUDA-graph replay) over ``ell`` at each split
    threshold of ELL_THRESHOLDS (0: nothing split), each checked against
    the plain version under the "spmm" rule."""
    from difformer_tpu_torch.kernels import ell as K6
    from difformer_tpu_torch.kernels.tolerance import assert_close

    ref, scale = K6.ell_spmm_plain(x, ell), K6.ell_spmm_abs(x, ell)
    times = []
    for t in ELL_THRESHOLDS:
        layout = ell.with_split(t or max(ell.bucket_sizes))
        call = lambda: K6.ell_spmm_rows(  # noqa: E731
            x, layout, transposed=transposed)
        assert_close(f"{tag} T={t}", call(), ref, "spmm", scale=scale)
        times.append(f"T={t or 'none'} ({layout.split.partials} partial "
                     f"rows) {replay_ms(call):.4f} ms")
    say(f"phase ell-bsr-kernels: {tag}: split threshold T (the source's "
        f"{K6.SPLIT_THRESHOLD}): " + ", ".join(times))


def check_k7(tag, x, d, transposed, library=True):
    """K7 (the blocks alone: its kernel, and the combine kernel where
    ``split_plan`` cuts a group) and the whole direction (K7 then K6 adding
    the residual) against their plain versions on ``x``: the "spmm" rule
    (shown to fail a wrong output, with the residual too), two calls
    bit-equal, the device kernels
    a call counted from its CUDA graph (K7's launches, 1 or 2 where split,
    one copy more where x is staged to rows of 16 bytes, and K6 for the
    residual, 2 where its plan splits); the kernel's device time by CUDA-graph replay, the plain
    version's and cuSPARSE BSR's (the blocks that hold an edge, as x's
    dtype, the count scale folded in) by the profiler, beside the FP32 and
    the tensor-core bounds. Returns the JSON row, the time of one block
    slot, and the combine kernel's row (:func:`check_combine`) or None."""
    from difformer_tpu_torch.kernels import bsr as K7
    from difformer_tpu_torch.kernels import ell as K6
    from difformer_tpu_torch.kernels.tolerance import assert_close
    from difformer_tpu_torch.ops.bsr import bsr_matvec

    groups, scale = d.groups(), getattr(d, "inv_scale", None)
    w = x.shape[1]
    chunks = K7.split_plan(K7.group_shapes(groups), d.tile, w,
                           K7.sm_count(x.device))
    launches = 1 + any(c > 1 for c in chunks)
    staged = K7.staged_x(x)[0] is not x
    call = lambda: K7.bsr_spmm_blocks(  # noqa: E731
        x, groups, d.tile, scale=scale, transposed=transposed)
    plain = lambda: K7.bsr_spmm_blocks_plain(  # noqa: E731
        x, groups, d.tile, scale)
    out, ref = call(), plain()
    sc = K7.bsr_spmm_blocks_abs(x, groups, d.tile, scale)
    err = assert_close(tag, out, ref, "spmm", scale=sc)
    assert_rejects(tag, ref, "spmm", scale=sc)
    if not torch.equal(out, call()):
        raise AssertionError(f"{tag}: two calls differ")
    whole = lambda: bsr_matvec(d, x, transposed=transposed)  # noqa: E731
    got = whole()
    if d.residual is not None:
        ref = K6.ell_spmm_plain(x, d.residual, add_to=ref)
        sc = K6.ell_spmm_abs(x, d.residual).float() + sc.float()
    whole_err = assert_close(f"{tag} with residual", got, ref, "spmm",
                             scale=sc)
    assert_rejects(f"{tag} with residual", ref, "spmm", scale=sc)
    del out, ref, sc, got
    expect = launches + staged
    # K6 adding the residual, and its combine where its plan splits
    residual = (0 if d.residual is None
                else 1 + (d.residual.split.partials > 0))
    for fn, want in ((call, expect), (whole, expect + residual)):
        kernels, nodes = graph_kernels(fn)
        if kernels != want or nodes != want:
            raise AssertionError(f"{tag}: {kernels} device kernels in "
                                 f"{nodes} graph nodes a call, expected "
                                 f"{want}")
    bound, bound_by, nbytes, fp32_bound, tc_bound, blocks = bsr_bounds(
        d, w, x.dtype)
    slots = sum(int(np.prod(c.shape)) for _, c, _ in groups
                if c is not None)
    ms, plain_ms, whole_ms = replay_ms(call), device_ms(plain), \
        replay_ms(whole)
    library_ms = None
    if library:
        try:
            lib = library_bsr(d, x)
            library_ms = device_ms(lib)
            del lib
        except (RuntimeError, NotImplementedError) as ex:
            say(f"phase ell-bsr-kernels: {tag}: cuSPARSE BSR refused: "
                f"{str(ex).splitlines()[0][:160]}")
        torch.cuda.empty_cache()
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    stage = (f", x staged to rows of {K7.staged_x(x)[1]} "
             f"({x.shape[0] * K7.staged_x(x)[1] * x.element_size() / 1e6:.2f}"
             f" MB written)" if staged else "")
    say(f"phase ell-bsr-kernels: {tag:52s} max_abs_err {err:.3e} (with "
        f"the residual {whole_err:.3e}), two calls bit-equal, {expect} "
        f"device kernels a call ({expect + residual} with "
        f"the residual) | K7 launches a call {launches} (S = "
        f"{K7.SPLIT_BLOCKS}, chunks {chunks}), column tile "
        f"{K7.column_tile(w)}{stage} | {slots} block slots, {blocks} with "
        f"edges, {len(groups)} groups | kernel {ms:.4f} ms "
        f"({1e6 * ms / max(slots, 1):.2f} ns a slot), with the residual "
        f"{whole_ms:.4f} ms | plain {plain_ms:.4f} ms | cuSPARSE BSR {lib} | "
        f"bound {bound:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB; "
        f"{100 * bound / ms:.1f}% of the kernel's time): FP32 units "
        f"{fp32_bound:.4f} ms, tensor cores {tc_bound:.4f} ms")
    combine = (check_combine(tag, x, d, chunks, transposed)
               if launches > 1 else None)
    return (dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                 bound_by=bound_by, library_ms=library_ms),
            ms / max(slots, 1), combine)


def check_combine(tag, x, d, chunks, transposed):
    """K7's combine kernel alone, on the partials K7's first kernel wrote
    for ``x`` under the plan ``chunks``, against its plain version (the
    "spmm" rule over the sums of |partials|; bit-equal expected: the same
    f32 adds in the same order); its time by CUDA-graph replay, the plain
    version's by the profiler; bound: the partials read once, the split
    rows written once and their scales read (bytes). Returns the JSON
    row."""
    from difformer_tpu_torch.kernels import bsr as K7
    from difformer_tpu_torch.kernels.tolerance import assert_close

    groups, scale, t = d.groups(), getattr(d, "inv_scale", None), d.tile
    out, partial = K7.bsr_spmm_split(x, groups, t, chunks, scale=scale,
                                     transposed=transposed)
    call = lambda: K7.bsr_spmm_combine(  # noqa: E731
        partial, out, groups, t, chunks, scale=scale)
    plain = lambda: K7.bsr_spmm_combine_plain(  # noqa: E731
        partial, out, groups, t, chunks, scale)
    ref = plain()
    got = call().clone()
    sc = K7.bsr_spmm_combine_plain(partial.abs(), out.abs(), groups, t,
                                   chunks, None if scale is None
                                   else scale.abs())
    err = assert_close(f"{tag} combine", got, ref, "spmm", scale=sc)
    if not torch.equal(got, call()):
        raise AssertionError(f"{tag} combine: two calls differ")
    n, w = x.shape
    rows = sum(min(m * t, n) for (m, _), c in zip(K7.group_shapes(groups),
                                                  chunks) if c > 1)
    nbytes = 4 * partial.numel() + rows * (w * x.element_size()
                                           + 4 * (scale is not None))
    bound = 1e3 * nbytes / PEAK_BYTES
    ms, plain_ms = replay_ms(call), device_ms(plain)
    library_ms = device_ms(library_combine(partial, groups, t, w, chunks))
    # (a package from before the combine plan, e.g. time_kernels.py --root,
    # has no thread blocks to print)
    blocks = (f" ({K7.combine_plan(groups, chunks, t, w)[1]} thread blocks "
              f"of {K7.combine_rows(w)} rows)"
              if hasattr(K7, "combine_plan") else "")
    say(f"phase ell-bsr-kernels: {tag} combine: max_abs_err {err:.3e} "
        f"({'bit-equal' if torch.equal(got, ref) else 'not bit-equal'} to "
        f"the plain version), two calls bit-equal | {partial.numel()} "
        f"partials of {sum(c > 1 for c in chunks)} split groups{blocks}, "
        f"out {str(out.dtype).split('.')[-1]} | "
        f"kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | library "
        f"{library_ms:.4f} ms (torch.sum over the chunks, one call a split "
        f"group, without the scale and the scatter into out) | bound "
        f"{bound:.4f} ms by bytes ({nbytes / 1e6:.2f} MB; "
        f"{100 * bound / ms:.1f}%)")
    del out, partial, ref, got, sc
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", library_ms=library_ms)


def library_combine(partial, groups, tile, width, chunks):
    """The combine's sums by PyTorch: ``torch.sum`` over the chunk axis of
    each split group's [chunks, m·T, W] partials, one call a group. It
    leaves out the scale and the scatter of the rows into out, which no
    single call does."""
    from difformer_tpu_torch.kernels import bsr as K7

    offsets, _ = K7.partial_offsets(groups, chunks, tile, width)
    views = [partial[off:off + c * m * tile * width].view(c, m * tile, width)
             for (m, _), c, off in zip(K7.group_shapes(groups), chunks,
                                       offsets) if c > 1]
    return lambda: [torch.sum(v, 0) for v in views]


def edge_time_ms():
    """K1's device time per edge (ms) at Pokec's size with uniform ends,
    W = 64, float32: the gather cost of the cost model, with x (418 MB)
    out of L2."""
    from difformer_tpu_torch.kernels import spmm as K1
    from difformer_tpu_torch.ops.graph_ops import build_csr_plan

    g = torch.Generator("cuda").manual_seed(11)
    n, e = POKEC_NODES, POKEC_EDGES
    senders = torch.randint(0, n, (e,), device="cuda", generator=g)
    receivers = torch.randint(0, n, (e,), device="cuda",
                              generator=g).sort().values
    plan = build_csr_plan(senders, receivers, n)
    del senders, receivers
    x = torch.randn((n, 64), device="cuda", generator=g)
    ms = device_ms(lambda: K1.csr_spmm(x, plan.row_ptr, plan.col, plan.val,
                                       split=plan.split))
    del plan, x
    torch.cuda.empty_cache()
    return ms / e, ms


def hub_layout(graph=None):
    """The forward direction of bench.py's power-law graph (``graph``, or
    drawn anew) after the degree-sorted relabel, as the bucketed int8
    hybrid at T = 256, on the card: its hub row tile holds 256 blocks,
    which K7 splits."""
    from difformer_tpu_torch.ops import bsr as B

    _, s, r = bench_graph("powerlaw") if graph is None else graph
    s, r = degree_sorted(s, r, BENCH_NODES)
    fwd, _ = B.build_bsr_bucketed_gcn(s, r, BENCH_NODES, tile=BSR_TILE,
                                      min_edges=KERNEL_MIN_EDGES)
    return fwd.to("cuda")


def phase_ell_bsr_kernels():
    """K6 and K7 against their plain versions on the card (module
    docstring), the layouts' device footprints, and this card's cost model
    measured: ``_EDGE_EQUIV_BYTES`` from K1's time per edge and K7's per
    float32 256 x 256 block, ``_BUCKETED_BREAKEVEN_SCALE`` from K7's per
    int8-count block. Returns the JSON rows and the two constants."""
    from difformer_tpu_torch.ops import bsr as B
    from difformer_tpu_torch.ops.ell import build_ell_gcn
    from difformer_tpu_torch.ops.graph_ops import build_csr_plan

    rows = {}

    def both(label, s, r, n, x32, dtypes, json_label=None):
        t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
        fwd, rev = (d.to("cuda") for d in build_ell_gcn(s, r, n))
        plan = build_csr_plan(t(s), t(r), n)
        csrs = ((plan.row_ptr, plan.col, plan.val),
                (plan.t_row_ptr, plan.t_col, plan.t_val))
        say(f"phase ell-bsr-kernels: {label} N={n} E={s.size}: device "
            f"footprint ELL {layout_bytes((fwd, rev)) / 1e6:.2f} MB (both "
            f"directions) against K1's CSR plan "
            f"{layout_bytes(plan) / 1e6:.2f} MB")
        for dtype in dtypes:
            x = x32.to(dtype)
            suffix = "" if dtype == torch.float32 else " bf16"
            for name, ell, csr in zip(ELL_PATH, (fwd, rev), csrs):
                transposed = name.endswith("transposed")
                tag = f"{name}{suffix} {label} W={x.shape[1]}"
                row, combine = check_k6(tag, x, ell, transposed, csr)
                if json_label is not None:
                    rows[f"{name}{json_label}{suffix}"] = row
                if json_label is not None and combine is not None:
                    rows[f"{ELL_COMBINE}{json_label}{suffix}"
                         f"{' transposed' if transposed else ''}"] = combine
                if label == "powerlaw" and dtype == torch.float32:
                    sweep_ell_threshold(tag, x, ell, transposed)
        del fwd, rev, plan
        torch.cuda.empty_cache()

    g = torch.Generator("cuda").manual_seed(7)
    _, ei, _ = cora_graph()
    n = 2708
    for w in (64, 65):
        both("cora", ei[0], ei[1], n, torch.randn((n, w), device="cuda",
                                                   generator=g),
             (torch.float32, torch.bfloat16) if w == 64 else
             (torch.float32,), "" if w == 64 else None)
    graphs = {}
    for kind in BENCH_GRAPHS:
        x, s, r = bench_graph(kind)
        graphs[kind] = (x, s, r)
        both(kind, s, r, BENCH_NODES, torch.as_tensor(x, device="cuda"),
             (torch.float32, torch.bfloat16), f" {kind}")

    # K7: the clustered graph's tiles of at least KERNEL_MIN_EDGES edges
    x, s, r = graphs["clustered"]
    n = BENCH_NODES
    x32 = torch.as_tensor(x, device="cuda")
    per_block = {}
    cases = [("padded f32", dict(tile=BSR_TILE), True, "", True),
             ("padded bf16-blocks", dict(tile=BSR_TILE,
                                         block_dtype=torch.bfloat16),
              False, " bf16-blocks", True),
             ("bucketed int8", dict(tile=BSR_TILE), True, " int8", False),
             ("padded f32 T=128", dict(tile=128), False, " T=128", True)]
    for label, kw, both_ways, json_suffix, padded in cases:
        build = B.build_bsr_gcn if padded else B.build_bsr_bucketed_gcn
        fwd, rev = (d.to("cuda") for d in build(
            s, r, n, min_edges=KERNEL_MIN_EDGES * kw["tile"] ** 2
            // BSR_TILE ** 2, **kw))
        say(f"phase ell-bsr-kernels: clustered {label}: device footprint "
            f"{layout_bytes((fwd, rev)) / 1e6:.2f} MB (blocks "
            f"{layout_bytes((fwd.blocks, rev.blocks)) / 1e6:.2f} MB)")
        for dtype in (torch.float32, torch.bfloat16):
            xx = x32.to(dtype)
            xs = "" if dtype == torch.float32 else " bf16"
            for name, d in list(zip(BSR_PATH, (fwd, rev)))[:2 if both_ways
                                                           else 1]:
                row, t_block, _ = check_k7(
                    f"{name}{xs} clustered {label} W=64", xx, d,
                    name.endswith("transposed"))
                rows[f"{name}{json_suffix}{xs}"] = row
                if dtype == torch.float32 and name == "bsr_spmm":
                    per_block[label] = t_block
        if label == "padded f32":
            # spmm_first's width F + 1 (x staged to rows of 16 bytes, one
            # column tile of 72) and the cifar10 preset's hidden 300 (three
            # column tiles of 104)
            for wx in (65, 300):
                rows[f"bsr_spmm W={wx}"], _, _ = check_k7(
                    f"bsr_spmm clustered {label} W={wx}",
                    torch.randn((n, wx), device="cuda", generator=g), fwd,
                    False)
        del fwd, rev
        torch.cuda.empty_cache()
    # the hub rows of the powerlaw graph after the hub-clustering relabel
    fwd = hub_layout(graphs["powerlaw"])
    say(f"phase ell-bsr-kernels: powerlaw degree-sorted bucketed int8: "
        f"buckets {[tuple(b.shape[:2]) for b in fwd.blocks]}, device "
        f"footprint {layout_bytes(fwd) / 1e6:.2f} MB (one direction)")
    rows["bsr_spmm hub int8"], _, combine = check_k7(
        "bsr_spmm powerlaw degree-sorted bucketed int8 W=64", x32, fwd,
        False)
    if combine is None:
        raise AssertionError("the power-law hub row tile was not split")
    rows[f"{BSR_COMBINE} hub int8"] = combine
    # the combine at spmm_first's width (single values), the cifar10
    # preset's (four column tiles of K7) and at bf16 x and out
    for label, xx in (("W=65", torch.randn((n, 65), device="cuda",
                                           generator=g)),
                      ("W=300", torch.randn((n, 300), device="cuda",
                                            generator=g)),
                      ("bf16", x32.to(torch.bfloat16))):
        _, _, combine = check_k7(
            f"bsr_spmm powerlaw degree-sorted bucketed int8 {label}", xx,
            fwd, False, library=False)
        if combine is None:
            raise AssertionError(f"the power-law hub row tile was not split "
                                 f"at {label}")
        rows[f"{BSR_COMBINE} hub int8 {label}"] = combine
        del xx
    # the split size S (kernels/bsr.py SPLIT_BLOCKS), measured on this layout
    from difformer_tpu_torch.kernels import bsr as K7

    sweep = {}
    for size in (2, 3, 4, 8, 16, 32):
        with unittest.mock.patch.object(K7, "SPLIT_BLOCKS", size):
            sweep[size] = replay_ms(lambda: K7.bsr_spmm_blocks(
                x32, fwd.groups(), fwd.tile, scale=fwd.inv_scale))
    say(f"phase ell-bsr-kernels: split size S on the power-law hub layout "
        f"(W=64; the source's S = {K7.SPLIT_BLOCKS}): "
        + ", ".join(f"S={k} {v:.4f} ms" for k, v in sweep.items()))

    del fwd, graphs
    torch.cuda.empty_cache()

    # this card's cost model
    t_edge, k1_ms = edge_time_ms()
    block_bytes = BSR_TILE * BSR_TILE * 4 + BSR_TILE * 128
    edge_equiv = t_edge * block_bytes / per_block["padded f32"]
    min_f32 = max(8, int(block_bytes / edge_equiv) + 1)
    min_int8 = max(8, int((BSR_TILE * BSR_TILE + BSR_TILE * 128)
                          / edge_equiv) + 1)
    scale = per_block["bucketed int8"] / t_edge / min_int8
    say(f"phase ell-bsr-kernels: cost model: K1 {k1_ms:.4f} ms for Pokec's "
        f"{POKEC_EDGES} edges at W=64 = {1e6 * t_edge:.4f} ns an edge; K7 "
        f"{1e6 * per_block['padded f32']:.2f} ns a float32 256x256 block "
        f"slot, {1e6 * per_block['bucketed int8']:.2f} ns an int8 one (W=64) "
        f"-> _EDGE_EQUIV_BYTES {edge_equiv:.1f} (in the source "
        f"{B._EDGE_EQUIV_BYTES}), default_min_edges(256) {min_f32}; "
        f"_BUCKETED_BREAKEVEN_SCALE {scale:.3f} (in the source "
        f"{B._BUCKETED_BREAKEVEN_SCALE}), int8 breakeven "
        f"{per_block['bucketed int8'] / t_edge:.0f} edges")
    return rows, dict(edge_equiv=edge_equiv, scale=scale)


def layout_trainer(x, s, r, y, ell, epochs_seed=0):
    """bench.py's model (DIFFormer-s, hidden 64, 3 layers, dropout 0, 112
    outputs) and ``FullBatchTrainer`` on the graph, with NLL and accuracy
    over 112 classes (bench.py's BCE and ROC-AUC over 112 tasks would put
    a host ROC-AUC of 112 tasks in every loop eval, tens of seconds),
    with ``ell`` (a layout pair, or None for K1)."""
    from difformer_tpu_torch import DIFFormer, FullBatchTrainer, GraphData

    graph = GraphData.from_numpy(x, np.stack([s, r]), device="cuda")
    model = DIFFormer(BENCH_FEATURES, BENCH_HIDDEN, BENCH_CLASSES,
                      num_layers=BENCH_LAYERS, dropout=0.0, seed=3,
                      device="cuda")
    return FullBatchTrainer(model, graph, y, lr=1e-2, weight_decay=0.0,
                            loss="nll", metric="acc", seed=5,
                            model_kwargs=None if ell is None
                            else {"ell": ell}, device="cuda")


def layout_fit(trainer, split, epoch_block):
    """(best, ms per steady epoch, launches) of a LAYOUT_EPOCHS-epoch fit
    with an eval every 5 epochs. For the epoch-block fit the launches add
    the replays to the wrappers' counts, and the steady epoch is a block of
    5 replayed epochs (a step and an eval each) after the fit, on the host
    clock (the median of 3); for the loop, the fit's mean."""
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = trainer.fit(split, epochs=LAYOUT_EPOCHS, eval_step=5,
                       epoch_block=epoch_block)[0]
    torch.cuda.synchronize()
    epoch_ms = 1e3 * (time.perf_counter() - t0) / LAYOUT_EPOCHS
    counted = launch_counts()
    if epoch_block:
        runner = trainer.epoch_runner
        replayed = runner.launches()
        counted = {k: counted[k] + replayed.get(k, 0) for k in counted}

        # at most as many epochs as rows of the runner's record
        epoch_ms = steady_epoch_ms(runner, min(5, LAYOUT_EPOCHS))
    return best, epoch_ms, counted


def layout_path(layout, width):
    """The kernels a layout pair runs at ``width``: K6 for ELL (and its
    combine where a direction's plan splits a bucket); for the
    block-sparse hybrids K7, its combine kernel where ``split_plan`` cuts a
    group of either direction at that width on this card, and K6 where a
    direction has a residual (with its combine where that splits)."""
    from difformer_tpu_torch.kernels import bsr as K7
    from difformer_tpu_torch.ops.ell import EllGraph

    if isinstance(layout[0], EllGraph):
        return ell_path(layout)
    split = any(c > 1 for d in layout for c in K7.split_plan(
        K7.group_shapes(d.groups()), d.tile, width, K7.sm_count("cuda")))
    return BSR_PATH + ((BSR_COMBINE,) if split else ()) + ell_path(
        [d.residual for d in layout if d.residual is not None])


def ell_path(ells):
    """The kernels K6 runs over the ELL directions ``ells``: none, K6, or
    K6 and its combine where a direction's plan splits a bucket."""
    if not ells:
        return ()
    return ELL_PATH + ((ELL_COMBINE,) if any(d.split.partials
                                             for d in ells) else ())


def phase_spmm_layouts():
    """bench.py's three graphs: ``choose_spmm`` with this card's cost model
    prints its election and coverage; the elected layout, built as the
    command line builds it (and, at KERNEL_MIN_EDGES, on the clustered graph
    the padded hybrid with every intra-community tile dense, on the power
    law the degree-sorted bucketed hybrid whose hub row tile K7 splits, so
    the combine kernel runs), trains bench.py's model through the epoch-block
    fit (CUDA graphs) and the per-epoch loop, bit-equal, and against K1's
    graph fit from the same weights within LAYOUT_RTOL; ms per epoch of
    each. Returns the launches of the layouts' graph fits, summed."""
    from difformer_tpu_torch.ops import bsr as B
    from difformer_tpu_torch.ops.ell import build_ell_gcn

    total = {}
    n = BENCH_NODES
    rng = np.random.default_rng(1)
    y = rng.integers(0, BENCH_CLASSES, n)
    perm = rng.permutation(n)
    split = {"train": perm[:n // 2], "valid": perm[n // 2:3 * n // 4],
             "test": perm[3 * n // 4:]}
    for kind in BENCH_GRAPHS:
        x, s, r = bench_graph(kind)
        t0 = time.perf_counter()
        mode, cov = B.choose_spmm(s, r, n, tile=BSR_TILE)
        tiles = np.bincount((r // BSR_TILE).astype(np.int64) * (
            -(-n // BSR_TILE)) + s // BSR_TILE)
        say(f"phase spmm-layouts: {kind}: choose_spmm -> {mode} (dense-tile "
            f"coverage {cov:.3f} at default_min_edges({BSR_TILE}) = "
            f"{B.default_min_edges(BSR_TILE)}; the densest tiles hold "
            f"{int(np.percentile(tiles, 99))} (99th percentile) to "
            f"{int(tiles.max())} edges; {time.perf_counter() - t0:.2f} s)")
        # whatever the cost model elects, the clustered graph's
        # intra-community tiles as dense blocks too, and the power-law
        # graph's degree-sorted bucketed hybrid, whose hub row tile K7
        # splits (KERNEL_MIN_EDGES)
        modes = [mode] + {"clustered": ["bsr dense"],
                          "powerlaw": ["bsr-sorted dense"]}.get(kind, [])
        k1 = None
        for layout_mode in modes:
            sk, rk, xk, yk, split_k = s, r, x, y, split
            t0 = time.perf_counter()
            if layout_mode.startswith("bsr-sorted"):
                # relabelled by degree: the split follows its nodes, so the
                # losses are K1's on the same nodes
                role = np.full(n, len(split))
                for i, key in enumerate(split):
                    role[split[key]] = i
                sk, rk, xk, yk, role = degree_sorted(s, r, n, x, y, role)
                split_k = {key: np.flatnonzero(role == i)
                           for i, key in enumerate(split)}
                layout = B.build_bsr_bucketed_gcn(
                    sk, rk, n, tile=BSR_TILE, min_edges=KERNEL_MIN_EDGES
                    if layout_mode.endswith("dense") else None)
            elif layout_mode == "bsr":
                layout = B.build_bsr_gcn(sk, rk, n, tile=BSR_TILE)
            elif layout_mode == "bsr dense":
                layout = B.build_bsr_gcn(sk, rk, n, tile=BSR_TILE,
                                         min_edges=KERNEL_MIN_EDGES)
            else:
                layout = build_ell_gcn(sk, rk, n)
            build_s = time.perf_counter() - t0
            fits = {}
            runs = [("graph", layout, 5), ("loop", layout, 0)]
            if k1 is None:
                runs.append(("K1 graph", None, 5))
            for label, ell, block in runs:
                gc.collect()
                torch.cuda.empty_cache()
                trainer = layout_trainer(xk, sk, rk, yk, ell)
                fits[label] = layout_fit(trainer, split_k, block)
                del trainer
            k1 = fits.get("K1 graph", k1)
            (g, g_ms, g_n), (lp, lp_ms, lp_n), (k1b, k1_ms, _) = (
                fits["graph"], fits["loop"], k1)
            path = layout_path(layout, BENCH_HIDDEN)
            rel = largest_rel_diff(np.asarray(g["losses"]),
                                   np.asarray(k1b["losses"]))
            say(f"phase spmm-layouts: {kind} ({layout_mode}): built in "
                f"{build_s:.2f} s, device footprint "
                f"{layout_bytes(layout) / 1e6:.2f} MB; losses "
                f"{g['losses'][0]:.6f} -> {g['losses'][-1]:.6f}; graph vs "
                f"loop bit-equal {g['losses'] == lp['losses']}; against K1 "
                f"largest relative difference {rel:.3e}; steady ms per "
                f"epoch (a step and an eval, replayed) {g_ms:.3f} (K1 "
                f"{k1_ms:.3f}; the loop's fit {lp_ms:.3f}); "
                f"best epoch {g['epoch']} valid accuracy {g['valid']:.4f}; "
                f"launches graph {g_n} loop {lp_n}")
            if g["losses"] != lp["losses"] or g["epoch"] != lp["epoch"]:
                raise AssertionError(f"{kind}: the graph fit's losses differ "
                                     f"from the loop's")
            if not rel <= LAYOUT_RTOL:
                raise AssertionError(f"{kind}: {layout_mode} against K1 "
                                     f"differs by {rel:.3e} > {LAYOUT_RTOL}")
            off = {k: v for k, v in g_n.items() if (v > 0) != (k in path)}
            if off:
                raise AssertionError(f"{kind}: launches against the path "
                                     f"{path}: {off}")
            for k in ELL_PATH + (ELL_COMBINE,) + BSR_PATH + (BSR_COMBINE,):
                total[k] = total.get(k, 0) + g_n[k]
            del layout, fits
        gc.collect()
        torch.cuda.empty_cache()
    return total


def phase_cli_layouts(tmp):
    """The command line's other layouts: --spmm bsr, bsr-sorted and auto on
    the cora preset's files, cut to 1 run (of its 500 epochs); --spmm auto on
    bench.py's clustered graph written as a Pokec file (the pokec preset
    full-batch, --use_minibatch false, 20 epochs at lr 0.001: the preset's
    0.01 is its mini-batch rate, at which the full graph does not fit this
    stand-in in 20 epochs), which must elect bsr.
    Returns the launches of the runs, summed."""
    import io

    write_planetoid_cora(tmp)
    base = ["--dataset", "cora", "--data_dir", tmp, "--runs", "1"]
    total = {}
    runs = [(base + ["--spmm", "bsr"], 7, None),
            (base + ["--spmm", "bsr-sorted"], 7, None),
            (base + ["--spmm", "auto"], 7, None)]
    x, s, r = bench_graph("clustered", f=POKEC_FEATURES)
    y = ((np.arange(BENCH_NODES) // 1024) % 2).astype(np.int64)
    x[:, :4] += 3.0 * (2 * y[:, None] - 1)
    pokec_dir = os.path.join(tmp, "clustered")
    write_pokec_mat(pokec_dir, x, np.stack([s, r]), y)
    runs.append((["--dataset", "pokec", "--data_dir", pokec_dir,
                  "--use_minibatch", "false", "--spmm", "auto", "--lr",
                  "0.001", "--epochs", "20", "--runs", "1"], 2, "bsr"))
    for argv, classes, elect in runs:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            run = CliRun("cli-layouts", argv)
        elected = re.search(r"spmm=auto: dense-tile coverage (\S+) -> (\S+)",
                            out.getvalue())
        if elected:
            say(f"phase cli-layouts: {elected[0]}")
        path = run.ell_path()
        if elect is not None and (not elected or elected[2] != elect):
            raise AssertionError(f"{' '.join(argv)} elected "
                                 f"{elected and elected[2]}, expected "
                                 f"{elect}")
        run.check(classes, path)
        run.report()
        for k, v in run.launches.items():
            total[k] = total.get(k, 0) + v
    return total


def repeat_captures(trainer, times=CAPTURE_REPEATS):
    """Capture ``trainer``'s train step on its first batch's layout
    ``times`` times, each in a new runner, while the trainer's packing
    threads pack batches without pause (each pack a new pinned host buffer;
    the host cache emptied now and then where this PyTorch can): the
    situation in which a capture in PyTorch's global mode was once
    invalidated (cudaErrorStreamCaptureInvalidated). Raises on any failure;
    returns (the layout's plan, batches packed meanwhile)."""
    import threading

    from difformer_tpu_torch.data.batching import batch_iterator
    from difformer_tpu_torch.train.graph_level import PACK_WORKERS

    state = trainer.init_state(0)
    generator = torch.Generator(trainer.device).manual_seed(0)
    indices = np.arange(len(trainer.dataset))

    def raw():
        return batch_iterator(trainer.dataset, indices, trainer.batch_size,
                              max_nodes=trainer.max_nodes,
                              max_edges=trainer.max_edges)

    layout, host, _, _ = trainer.pack(next(raw()))
    stop, lock = threading.Event(), threading.Lock()
    packed, errors = [0], []
    empty_cache = getattr(torch._C, "_host_emptyCache", None)

    def pack():
        held = []
        try:
            while not stop.is_set():
                for batch in raw():
                    held.append(trainer.pack(batch)[1])
                    with lock:
                        packed[0] += 1
                    if len(held) > 4:
                        held.clear()
                        if empty_cache is not None:
                            empty_cache()
                    if stop.is_set():
                        break
        except Exception as ex:  # noqa: BLE001 (reported by the caller)
            errors.append(ex)

    threads = [threading.Thread(target=pack, daemon=True)
               for _ in range(PACK_WORKERS)]
    for t in threads:
        t.start()
    try:
        for _ in range(times):
            runner = trainer._runner(state, generator, capture=True)
            runner.load(layout, host)
            runner.run("step", layout)
            torch.cuda.synchronize()
            del runner
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a packing thread did not stop")
    if errors:
        raise errors[0]
    return layout.plan, packed[0]


def phase_capture_repeat(graphs):
    """The repair of the capture invalidated by another thread: the
    actstrack preset's sigmoid trainer (the dense plan) captures its step
    CAPTURE_REPEATS times while its packing threads run."""
    t0 = time.perf_counter()
    trainer = graph_level_trainer(graphs, "sigmoid")
    plan, packed = repeat_captures(trainer)
    say(f"phase capture-repeat: {CAPTURE_REPEATS} captures of the sigmoid "
        f"{plan}-plan step while {packed} batches were packed by the "
        f"packing threads: none invalidated ({time.perf_counter() - t0:.1f} "
        f"s)")
    del trainer


def profile_steps(step, step_ms, phase, steps=5, top=12):
    """Device time by kernel over ``steps`` train steps (torch.profiler),
    and its share of ``step_ms``, the step's time measured without the
    profiler. Only the device's own kernels and copies are summed: the
    CPU-side ranges of the autograd Functions also carry the ctypes-launched
    kernels' time as theirs, and the optimizer's range is mirrored on the
    device as an annotation spanning its kernels. Returns the rows
    (ms per step, launches per step, kernel name), longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3 / steps, e.count // steps,
                    e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        say(f"phase {phase} profile: the profiler saw no device time (not "
            f"measured)")
        return rows
    busy = sum(r[0] for r in rows)
    before = (f" ({HOST_ADAM_LAUNCHES[phase]} with the host-stepped Adam)"
              if phase in HOST_ADAM_LAUNCHES else "")
    say(f"phase {phase} profile: device time {busy:.4f} ms per train step "
        f"over {steps} steps = {100 * busy / step_ms:.1f}% of the "
        f"{step_ms:.3f} ms step (idle {100 * (1 - busy / step_ms):.1f}%), "
        f"{sum(r[1] for r in rows)} launches per step{before}")
    for ms, count, key in rows[:top]:
        say(f"phase {phase} profile: {ms:9.4f} ms/step "
            f"{100 * ms / busy:5.1f}% x{count:<3d} {key[:100]}")
    return rows


def main():
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    spmm_rows, dval_rows = phase_spmm_kernels()
    wide_rows = phase_kernels_wide()
    say(f"phase kernels: done at {time.perf_counter() - t0:.1f} s")
    layout_rows, _ = phase_ell_bsr_kernels()
    say(f"phase ell-bsr-kernels: done at {time.perf_counter() - t0:.1f} s")
    launches = phase_slice()
    launches_s = phase_slice_s()
    phase_slice_s_h8()
    from difformer_tpu_torch.utils.config import make_config

    f32_s = phase_graph("slice-s-graph", make_config("cora"),
                        attention=False)
    f32_a = phase_graph("slice-graph", make_config("cora", kernel="sigmoid"),
                        attention=True)
    say(f"phase graph: done at {time.perf_counter() - t0:.1f} s")
    # phase sharded-a-bsr's rank cases run in the spawns of phases
    # sharded-s (gloo) and distributed (NCCL): two spawns fewer
    a_bsr = sharded_a_bsr_setup()
    say(f"phase sharded-a-bsr: references at {time.perf_counter() - t0:.1f}"
        f" s")
    # and phase dp-tp's, in the same two spawns
    dp_tp = dp_tp_setup()
    say(f"phase dp-tp: references at {time.perf_counter() - t0:.1f} s")
    n_gloo, n_nccl = len(a_bsr["gloo"]), len(a_bsr["nccl"])
    sharded_rows, launches_sharded, eager_ms, gloo_extra = phase_sharded_s(
        a_bsr["gloo"] + dp_tp["gloo"])
    a_bsr_gloo, dp_tp_gloo = gloo_extra[:n_gloo], gloo_extra[n_gloo:]
    say(f"phase sharded-s: done at {time.perf_counter() - t0:.1f} s")
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        dist_rows, launches_dist, nccl_extra = phase_distributed(
            f32_s["ms"]["graph"], eager_ms, tmp,
            a_bsr["nccl"] + dp_tp["nccl"])
    # one NCCL rank: each case's result is that rank's
    a_bsr_nccl = nccl_extra[:n_nccl]
    dp_tp_nccl = [[out] for out in nccl_extra[n_nccl:]]
    say(f"phase distributed: done at {time.perf_counter() - t0:.1f} s")
    tp_rows, launches_tp = phase_dp_tp(dp_tp, dp_tp_nccl, dp_tp_gloo)
    del dp_tp, dp_tp_nccl, dp_tp_gloo
    say(f"phase dp-tp: done at {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        slice_rows, launches_ring, launches_hybrid = phase_sharded_a_bsr(
            tmp, a_bsr, a_bsr_nccl, a_bsr_gloo)
    del a_bsr, a_bsr_nccl, a_bsr_gloo
    say(f"phase sharded-a-bsr: done at {time.perf_counter() - t0:.1f} s")
    launches_bf16 = phase_graph_bf16("slice-s-bf16-graph", make_config("cora"),
                                     False, f32_s)
    phase_graph_bf16("slice-bf16-graph", make_config("cora", kernel="sigmoid"),
                     True, f32_a)
    del f32_s, f32_a
    say(f"phase bf16 graph: done at {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        launches_cli = phase_cli(tmp)
    say(f"phase cli: done at {time.perf_counter() - t0:.1f} s")
    launches_layouts = phase_spmm_layouts()
    say(f"phase spmm-layouts: done at {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli_layouts(tmp)
    say(f"phase cli-layouts: done at {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        launches_set = phase_cli_set(tmp)
    say(f"phase cli-set: done at {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        launches_gat = phase_zoo_cora(tmp)
    say(f"phase zoo-cora: done at {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        launches_gat_cifar = phase_zoo_cifar10(tmp)
    say(f"phase zoo-cifar10: done at {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        launches_mb, chunk_rows, base, split = phase_minibatch_pokec(tmp)
        say(f"phase minibatch-pokec: done at "
            f"{time.perf_counter() - t0:.1f} s")
        launches_zoo, zoo_rows = phase_minibatch_zoo(tmp)
    say(f"phase minibatch-zoo: done at {time.perf_counter() - t0:.1f} s")
    launches_remat, chunk_bf16_rows = phase_minibatch_remat(base, split)
    del base
    say(f"phase minibatch-pokec-remat: done at "
        f"{time.perf_counter() - t0:.1f} s")
    phase_minibatch_proteins()
    say(f"phase minibatch-proteins: done at "
        f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        phase_temporal_all(tmp)
    say(f"phase temporal: done at {time.perf_counter() - t0:.1f} s")
    graphs = actstrack_standin(ACTSTRACK_GRAPHS)
    phase_graph_level(graphs)
    say(f"phase graph-level: done at {time.perf_counter() - t0:.1f} s")
    graph_rows, launches_gl = phase_graph_level_plans(graphs)
    say(f"phase graph-level-plans: done at {time.perf_counter() - t0:.1f} s")
    phase_capture_repeat(graphs)
    del graphs
    say(f"phase capture-repeat: done at {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli_actstrack(tmp)
    say(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    # every ms, plain_ms and library_ms is a device time at the slice's
    # shape (K1 also at Pokec's and a Pokec chunk's): the profiler's sum
    # (device_ms), for the chunk's rows CUDA events (phase_spmm_chunk)
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": row["max_abs_err"], "ms": row["ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": None}
        for name, row in rows.items()
    ] + [
        # K1 on the main path, DIFFormer-s, at the slice's graph and at
        # Pokec's size; launches are the main path's, at f32 and, for the
        # bf16 rows, at compute_dtype="bfloat16" (the slice-s-bf16-graph
        # phase: captured x replays)
        {"name": name, "route": "cuda", "source": SPMM_SOURCE,
         "replaces": SPMM_REPLACES,
         "launches": (launches_bf16 if name.endswith(" bf16")
                      else launches_s)[name.split()[0]],
         **row}
        for name, row in spmm_rows.items()
    ] + [
        # K2-K4 on their wide path at the set track's shape; launches are
        # the cli-set phase's run with --kernel sigmoid (hidden 300)
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name.split()[0]],
         "launches": launches_set[name.split()[0]], **row}
        for name, row in wide_rows.items()
    ] + [
        # K1 through the mini-batch trainer's capacity launch on its Pokec
        # chunk with the most segments; launches are the minibatch-pokec
        # phase's (warm-up, capture and the eager evals, plus the replays)
        {"name": name, "route": "cuda", "source": SPMM_SOURCE,
         "replaces": SPMM_REPLACES,
         "launches": launches_mb[name.split()[0]], **row}
        for name, row in chunk_rows.items()
    ] + [
        # K1 on GCN's self-looped chunk plan and K1-dval on GAT's, packed
        # at capacity by the mini-batch trainer of the zoo's pokec runs;
        # launches are the minibatch-zoo phase's GCN run's (K1) and GAT
        # run's (K1-dval): wrappers (warm-up, capture, eager evals) plus
        # the replays
        {"name": name, "route": "cuda", "source": SPMM_SOURCE,
         "replaces": (DVAL_REPLACES if name.startswith(DVAL_NAME)
                      else SPMM_REPLACES),
         "launches": launches_zoo["gat" if name.startswith(DVAL_NAME)
                                  else "gcn"][name.split()[0]], **row}
        for name, row in zoo_rows.items()
    ] + [
        # the same at bf16 on the minibatch-pokec-remat phase's trainer;
        # launches are that phase's remat run's
        {"name": name, "route": "cuda", "source": SPMM_SOURCE,
         "replaces": SPMM_REPLACES,
         "launches": launches_remat[name.split()[0]], **row}
        for name, row in chunk_bf16_rows.items()
    ] + [
        # K1 on a graph-level batch (1024 actstrack-shaped graphs, the
        # edge-list plan at capacity); launches are the graph-level-plans
        # phase's epoch on that plan (captured x replays)
        {"name": name, "route": "cuda", "source": SPMM_SOURCE,
         "replaces": SPMM_REPLACES,
         "launches": launches_gl[name.split()[0]], **row}
        for name, row in graph_rows.items()
    ]
    kernels += [
        # K1 on the rectangular plan of the halo exchange (rank 1 of the
        # slice's graph cut 4 ways: N_loc rows over [own ‖ halo]); launches
        # are the sharded-s phase's 4-rank halo run's, summed over its
        # ranks (the pack's product and the conv's, each way)
        {"name": name, "route": "cuda", "source": SPMM_SOURCE,
         "replaces": SPMM_REPLACES,
         "launches": launches_sharded[name.split()[0]], **row}
        for name, row in sharded_rows.items()
    ]
    kernels += [
        # K1 on the NCCL rank's internal plan (the distributed trainer at
        # one rank, the cora preset); launches are the distributed phase's
        # captured fit at the preset's dropout (captured x replays)
        {"name": name, "route": "cuda", "source": SPMM_SOURCE,
         "replaces": SPMM_REPLACES,
         "launches": launches_dist[name.split()[0]], **row}
        for name, row in dist_rows.items()
    ]
    kernels += [
        # K2-K4 at one ring step of the cora preset cut in two (the ring's
        # unnormalized K2); launches are the sharded-a-bsr phase's captured
        # ring fit at one NCCL rank (captured x replays)
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name.split()[0]],
         "launches": launches_ring[name.split()[0]], **row}
        for name, row in slice_rows.items() if name.endswith(RING_JSON)
    ] + [
        # K7 on a rank's shard of bench.py's clustered graph (cut in two,
        # and whole at one rank); launches are the sharded-a-bsr phase's
        # captured spmm="bsr" fit at one NCCL rank
        {"name": name, "route": "cuda", "source": BSR_SOURCE,
         "replaces": BSR_SHARD_REPLACES,
         "launches": launches_hybrid[name.split()[0]], **row}
        for name, row in slice_rows.items() if not name.endswith(RING_JSON)
    ]
    kernels += [
        # K2-K4 at a tensor-parallel rank's shape (the cora preset at 8
        # heads on 2 ranks: H = 4 a rank); launches are the dp-tp phase's
        # T = 2 DIFFormer-a run's, summed over its 2 ranks
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name.split()[0]],
         "launches": launches_tp[name.split()[0]], **row}
        for name, row in tp_rows.items()
    ]
    kernels += [
        # K1-dval at GAT's shapes on the slice's graph and on cifar10's kNN
        # graph, and at Pokec's size; launches are the zoo-cora phase's GAT
        # run's (wrappers and replays; the cifar10 row zoo-cifar10's)
        {"name": name, "route": "cuda", "source": SPMM_SOURCE,
         "replaces": DVAL_REPLACES,
         "launches": (launches_gat_cifar if name.endswith(" cifar10")
                      else launches_gat)[DVAL_NAME], **row}
        for name, row in dval_rows.items()
    ]
    kernels += [
        # K6 at the cora preset's graph (W = 64 and the spmm_first 65) and
        # bench.py's three graphs (W = 64), K7 on bench.py's clustered
        # graph (T = 256 padded float32, bfloat16 blocks and bucketed int8
        # counts; T = 128; W = 65 and 300) and on its degree-sorted power
        # law's bucketed int8 counts (the hub row tile split, and the
        # combine kernel), f32 and bf16 x; K6's combine (K1's
        # csr_spmm_combine) on the power law's split hub buckets. Launches:
        # the cora rows the cli phase's main run's (the cora preset on its
        # default ELL layout), the others the spmm-layouts phase's fits
        # (wrappers and replays)
        {"name": name, "route": "cuda",
         "source": (BSR_SOURCE if name.startswith("bsr") else SPMM_SOURCE
                    if name.startswith(ELL_COMBINE) else ELL_SOURCE),
         "replaces": (BSR_REPLACES["bucketed" if " int8" in name
                                   else "padded"]
                      if name.startswith("bsr") else ELL_REPLACES),
         "launches": (launches_cli if name.startswith("ell")
                      and name.split()[1:] in ([], ["bf16"])
                      else launches_layouts)[name.split()[0]],
         **row}
        for name, row in layout_rows.items()
    ]
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
