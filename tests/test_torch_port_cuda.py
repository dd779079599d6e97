"""The port's CUDA kernels on the GPU, against their plain versions.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one:
a CUDA kernel has no CPU mode. The file imports no JAX, so it runs on a GPU
machine without it:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -p no:cacheprovider

Tolerances: each kernel against its plain version under the one rule of
``difformer_tpu_torch/kernels/tolerance.py`` (float32 at the JAX package's
own tolerances, the unnormalized numerator per unit of its row's
denominator, bfloat16 relative to the largest reference value, the CSR
SpMM K1 and its value gradient K1-dval at the forward's float32
tolerance); the model's logits and gradients rtol 1e-3 / atol 1e-4 (layers
of kernel-vs-plain float32 rounding). The baseline zoo (``-k zoo``) on the
card against the CPU, its graph fits against the loop, BatchNorm's
statistics across the capture, and K1-dval (``-k dval``) alone (every
head in one launch, on strided head views, with its rows split) and
through ``spmm``'s value gradient. The sparse layouts (``-k "ell or
bsr"``; K7's combine alone ``-k combine``): K6 and
K7 against their plain versions under the "spmm" rule, one kernel a call
(two where a split plan cuts K6's hub bucket or K7's hub row tile, the
second its combine), two calls bit-equal, K6's split hub captured and
replayed, its padding never read, K7 at every width, tile and block type, on a split hub
bucket and on strided x, and the epoch-block fit on each layout bit-equal to
the loop; the graph-level capture repeated while the packing threads allocate
(``-k repeated``). The ring sigmoid attention and the node-sharded hybrid
(``-k "rectangular_shard or ring or hybrid"``): K7 on a rank's rectangular
shard against its plain version, the ring's exchange captured under NCCL
and on gloo ranks sharing the card, the ring and the hybrid trained at one
NCCL rank and on 2 gloo ranks against the unsharded steps, and the
distributed trainer's captured fit with both.
"""

import dataclasses

import numpy as np
import pytest
import torch

from difformer_tpu_torch import DIFFormer, FullBatchTrainer, GraphData
from difformer_tpu_torch.data import random_graph, standard_preprocess
from difformer_tpu_torch.kernels import sigmoid_attention as K
from difformer_tpu_torch.kernels import spmm as K1
from difformer_tpu_torch.kernels.tolerance import assert_close
from difformer_tpu_torch.ops.graph_ops import build_csr_plan, gcn_conv
from torch_port_helpers import RowLog, cuda, make_inputs  # noqa: F401
from torch_port_helpers import to_torch as _t

GRAD = dict(rtol=1e-3, atol=1e-4)
SHAPES = [
    ((300, 300, 1, 64, 64), False),
    ((200, 333, 2, 32, 48), True),
    ((150, 90, 3, 100, 120), True),
    ((70, 65, 1, 256, 200), False),
    ((1024, 3000, 1, 64, 64), True),  # L in the thousands: num scales by den
    ((64, 5000, 1, 64, 64), False),  # one query tile: K2 splits the keys 79 ways
    ((5000, 64, 1, 64, 64), False),  # one key tile: K4 splits the queries 79 ways
]


def _plan(cuda, name, n, l, h, m=64, d=64):
    """(blocks of one split, S, loop tiles per split) of kernel ``name``."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    return K.split_plan(name, n, l, h, m, d, sms)


def _on(cuda, dtype, q, k, v, mask):
    return [_t(a, dtype).to(cuda) for a in (q, k, v)] + [
        None if mask is None else _t(mask).to(cuda)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("shape,masked", SHAPES)
def test_fwd_kernel_matches_plain(cuda, shape, masked, normalize, dtype):
    n, l, h, m, d = shape
    args = _on(cuda, dtype, *make_inputs(6, n, l, h, m=m, d=d, masked=masked))
    K.reset_launch_counts()
    out, den = K.sigmoid_attention_fwd(*args, normalize=normalize)
    torch.cuda.synchronize()
    assert K.LAUNCHES["sigmoid_attention_fwd"] == 1
    ref_out, ref_den = K.sigmoid_attention_fwd_plain(*args,
                                                     normalize=normalize)
    if normalize:
        assert_close("out", out, ref_out, "out")
    else:
        assert_close("num", out, ref_out, "num", den=ref_den)
    assert_close("den", den, ref_den, "den")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,masked", SHAPES)
def test_bwd_kernels_match_plain(cuda, shape, masked, dtype):
    n, l, h, m, d = shape
    args = _on(cuda, dtype, *make_inputs(19, n, l, h, m=m, d=d,
                                         masked=masked))
    rng = np.random.default_rng(20)
    dnum = torch.from_numpy(rng.normal(size=(n, h, d)).astype(np.float32))
    dden = torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32))
    args += [dnum.to(cuda), dden.to(cuda)]
    K.reset_launch_counts()
    got = (K.sigmoid_attention_dq(*args), *K.sigmoid_attention_dkv(*args))
    torch.cuda.synchronize()
    assert K.LAUNCHES["sigmoid_attention_dq"] == 1
    assert K.LAUNCHES["sigmoid_attention_dkv"] == 1
    ref = (K.sigmoid_attention_dq_plain(*args),
           *K.sigmoid_attention_dkv_plain(*args))
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert_close(name, g, r, "grad")


@pytest.mark.cuda
def test_strided_and_broadcast_inputs(cuda):
    """The kernels read [N,H,M] through strides: a transposed view and a
    value head broadcast with stride 0 need no copy."""
    q, k, v, mask = make_inputs(21, 128, 96, 2, m=32, d=32, masked=True)
    qc, kc, vc, mc = _on(cuda, torch.float32, q, k, v, mask)
    q_view = qc.transpose(0, 1).contiguous().transpose(0, 1)  # [N,H,M] view
    v_bcast = vc[:, :1].expand(-1, 2, -1)
    assert _plan(cuda, "sigmoid_attention_fwd", 128, 96, 2)[1] > 1  # combine
    out, den = K.sigmoid_attention_fwd(q_view, kc, v_bcast, mc)
    ref, ref_den = K.sigmoid_attention_fwd_plain(q_view, kc, v_bcast, mc)
    assert_close("out", out, ref, "out")
    assert_close("den", den, ref_den, "den")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("normalize", [True, False])
def test_fwd_split_chunk_fully_masked(cuda, normalize, dtype):
    """A key chunk whose keys are all masked adds exact zeros to every
    row; the other chunks' keys still count."""
    n, l, h = 64, 2000, 1
    _, splits, chunk = _plan(cuda, "sigmoid_attention_fwd", n, l, h)
    assert splits > 2
    q, k, v, mask = make_inputs(23, n, l, h, m=64, d=64, masked=True)
    lo, hi = chunk * K.TILE, 2 * chunk * K.TILE
    mask[lo:hi] = 0.0  # the whole second chunk
    args = _on(cuda, dtype, q, k, v, mask)
    out, den = K.sigmoid_attention_fwd(*args, normalize=normalize)
    ref_out, ref_den = K.sigmoid_attention_fwd_plain(*args,
                                                     normalize=normalize)
    kind, ref_scale = ("out", None) if normalize else ("num", ref_den)
    assert_close("out", out, ref_out, kind, den=ref_scale)
    assert_close("den", den, ref_den, "den")
    # the same keys dropped from the problem give the same result
    keep = torch.ones(l, dtype=torch.bool)
    keep[lo:hi] = False
    cut = [a[keep.to(cuda)] for a in args[1:]]
    out_cut, den_cut = K.sigmoid_attention_fwd(args[0], *cut,
                                               normalize=normalize)
    assert_close("out", out, out_cut.to(out.dtype), kind, den=ref_scale)
    assert_close("den", den, den_cut, "den")


def _cotangents(cuda, seed, args, d):
    """dnum, dden as the normalized op's backward derives them (g/den)."""
    n, h = args[0].shape[:2]
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.normal(size=(n, h, d)).astype(np.float32))
    out, den = K.sigmoid_attention_fwd_plain(*args)
    g = g.to(cuda)
    return [g / den[..., None], -(g * out.float()).sum(-1) / den]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dq_split_chunk_fully_masked(cuda, dtype):
    """A key chunk of dq's split whose keys are all masked adds exact zeros
    to dq; the other chunks' keys still count."""
    n, l, h = 64, 2000, 1
    _, splits, chunk = _plan(cuda, "sigmoid_attention_dq", n, l, h)
    assert splits > 2
    q, k, v, mask = make_inputs(27, n, l, h, m=64, d=64, masked=True)
    lo, hi = chunk * K.TILE, 2 * chunk * K.TILE
    mask[lo:hi] = 0.0  # the whole second chunk
    args = _on(cuda, dtype, q, k, v, mask)
    grads = _cotangents(cuda, 28, args, 64)
    dq = K.sigmoid_attention_dq(*args, *grads)
    assert_close("dq", dq, K.sigmoid_attention_dq_plain(*args, *grads),
                 "grad")
    # the same keys dropped from the problem give the same dq
    keep = torch.ones(l, dtype=torch.bool)
    keep[lo:hi] = False
    cut = [a[keep.to(cuda)] for a in args[1:]]
    assert_close("dq", dq, K.sigmoid_attention_dq(args[0], *cut, *grads),
                 "grad")


@pytest.mark.cuda
@pytest.mark.parametrize("n,l,h", [(64, 5000, 1), (2708, 2708, 1),
                                   (19717, 2000, 1)])
def test_fwd_is_deterministic_and_counts_one_launch(cuda, n, l, h):
    """Two calls give bit-equal out and den (the partials of the key split
    are summed in a fixed order, without atomics), and each call counts one
    launch, with the combine or without it."""
    args = _on(cuda, torch.float32, *make_inputs(24, n, l, h, m=64, d=64,
                                                 masked=True))
    K.reset_launch_counts()
    first = K.sigmoid_attention_fwd(*args)
    second = K.sigmoid_attention_fwd(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["sigmoid_attention_fwd"] == 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    num = K.sigmoid_attention_fwd(*args, normalize=False)[0]
    assert torch.equal(num, K.sigmoid_attention_fwd(*args,
                                                    normalize=False)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n,l,h", [(64, 5000, 1), (5000, 64, 1),
                                   (2708, 2708, 1), (19717, 2000, 1),
                                   (2000, 19717, 1)])
def test_bwd_is_deterministic_and_counts_one_launch(cuda, n, l, h):
    """Two calls give bit-equal dq, dk and dv (the partials of the key split
    of dq and of the query split of dk/dv are summed in a fixed order,
    without atomics), and each call counts one launch, with the combine or
    without it; the shapes take both. The cotangents are those the
    normalized op's backward derives (dnum = g/den), as in the model: unit
    ones would sum over N = 19717 queries past the float32 gradient
    tolerance's absolute limit in any order."""
    args = _on(cuda, torch.float32, *make_inputs(25, n, l, h, m=64, d=64,
                                                 masked=True))
    args += _cotangents(cuda, 26, args, 64)
    K.reset_launch_counts()
    first = (K.sigmoid_attention_dq(*args), *K.sigmoid_attention_dkv(*args))
    second = (K.sigmoid_attention_dq(*args), *K.sigmoid_attention_dkv(*args))
    torch.cuda.synchronize()
    assert K.LAUNCHES["sigmoid_attention_dq"] == 2
    assert K.LAUNCHES["sigmoid_attention_dkv"] == 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    ref = (K.sigmoid_attention_dq_plain(*args),
           *K.sigmoid_attention_dkv_plain(*args))
    for name, g, r in zip(("dq", "dk", "dv"), first, ref):
        assert_close(name, g, r, "grad")


@pytest.mark.cuda
def test_autograd_function_matches_cpu(cuda):
    q, k, v, mask = make_inputs(22, 257, 300, 2, masked=True)
    t = torch.randn((257, 2, 16), generator=torch.Generator().manual_seed(0))

    def grads(device):
        qs, ks, vs = (_t(a).to(device).requires_grad_() for a in (q, k, v))
        out = K.sigmoid_attention_flash(qs, ks, vs, _t(mask).to(device))
        ((out - t.to(device)) ** 2).sum().backward()
        return [x.detach().cpu() for x in (out, qs.grad, ks.grad, vs.grad)]

    for g, c in zip(grads(cuda), grads("cpu")):
        torch.testing.assert_close(g, c, **GRAD)


def _model_and_graph(device):
    x, ei, y = random_graph(500, 2000, 32, 5, seed=1, homophily=0.7)
    ei = standard_preprocess(ei, 500)
    model = DIFFormer(32, 64, 5, num_layers=3, num_heads=2, kernel="sigmoid",
                      dropout=0.0, graph_weight=0.7, seed=5, device=device)
    return model, GraphData.from_numpy(x, ei, device=device), y


@pytest.mark.cuda
def test_model_logits_and_grads_match_cpu(cuda):
    results = []
    for device in (cuda, "cpu"):
        model, g, _ = _model_and_graph(device)
        K.reset_launch_counts()
        out = model(g.node_feat, g.senders, g.receivers)
        out.square().sum().backward()
        results.append((out.detach().cpu(),
                        {n: p.grad.cpu() for n, p in model.named_parameters()},
                        dict(K.LAUNCHES)))
    (out_g, grads_g, launches), (out_c, grads_c, _) = results
    assert launches == {"sigmoid_attention_fwd": 3, "sigmoid_attention_dq": 3,
                        "sigmoid_attention_dkv": 3}
    torch.testing.assert_close(out_g, out_c, **GRAD)
    for name in grads_c:
        torch.testing.assert_close(grads_g[name], grads_c[name], **GRAD,
                                   msg=name)


@pytest.mark.cuda
def test_trainer_steps_match_cpu(cuda):
    losses = []
    for device in (cuda, "cpu"):
        model, g, y = _model_and_graph(device)
        trainer = FullBatchTrainer(model, g, y, lr=1e-3, weight_decay=0.01,
                                   device=device)
        state = trainer.init_state(0)
        mask = torch.zeros(500, dtype=torch.bool, device=device)
        mask[:100] = True
        run = []
        for _ in range(3):
            state, loss = trainer.train_step(state, None, mask)
            run.append(loss.item())
        losses.append(run)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-3, atol=1e-4)


# --- K1, the CSR SpMM of the GCN branch -------------------------------------

def _spmm_graph(kind):
    """(senders, receivers, N, edge_weight, edge_mask) as numpy: the
    synthetic graphs of Cora's and PubMed's size that chip_smoke.py uses,
    a ragged one (unsorted edges, weights, a mask, rows empty in both
    CSRs), or one with power-law in- and out-degrees whose hubs hold a few
    thousand edges (rank floor(n·u²) over shuffled ids, as chip_smoke.py's
    graph of Pokec's size), so K1 splits rows in both directions."""
    if kind == "hubs":
        rng = np.random.default_rng(9)
        n, e = 10000, 300000
        nodes = lambda: rng.permutation(n)[np.minimum(  # noqa: E731
            (n * rng.random(e) ** 2).astype(np.int64), n - 1)]
        return nodes(), nodes(), n, None, None
    if kind == "ragged":
        rng = np.random.default_rng(5)
        n, e = 1000, 6000
        return (rng.integers(0, 950, e), rng.integers(0, 900, e), n,
                rng.uniform(0.2, 2.0, e).astype(np.float32),
                rng.random(e) > 0.2)
    n, e, f = (2708, 10556, 1433) if kind == "cora" else (19717, 44324, 500)
    _, ei, _ = random_graph(n, e, f, 7, seed=42, homophily=0.8)
    ei = standard_preprocess(ei, n)
    return ei[0], ei[1], n, None, None


def _spmm_plan(cuda, kind):
    s, r, n, w, mask = _spmm_graph(kind)
    t = lambda a: None if a is None else torch.as_tensor(a).to(cuda)
    return build_csr_plan(t(s), t(r), n, t(w), t(mask))


SPMM_SHAPES = [("cora", 64), ("cora", 65), ("cora", 512), ("cora", 1),
               ("cora", 6), ("ragged", 48), ("pubmed", 64), ("hubs", 1),
               ("hubs", 6), ("hubs", 64), ("hubs", 65), ("hubs", 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,width", SPMM_SHAPES)
def test_spmm_kernel_matches_plain(cuda, kind, width):
    """Forward and transposed CSR, float4 rows (W % 4 == 0) and scalar
    ones (W = 1, 6, 65), with heavy rows split into segments on the hubs
    graph, each call counted once."""
    plan = _spmm_plan(cuda, kind)
    heavy = (plan.split.num_heavy, plan.t_split.num_heavy)
    assert all(heavy) if kind == "hubs" else not any(heavy)
    x = torch.randn((plan.num_nodes, width),
                    generator=torch.Generator().manual_seed(width)).to(cuda)
    K1.reset_launch_counts()
    for name, csr, split in (
            ("csr_spmm", (plan.row_ptr, plan.col, plan.val), plan.split),
            ("csr_spmm_transposed", (plan.t_row_ptr, plan.t_col, plan.t_val),
             plan.t_split)):
        out = K1.csr_spmm(x, *csr, split=split,
                          transposed=name != "csr_spmm")
        torch.cuda.synchronize()
        assert_close(name, out, K1.csr_spmm_plain(x, *csr), "spmm",
                     scale=K1.csr_spmm_abs(x, *csr))
    assert K1.LAUNCHES == {"csr_spmm": 1, "csr_spmm_transposed": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ragged", "hubs"])
def test_spmm_reads_strided_and_offset_inputs(cuda, kind):
    """Strided views are copied to rows; a contiguous view that starts 4
    bytes in (no 16-byte alignment) takes the scalar loads at W = 64."""
    plan = _spmm_plan(cuda, kind)
    n = plan.num_nodes
    base = torch.randn((n, 65), device=cuda)
    offset = torch.randn(n * 64 + 1, device=cuda)[1:].view(n, 64)
    assert offset.is_contiguous() and offset.data_ptr() % 16 != 0
    csr = (plan.row_ptr, plan.col, plan.val)
    for x in (base[:, 1:], base.t().contiguous().t()[:, :64], offset):
        assert_close("strided", K1.csr_spmm(x, *csr, split=plan.split),
                     K1.csr_spmm_plain(x, *csr), "spmm",
                     scale=K1.csr_spmm_abs(x, *csr))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cora", "ragged", "hubs"])
def test_spmm_is_deterministic(cuda, kind):
    """Each row is summed in CSR order, a heavy row by segments combined in
    segment order, without atomics: two calls are bit-equal."""
    plan = _spmm_plan(cuda, kind)
    x = torch.randn((plan.num_nodes, 64), device=cuda)
    for *csr, split in ((plan.row_ptr, plan.col, plan.val, plan.split),
                        (plan.t_row_ptr, plan.t_col, plan.t_val,
                         plan.t_split)):
        assert torch.equal(K1.csr_spmm(x, *csr, split=split),
                           K1.csr_spmm(x, *csr, split=split))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cora", "hubs"])
def test_spmm_launches_the_combine_only_with_heavy_rows(cuda, kind):
    """One device kernel a call without heavy rows, two with them (the
    segments' combine), whichever the wrapper counts as one call; the
    same schedule is built when the caller passes none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plan = _spmm_plan(cuda, kind)
    x = torch.randn((plan.num_nodes, 64), device=cuda)
    csr = (plan.row_ptr, plan.col, plan.val)
    K1.csr_spmm(x, *csr, split=plan.split)
    torch.cuda.synchronize()
    K1.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = K1.csr_spmm(x, *csr, split=plan.split)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    assert kernels == (2 if kind == "hubs" else 1)
    assert K1.LAUNCHES == {"csr_spmm": 1, "csr_spmm_transposed": 0}
    assert torch.equal(K1.csr_spmm(x, *csr), out)


@pytest.mark.cuda
def test_spmm_is_captured_by_a_cuda_graph(cuda):
    """Given its plan's schedule, K1 reads nothing back from the device
    (a host sync would fail the capture), so a CUDA graph holds both of its
    kernels; replays match a direct call bit for bit."""
    plan = _spmm_plan(cuda, "hubs")
    x = torch.randn((plan.num_nodes, 64), device=cuda)
    csr = (plan.row_ptr, plan.col, plan.val)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K1.csr_spmm(x, *csr, split=plan.split)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K1.csr_spmm(x, *csr, split=plan.split)
    for scale in (1.0, -2.0):
        x.mul_(scale)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, K1.csr_spmm(x, *csr, split=plan.split))


@pytest.mark.cuda
def test_spmm_zero_edges_launch_nothing(cuda):
    empty = torch.zeros(0, dtype=torch.long, device=cuda)
    x = torch.randn((5, 3), device=cuda, requires_grad=True)
    K1.reset_launch_counts()
    out = gcn_conv(x, empty, empty)
    out.sum().backward()
    assert not out.any() and not x.grad.any()
    assert K1.LAUNCHES == {"csr_spmm": 0, "csr_spmm_transposed": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ragged", "hubs"])
@pytest.mark.parametrize("trailing", [(64,), (8, 64), (65,)])
def test_gcn_conv_backward_matches_autograd_through_plain(cuda, trailing,
                                                          kind):
    """The backward's transposed CSR on the card against the CPU, where
    the same autograd Function runs the plain version."""
    s, r, n, w, mask = _spmm_graph(kind)
    x = torch.randn((n,) + trailing,
                    generator=torch.Generator().manual_seed(1))
    cot = torch.randn((n,) + trailing,
                      generator=torch.Generator().manual_seed(2))
    results = []
    for device in (cuda, "cpu"):
        t = lambda a: None if a is None else torch.as_tensor(a).to(device)
        xs = x.to(device).requires_grad_()
        K1.reset_launch_counts()
        out = gcn_conv(xs, t(s), t(r), t(w), edge_mask=t(mask))
        out.backward(cot.to(device))
        results.append((out.detach().cpu(), xs.grad.cpu(), dict(K1.LAUNCHES)))
    (out_g, dx_g, launches), (out_c, dx_c, _) = results
    assert launches == {"csr_spmm": 1, "csr_spmm_transposed": 1}
    plan = _spmm_plan("cpu", kind)
    flat = lambda a: a.reshape(n, -1)
    scale_out = K1.csr_spmm_abs(flat(x), plan.row_ptr, plan.col, plan.val)
    scale_dx = K1.csr_spmm_abs(flat(cot), plan.t_row_ptr, plan.t_col,
                               plan.t_val)
    assert_close("out", out_g, out_c, "spmm",
                 scale=scale_out.reshape(out_c.shape))
    assert_close("dx", dx_g, dx_c, "spmm", scale=scale_dx.reshape(dx_c.shape))


def _simple_model_and_graph(device, heads, **flags):
    x, ei, y = random_graph(500, 2000, 32, 5, seed=1, homophily=0.7)
    ei = standard_preprocess(ei, 500)
    model = DIFFormer(32, 64, 5, num_layers=3, num_heads=heads,
                      kernel="simple", dropout=0.0, seed=5, device=device,
                      **flags)
    return model, GraphData.from_numpy(x, ei, device=device), y


@pytest.mark.cuda
@pytest.mark.parametrize("heads,flags", [(1, {}), (8, {"spmm_first": "auto"}),
                                         (2, {"fuse_head_mean": False})])
def test_simple_model_logits_and_grads_match_cpu(cuda, heads, flags):
    """DIFFormer-s through K1 on the card against the CPU; every layer
    launches K1 once forward and once transposed."""
    results = []
    for device in (cuda, "cpu"):
        model, g, _ = _simple_model_and_graph(device, heads, **flags)
        K1.reset_launch_counts()
        out = model(g.node_feat, g.senders, g.receivers, plan=g.csr_plan())
        out.square().sum().backward()
        results.append((out.detach().cpu(),
                        {n: p.grad.cpu() for n, p in model.named_parameters()},
                        dict(K1.LAUNCHES)))
    (out_g, grads_g, launches), (out_c, grads_c, _) = results
    assert launches == {"csr_spmm": 3, "csr_spmm_transposed": 3}
    torch.testing.assert_close(out_g, out_c, **GRAD)
    for name in grads_c:
        torch.testing.assert_close(grads_g[name], grads_c[name], **GRAD,
                                   msg=name)


@pytest.mark.cuda
def test_simple_trainer_steps_match_cpu(cuda):
    losses = []
    for device in (cuda, "cpu"):
        model, g, y = _simple_model_and_graph(device, 1)
        trainer = FullBatchTrainer(model, g, y, lr=1e-3, weight_decay=0.01,
                                   device=device)
        state = trainer.init_state(0)
        mask = torch.zeros(500, dtype=torch.bool, device=device)
        mask[:100] = True
        run = []
        for _ in range(3):
            state, loss = trainer.train_step(state, None, mask)
            run.append(loss.item())
        losses.append(run)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-3, atol=1e-4)


# --- CUDA graphs: the kernels, the model and the epoch-block fit -----------

ATTENTION_CALLS = {
    "fwd": lambda args, grads: K.sigmoid_attention_fwd(*args),
    "fwd-unnormalized": lambda args, grads: K.sigmoid_attention_fwd(
        *args, normalize=False),
    "dq": lambda args, grads: (K.sigmoid_attention_dq(*args, *grads),),
    "dkv": lambda args, grads: K.sigmoid_attention_dkv(*args, *grads),
}


@pytest.mark.cuda
@pytest.mark.parametrize("call,n,l", [
    ("fwd", 64, 5000), ("fwd-unnormalized", 64, 5000), ("dq", 64, 5000),
    ("dkv", 5000, 64), ("fwd", 2708, 2708), ("dq", 2708, 2708),
    ("dkv", 2708, 2708)])
def test_attention_kernels_are_captured_by_a_cuda_graph(cuda, call, n, l):
    """K2–K4 read nothing back from the device and allocate only through
    torch, so a CUDA graph holds each with its combine (the shapes split
    the loop axis, S > 1); replays match a direct call bit for bit, and the
    wrapper counts the kernel once, at the capture."""
    name = {"fwd": "sigmoid_attention_fwd", "dq": "sigmoid_attention_dq",
            "dkv": "sigmoid_attention_dkv"}[call.split("-")[0]]
    assert _plan(cuda, name, n, l, 1)[1] > 1
    args = _on(cuda, torch.float32, *make_inputs(29, n, l, 1, m=64, d=64,
                                                 masked=True))
    grads = _cotangents(cuda, 30, args, 64)
    run = lambda: ATTENTION_CALLS[call](args, grads)  # noqa: E731
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    K.reset_launch_counts()
    with torch.cuda.graph(graph):
        out = run()
    assert K.LAUNCHES[name] == 1
    for scale in (1.0, -0.5):
        args[0].mul_(scale)
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(out, run()):
            assert torch.equal(got, want)


def _trainer_on(device, kernel, dropout=0.2, layers=3):
    """A small trainer of ``kernel`` with dropout on, and a split."""
    from difformer_tpu_torch.data import class_rand_splits

    x, ei, y = random_graph(500, 2000, 32, 5, seed=1, homophily=0.7)
    ei = standard_preprocess(ei, 500)
    model = DIFFormer(32, 64, 5, num_layers=layers, num_heads=1,
                      kernel=kernel, dropout=dropout, seed=5, device=device)
    trainer = FullBatchTrainer(model, GraphData.from_numpy(x, ei,
                                                           device=device),
                               y, lr=1e-3, weight_decay=0.01, device=device)
    return trainer, class_rand_splits(y, 20, valid_num=100, test_num=200,
                                      rng=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["simple", "sigmoid"])
def test_model_forward_is_captured_by_a_cuda_graph(cuda, kernel):
    """DIFFormer-s and DIFFormer-a's eval forward in a CUDA graph: nothing
    on the path copies from the host (the linear attention fills its key
    count and query count in on the device), and replays match eager."""
    trainer, _ = _trainer_on(cuda, kernel)
    state = trainer.init_state(0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        trainer.forward_eval(state)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = trainer.forward_eval(state)
    for _ in range(2):
        with torch.no_grad():
            for p in state.model.parameters():
                p.mul_(0.9)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, trainer.forward_eval(state))


@pytest.mark.cuda
def test_dropout_replays_draw_new_masks_as_eager_calls_do(cuda):
    """With its generator registered, each replay of a captured dropout
    draws the next masks: two replays differ, and the replays' stream is
    the stream of eager calls from the same seed."""
    from difformer_tpu_torch.nn.common import dropout

    x = torch.ones(4096, device=cuda)
    gen = torch.Generator(cuda).manual_seed(3)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        out = dropout(x, 0.5, True, gen)
    replays = []
    for _ in range(3):
        graph.replay()
        replays.append(out.clone())
    assert not torch.equal(replays[0], replays[1])
    eager_gen = torch.Generator(cuda).manual_seed(3)
    for got in replays:
        assert torch.equal(got, dropout(x, 0.5, True, eager_gen))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["simple", "sigmoid"])
def test_captured_train_steps_match_eager_steps(cuda, kernel):
    """The step graph of the epoch-block fit against eager train steps of
    an identical trainer from the same dropout seed: the same losses and
    weights, so every replay advanced the dropout stream as eager steps
    do and the warm-up before the capture left no trace."""
    from difformer_tpu_torch.train.trainer import EpochRunner, idx_to_mask

    results = []
    for graphed in (True, False):
        trainer, split = _trainer_on(cuda, kernel)
        state = trainer.init_state(0)
        gen = torch.Generator(cuda).manual_seed(11)
        mask = torch.as_tensor(idx_to_mask(split["train"], 500), device=cuda)
        if graphed:
            masks = torch.stack([mask] * 3)
            runner = EpochRunner(trainer, state, gen, mask, masks, 4)
            for _ in range(4):
                runner.step()
            losses = runner.fetch(0, 4)[:, 0].tolist()
            assert runner.graphs["step"]["replays"] == 4
        else:
            losses = [trainer.train_step(state, gen, mask)[1].item()
                      for _ in range(4)]
        results.append((losses, [p.detach().clone()
                                 for p in state.model.parameters()]))
    (graph_losses, graph_params), (eager_losses, eager_params) = results
    np.testing.assert_allclose(graph_losses, eager_losses, rtol=1e-5)
    for a, b in zip(graph_params, eager_params):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["simple", "sigmoid"])
def test_epoch_block_fit_matches_the_loop_on_the_card(cuda, kernel):
    """``fit(epoch_block=4)`` (graph replays) against the per-epoch loop
    on the card, dropout on: the same best epoch, losses at rtol 1e-5,
    logged metrics at atol 1e-6; each kernel launched, as captured count ×
    replays, exactly as often as the loop's 10 steps and 6 evals need."""
    results = []
    for block in (0, 4):
        trainer, split = _trainer_on(cuda, kernel)
        log = RowLog()
        best = trainer.fit(split, epochs=10, eval_step=2, epoch_block=block,
                           logger=log)[0]
        results.append((best, np.asarray(log.rows), trainer.epoch_runner))
    (loop, loop_rows, _), (blk, blk_rows, runner) = results
    assert blk["epoch"] == loop["epoch"]
    np.testing.assert_allclose(blk["losses"], loop["losses"], rtol=1e-5)
    np.testing.assert_allclose(blk_rows, loop_rows, rtol=0, atol=1e-6)
    assert runner.graphs["step"]["replays"] == 10
    assert runner.graphs["eval"]["replays"] == 6
    steps, evals, layers = 10, 6, 3
    attention = kernel == "sigmoid"
    assert runner.launches() == {
        "sigmoid_attention_fwd": layers * (steps + evals) * attention,
        "sigmoid_attention_dq": layers * steps * attention,
        "sigmoid_attention_dkv": layers * steps * attention,
        "csr_spmm": layers * (steps + evals),
        "csr_spmm_transposed": layers * steps,
        "ell_spmm": 0, "ell_spmm_transposed": 0, "ell_spmm_combine": 0,
        "bsr_spmm": 0, "bsr_spmm_transposed": 0, "bsr_spmm_combine": 0}


@pytest.mark.cuda
def test_resume_on_the_card(cuda, tmp_path):
    """A run stopped after a checkpoint and resumed on the card gives the
    uninterrupted run's losses and best record (the capturable Adam's
    device step and the CUDA generator restored)."""
    trainer, split = _trainer_on(cuda, "simple")
    full = trainer.fit(split, epochs=8, ckpt_dir=str(tmp_path / "full"),
                       checkpoint_every=3)[0]
    trainer, split = _trainer_on(cuda, "simple")
    trainer.fit(split, epochs=5, ckpt_dir=str(tmp_path / "cut"),
                checkpoint_every=3)
    trainer, split = _trainer_on(cuda, "simple")
    resumed = trainer.fit(split, epochs=8, ckpt_dir=str(tmp_path / "cut"),
                          checkpoint_every=3, resume=True)[0]
    assert resumed["losses"] == full["losses"]
    for k in ("train", "valid", "test", "epoch"):
        assert resumed[k] == full[k]


@pytest.mark.cuda
def test_capturable_adam_trajectory_matches_cpu(cuda):
    """On the card the trainer's Adam is capturable and fused (its step on
    the device, one kernel for the update); 5 steps at dropout 0 reach the
    CPU's weights."""
    weights = []
    for device in (cuda, "cpu"):
        trainer, split = _trainer_on(device, "simple", dropout=0.0)
        state = trainer.init_state(0)
        assert state.optimizer.defaults["capturable"] == (device == cuda)
        assert bool(state.optimizer.defaults["fused"]) == (device == cuda)
        mask = torch.zeros(500, dtype=torch.bool, device=device)
        mask[:100] = True
        for _ in range(5):
            trainer.train_step(state, None, mask)
        weights.append({n: p.detach().cpu()
                        for n, p in state.model.named_parameters()})
    for name in weights[1]:
        torch.testing.assert_close(weights[0][name], weights[1][name],
                                   **GRAD, msg=name)


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda):
    """A host sync in the step makes its capture fail, and the epoch-block
    fit raises instead of running eagerly. In a process of its own, as a
    failed capture may leave the allocator's capture state behind."""
    import os
    import pathlib
    import subprocess
    import sys

    code = (
        "import pytest, torch\n"
        "import test_torch_port_cuda as t\n"
        "trainer, split = t._trainer_on(torch.device('cuda'), 'simple')\n"
        "real = trainer._loss\n"
        "trainer._loss = lambda out, m: real(out, m) * float(out.sum() > 0)\n"
        "with pytest.raises(RuntimeError):\n"
        "    trainer.fit(split, epochs=4, epoch_block=2)\n")
    tests = pathlib.Path(__file__).resolve().parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=tests.parent,
                          env={**os.environ,
                               "PYTHONPATH": f"{tests}:{tests.parent}"},
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# --------------------------------------------------------------------------
# the wide path (M or D above NARROW_WIDTH: the set track's hidden 300 and
# 400) and the command line on the card
# --------------------------------------------------------------------------

WIDE_SHAPES = [
    ((150, 170, 1, 257, 257), True),
    ((300, 260, 1, 300, 300), True),
    ((200, 330, 1, 400, 400), False),
    ((130, 140, 2, 512, 512), True),
    ((100, 120, 1, 300, 64), False),
    ((100, 120, 1, 64, 400), True),
    # ragged for the tensor-core tiles: N and L past whole tiles of 64 (and
    # K4's 32 keys), M and D not multiples of the product depth of 8
    ((301, 301, 1, 257, 300), True),
    ((301, 97, 1, 300, 257), False),
    # too wide for the resident tiles: K2's q tile (M above 640) and K4's k
    # and v tiles (M + D above about 1090) come through the ring instead
    ((70, 90, 1, 700, 200), True),
    ((90, 70, 1, 640, 640), False),
]


def _wide_inputs(cuda, dtype, n, l, h, m, d, masked, seed):
    """Inputs of the wide cases, q and k scaled for unit-variance scores
    (off the sigmoid's flat ends)."""
    q, k, v, mask = make_inputs(seed, n, l, h, m=m, d=d, masked=masked)
    q, k = q * m ** -0.25, k * m ** -0.25
    return _on(cuda, dtype, q, k, v, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,masked", WIDE_SHAPES)
def test_wide_fwd_kernel_matches_plain(cuda, shape, masked, dtype):
    """K2's wide path, normalised, and (float32) the raw numerator. At
    bfloat16 inputs the raw numerator is left out: a one-ulp change of q·k
    flips s's bfloat16 rounding now and then, which moves a raw sum by more
    than the float32 rule allows; the normalised output keeps the bfloat16
    rule."""
    n, l, h, m, d = shape
    assert K.is_wide(m, d)
    args = _wide_inputs(cuda, dtype, n, l, h, m, d, masked, 31)
    K.reset_launch_counts()
    out, den = K.sigmoid_attention_fwd(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["sigmoid_attention_fwd"] == 1
    ref_out, ref_den = K.sigmoid_attention_fwd_plain(*args)
    assert_close("out", out, ref_out, "out")
    assert_close("den", den, ref_den, "den")
    if dtype == torch.float32:
        num, _ = K.sigmoid_attention_fwd(*args, normalize=False)
        ref_num, _ = K.sigmoid_attention_fwd_plain(*args, normalize=False)
        assert_close("num", num, ref_num, "num", den=ref_den)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,masked", WIDE_SHAPES)
def test_wide_bwd_kernels_match_plain(cuda, shape, masked, dtype):
    n, l, h, m, d = shape
    args = _wide_inputs(cuda, dtype, n, l, h, m, d, masked, 32)
    g = torch.Generator().manual_seed(3)
    dnum = torch.randn((n, h, d), generator=g).to(cuda)
    dden = torch.randn((n, h), generator=g).to(cuda)
    dq = K.sigmoid_attention_dq(*args, dnum, dden)
    dk, dv = K.sigmoid_attention_dkv(*args, dnum, dden)
    assert_close("dq", dq, K.sigmoid_attention_dq_plain(*args, dnum, dden),
                 "grad")
    ref_dk, ref_dv = K.sigmoid_attention_dkv_plain(*args, dnum, dden)
    assert_close("dk", dk, ref_dk, "grad")
    assert_close("dv", dv, ref_dv, "grad")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_kernels_take_strided_inputs(cuda, dtype):
    """The wide path on views: q with a feature stride of H (its heads
    innermost), k offset by one element (rows not 16-byte aligned), and one
    value head broadcast over H = 2 (a head stride of 0)."""
    n, l, h, m, d = 130, 150, 2, 300, 260
    q, k, v, mask = _wide_inputs(cuda, dtype, n, l, h, m, d, True, 34)
    q = q.transpose(1, 2).contiguous().transpose(1, 2)
    k = torch.cat([k.new_zeros(1), k.flatten()])[1:].view(l, h, m)
    v = v[:, :1].expand(l, h, d)
    assert q.stride(2) == h and k.data_ptr() % 16 and v.stride(1) == 0
    g = torch.Generator().manual_seed(4)
    dnum = torch.randn((n, h, d), generator=g).to(cuda)
    dden = torch.randn((n, h), generator=g).to(cuda)
    out, den = K.sigmoid_attention_fwd(q, k, v, mask)
    ref_out, ref_den = K.sigmoid_attention_fwd_plain(q, k, v, mask)
    assert_close("out", out, ref_out, "out")
    assert_close("den", den, ref_den, "den")
    dk, dv = K.sigmoid_attention_dkv(q, k, v, mask, dnum, dden)
    ref_dk, ref_dv = K.sigmoid_attention_dkv_plain(q, k, v, mask, dnum, dden)
    assert_close("dk", dk, ref_dk, "grad")
    assert_close("dv", dv, ref_dv, "grad")
    assert_close("dq", K.sigmoid_attention_dq(q, k, v, mask, dnum, dden),
                 K.sigmoid_attention_dq_plain(q, k, v, mask, dnum, dden),
                 "grad")


@pytest.mark.cuda
@pytest.mark.parametrize("n,l", [(64, 5000), (5000, 64)])
def test_wide_split_is_deterministic(cuda, n, l):
    """The wide path with its loop axis split (K2 and K3 over keys, K4
    over queries): two calls bit-equal, one launch each, against the
    plain version."""
    args = _wide_inputs(cuda, torch.float32, n, l, 1, 300, 300, True, 33)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    dnum = torch.ones((n, 1, 300), device=cuda)
    dden = torch.zeros((n, 1), device=cuda)
    calls = {
        "sigmoid_attention_fwd": lambda: K.sigmoid_attention_fwd(*args)[0],
        "sigmoid_attention_dq": lambda: K.sigmoid_attention_dq(
            *args, dnum, dden),
        "sigmoid_attention_dkv": lambda: K.sigmoid_attention_dkv(
            *args, dnum, dden)[0],
    }
    assert any(K.split_plan(name, n, l, 1, 300, 300, sms)[1] > 1
               for name in calls)
    for name, call in calls.items():
        K.reset_launch_counts()
        assert torch.equal(call(), call())
        assert K.LAUNCHES[name] == 2
    assert_close("out", calls["sigmoid_attention_fwd"](),
                 K.sigmoid_attention_fwd_plain(*args)[0], "out")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_dq_split_chunk_fully_masked(cuda, dtype):
    """A key chunk of the wide K3's split whose keys are all masked adds
    exact zeros to dq; the other chunks' keys still count."""
    n, l, h, m, d = 64, 2000, 1, 300, 300
    _, splits, chunk = _plan(cuda, "sigmoid_attention_dq", n, l, h, m, d)
    assert splits > 2
    q, k, v, mask = make_inputs(35, n, l, h, m=m, d=d, masked=True)
    q, k = q * m ** -0.25, k * m ** -0.25
    lo, hi = chunk * K.TILE, 2 * chunk * K.TILE
    mask[lo:hi] = 0.0  # the whole second chunk
    args = _on(cuda, dtype, q, k, v, mask)
    grads = _cotangents(cuda, 36, args, d)
    dq = K.sigmoid_attention_dq(*args, *grads)
    assert_close("dq", dq, K.sigmoid_attention_dq_plain(*args, *grads),
                 "grad")
    # the same keys dropped from the problem give the same dq
    keep = torch.ones(l, dtype=torch.bool)
    keep[lo:hi] = False
    cut = [a[keep.to(cuda)] for a in args[1:]]
    assert_close("dq", dq, K.sigmoid_attention_dq(args[0], *cut, *grads),
                 "grad")


@pytest.mark.cuda
def test_cli_runs_on_the_card(cuda, tmp_path):
    """The command line with its default device, the card: a synthetic
    graph with the sigmoid kernel at hidden 300 (the wide path), K2-K4 and
    the default ELL layout's K6 launched (no bucket of this graph is
    split), K1 not."""
    from difformer_tpu_torch import cli
    from difformer_tpu_torch.kernels import ell as K6
    from difformer_tpu_torch.kernels import spmm as K1

    for kernels in (K, K1, K6):
        kernels.reset_launch_counts()
    res = cli.main(["--dataset", "synthetic-400-1600-16-3", "--epochs", "20",
                    "--runs", "1", "--rand_split", "true", "--kernel",
                    "sigmoid", "--hidden_channels", "300", "--lr", "0.001",
                    "--dropout", "0.0", "--display_step", "100",
                    "--data_dir", str(tmp_path)])
    assert res[0]["test"] >= 0.8, res  # 0.99 on the CPU
    assert all(K.LAUNCHES[name] > 0 for name in K.LAUNCHES)
    assert K6.LAUNCHES["ell_spmm"] > 0 and K6.LAUNCHES["ell_spmm_transposed"]
    assert not any(K1.LAUNCHES.values())


# --- the mini-batch trainer: K1 at capacity, chunk steps as CUDA graphs -------

def _hub_chunks(count=3, batch=2500):
    """The hubs graph's first ``count`` chunks of a random permutation, as
    (nodes, induced subgraph): a few thousand to tens of thousands of edges
    each, with hub rows of more than T edges in the chunks that hold a
    hub."""
    from difformer_tpu_torch import native

    s, r, n, _, _ = _spmm_graph("hubs")
    perm = np.random.default_rng(3).permutation(n)
    # the chunks of the largest in-degree nodes first, so they split rows
    top = np.argsort(-np.bincount(r, minlength=n))[:count]
    subs = native.chunk_subgraphs(s, r, perm, batch)
    chunk_of = np.empty(n, np.int64)
    chunk_of[perm] = np.arange(n) // batch
    order = list(dict.fromkeys(chunk_of[top].tolist()))
    order += [c for c in range(len(subs)) if c not in order]
    return [(perm[c * batch:(c + 1) * batch], subs[c])
            for c in order[:count]]


@pytest.mark.cuda
def test_capacity_launch_replayed_over_chunks_matches_eager_launches(cuda):
    """One CUDA graph of K1 (forward and transposed) over a static chunk
    buffer at capacity, replayed for three chunks of different edge counts
    and heavy rows: each replay bit-equal to the eager exact-count launch
    on that chunk's own CSRs, and within the "spmm" rule of the plain
    version."""
    from difformer_tpu_torch import native
    from difformer_tpu_torch.train import minibatch as M

    chunks = _hub_chunks()
    edges = [sub.shape[1] for _, sub in chunks]
    assert len(set(edges)) == 3
    layout = M.ChunkLayout(2500, max(edges) + 1000)
    buf = torch.zeros(layout.size, dtype=torch.int32, device=cuda)
    plan = M.chunk_plan(layout, buf)
    x = torch.randn((2500, 64), device=cuda)
    csrs = ((plan.row_ptr, plan.col, plan.val, plan.split, False),
            (plan.t_row_ptr, plan.t_col, plan.t_val, plan.t_split, True))
    host = np.zeros(layout.size, np.int32)
    heavy = []
    for nodes, sub in chunks[:1]:  # warm-up with a real plan in place
        M.pack_chunk(layout, host, nodes, sub)
        buf.copy_(torch.from_numpy(host))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for ptr, col, val, split, t in csrs:
            K1.csr_spmm(x, ptr, col, val, split=split, transposed=t)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [K1.csr_spmm(x, ptr, col, val, split=split, transposed=t)
                for ptr, col, val, split, t in csrs]
    for nodes, sub in chunks:
        heavy.append(M.pack_chunk(layout, host, nodes, sub)[0])
        buf.copy_(torch.from_numpy(host))
        graph.replay()
        arrays = [torch.as_tensor(a, device=cuda)
                  for a in native.chunk_csr(sub[0], sub[1], 2500)]
        for out, (ptr, col, val) in zip(outs, (arrays[:3], arrays[3:])):
            split = K1.row_split(ptr)
            exact = K1.csr_spmm(x, ptr, col, val, split=split)
            assert torch.equal(out, exact)
            assert_close("capacity", out, K1.csr_spmm_plain(x, ptr, col, val),
                         "spmm", scale=K1.csr_spmm_abs(x, ptr, col, val))
    assert heavy[0] > 0  # the first chunk holds the largest hub


def _minibatch(device, use_scan, dropout=0.0, n=2000, batch=600):
    from difformer_tpu_torch.train.minibatch import MiniBatchTrainer

    x, ei, y = random_graph(n, 8 * n, 16, 4, seed=2, homophily=0.8)
    ei = standard_preprocess(ei, n)
    model = DIFFormer(16, 32, 4, num_layers=2, dropout=dropout,
                      device=device)
    return MiniBatchTrainer(model, x, ei, y, batch_size=batch,
                            use_scan=use_scan, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_minibatch_graphs_match_the_loop_on_the_card(cuda, dropout):
    """use_scan=True (each chunk a replay of the full-size or the last
    chunk's graph) against use_scan=False (eager steps on exact plans): the
    same chunk losses bit for bit, the same logged metrics and best epoch;
    K1 captured in both graphs, replayed for every chunk."""
    split = {k: np.arange(i, 2000, 3) for i, k in enumerate(
        ("train", "valid", "test"))}
    runs = []
    for use_scan in (False, True):
        trainer = _minibatch(cuda, use_scan, dropout)
        log = RowLog()
        best = trainer.fit(split, epochs=3, eval_step=1, logger=log)[0]
        runs.append((best, log.rows, trainer))
    (loop, loop_rows, _), (scan, scan_rows, trainer) = runs
    assert scan["chunk_losses"] == loop["chunk_losses"]
    assert scan_rows == loop_rows and scan["epoch"] == loop["epoch"]
    graphs = trainer.runner.graphs
    assert set(graphs) == {"step", "last step"}
    assert [g["replays"] for g in graphs.values()] == [9, 3]
    for g in graphs.values():
        assert g["captured"]["csr_spmm"] == 2
        assert g["captured"]["csr_spmm_transposed"] == 2
    assert trainer.runner.launches()["csr_spmm"] == 2 * 12


@pytest.mark.cuda
def test_minibatch_trainer_matches_cpu(cuda):
    """The same fit on the card and on the CPU: losses and the eval's
    metrics at the model's float32 tolerance."""
    split = {k: np.arange(i, 2000, 3) for i, k in enumerate(
        ("train", "valid", "test"))}
    res = [_minibatch(device, True).fit(split, epochs=2, eval_step=1)[0]
           for device in (cuda, "cpu")]
    np.testing.assert_allclose(res[0]["losses"], res[1]["losses"], **GRAD)
    for k in ("train", "valid", "test"):
        np.testing.assert_allclose(res[0][k], res[1][k], atol=2e-3)


def _zoo_minibatch(device, use_scan, method, n=2000, batch=600,
                   capacity_scale=1):
    """A zoo model (BatchNorm on; GAT with 2 heads, attention dropout 0)
    in the mini-batch trainer; ``capacity_scale`` multiplies the edge
    capacity, so that a chunk's real edges fill a fraction of it."""
    from difformer_tpu_torch.nn import gnns as Z
    from difformer_tpu_torch.train import minibatch as M

    x, ei, y = random_graph(n, 8 * n, 16, 4, seed=2, homophily=0.8)
    ei = standard_preprocess(ei, n)
    model = (Z.GCN(16, 32, 4, num_layers=3, dropout=0.3, device=device)
             if method == "gcn" else
             Z.GAT(16, 16, 4, num_layers=2, dropout=0.0, use_bn=True,
                   device=device))
    trainer = M.MiniBatchTrainer(model, x, ei, y, batch_size=batch,
                                 use_scan=use_scan, device=device)
    if capacity_scale != 1:
        trainer.edge_capacity *= capacity_scale
        loops = trainer.kind in ("norm_loops", "gat")
        trainer.layouts = {m: M.ChunkLayout(
            m, trainer.edge_capacity + (m if loops else 0), trainer.kind)
            for m in trainer.layouts}
    return trainer


@pytest.mark.cuda
@pytest.mark.parametrize("method,scale", [("gcn", 1), ("gat", 1),
                                          ("gat", 4)])
def test_zoo_minibatch_graphs_match_the_loop_on_the_card(cuda, method,
                                                         scale):
    """A zoo model's chunk steps replayed as CUDA graphs (GCN's self-looped
    ``gcn_norm`` plan; GAT's edges and loops, also at 4 times the edge
    capacity, most of it padding) against the eager loop on exact plans:
    the same chunk losses, logged metrics and best epoch bit for bit, and
    the BatchNorm statistics after the fit (the capture's warm-up undone);
    K1 (and K1-dval for GAT) captured once a step and replayed for every
    chunk."""
    split = {k: np.arange(i, 2000, 3) for i, k in enumerate(
        ("train", "valid", "test"))}
    runs = []
    for use_scan in (False, True):
        trainer = _zoo_minibatch(cuda, use_scan, method,
                                 capacity_scale=scale)
        log = RowLog()
        best = trainer.fit(split, epochs=3, eval_step=1, logger=log)[0]
        runs.append((best, log.rows, trainer, {
            k: b.clone() for k, b in trainer.model.named_buffers()}))
    (loop, loop_rows, _, loop_bufs), (scan, scan_rows, trainer,
                                      scan_bufs) = runs
    assert scan["chunk_losses"] == loop["chunk_losses"]
    assert scan_rows == loop_rows and scan["epoch"] == loop["epoch"]
    assert loop_bufs and set(loop_bufs) == set(scan_bufs)
    for k in loop_bufs:
        assert torch.equal(loop_bufs[k], scan_bufs[k]), k
    graphs = trainer.runner.graphs
    assert [g["replays"] for g in graphs.values()] == [9, 3]
    k1 = 3 if method == "gcn" else (4 + 2) + (4 + 1)
    for g in graphs.values():
        assert g["captured"]["csr_spmm"] == k1
        assert g["captured"]["csr_spmm_transposed"] == k1
        assert g["captured_dval"] == (0 if method == "gcn" else 2)
    assert trainer.runner.launches()["csr_spmm"] == k1 * 12


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["norm", "norm_loops", "gat"])
def test_zoo_host_chunk_plans_equal_the_device_plans_on_the_card(cuda,
                                                                   kind):
    """The mini-batch trainer's host plans (``native.chunk_norm_csr``,
    ``chunk_gat_csr``) against ``norm_plan`` and ``gat_plan`` built on the
    card, bit for bit: ``gcn_norm`` takes its inverse square roots on the
    host, where the card's ``rsqrt`` would round them otherwise."""
    from difformer_tpu_torch import native
    from difformer_tpu_torch.nn.gnns import gat_plan, norm_plan

    rng = np.random.default_rng(0)
    n, e = 20_000, 200_000
    s = rng.integers(0, n, e).astype(np.int32)
    r = np.minimum((n * rng.random(e) ** 2).astype(np.int64),
                   n - 1).astype(np.int32)
    st, rt = torch.as_tensor(s, device=cuda), torch.as_tensor(r, device=cuda)
    if kind == "gat":
        host = native.chunk_gat_csr(s, r, n)
        p = gat_plan(st, rt, n).plan
        want = (p.row_ptr, p.col, p.rows, p.t_row_ptr, p.t_col, p.t_order)
    else:
        host = native.chunk_norm_csr(s, r, n, kind == "norm_loops")
        p = norm_plan(st, rt, n, add_self_loops=kind == "norm_loops")
        want = (p.row_ptr, p.col, p.val, p.t_row_ptr, p.t_col, p.t_val)
    for got, ref in zip(host, want):
        np.testing.assert_array_equal(got, ref.cpu().numpy())


@pytest.mark.cuda
def test_zoo_minibatch_trainer_matches_cpu(cuda):
    """GAT's chunk fit on the card and on the CPU: losses and the eval's
    metrics at the model's float32 tolerance."""
    split = {k: np.arange(i, 2000, 3) for i, k in enumerate(
        ("train", "valid", "test"))}
    res = [_zoo_minibatch(device, True, "gat").fit(
        split, epochs=2, eval_step=1)[0] for device in (cuda, "cpu")]
    np.testing.assert_allclose(res[0]["losses"], res[1]["losses"], **GRAD)
    for k in ("train", "valid", "test"):
        np.testing.assert_allclose(res[0][k], res[1][k], atol=2e-3)


# --- K1 at bf16, compute_dtype and remat in the CUDA-graph fits -------------

BF16_SPMM_SHAPES = [("cora", 64), ("cora", 65), ("cora", 8), ("cora", 1),
                    ("ragged", 48), ("hubs", 64), ("hubs", 65), ("hubs", 8),
                    ("hubs", 136)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,width", BF16_SPMM_SHAPES)
def test_spmm_kernel_matches_plain_at_bf16(cuda, kind, width):
    """bf16 x and out (8 values a lane where W % 8 == 0, scalar loads
    otherwise), f32 sums, one rounding: the plain version rounds the f32
    sum once too, so the two differ by the two f32 sums' difference (the
    "spmm" rule's 1e-5 of the row's sum of |w·x|) and one bf16 step (2⁻⁷
    of the value at most) where they straddle a rounding boundary; one
    call counted in each direction, two calls bit-equal."""
    plan = _spmm_plan(cuda, kind)
    x = torch.randn((plan.num_nodes, width),
                    generator=torch.Generator().manual_seed(width)).to(
        cuda, torch.bfloat16)
    K1.reset_launch_counts()
    for name, csr, split in (
            ("csr_spmm", (plan.row_ptr, plan.col, plan.val), plan.split),
            ("csr_spmm_transposed", (plan.t_row_ptr, plan.t_col, plan.t_val),
             plan.t_split)):
        call = lambda: K1.csr_spmm(  # noqa: E731
            x, *csr, split=split, transposed=name != "csr_spmm")
        out = call()
        torch.cuda.synchronize()
        ref = K1.csr_spmm_plain(x, *csr)
        assert out.dtype == torch.bfloat16
        assert_close(name, out, ref, "spmm")
        step = (2.0 ** -7 * ref.float().abs()
                + 1e-5 * K1.csr_spmm_abs(x.float(), *csr))
        assert torch.all((out.float() - ref.float()).abs() <= step)
        assert torch.equal(out, call())
    assert K1.LAUNCHES == {"csr_spmm": 2, "csr_spmm_transposed": 2}


@pytest.mark.cuda
def test_bf16_capacity_launch_matches_exact_launch(cuda):
    """K1's schedule held at capacity (the mini-batch trainer's chunks),
    replayed in a CUDA graph at bf16: bit-equal to the exact-count launch
    on each chunk's own CSRs."""
    from difformer_tpu_torch import native
    from difformer_tpu_torch.train import minibatch as M

    chunks = _hub_chunks()
    edges = [sub.shape[1] for _, sub in chunks]
    layout = M.ChunkLayout(2500, max(edges) + 1000)
    buf = torch.zeros(layout.size, dtype=torch.int32, device=cuda)
    plan = M.chunk_plan(layout, buf)
    x = torch.randn((2500, 64), device=cuda).to(torch.bfloat16)
    host = np.zeros(layout.size, np.int32)
    M.pack_chunk(layout, host, *chunks[0])
    buf.copy_(torch.from_numpy(host))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K1.csr_spmm(x, plan.row_ptr, plan.col, plan.val, split=plan.split)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K1.csr_spmm(x, plan.row_ptr, plan.col, plan.val,
                          split=plan.split)
    heavy = []
    for nodes, sub in chunks:
        heavy.append(M.pack_chunk(layout, host, nodes, sub)[0])
        buf.copy_(torch.from_numpy(host))
        graph.replay()
        ptr, col, val = (torch.as_tensor(a, device=cuda) for a in
                         native.chunk_csr(sub[0], sub[1], 2500)[:3])
        torch.cuda.synchronize()
        assert torch.equal(out, K1.csr_spmm(x, ptr, col, val,
                                            split=K1.row_split(ptr)))
    assert any(heavy)


OPTIONS = {"bf16": dict(compute_dtype="bfloat16"), "remat": dict(remat=True),
           "bf16-remat": dict(compute_dtype="bfloat16", remat=True),
           "remat-spmm-first": dict(remat=True, num_heads=4,
                                    spmm_first=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("kernel", ["simple", "sigmoid"])
def test_options_in_the_epoch_block_fit_match_the_loop(cuda, kernel, option):
    """bf16 and remat in the epoch-block fit (the step and the eval captured
    as CUDA graphs, dropout on): the loop's losses bit for bit; remat's
    checkpoints run under capture without reading the RNG state, and on
    the spmm_first branch re-run K1's forward once a layer in the
    backward."""
    x, ei, y = random_graph(1500, 6000, 32, 5, seed=3, homophily=0.8)
    ei = standard_preprocess(ei, 1500)
    split = {k: np.arange(i, 1500, 3) for i, k in enumerate(
        ("train", "valid", "test"))}
    res = []
    for block in (0, 4):
        g = GraphData.from_numpy(x, ei, device=cuda)
        m = DIFFormer(32, 32, 5, num_layers=3, kernel=kernel, dropout=0.2,
                      device=cuda, **OPTIONS[option])
        trainer = FullBatchTrainer(m, g, y, device=cuda)
        res.append((trainer.fit(split, epochs=8, epoch_block=block)[0],
                    trainer))
    (loop, _), (graph, trainer) = res
    assert graph["losses"] == loop["losses"]
    assert all(np.isfinite(graph["losses"]))
    extra = 3 if option == "remat-spmm-first" else 0
    launches = trainer.epoch_runner.launches()
    assert launches["csr_spmm"] == 8 * (3 + extra) + 8 * 3
    assert launches["csr_spmm_transposed"] == 8 * 3


@pytest.mark.cuda
@pytest.mark.parametrize("option", ["bf16", "remat", "bf16-remat"])
def test_options_in_the_minibatch_graphs_match_the_loop(cuda, option):
    from difformer_tpu_torch.train.minibatch import MiniBatchTrainer

    x, ei, y = random_graph(2000, 16000, 16, 4, seed=2, homophily=0.8)
    ei = standard_preprocess(ei, 2000)
    split = {k: np.arange(i, 2000, 3) for i, k in enumerate(
        ("train", "valid", "test"))}
    runs = []
    for use_scan in (False, True):
        model = DIFFormer(16, 32, 4, num_layers=2, dropout=0.3, device=cuda,
                          **OPTIONS[option])
        trainer = MiniBatchTrainer(model, x, ei, y, batch_size=600,
                                   use_scan=use_scan, device=cuda)
        runs.append(trainer.fit(split, epochs=2, eval_step=1)[0])
    assert runs[0]["chunk_losses"] == runs[1]["chunk_losses"]


def _temporal_model(name, cuda):
    from difformer_tpu_torch.nn.temporal import DCRNN, MPNNLSTM

    if name == "dcrnn":
        return DCRNN(8, 16, 1, K=3, device=cuda)
    if name == "mpnn_lstm":
        return MPNNLSTM(8, 16, 1, 200, 1, dropout=0.2, device=cuda)
    return DIFFormer(8, 16, 1, num_layers=2, dropout=0.2, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cumulative", "incremental"])
@pytest.mark.parametrize("name", ["difformer", "dcrnn", "mpnn_lstm"])
def test_temporal_graphs_match_the_loop(cuda, name, mode):
    """The temporal trainer's epochs replayed as CUDA graphs against the
    per-snapshot loop on weighted edges: the same train, validation and
    test costs bit for bit (each trainer builds its own plans, whose
    weighted degrees are summed in a fixed order)."""
    from difformer_tpu_torch.data.synthetic import random_temporal_sequence
    from difformer_tpu_torch.train.temporal import (
        TemporalTrainer,
        temporal_signal_split,
    )

    snaps = random_temporal_sequence(200, 40, 8, seed=1)
    train, rest = temporal_signal_split(snaps, 0.5)
    val, test = temporal_signal_split(rest, 0.5)
    res = []
    for use_scan in (False, True):
        trainer = TemporalTrainer(_temporal_model(name, cuda), mode=mode,
                                  use_scan=use_scan, device=cuda)
        res.append(trainer.fit(train, val, test, epochs=4))
    assert res[0]["losses"] == res[1]["losses"]
    assert res[0]["val_costs"] == res[1]["val_costs"]
    assert res[0]["test"] == res[1]["test"]
    graphs = trainer.runner.graphs
    assert {g["replays"] for k, g in graphs.items()
            if k.startswith("step")} == {4 * len(train)}


@pytest.mark.cuda
def test_temporal_plans_are_the_same_at_every_build(cuda):
    """DConv's and GCNLayer's plans of a weighted graph, built twice on the
    card, are bit-equal (index_add_ would sum the weighted degrees in no
    fixed order)."""
    from difformer_tpu_torch.nn.temporal import DCRNN, MPNNLSTM

    rng = np.random.default_rng(4)
    s = torch.as_tensor(rng.integers(0, 3000, 60000), device=cuda)
    r = torch.as_tensor(rng.integers(0, 3000, 60000), device=cuda)
    w = torch.as_tensor(rng.random(60000).astype(np.float32), device=cuda)
    a, b = (DCRNN.build_plan(s, r, 3000, w) for _ in range(2))
    assert torch.equal(a.fwd.val, b.fwd.val)
    assert torch.equal(a.rev.val, b.rev.val)
    a, b = (MPNNLSTM.build_plan(s, r, 3000, w) for _ in range(2))
    assert torch.equal(a.val, b.val) and torch.equal(a.t_val, b.t_val)


def _graph_level_trainer(cuda, kernel, use_graphs, pooling="mean",
                         batch=16):
    from difformer_tpu_torch.data.synthetic import random_small_graphs
    from difformer_tpu_torch.nn.difformer_v2 import (
        DIFFormerV2,
        GraphLevelModel,
    )
    from difformer_tpu_torch.train.graph_level import GraphLevelTrainer

    graphs = random_small_graphs(90, seed=2)
    enc = DIFFormerV2(8, 16, 16, num_layers=2, kernel=kernel, dropout=0.3,
                      device=cuda)
    model = GraphLevelModel(enc, 1, pooling, device=cuda)
    return graphs, GraphLevelTrainer(model, graphs, batch_size=batch,
                                     lr=5e-3, use_graphs=use_graphs,
                                     device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["dense", "table", "edges"])
@pytest.mark.parametrize("kernel", ["simple", "sigmoid"])
def test_graph_level_graphs_match_the_loop(cuda, kernel, plan):
    """The graph-level trainer's steps and evals replayed as CUDA graphs
    against the eager loop, on each conv plan, dropout on: the same batch
    losses and split metrics bit for bit, and one step and one eval graph
    replayed once a batch."""
    from difformer_tpu_torch.data.splits import get_random_idx_split

    modes = {"dense": (None, None), "table": (False, None),
             "edges": (False, False)}[plan]
    split = get_random_idx_split(90, 0.6, 0.2, rng=0)
    res = []
    for use_graphs in (False, True):
        graphs, trainer = _graph_level_trainer(cuda, kernel, use_graphs)
        trainer._dense_mode, trainer._knn_mode = modes
        res.append(trainer.fit(split, epochs=3)[0])
    for key in ("losses", "train", "valid", "test", "epoch"):
        assert res[0][key] == res[1][key], key
    runner = trainer.runner
    assert {lay.plan for lay in runner.buffers} == {plan}
    steps = 3 * len(res[1]["losses"][0])
    assert runner.graphs[f"step {plan}"]["replays"] == steps
    launches = runner.launches()
    if plan == "edges":
        evals = 3 * sum(-(-len(i) // 16) for i in split.values())
        assert launches["csr_spmm"] == 2 * (steps + evals)
        assert launches["csr_spmm_transposed"] == 2 * steps
    else:
        assert not any(launches.values())


@pytest.mark.cuda
@pytest.mark.parametrize("pooling", ["sum", "mean", "max"])
def test_graph_level_model_matches_cpu(cuda, pooling):
    """GraphLevelModel's logits and gradients on the card (K1 on the
    edge-list plan) against the same weights on the CPU."""
    from difformer_tpu_torch.data.batching import pad_graph_batch
    from difformer_tpu_torch.data.synthetic import random_small_graphs
    from difformer_tpu_torch.nn.difformer_v2 import (
        DIFFormerV2,
        GraphLevelModel,
    )

    graphs = random_small_graphs(6, seed=5)
    b = pad_graph_batch([g[0] for g in graphs], [g[1] for g in graphs],
                        [g[2] for g in graphs], batch_size=8)
    outs, grads = [], []
    for dev in ("cpu", cuda):
        enc = DIFFormerV2(8, 16, 16, num_layers=2, dropout=0.0, device=dev)
        model = GraphLevelModel(enc, 1, pooling, seed=3, device=dev)
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        out = model(t(b.node_feat), t(b.node_mask), t(b.n_nodes),
                    t(b.senders).long(), t(b.receivers).long(), None,
                    t(b.edge_mask))
        out.sum().backward()
        outs.append(out.detach().cpu())
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    torch.testing.assert_close(outs[1], outs[0], **GRAD)
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], **GRAD)


# --------------------------------------------------------------------------
# K1-dval and the baseline zoo
# --------------------------------------------------------------------------

def _zoo_graph(seed=3, n=400, e=2400, f=12, c=4):
    x, ei, y = random_graph(n, e, f, c, seed=seed, homophily=0.8)
    return x, standard_preprocess(ei, n), y


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 7, 64, 300])
@pytest.mark.parametrize("hub", [False, True])
def test_dval_kernel_matches_plain(cuda, width, hub):
    """K1-dval against its plain version at vector and scalar widths, on a
    graph with a hub row of thousands of edges: within the "spmm" rule,
    two calls bit-equal, one launch counted a call."""
    from difformer_tpu_torch.ops.graph_ops import build_spmm_plan

    rng = np.random.default_rng(width)
    n, e = 3000, 20000
    s = rng.integers(0, n, e)
    r = np.where(rng.random(e) < 0.3, 5, rng.integers(0, n, e)) if hub \
        else rng.integers(0, n, e)
    plan = build_spmm_plan(None, torch.as_tensor(s, device=cuda),
                           torch.as_tensor(r, device=cuda), n,
                           value_grad=True)
    g = torch.as_tensor(rng.normal(size=(n, width)).astype(np.float32),
                        device=cuda)
    x = torch.as_tensor(rng.normal(size=(n, width)).astype(np.float32),
                        device=cuda)
    kw = dict(row_ptr=plan.row_ptr, split=plan.dval_split)
    K1.reset_launch_counts()
    got = K1.csr_spmm_dval(g, x, plan.rows, plan.col, **kw)
    assert K1.DVAL_LAUNCHES == {"csr_spmm_dval": 1}
    assert torch.equal(got, K1.csr_spmm_dval(g, x, plan.rows, plan.col,
                                             **kw))
    ref = K1.csr_spmm_dval_plain(g, x, plan.rows, plan.col)
    scale = K1.csr_spmm_dval_abs(g, x, plan.rows, plan.col)
    assert_close(f"dval W={width}", got, ref, "spmm", scale=scale)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [0, 2])
def test_dval_value_gradient_on_the_card(cuda, heads):
    """spmm's value and x gradients on the card (K1, its transposed launch
    and K1-dval) against the same product's on the CPU (plain versions),
    on a directed graph with distinct values."""
    from difformer_tpu_torch.ops.graph_ops import build_spmm_plan, spmm

    rng = np.random.default_rng(9)
    n, e = 500, 3000
    s, r = rng.integers(0, n - 10, e), rng.integers(5, n, e)
    vals = rng.permutation(e).astype(np.float32) / e + 0.1
    shape = (n, heads, 16) if heads else (n, 24)
    if heads:
        vals = np.stack([vals * (h + 1) for h in range(heads)], 1)
    x = rng.normal(size=shape).astype(np.float32)
    cot = rng.normal(size=shape).astype(np.float32)
    res = {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        v, xx = t(vals).requires_grad_(), t(x).requires_grad_()
        plan = build_spmm_plan(None, t(s), t(r), n, value_grad=True)
        K1.reset_launch_counts()
        (spmm(v, None, None, xx, plan=plan) * t(cot)).sum().backward()
        res[str(dev)] = (v.grad.cpu(), xx.grad.cpu(),
                         dict(K1.DVAL_LAUNCHES))
    (v_cpu, x_cpu, _), (v_gpu, x_gpu, launched) = res["cpu"], res[str(cuda)]
    torch.testing.assert_close(v_gpu, v_cpu, **GRAD)
    torch.testing.assert_close(x_gpu, x_cpu, **GRAD)
    assert launched == {"csr_spmm_dval": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [None, 4])
@pytest.mark.parametrize("width", [7, 64, 65, 300])
@pytest.mark.parametrize("heads", [1, 2])
def test_dval_heads_kernel_matches_plain(cuda, heads, width, threshold):
    """K1-dval for every head in one launch, on strided [N, H, D] views
    (every other head of a wider buffer, a column slice), on a graph with
    a hub row of thousands of edges (split at the plan's K1-dval T, and at
    T = 4 where most rows are): within the "spmm" rule of the plain
    version, two calls bit-equal, one launch counted, no copy of the
    inputs."""
    from difformer_tpu_torch.ops.graph_ops import build_spmm_plan

    rng = np.random.default_rng(width + heads)
    n, e = 3000, 20000
    s = rng.integers(0, n, e)
    r = np.where(rng.random(e) < 0.3, 5, rng.integers(0, n, e))
    plan = build_spmm_plan(None, torch.as_tensor(s, device=cuda),
                           torch.as_tensor(r, device=cuda), n,
                           value_grad=True)
    split = (plan.dval_split if threshold is None
             else K1.row_split(plan.row_ptr, threshold))
    assert split.num_heavy > 0
    gen = torch.Generator(cuda).manual_seed(width)
    g = torch.randn((n, 2 * heads, width + 4), device=cuda,
                    generator=gen)[:, ::2, :width]
    x = torch.randn((n, heads, width + 8), device=cuda,
                    generator=gen)[:, :, 4:width + 4]
    if heads == 1:
        g, x = g[:, 0], x[:, 0]
    call = lambda: K1.csr_spmm_dval(  # noqa: E731
        g, x, plan.rows, plan.col, row_ptr=plan.row_ptr, split=split)
    K1.reset_launch_counts()
    got = call()
    assert K1.DVAL_LAUNCHES == {"csr_spmm_dval": 1}
    assert got.shape == ((e, heads) if heads > 1 else (e,))
    assert torch.equal(got, call())
    ref = K1.csr_spmm_dval_plain(g, x, plan.rows, plan.col)
    scale = K1.csr_spmm_dval_abs(g, x, plan.rows, plan.col)
    assert_close(f"dval H={heads} D={width}", got, ref, "spmm", scale=scale)


def _zoo_models(f, c, n):
    from difformer_tpu_torch.nn import gnns as Z

    return {
        "link": lambda: Z.LINK(n, c, device="cpu"),
        "mlp": lambda: Z.MLP(f, 16, c, dropout=0.0, device="cpu"),
        "sgc": lambda: Z.SGC(f, c, device="cpu"),
        "gcn": lambda: Z.GCN(f, 16, c, dropout=0.0, device="cpu"),
        "gat": lambda: Z.GAT(f, 8, c, dropout=0.0, device="cpu"),
        "mixhop": lambda: Z.MixHop(f, 8, c, dropout=0.0, device="cpu"),
        "gcnjk": lambda: Z.GCNJK(f, 16, c, jk_type="lstm", dropout=0.0,
                                 device="cpu"),
        "gatjk": lambda: Z.GATJK(f, 8, c, jk_type="cat", dropout=0.0,
                                 device="cpu"),
        "h2gcn": lambda: Z.H2GCN(f, 8, c, dropout=0.0, device="cpu"),
        "appnp": lambda: Z.APPNPNet(f, 16, c, dropout=0.0, device="cpu"),
        "gprgnn": lambda: Z.GPRGNN(f, 16, c, dropout=0.0, dprate=0.0,
                                   device="cpu"),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_zoo_models(1, 1, 1)))
def test_zoo_model_on_the_card_matches_the_cpu(cuda, name):
    """Every zoo model's logits and gradients on the card (K1, and K1-dval
    for GAT) against the same weights on the CPU (plain versions), in
    training with BatchNorm's batch statistics; GAT and GATJK launch
    K1-dval, the others none."""
    x, ei, _ = _zoo_graph()
    n, f = x.shape
    make = _zoo_models(f, 4, n)[name]
    # a cotangent that differs from node to node: one that is the same for
    # every node has no gradient through a BatchNorm but rounding noise
    cot = np.random.default_rng(2).normal(size=(n, 4)).astype(np.float32)
    outs = []
    for dev in ("cpu", cuda):
        model = make().to(dev)
        model.train()
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        plan = model.build_plan(t(ei[0]), t(ei[1]), n)
        K1.reset_launch_counts()
        out = model(t(x), plan=plan)
        (out * t(cot)).sum().backward()
        outs.append((out.detach().cpu(),
                     {k: p.grad.cpu() for k, p in model.named_parameters()
                      if p.grad is not None},
                     dict(K1.DVAL_LAUNCHES)))
    (o_cpu, g_cpu, _), (o_gpu, g_gpu, launched) = outs
    torch.testing.assert_close(o_gpu, o_cpu, **GRAD)
    for key in g_cpu:
        torch.testing.assert_close(g_gpu[key], g_cpu[key], **GRAD, msg=key)
    assert (launched["csr_spmm_dval"] > 0) == (name in ("gat", "gatjk"))


def _zoo_trainer(cuda, make, seed=0):
    x, ei, y = _zoo_graph(seed=seed)
    from difformer_tpu_torch.data import class_rand_splits

    split = class_rand_splits(y, 10, valid_num=60, test_num=80, rng=0)
    tr = FullBatchTrainer(make(), GraphData.from_numpy(x, ei, device=cuda),
                          y, device=cuda)
    return tr, split


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_zoo_graph_fit_matches_the_loop(cuda, name):
    """The epoch-block fit replayed as CUDA graphs against the per-epoch
    loop, with dropout on: the same best epoch, losses and logged metrics
    within rtol 1e-5 (PERF.md §2), and the same running statistics."""
    from difformer_tpu_torch.nn import gnns as Z

    make = {"gcn": lambda: Z.GCN(12, 16, 4, device=cuda),
            "gat": lambda: Z.GAT(12, 8, 4, device=cuda)}[name]
    fits = []
    for block in (0, 5):
        tr, split = _zoo_trainer(cuda, make)
        log = RowLog()
        res = tr.fit(split, epochs=10, epoch_block=block, logger=log)[0]
        fits.append((res, np.asarray(log.rows), tr.model.state_dict(), tr))
    (a, rows_a, sd_a, _), (b, rows_b, sd_b, tr) = fits
    assert tr.epoch_runner.graphs["step"]["replays"] == 10
    assert a["epoch"] == b["epoch"]
    np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-5)
    np.testing.assert_allclose(rows_b, rows_a, rtol=1e-5, atol=1e-7)
    for key in sd_a:
        torch.testing.assert_close(sd_b[key], sd_a[key], rtol=1e-5,
                                   atol=1e-6, msg=key)


@pytest.mark.cuda
def test_zoo_batch_norm_statistics_survive_the_capture(cuda):
    """GCN's running statistics after N replayed epochs equal those after N
    loop epochs: the warm-up's updates before the capture are undone with
    the weights (the CPU cannot show this: there the epoch-block fit runs
    eagerly, with no warm-up)."""
    from difformer_tpu_torch.nn import gnns as Z

    stats = []
    for block in (0, 4):
        tr, split = _zoo_trainer(
            cuda, lambda: Z.GCN(12, 16, 4, dropout=0.0, device=cuda))
        tr.fit(split, epochs=8, eval_step=100, epoch_block=block)
        stats.append({k: v.clone() for k, v in tr.model.named_buffers()})
    assert set(stats[0]) == {"bn_0.running_mean", "bn_0.running_var"}
    for key in stats[0]:
        torch.testing.assert_close(stats[1][key], stats[0][key], rtol=1e-5,
                                   atol=1e-6, msg=key)


@pytest.mark.cuda
def test_zoo_values_without_gradient_launch_no_dval(cuda):
    """DIFFormer's and GCN's train steps launch K1 in both directions and
    no K1-dval: their values take no gradient."""
    from difformer_tpu_torch.nn import gnns as Z

    for make in (lambda: Z.GCN(12, 16, 4, device=cuda),
                 lambda: DIFFormer(12, 16, 4, num_layers=2, device=cuda)):
        tr, split = _zoo_trainer(cuda, make)
        K1.reset_launch_counts()
        tr.fit(split, epochs=2)
        assert K1.LAUNCHES["csr_spmm_transposed"] > 0
        assert K1.DVAL_LAUNCHES == {"csr_spmm_dval": 0}


# --------------------------------------------------------------------------
# the sparse layouts: K6 (ELL) and K7 (block-sparse)
# --------------------------------------------------------------------------

def _layout_graph(kind, n=3000, e=40000, seed=4):
    """(senders, receivers) of a clustered graph (communities of 512 nodes
    holding 80 % of the edges) or of one with a hub row of thousands."""
    rng = np.random.default_rng(seed)
    if kind == "clustered":
        e_in = int(0.8 * e)
        c = rng.integers(0, n // 512, e_in)
        s = np.concatenate([c * 512 + rng.integers(0, 512, e_in),
                            rng.integers(0, n, e - e_in)])
        r = np.concatenate([c * 512 + rng.integers(0, 512, e_in),
                            rng.integers(0, n, e - e_in)])
    else:
        s = rng.integers(0, n, e)
        r = np.where(rng.random(e) < 0.2, 7, rng.integers(0, n, e))
    return s, r


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [64, 65, 8])
@pytest.mark.parametrize("kind", ["clustered", "hub"])
def test_ell_kernel_matches_plain(cuda, kind, width, dtype):
    """K6 over both directions against its plain version (with and
    without ``add_to``): the "spmm" rule, one launch counted, or two where
    the plan splits a bucket (the combine), two calls bit-equal; the hub
    graph has a bucket wider than SPLIT_THRESHOLD."""
    from difformer_tpu_torch.kernels import ell as K6
    from difformer_tpu_torch.ops.ell import build_ell_gcn

    s, r = _layout_graph(kind)
    n = 3000
    x = torch.randn((n, width), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1)).to(dtype)
    base = torch.randn((n, width), device=cuda).to(dtype)
    fwd, rev = (d.to(cuda) for d in build_ell_gcn(s, r, n))
    if kind == "hub":  # the hub's in-edges: a split bucket
        assert max(fwd.bucket_sizes) > K6.SPLIT_THRESHOLD
        assert fwd.split.partials > 0
    for ell in (fwd, rev):
        K6.reset_launch_counts()
        got = K6.ell_spmm_rows(x, ell)
        assert K6.LAUNCHES == {"ell_spmm": 1, "ell_spmm_transposed": 0,
                               "ell_spmm_combine": int(ell.split.partials
                                                       > 0)}
        assert torch.equal(got, K6.ell_spmm_rows(x, ell))
        scale = K6.ell_spmm_abs(x, ell)
        assert_close("K6", got, K6.ell_spmm_plain(x, ell), "spmm",
                     scale=scale)
        added = K6.ell_spmm_rows(x, ell, add_to=base.clone())
        assert_close("K6 add_to", added,
                     K6.ell_spmm_plain(x, ell, add_to=base), "spmm",
                     scale=scale + base.float().abs())


def _hub_layout(cuda):
    """The hub graph's ELL pair on the card, with node 0's only edges to
    node 7 (one) and node 9 (two): real index-0 slots in front of the
    padding of their rows."""
    from difformer_tpu_torch.ops.ell import build_ell_gcn

    s, r = _layout_graph("hub")
    keep = s != 0
    s = np.concatenate([s[keep], [0, 0, 0]])
    r = np.concatenate([r[keep], [7, 9, 9]])
    return [d.to(cuda) for d in build_ell_gcn(s, r, 3000)]


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [8, 64, 65])
def test_ell_split_hub_on_the_card(cuda, width, dtype, threshold):
    """A split hub bucket: K6's kernel alone against its plain version (the
    unsplit rows and the chunks' partial sums over the real slots), the
    combine alone bit-equal to its plain version (the same f32 adds in
    chunk order), the whole product with and without ``add_to`` under the
    "spmm" rule; two calls bit-equal; a call captured in a CUDA graph and
    replayed bit-equal to the eager call. Rows 7 and 9 start their padding
    after real edges to node 0. The reverse direction has no hub: it is
    split at T = 16, every row of it."""
    from difformer_tpu_torch.kernels import ell as K6

    fwd, rev = _hub_layout(cuda)
    fwd, rev = fwd.with_split(threshold), rev.with_split(16)
    row = fwd.inv_perm.cpu()
    assert fwd.pads[row[7], 0].item() == 1
    assert fwd.pads[row[9], 0].item() == 2
    gen = torch.Generator(cuda).manual_seed(width)
    x = torch.randn((3000, width), device=cuda, generator=gen).to(dtype)
    base = torch.randn((3000, width), device=cuda, generator=gen).to(dtype)
    for ell in (fwd, rev):
        assert ell.split.partials > 0
        out, partial = K6.ell_spmm_split(x, ell, add_to=base.clone())
        ref_out, ref_partial = K6.ell_spmm_split_plain(x, ell, base)
        assert_close("K6 partials", partial, ref_partial, "spmm",
                     scale=K6.ell_spmm_split_plain(
                         x.abs(), dataclasses.replace(
                             ell, val=ell.val.abs()))[1])
        unsplit = torch.ones(3000, dtype=torch.bool, device=cuda)
        unsplit[ell.split.rows.long()] = False
        scale = K6.ell_spmm_abs(x, ell).float() + base.float().abs()
        assert_close("K6 unsplit rows", out[unsplit], ref_out[unsplit],
                     "spmm", scale=scale[unsplit])
        assert torch.equal(out[~unsplit], base[~unsplit])
        combined = K6.ell_spmm_combine(partial, out.clone(), ell,
                                       accumulate=True)
        assert torch.equal(combined, K6.ell_spmm_combine_plain(
            partial, out, ell, accumulate=True))
        K6.reset_launch_counts()
        got = K6.ell_spmm_rows(x, ell)
        assert K6.LAUNCHES == {"ell_spmm": 1, "ell_spmm_transposed": 0,
                               "ell_spmm_combine": 1}
        assert_close("K6", got, K6.ell_spmm_plain(x, ell), "spmm",
                     scale=K6.ell_spmm_abs(x, ell))
        assert torch.equal(got, K6.ell_spmm_rows(x, ell))
        added = K6.ell_spmm_rows(x, ell, add_to=base.clone())
        assert_close("K6 add_to", added,
                     K6.ell_spmm_plain(x, ell, add_to=base), "spmm",
                     scale=scale)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = K6.ell_spmm_rows(x, ell)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, got)


@pytest.mark.cuda
def test_ell_skips_the_padding_on_the_card(cuda):
    """A NaN in x[0] reaches only the rows with a real edge to node 0: the
    padding's x[0] is never read (ROADMAP.md queue C)."""
    from difformer_tpu_torch.kernels import ell as K6

    fwd, _ = _hub_layout(cuda)
    x = torch.ones((3000, 8), device=cuda)
    x[0] = float("nan")
    got = K6.ell_spmm_rows(x, fwd)
    hit = torch.zeros(3000, dtype=torch.bool, device=cuda)
    for (r0, _, _), nbr, real in zip(fwd.table, fwd.nbr_idx,
                                     K6.real_slots(fwd)):
        hit[fwd.rows[r0:r0 + nbr.shape[0]].long()] = ((nbr == 0)
                                                      & real).any(1)
    assert hit[7] and hit[9]
    assert torch.isnan(got[hit]).all() and torch.isfinite(got[~hit]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("width", [72, 65])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["padded f32", "padded bf16",
                                    "bucketed int8", "bucketed f32",
                                    "padded T=64", "padded T=48",
                                    "padded T=50"])
def test_bsr_kernel_matches_plain(cuda, layout, dtype, width):
    """K7 (the blocks) and the whole direction (K7, then K6 adding the
    residual) against their plain versions, both directions: the "spmm"
    rule, one launch counted each, two calls bit-equal. Width 72 is read
    in place, 65 staged at a row of 16 bytes; T = 48 and 50 end on part
    of a 32-column slice, and T = 50's rows of 200 bytes are loaded
    without 16-byte copies."""
    from difformer_tpu_torch.kernels import bsr as K7
    from difformer_tpu_torch.kernels import ell as K6
    from difformer_tpu_torch.ops import bsr as B

    s, r = _layout_graph("clustered")
    n = 3000
    tile = int(layout[-2:]) if "T=" in layout else 128
    if layout.startswith("padded"):
        pair = B.build_bsr_gcn(
            s, r, n, tile=tile, min_edges=40,
            block_dtype=torch.bfloat16 if "bf16" in layout else torch.float32)
    else:
        pair = B.build_bsr_bucketed_gcn(s, r, n, tile=tile, min_edges=40,
                                        scaled_int8="int8" in layout)
    x = torch.randn((n, width), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(2)).to(dtype)
    for d in (p.to(cuda) for p in pair):
        assert d.residual is not None
        groups, scale = d.groups(), getattr(d, "inv_scale", None)
        K7.reset_launch_counts()
        K6.reset_launch_counts()
        got = K7.bsr_spmm_blocks(x, groups, tile, scale=scale)
        assert K7.LAUNCHES == {"bsr_spmm": 1, "bsr_spmm_transposed": 0,
                               "bsr_spmm_combine": _splits(groups, tile,
                                                           width, cuda)}
        assert torch.equal(got, K7.bsr_spmm_blocks(x, groups, tile,
                                                   scale=scale))
        ref = K7.bsr_spmm_blocks_plain(x, groups, tile, scale)
        sc = K7.bsr_spmm_blocks_abs(x, groups, tile, scale)
        assert_close("K7", got, ref, "spmm", scale=sc)
        whole = B.bsr_matvec(d, x, transposed=True)
        assert K6.LAUNCHES["ell_spmm_transposed"] == 1
        assert_close("K7 + K6", whole,
                     K6.ell_spmm_plain(x, d.residual, add_to=ref), "spmm",
                     scale=sc + K6.ell_spmm_abs(x, d.residual))


def _splits(groups, tile, width, device):
    """1 where K7's split plan cuts a group at this width on this card (the
    combine kernel then launches), else 0."""
    from difformer_tpu_torch.kernels import bsr as K7

    return int(max(K7.split_plan(K7.group_shapes(groups), tile, width,
                                 K7.sm_count(device))) > 1)


def _check_k7(x, groups, tile, scale=None, **rect):
    """K7 against its plain version under the "spmm" rule, two calls
    bit-equal, a call captured in a CUDA graph equal to the eager one;
    returns the launches of one call. ``rect``: a rectangular shard's
    ``num_rows``, ``row_scale`` and ``col_scale``."""
    from difformer_tpu_torch.kernels import bsr as K7

    K7.reset_launch_counts()
    got = K7.bsr_spmm_blocks(x, groups, tile, scale=scale, **rect)
    launches = dict(K7.LAUNCHES)
    assert_close("K7", got,
                 K7.bsr_spmm_blocks_plain(x, groups, tile, scale, **rect),
                 "spmm", scale=K7.bsr_spmm_blocks_abs(x, groups, tile, scale,
                                                      **rect))
    assert torch.equal(got, K7.bsr_spmm_blocks(x, groups, tile, scale=scale,
                                               **rect))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = K7.bsr_spmm_blocks(x, groups, tile, scale=scale, **rect)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, captured)
    return launches


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("tile", [64, 128, 256])
@pytest.mark.parametrize("width", [1, 3, 64, 65, 72, 300])
def test_bsr_kernel_at_every_width(cuda, width, tile, blocks):
    """K7 on the clustered graph's forward blocks (padded f32 or bf16
    blocks, bucketed int8 counts with their scale) at f32 and bf16 x:
    every width on the one kernel, each block read by the thread blocks of
    one column tile (300: four of 80 columns), one launch a call (two
    where the few row tiles of this small graph are split)."""
    from difformer_tpu_torch.kernels import bsr as K7
    from difformer_tpu_torch.ops import bsr as B

    s, r = _layout_graph("clustered")
    n = 3000
    if blocks == "int8":
        d = B.build_bsr_bucketed_gcn(s, r, n, tile=tile, min_edges=40)[0]
        assert all(b.dtype == torch.int8 for b in d.blocks)
    else:
        d = B.build_bsr_gcn(s, r, n, tile=tile, min_edges=40, block_dtype={
            "f32": torch.float32, "bf16": torch.bfloat16}[blocks])[0]
    d = d.to(cuda)
    groups, scale = d.groups(), getattr(d, "inv_scale", None)
    assert K7.column_tile(width) == {300: 80}.get(width, -(-width // 8) * 8)
    gen = torch.Generator(cuda).manual_seed(width)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((n, width), device=cuda, generator=gen).to(dtype)
        assert _check_k7(x, groups, tile, scale) == {
            "bsr_spmm": 1, "bsr_spmm_transposed": 0,
            "bsr_spmm_combine": _splits(groups, tile, width, cuda)}


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 65])
@pytest.mark.parametrize("tile", [64, 256])
@pytest.mark.parametrize("blocks", ["f32", "int8"])
def test_bsr_kernel_splits_a_hub_row_tile(cuda, blocks, tile, width):
    """A bucket of one row tile of 256 blocks (the hub), a bucket of 8
    row tiles of S and the row tiles without blocks: the hub is cut into
    chunks (split_plan), its partials summed by the combine kernel, the
    other groups written by the first; against the plain version, two
    calls bit-equal, the captured call equal to the eager one."""
    from difformer_tpu_torch.kernels import bsr as K7

    gen = torch.Generator(cuda).manual_seed(tile)
    ntr = 256
    n = ntr * tile - 5
    if blocks == "int8":
        def make(m, kb):
            return torch.randint(0, 3, (m, kb, tile, tile), device=cuda,
                                 generator=gen, dtype=torch.int8)
        scale = torch.rand(n, device=cuda, generator=gen) + 0.1
    else:
        def make(m, kb):
            return torch.randn((m, kb, tile, tile), device=cuda,
                               generator=gen)
        scale = None
    i32 = dict(device=cuda, dtype=torch.int32)
    groups = [
        (make(1, 256), torch.randperm(256, device=cuda, generator=gen)
         .to(torch.int32)[None], torch.tensor([3], **i32)),
        (make(8, K7.SPLIT_BLOCKS),
         torch.randint(0, ntr, (8, K7.SPLIT_BLOCKS), generator=gen, **i32),
         torch.arange(4, 12, **i32)),
        (None, None, torch.tensor([0, 1, 2] + list(range(12, ntr)), **i32)),
    ]
    chunks = K7.split_plan(K7.group_shapes(groups), tile, width,
                           K7.sm_count(cuda))
    assert chunks[0] > 1 and chunks[1:] == [1, 1]
    x = torch.randn((n, width), device=cuda, generator=gen)
    assert _check_k7(x, groups, tile, scale) == {
        "bsr_spmm": 1, "bsr_spmm_transposed": 0, "bsr_spmm_combine": 1}
    # the combine alone against its plain version on the kernel's partials
    out, partial = K7.bsr_spmm_split(x, groups, tile, chunks, scale=scale)
    want = K7.bsr_spmm_combine_plain(partial, out, groups, tile, chunks,
                                     scale)
    assert torch.equal(K7.bsr_spmm_combine(partial, out, groups, tile,
                                           chunks, scale=scale), want)


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [64, 65, 300])
def test_bsr_combine_on_the_card(cuda, width, dtype, scaled):
    """The combine kernel alone on split partials: a hub group of one row
    tile, the last, whose rows run past N (cut into 86 chunks at S = 3),
    and a group of 8 row tiles in 2 chunks; f32 and bf16 out (16-byte and
    8-byte packs at W = 64 and 300, single values at 65), with and without
    the scale: bit-equal to its plain version, two calls bit-equal, the
    rows of other groups untouched, one launch counted."""
    from difformer_tpu_torch.kernels import bsr as K7

    gen = torch.Generator(cuda).manual_seed(width)
    tile, ntr = 256, 16
    n = ntr * tile - 5
    i32 = dict(device=cuda, dtype=torch.int32)
    groups = [
        (torch.empty((1, 256, tile, tile), device=cuda),
         torch.zeros((1, 256), **i32), torch.tensor([ntr - 1], **i32)),
        (torch.empty((8, 6, tile, tile), device=cuda),
         torch.zeros((8, 6), **i32), torch.arange(2, 10, **i32)),
        (None, None, torch.tensor([0, 1, 10, 11, 12, 13, 14], **i32)),
    ]
    chunks = [86, 2, 1]
    size = K7.partial_offsets(groups, chunks, tile, width)[1]
    partial = torch.randn(size, device=cuda, generator=gen)
    out = torch.randn((n, width), device=cuda, generator=gen).to(dtype)
    scale = (torch.rand(n, device=cuda, generator=gen) + 0.1 if scaled
             else None)
    want = K7.bsr_spmm_combine_plain(partial, out, groups, tile, chunks,
                                     scale)
    K7.reset_launch_counts()
    got = K7.bsr_spmm_combine(partial, out.clone(), groups, tile, chunks,
                              scale=scale)
    assert K7.LAUNCHES["bsr_spmm_combine"] == 1
    assert torch.equal(got, want)
    assert torch.equal(got, K7.bsr_spmm_combine(partial, out.clone(), groups,
                                                tile, chunks, scale=scale))
    kept = torch.cat([torch.arange(t * tile, (t + 1) * tile, device=cuda)
                      for t in (0, 1, 10, 11, 12, 13, 14)])
    assert torch.equal(got[kept], out[kept])


@pytest.mark.cuda
def test_bsr_kernel_takes_misaligned_and_strided_x(cuda):
    """x as a view: 4 bytes past an aligned address (staged), a column
    slice of a wider tensor at a row of 16 bytes (read in place, no copy)
    and a transposed one (staged): each as the contiguous copy gives."""
    from difformer_tpu_torch.kernels import bsr as K7
    from difformer_tpu_torch.ops import bsr as B

    s, r = _layout_graph("clustered")
    n, w = 3000, 65
    d = B.build_bsr_gcn(s, r, n, tile=128, min_edges=40)[0].to(cuda)
    groups = d.groups()
    gen = torch.Generator(cuda).manual_seed(0)
    flat = torch.randn(n * w + 1, device=cuda, generator=gen)
    wide = torch.randn((n, 72), device=cuda, generator=gen)
    for x, in_place in ((flat[1:].view(n, w), False), (wide[:, :w], True),
                        (torch.randn((w, n), device=cuda,
                                     generator=gen).t(), False)):
        assert (K7.staged_x(x)[0] is x) == in_place
        _check_k7(x, groups, 128)
        assert torch.equal(K7.bsr_spmm_blocks(x, groups, 128),
                           K7.bsr_spmm_blocks(x.contiguous(), groups, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ell", "bsr", "bsr-bucketed"])
def test_layout_graph_fit_matches_the_loop(cuda, layout):
    """FullBatchTrainer on a sparse layout: the epoch-block fit (CUDA
    graphs, K6 and K7 captured with no host read) against the per-epoch
    loop, losses bit-equal and the best epoch's metrics (device against
    host) at atol 1e-6; the layout's kernels replayed, K1 never launched;
    and against K1's fit from the same weights."""
    from difformer_tpu_torch.ops import bsr as B
    from difformer_tpu_torch.ops.ell import build_ell_gcn

    s, r = _layout_graph("clustered")
    n = 3000
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    y = (np.arange(n) // 512) % 4
    build = {"ell": build_ell_gcn,
             "bsr": lambda s, r, n: B.build_bsr_gcn(s, r, n, tile=128,
                                                    min_edges=40),
             "bsr-bucketed": lambda s, r, n: B.build_bsr_bucketed_gcn(
                 s, r, n, tile=128, min_edges=40)}[layout]
    split = {"train": np.arange(0, n, 2), "valid": np.arange(1, n, 4),
             "test": np.arange(3, n, 4)}
    res = []
    for ell, block in ((build(s, r, n), 5), (build(s, r, n), 0),
                       (None, 5)):
        g = GraphData.from_numpy(x, np.stack([s, r]), device=cuda)
        m = DIFFormer(16, 32, 4, num_layers=2, num_heads=2, dropout=0.2,
                      spmm_first=True, seed=2, device=cuda)
        t = FullBatchTrainer(m, g, y, model_kwargs=None if ell is None
                             else {"ell": ell}, device=cuda)
        K1.reset_launch_counts()
        res.append(t.fit(split, epochs=10, eval_step=2,
                         epoch_block=block)[0])
        if block and ell is not None:
            launches = t.epoch_runner.launches()
            assert launches["csr_spmm"] == 0
            name = "ell_spmm" if layout == "ell" else "bsr_spmm"
            assert launches[name] > 0 and launches[f"{name}_transposed"] > 0
        if ell is not None:
            assert not any(K1.LAUNCHES.values())
    assert res[0]["losses"] == res[1]["losses"]
    assert res[0]["epoch"] == res[1]["epoch"]
    for key in ("train", "valid", "test"):  # device metric against host's
        np.testing.assert_allclose(res[0][key], res[1][key], rtol=0,
                                   atol=1e-6, err_msg=key)
    np.testing.assert_allclose(res[0]["losses"], res[2]["losses"], **GRAD)


@pytest.mark.cuda
def test_repeated_capture_survives_the_packing_threads(cuda):
    """The graph-level trainer's sigmoid step on the dense plan captured 30
    times while its packing threads allocate pinned buffers without pause:
    no capture is invalidated (the captures run in thread-local mode)."""
    import chip_smoke

    _, trainer = _graph_level_trainer(cuda, "sigmoid", True)
    plan, packed = chip_smoke.repeat_captures(trainer, times=30)
    assert plan == "dense" and packed > 0


# --------------------------------------------------------------------------
# the node-sharded main path (difformer_tpu_torch/parallel/)
# --------------------------------------------------------------------------

SHARD_F, SHARD_C, SHARD_STEPS = 16, 4, 3


def _sharded_graph():
    x, ei, y = random_graph(300, 1500, SHARD_F, SHARD_C, seed=21)
    mask = np.zeros(300, bool)
    mask[:150] = True
    return x, standard_preprocess(ei, 300), y, mask


def _rect_plans(cuda):
    """K1's rectangular plans of rank 1 of a 4-rank partition: the
    all-gather's (N_loc rows over N_glob columns), the halo exchange's
    pack and conv, the overlap's internal and boundary products."""
    from difformer_tpu_torch.ops.graph_ops import build_value_plan
    from difformer_tpu_torch.parallel import partition_graph
    from difformer_tpu_torch.parallel.sharded_ops import (halo_plan,
                                                          overlap_plan)

    x, ei, y, _ = _sharded_graph()
    sg = partition_graph(x, ei, 4, labels=y, build_halo=True)
    rg = sg.rank_graph(1, cuda)
    senders, halo = rg.senders_and_halo()
    n_loc = rg.nodes_per_shard
    em = rg.edge_mask
    gather = build_value_plan(em.float()[em], rg.senders[em],
                              rg.receivers[em], n_loc, 4 * n_loc)
    hp = halo_plan(senders, rg.receivers, rg.edge_value, rg.send_idx,
                   rg.send_mask, n_loc)
    op = overlap_plan(halo, n_loc)
    return {"gather": gather, "pack": hp.pack, "conv": hp.conv,
            "internal": op.internal, "boundary": op.boundary}


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 64, 65])
def test_rectangular_k1_plans_match_plain(cuda, width):
    g = torch.Generator(device=cuda).manual_seed(width)
    for name, plan in _rect_plans(cuda).items():
        assert plan.num_edges > 0, name
        for transposed, (ptr, col, val, split), rows_in in (
                (False, (plan.row_ptr, plan.col, plan.val, plan.split),
                 plan.num_cols),
                (True, (plan.t_row_ptr, plan.t_col, plan.t_val,
                        plan.t_split), plan.num_nodes)):
            xin = torch.randn((rows_in, width), device=cuda, generator=g)
            K1.reset_launch_counts()
            out = K1.csr_spmm(xin, ptr, col, val, split=split,
                              transposed=transposed)
            torch.cuda.synchronize()
            key = "csr_spmm_transposed" if transposed else "csr_spmm"
            assert K1.LAUNCHES[key] == 1
            assert out.shape == (ptr.numel() - 1, width)
            ref = K1.csr_spmm_plain(xin, ptr, col, val)
            assert_close(f"{name} transposed={transposed}", out, ref, "spmm",
                         scale=K1.csr_spmm_abs(xin, ptr, col, val))
            assert torch.equal(out, K1.csr_spmm(xin, ptr, col, val,
                                                split=split))


def _sharded_run(cuda, world, backend, flavours):
    """(unsharded losses and final logits, the ranks' results, the
    partitions) of SHARD_STEPS steps of a 2-layer DIFFormer-s from one set
    of weights: eager on the card unsharded, and sharded on ``world``
    ranks of ``backend`` for each exchange in ``flavours``."""
    from difformer_tpu_torch.parallel import partition_graph
    from difformer_tpu_torch.parallel.launch import run_ranks
    from difformer_tpu_torch.parallel.rank_checks import run_checks
    from difformer_tpu_torch.train.optim import torch_adam
    from difformer_tpu_torch.train.trainer import nll_loss
    from difformer_tpu_torch.utils.weights import params_from_torch_state_dict

    x, ei, y, mask = _sharded_graph()
    kw = dict(in_channels=SHARD_F, hidden_channels=32,
              out_channels=SHARD_C, num_layers=2, dropout=0.0)
    model = DIFFormer(SHARD_F, 32, SHARD_C, num_layers=2, dropout=0.0,
                      seed=3, device=cuda)
    params = params_from_torch_state_dict(model.state_dict())
    opt = torch_adam(model.parameters(), 1e-2, 5e-4)
    args = [torch.as_tensor(a, device=cuda) for a in (x, ei[0], ei[1])]
    labels, train = (torch.as_tensor(a, device=cuda) for a in (y, mask))
    losses = []
    for _ in range(SHARD_STEPS):
        model.train()
        opt.zero_grad()
        loss = nll_loss(model(*args), labels, train)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    model.eval()
    with torch.no_grad():
        logits = model(*args).cpu().numpy()
    halo = partition_graph(x, ei, world, labels=y, label_mask=mask,
                           build_halo=True)
    parts = {"gather": partition_graph(x, ei, world, labels=y,
                                       label_mask=mask),
             "halo": halo.without_overlap(), "overlap": halo}
    outs = run_ranks(run_checks, world, backend, "cuda",
                     [dict(kind="train", sg=parts[f], params=params,
                           model_kw=kw, steps=SHARD_STEPS)
                      for f in flavours])
    return np.array(losses), logits, outs, parts


def _check_sharded(outs, parts, flavours, losses, logits):
    for i, flavour in enumerate(flavours):
        sg = parts[flavour]
        got = np.concatenate([o[i]["logits"] for o in outs])
        got = got[sg.node_mask.reshape(-1)]
        np.testing.assert_allclose(outs[0][i]["losses"], losses, **GRAD)
        np.testing.assert_allclose(got, logits, **GRAD)
        for out in outs:
            want = SHARD_STEPS * 2 * out[i]["products"]
            assert out[i]["products"] >= 1
            assert out[i]["launches"] == {"csr_spmm": want,
                                          "csr_spmm_transposed": want}
            assert not out[i]["jax_loaded"]


@pytest.mark.cuda
def test_nccl_world_one_follows_the_unsharded_step(cuda):
    flavours = ("gather", "halo", "overlap")
    losses, logits, outs, parts = _sharded_run(cuda, 1, "nccl", flavours)
    _check_sharded(outs, parts, flavours, losses, logits)


@pytest.mark.cuda
def test_gloo_ranks_sharing_the_card_follow_the_unsharded_step(cuda):
    flavours = ("gather", "overlap")
    losses, logits, outs, parts = _sharded_run(cuda, 2, "gloo", flavours)
    _check_sharded(outs, parts, flavours, losses, logits)


@pytest.mark.cuda
def test_nccl_with_more_ranks_than_cards_raises(cuda):
    from difformer_tpu_torch.parallel.launch import run_ranks
    from difformer_tpu_torch.parallel.rank_checks import run_checks

    with pytest.raises(ValueError, match="one rank on a card"):
        run_ranks(run_checks, torch.cuda.device_count() + 1, "nccl", "cuda",
                  [])


@pytest.mark.cuda
def test_nccl_world_one_captured_fit_follows_the_unsharded_fit(cuda):
    # the distributed trainer's epoch-block fit at one NCCL rank: its step
    # and eval captured as CUDA graphs (the collectives in them), against
    # FullBatchTrainer's captured fit from the same weights, at dropout 0
    from difformer_tpu_torch.data.splits import rand_train_test_idx
    from difformer_tpu_torch.parallel.launch import run_ranks
    from difformer_tpu_torch.parallel.rank_checks import run_checks
    from difformer_tpu_torch.utils.weights import params_from_torch_state_dict

    x, ei, y, _ = _sharded_graph()
    split = rand_train_test_idx(y, 0.5, 0.25, rng=0)
    model = DIFFormer(SHARD_F, 32, SHARD_C, num_layers=2, dropout=0.0,
                      seed=3, device=cuda)
    params = params_from_torch_state_dict(model.state_dict())
    trainer = FullBatchTrainer(model, GraphData.from_numpy(x, ei,
                                                           device=cuda),
                               y, lr=1e-2, weight_decay=5e-4, device=cuda)
    fit_kw = dict(epochs=12, eval_step=1, epoch_block=4)
    best = trainer.fit(split, init_params=params, **fit_kw)[0]
    logits = trainer.forward_eval(trainer.epoch_runner.state).cpu().numpy()
    case = run_ranks(run_checks, 1, "nccl", "cuda", [dict(
        kind="fit", x=x, ei=ei, y=y, split=split,
        model_kw=dict(in_channels=SHARD_F, hidden_channels=32,
                      out_channels=SHARD_C, num_layers=2, dropout=0.0),
        trainer_kw=dict(lr=1e-2, weight_decay=5e-4), fits=[fit_kw],
        init_params=params)])[0][0]
    out = case["fits"][0]
    assert out["captured"] and not case["jax_loaded"]
    assert {name: g["replays"] for name, g in out["graphs"].items()} == {
        "step": 12, "eval": 12}
    np.testing.assert_allclose(out["summaries"][0]["losses"],
                               best["losses"], **GRAD)
    np.testing.assert_allclose(out["logits"], logits, **GRAD)
    products = case["products"]
    assert out["launches"] == {"csr_spmm": products * 2 * 24,
                               "csr_spmm_transposed": products * 2 * 12}


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 65])
@pytest.mark.parametrize("int8", ["auto", False])
@pytest.mark.parametrize("rank", [0, 1])
def test_bsr_kernel_on_a_rectangular_shard(cuda, rank, int8, width):
    """K7 on a rank's shard of the node-sharded hybrid (rows_per rows over
    the pad_n gathered ones; rank 0 holds a hub row tile, and the split
    plan cuts both shards),
    int8 counts with their row and column scales or value blocks, against
    the plain version; the whole shard's product (K7 and K1's residual)
    against the plain one."""
    from difformer_tpu_torch.kernels import bsr as K7
    from difformer_tpu_torch.ops import bsr as B

    n, tile = 4096, 64
    rng = np.random.default_rng(width)
    hub = np.nonzero(rng.random((tile, n)) < 0.3)
    blocks = [np.stack([hub[1], hub[0]])]
    for c in range(n // tile):
        r, co = np.nonzero(rng.random((tile, tile)) < 0.2)
        blocks.append(np.stack([co + c * tile, r + c * tile]))
    blocks.append(rng.integers(0, n, (2, 3000)))
    ei = np.concatenate(blocks, 1)
    fwd, _, rows_per = B.build_bsr_gcn_sharded(ei[0], ei[1], n, 2, tile=tile,
                                               min_edges=64,
                                               scaled_int8=int8)
    d = fwd.rank_shard(rank, None, cuda)
    x = torch.randn((2 * rows_per, width), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(rank))
    rect = dict(num_rows=rows_per, row_scale=d.inv_rows,
                col_scale=d.inv_cols)
    # every shard is padded to the hub row tile's blocks (the JAX build's
    # one Kb), so the split plan, which reads shapes alone, cuts both
    split = _splits(d.groups(), tile, width, cuda)
    assert split == 1
    assert _check_k7(x, d.groups(), tile, **rect) == {
        "bsr_spmm": 1, "bsr_spmm_transposed": 0, "bsr_spmm_combine": split}
    got = B.bsr_shard_apply(d, x)
    cpu = fwd.rank_shard(rank, None, "cpu")
    np.testing.assert_allclose(got.cpu().numpy(),
                               B.bsr_shard_apply(cpu, x.cpu()).numpy(),
                               rtol=1e-4, atol=1e-5)


def _slice_graph_run(cuda, world, backend, flavours):
    """(unsharded losses and logits, the ranks' results, the partitions) of
    SHARD_STEPS steps from one set of weights of a 2-layer DIFFormer for
    each of ``flavours``: "ring" (kernel="sigmoid" on the all-gather
    partition), "bsr" (the block-sparse hybrid at T = 64), "ring-bsr"."""
    from difformer_tpu_torch.ops.bsr import build_bsr_gcn_sharded
    from difformer_tpu_torch.parallel import partition_graph
    from difformer_tpu_torch.parallel.launch import run_ranks
    from difformer_tpu_torch.parallel.rank_checks import run_checks
    from difformer_tpu_torch.train.optim import torch_adam
    from difformer_tpu_torch.train.trainer import nll_loss
    from difformer_tpu_torch.utils.weights import params_from_torch_state_dict

    x, ei, y, mask = _sharded_graph()
    n = x.shape[0]
    refs, cases, parts = {}, [], {}
    for flavour in flavours:
        kernel = "sigmoid" if flavour.startswith("ring") else "simple"
        model = DIFFormer(SHARD_F, 32, SHARD_C, num_layers=2, dropout=0.0,
                          kernel=kernel, seed=3, device=cuda)
        params = params_from_torch_state_dict(model.state_dict())
        opt = torch_adam(model.parameters(), 1e-2, 5e-4)
        args = [torch.as_tensor(a, device=cuda) for a in (x, ei[0], ei[1])]
        labels, train = (torch.as_tensor(a, device=cuda) for a in (y, mask))
        losses = []
        for _ in range(SHARD_STEPS):
            model.train()
            opt.zero_grad()
            loss = nll_loss(model(*args), labels, train)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        model.eval()
        with torch.no_grad():
            refs[flavour] = (np.array(losses), model(*args).cpu().numpy())
        ell = None
        kw = dict(labels=y, label_mask=mask)
        if "bsr" in flavour:
            kw.update(build_halo=False, node_align=64)
            ell = build_bsr_gcn_sharded(ei[0], ei[1], n, world, tile=64,
                                        min_edges=8)[:2]
        parts[flavour] = partition_graph(x, ei, world, **kw)
        cases.append(dict(kind="train", sg=parts[flavour], params=params,
                          model_kw=dict(in_channels=SHARD_F,
                                        hidden_channels=32,
                                        out_channels=SHARD_C, num_layers=2,
                                        dropout=0.0, kernel=kernel),
                          steps=SHARD_STEPS, ell=ell))
    outs = run_ranks(run_checks, world, backend, "cuda", cases)
    return refs, outs, parts


def _check_slice(refs, outs, parts, flavours):
    """Each flavour's sharded run against its unsharded one, and its
    kernels launched: K2 per layer and ring step, K3 and K4 in the
    backward, K7 and K1 per layer and direction on the hybrid."""
    for i, flavour in enumerate(flavours):
        losses, logits = refs[flavour]
        got = np.concatenate([o[i]["logits"] for o in outs])
        got = got[parts[flavour].node_mask.reshape(-1)]
        np.testing.assert_allclose(outs[0][i]["losses"], losses, **GRAD)
        np.testing.assert_allclose(got, logits, **GRAD)
        ring = SHARD_STEPS * 2 * len(outs)
        for out in outs:
            launches = out[i]["launches"]
            assert not out[i]["jax_loaded"]
            if flavour.startswith("ring"):
                assert launches["sigmoid_attention_fwd"] == ring
                assert launches["sigmoid_attention_dq"] == ring
                assert launches["sigmoid_attention_dkv"] == ring
            if "bsr" in flavour:
                assert out[i]["products"] == 0
                assert launches["bsr_spmm"] == SHARD_STEPS * 2
                assert launches["bsr_spmm_transposed"] == SHARD_STEPS * 2
                assert launches["csr_spmm"] == SHARD_STEPS * 2


@pytest.mark.cuda
def test_nccl_world_one_ring_and_hybrid_follow_the_unsharded_step(cuda):
    flavours = ("ring", "bsr", "ring-bsr")
    refs, outs, parts = _slice_graph_run(cuda, 1, "nccl", flavours)
    _check_slice(refs, outs, parts, flavours)


@pytest.mark.cuda
def test_gloo_ranks_sharing_the_card_run_the_ring_and_hybrid(cuda):
    flavours = ("ring", "ring-bsr")
    refs, outs, parts = _slice_graph_run(cuda, 2, "gloo", flavours)
    _check_slice(refs, outs, parts, flavours)


@pytest.mark.cuda
def test_ring_shift_under_nccl_capture_and_gloo_on_the_card(cuda):
    """The ring's exchange at one NCCL rank recorded in a CUDA graph and
    replayed, and on 2 gloo ranks sharing the card (rank r gets rank
    r − 1's rows, the gradient goes back)."""
    from difformer_tpu_torch.parallel.launch import run_ranks
    from difformer_tpu_torch.parallel.rank_checks import run_checks

    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 3, 5)).astype(np.float32)
    cot = rng.normal(size=(8, 3, 5)).astype(np.float32)
    outs = run_ranks(run_checks, 2, "gloo", "cuda", [
        dict(kind="shift", x=x, cot=cot, n_loc=4)])
    np.testing.assert_array_equal(
        np.concatenate([o[0]["out"] for o in outs]),
        np.roll(x.reshape(2, 4, 3, 5), 1, 0).reshape(x.shape))
    np.testing.assert_array_equal(
        np.concatenate([o[0]["grad"] for o in outs]),
        np.roll(cot.reshape(2, 4, 3, 5), -1, 0).reshape(x.shape))
    (out,) = run_ranks(run_checks, 1, "nccl", "cuda", [
        dict(kind="shift", x=x, cot=cot, n_loc=8, captured=True)])
    np.testing.assert_array_equal(out[0]["out"], x)
    np.testing.assert_array_equal(out[0]["grad"], cot)
    assert out[0]["replayed"]


@pytest.mark.cuda
def test_nccl_world_one_captured_fit_on_the_ring_and_hybrid(cuda):
    # the distributed trainer with kernel="sigmoid" and spmm="bsr" at one
    # NCCL rank, step and eval captured, against FullBatchTrainer's
    # captured fit from the same weights at dropout 0
    from difformer_tpu_torch.data.splits import rand_train_test_idx
    from difformer_tpu_torch.parallel.launch import run_ranks
    from difformer_tpu_torch.parallel.rank_checks import run_checks
    from difformer_tpu_torch.utils.weights import params_from_torch_state_dict

    x, ei, y, _ = _sharded_graph()
    split = rand_train_test_idx(y, 0.5, 0.25, rng=0)
    model = DIFFormer(SHARD_F, 32, SHARD_C, num_layers=2, dropout=0.0,
                      kernel="sigmoid", seed=3, device=cuda)
    params = params_from_torch_state_dict(model.state_dict())
    trainer = FullBatchTrainer(model, GraphData.from_numpy(x, ei,
                                                           device=cuda),
                               y, lr=1e-2, weight_decay=5e-4, device=cuda)
    fit_kw = dict(epochs=12, eval_step=1, epoch_block=4)
    best = trainer.fit(split, init_params=params, **fit_kw)[0]
    logits = trainer.forward_eval(trainer.epoch_runner.state).cpu().numpy()
    case = run_ranks(run_checks, 1, "nccl", "cuda", [dict(
        kind="fit", x=x, ei=ei, y=y, split=split,
        model_kw=dict(in_channels=SHARD_F, hidden_channels=32,
                      out_channels=SHARD_C, num_layers=2, dropout=0.0,
                      kernel="sigmoid"),
        trainer_kw=dict(lr=1e-2, weight_decay=5e-4, spmm="bsr",
                        bsr_tile=64), fits=[fit_kw], init_params=params)])
    out = case[0][0]["fits"][0]
    assert out["captured"]
    np.testing.assert_allclose(out["summaries"][0]["losses"],
                               best["losses"], **GRAD)
    np.testing.assert_allclose(out["logits"][:x.shape[0]], logits, **GRAD)
    launches = out["launches"]
    assert launches["sigmoid_attention_fwd"] == 2 * 24
    assert launches["sigmoid_attention_dkv"] == 2 * 12
    assert launches["bsr_spmm"] == 2 * 24
    assert launches["bsr_spmm_transposed"] == 2 * 12
