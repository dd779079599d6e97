"""The port's CUDA kernels on the GPU, against their plain versions.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one:
a CUDA kernel has no CPU mode. The file imports no JAX, so it runs on a GPU
machine without it:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -p no:cacheprovider

Tolerances: each kernel against its plain version under the one rule of
``difformer_tpu_torch/kernels/tolerance.py`` (float32 at the JAX package's
own tolerances, the unnormalized numerator per unit of its row's
denominator, bfloat16 relative to the largest reference value, the CSR
SpMM K1 at the forward's float32 tolerance); the model's logits and
gradients rtol 1e-3 / atol 1e-4 (layers of kernel-vs-plain float32
rounding).
"""

import numpy as np
import pytest
import torch

from difformer_tpu_torch import DIFFormer, FullBatchTrainer, GraphData
from difformer_tpu_torch.data import random_graph, standard_preprocess
from difformer_tpu_torch.kernels import sigmoid_attention as K
from difformer_tpu_torch.kernels import spmm as K1
from difformer_tpu_torch.kernels.tolerance import assert_close
from difformer_tpu_torch.ops.graph_ops import build_csr_plan, gcn_conv
from torch_port_helpers import cuda, make_inputs  # noqa: F401
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
