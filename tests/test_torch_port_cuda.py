"""The port's CUDA kernels on the GPU, against their plain versions.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one:
a CUDA kernel has no CPU mode. The file imports no JAX, so it runs on a GPU
machine without it:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -p no:cacheprovider

Tolerances: each kernel against its plain version under the one rule of
``difformer_tpu_torch/kernels/tolerance.py`` (float32 at the JAX package's
own tolerances, the unnormalized numerator per unit of its row's
denominator, bfloat16 relative to the largest reference value); the model's
logits and gradients rtol 1e-3 / atol 1e-4 (layers of kernel-vs-plain
float32 rounding).
"""

import numpy as np
import pytest
import torch

from difformer_tpu_torch import DIFFormer, FullBatchTrainer, GraphData
from difformer_tpu_torch.data import random_graph, standard_preprocess
from difformer_tpu_torch.kernels import sigmoid_attention as K
from difformer_tpu_torch.kernels.tolerance import assert_close
from torch_port_helpers import cuda, make_inputs  # noqa: F401
from torch_port_helpers import to_torch as _t

GRAD = dict(rtol=1e-3, atol=1e-4)
SHAPES = [
    ((300, 300, 1, 64, 64), False),
    ((200, 333, 2, 32, 48), True),
    ((150, 90, 3, 100, 120), True),
    ((70, 65, 1, 256, 200), False),
    ((1024, 3000, 1, 64, 64), True),  # L in the thousands: num scales by den
]


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
    out, den = K.sigmoid_attention_fwd(q_view, kc, v_bcast, mc)
    ref, ref_den = K.sigmoid_attention_fwd_plain(q_view, kc, v_bcast, mc)
    assert_close("out", out, ref, "out")
    assert_close("den", den, ref_den, "den")


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
