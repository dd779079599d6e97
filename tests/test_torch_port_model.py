"""DIFFormer-a in the port against the JAX package's, on carried weights.

Both models get the same weights (the JAX init, carried over with
``difformer_tpu_torch.utils.weights``) and the same numpy inputs; the port
runs on the CPU through the plain kernel versions. Logits and every
parameter's gradient agree to rtol 2e-4 / atol 2e-5, the tolerance the JAX
package holds itself to against the reference
(tests/test_reference_exec.py:334).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difformer_tpu.data.graph import GraphData as JGraph
from difformer_tpu.data.synthetic import random_graph
from difformer_tpu.data.transforms import standard_preprocess
from difformer_tpu.nn.difformer import DIFFormer as JDIFFormer
from difformer_tpu.utils.torch_import import torch_state_dict_from_params
from difformer_tpu_torch import DIFFormer, GraphData
from difformer_tpu_torch.utils import weights as W

TOL = dict(rtol=2e-4, atol=2e-5)
N, F, C, HIDDEN = 40, 8, 3, 16


def _graph():
    x, ei, y = random_graph(N, 160, F, C, seed=4, homophily=0.7)
    ei = standard_preprocess(ei, N)
    return (JGraph.from_numpy(x, ei), GraphData.from_numpy(x, ei, device="cpu"),
            y)


def _models(heads, **flags):
    kw = dict(num_layers=2, num_heads=heads, kernel="sigmoid", dropout=0.0,
              **flags)
    jm = JDIFFormer(hidden_channels=HIDDEN, out_channels=C, **kw)
    jg, tg, y = _graph()
    params = jm.init(jax.random.PRNGKey(heads), jg.node_feat, jg.senders,
                     jg.receivers)["params"]
    tm = DIFFormer(F, HIDDEN, C, device="cpu", **kw)
    W.load_params(tm, params)
    return jm, params, jg, tm, tg, y


VARIANTS = [
    (1, {}),
    (2, {}),
    (2, {"use_graph": False}),
    (1, {"graph_weight": 0.7}),
    (2, {"graph_weight": 0.7, "use_source": True}),
    (1, {"use_weight": False}),
    (1, {"use_weight": False, "use_residual": False, "use_bn": False}),
]


@pytest.mark.parametrize("heads,flags", VARIANTS)
def test_logits_and_grads_match_jax(heads, flags):
    jm, params, jg, tm, tg, y = _models(heads, **flags)
    w = np.random.default_rng(0).normal(size=(N, C)).astype(np.float32)

    def loss_j(p):
        out = jm.apply({"params": p}, jg.node_feat, jg.senders, jg.receivers)
        return jnp.sum(out * w), out

    (_, out_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(params)

    out_t = tm(tg.node_feat, tg.senders, tg.receivers)
    (out_t * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)

    grads_t = W.params_from_torch_state_dict(
        {name: p.grad for name, p in tm.named_parameters()})
    flat_j = jax.tree_util.tree_leaves_with_path(grads_j)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(grads_t))
    assert len(flat_j) == len(flat_t) > 0
    for path, gj in flat_j:
        np.testing.assert_allclose(flat_t[path], np.asarray(gj), **TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_output_attn_matches_jax():
    jm, params, jg, tm, tg, _ = _models(2, graph_weight=0.7)
    out_j, attn_j = jm.apply({"params": params}, jg.node_feat, jg.senders,
                             jg.receivers, output_attn=True)
    out_t, attn_t = tm(tg.node_feat, tg.senders, tg.receivers,
                       output_attn=True)
    assert attn_t.shape == (2, N, N, 2)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    np.testing.assert_allclose(attn_t.detach().numpy(), np.asarray(attn_j),
                               **TOL)


def test_weight_carry_round_trips_exactly():
    _, params, _, tm, _, _ = _models(2, graph_weight=0.7)
    # the port's copy of the converter agrees with the JAX package's
    sd_port = W.torch_state_dict_from_params(params)
    sd_jax = torch_state_dict_from_params(params)
    assert sd_port.keys() == sd_jax.keys() == tm.state_dict().keys()
    for k in sd_port:
        np.testing.assert_array_equal(sd_port[k], sd_jax[k])
        np.testing.assert_array_equal(tm.state_dict()[k].numpy(), sd_port[k])
    back = W.params_from_torch_state_dict(tm.state_dict())
    leaves = {jax.tree_util.keystr(p): v
              for p, v in jax.tree_util.tree_leaves_with_path(params)}
    leaves_back = {jax.tree_util.keystr(p): v
                   for p, v in jax.tree_util.tree_leaves_with_path(back)}
    assert leaves.keys() == leaves_back.keys()
    for k, v in leaves.items():
        np.testing.assert_array_equal(np.asarray(v), leaves_back[k])


def test_state_dict_names_follow_the_reference():
    tm = DIFFormer(F, HIDDEN, C, num_layers=2, kernel="sigmoid", device="cpu")
    names = set(tm.state_dict())
    assert {"fcs.0.weight", "fcs.1.bias", "bns.0.weight", "bns.2.bias",
            "convs.1.Wq.weight", "convs.1.Wk.bias", "convs.0.Wv.weight"} <= names


def test_init_is_seeded_and_uniform():
    a = DIFFormer(F, HIDDEN, C, kernel="sigmoid", seed=3, device="cpu")
    b = DIFFormer(F, HIDDEN, C, kernel="sigmoid", seed=3, device="cpu")
    c = DIFFormer(F, HIDDEN, C, kernel="sigmoid", seed=4, device="cpu")
    for (name, pa), pb, pc in zip(a.state_dict().items(),
                                  b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb)
        if name.startswith(("fcs", "convs")):
            assert not torch.equal(pa, pc)
            fan_in = a.get_submodule(name.rsplit(".", 1)[0]).in_features
            assert pa.abs().max() <= fan_in ** -0.5


@pytest.mark.parametrize("kwargs", [
    dict(kernel="simple"),
    dict(kernel="sigmoid", spmm_first=True),
    dict(kernel="sigmoid", num_heads=4, spmm_first="auto"),
    dict(kernel="sigmoid", fuse_head_mean=True),
    dict(kernel="sigmoid", compute_dtype="bfloat16"),
    dict(kernel="sigmoid", remat=True),
    dict(kernel="sigmoid", axis_name="graph"),
])
def test_unsupported_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        DIFFormer(F, HIDDEN, C, device="cpu", **kwargs)


@pytest.mark.parametrize("call_kw", [dict(ell=(1, 2)), dict(halo=(1,)),
                                     dict(edge_chunk_size=64)])
def test_unsupported_call_options_raise(call_kw):
    tm = DIFFormer(F, HIDDEN, C, kernel="sigmoid", device="cpu")
    _, tg, _ = _graph()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tm(tg.node_feat, tg.senders, tg.receivers, **call_kw)


def test_spmm_first_auto_stays_off_at_one_head():
    DIFFormer(F, HIDDEN, C, kernel="sigmoid", spmm_first="auto",
              device="cpu")
