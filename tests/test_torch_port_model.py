"""DIFFormer-s and DIFFormer-a in the port against the JAX package's, on
carried weights.

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
import torch_port_helpers  # noqa: F401  (sets torch's threads)

TOL = dict(rtol=2e-4, atol=2e-5)
N, F, C, HIDDEN = 40, 8, 3, 16


def _graph():
    x, ei, y = random_graph(N, 160, F, C, seed=4, homophily=0.7)
    ei = standard_preprocess(ei, N)
    return (JGraph.from_numpy(x, ei), GraphData.from_numpy(x, ei, device="cpu"),
            y)


def _models(heads, kernel="sigmoid", **flags):
    kw = dict(num_layers=2, num_heads=heads, kernel=kernel, dropout=0.0,
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


# DIFFormer-s at HIDDEN = 16: spmm_first's "auto" is on from H = 3
# (H·D ≥ 2·(F+1) = 34) and fuse_head_mean's from H = 2; a fused layer with
# a value projection factors Wv through the key aggregates
SIMPLE_VARIANTS = [
    (1, {}),
    (2, {}),
    (2, {"fuse_head_mean": False}),
    (1, {"fuse_head_mean": True}),
    (2, {"use_graph": False}),
    (1, {"graph_weight": 0.7}),
    (2, {"graph_weight": 0.7, "use_source": True}),
    (1, {"use_weight": False}),
    (2, {"use_weight": False, "fuse_head_mean": True}),
    (1, {"use_weight": False, "use_residual": False, "use_bn": False}),
    (1, {"spmm_first": True}),
    (2, {"spmm_first": True}),
    (2, {"spmm_first": True, "fuse_head_mean": False, "graph_weight": 0.7}),
    (4, {"spmm_first": "auto"}),
    (2, {"spmm_first": "auto", "fuse_head_mean": "auto"}),
]


def _check_logits_and_grads(heads, kernel, flags, call_t=None, **call):
    """Logits and every parameter's gradient of ``sum(out * w)``; the JAX
    model gets ``call``, the port's ``call_t`` (default: the same)."""
    jm, params, jg, tm, tg, y = _models(heads, kernel, **flags)
    w = np.random.default_rng(0).normal(size=(N, C)).astype(np.float32)
    call_j = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
              for k, v in call.items()}
    if call_t is None:
        call_t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                  for k, v in call.items()}

    def loss_j(p):
        out = jm.apply({"params": p}, jg.node_feat, jg.senders, jg.receivers,
                       **call_j)
        return jnp.sum(out * w), out

    (_, out_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(params)

    out_t = tm(tg.node_feat, tg.senders, tg.receivers, **call_t)
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


@pytest.mark.parametrize("heads,flags", VARIANTS)
def test_logits_and_grads_match_jax(heads, flags):
    _check_logits_and_grads(heads, "sigmoid", flags)


@pytest.mark.parametrize("heads,flags", SIMPLE_VARIANTS)
def test_simple_logits_and_grads_match_jax(heads, flags):
    _check_logits_and_grads(heads, "simple", flags)


def _call_options():
    rng = np.random.default_rng(3)
    node_mask = rng.random(N) > 0.2
    _, tg, _ = _graph()
    edge_mask = rng.random(tg.num_edges) > 0.3
    return {
        "node_mask": dict(node_mask=node_mask),
        "num_nodes_global": dict(num_nodes_global=57),
        "edge_mask": dict(edge_mask=edge_mask),
        "edge_chunk_size": dict(edge_chunk_size=64),
        "indices_are_sorted": dict(indices_are_sorted=True),
    }


@pytest.mark.parametrize("option", sorted(_call_options()))
@pytest.mark.parametrize("heads,flags", [(1, {}), (2, {"spmm_first": True})])
def test_simple_call_options_match_jax(heads, flags, option):
    _check_logits_and_grads(heads, "simple", flags,
                            **_call_options()[option])


@pytest.mark.parametrize("heads", [1, 2])
def test_graph_plan_replaces_the_edges(heads):
    """The graph's CSR plan, passed in, gives what the edges give."""
    _, tg, _ = _graph()
    edge_mask = np.random.default_rng(4).random(tg.num_edges) > 0.3
    tg.edge_mask = torch.from_numpy(edge_mask)
    _check_logits_and_grads(heads, "simple", {"spmm_first": True},
                            call_t=dict(plan=tg.csr_plan()),
                            edge_mask=edge_mask)


@pytest.mark.parametrize("kwargs", [
    dict(kernel="simple"),
    dict(kernel="sigmoid", spmm_first=True),
    dict(kernel="sigmoid", num_heads=4, spmm_first="auto"),
    dict(kernel="sigmoid", fuse_head_mean=True),
    dict(kernel="sigmoid", call=dict(edge_chunk_size=64)),
])
def test_formerly_unported_options_match_jax(kwargs):
    """Options the port raised on before DIFFormer-s was ported. The JAX
    package runs the sigmoid kernel with spmm_first, and with
    fuse_head_mean=True simply does not fuse (fusion needs the simple
    kernel)."""
    kwargs = dict(kwargs)
    call = kwargs.pop("call", {})
    _check_logits_and_grads(kwargs.pop("num_heads", 1), kwargs.pop("kernel"),
                            kwargs, **call)


def _check_output_attn(kernel):
    jm, params, jg, tm, tg, _ = _models(2, kernel, graph_weight=0.7)
    out_j, attn_j = jm.apply({"params": params}, jg.node_feat, jg.senders,
                             jg.receivers, output_attn=True)
    out_t, attn_t = tm(tg.node_feat, tg.senders, tg.receivers,
                       output_attn=True)
    assert attn_t.shape == (2, N, N, 2)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    np.testing.assert_allclose(attn_t.detach().numpy(), np.asarray(attn_j),
                               **TOL)


def test_output_attn_matches_jax():
    _check_output_attn("sigmoid")


def test_simple_output_attn_matches_jax():
    """DIFFormer-s's [L, N, N, H] attention, with the [N, 1, H] normaliser
    (fusion and spmm_first are off under output_attn)."""
    _check_output_attn("simple")


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
    dict(kernel="sigmoid", axis_name="graph"),
])
def test_unsupported_options_raise(kwargs):
    # the port's graph axis is a process group, not the JAX package's name
    with pytest.raises(TypeError, match="process group"):
        DIFFormer(F, HIDDEN, C, device="cpu", **kwargs)


@pytest.mark.parametrize("call_kw", [dict(ell=(1, 2))])
def test_unsupported_call_options_raise(call_kw):
    _, tg, _ = _graph()
    for kernel in ("sigmoid", "simple"):
        tm = DIFFormer(F, HIDDEN, C, kernel=kernel, device="cpu")
        with pytest.raises(TypeError, match="gcn_conv_ell takes"):
            tm(tg.node_feat, tg.senders, tg.receivers, **call_kw)


@pytest.mark.parametrize("kernel", ["sigmoid", "simple"])
def test_spmm_first_auto_stays_off_at_one_head(kernel, monkeypatch):
    """The layers' input is HIDDEN wide, so "auto" is on only when
    H·HIDDEN ≥ 2·(HIDDEN+1): never at one head. The graph branch then
    convolves the [N, 1, HIDDEN] values, not the HIDDEN+1 wide rows of
    [x, 1]."""
    from difformer_tpu_torch.nn import difformer as module
    widths = []
    real = module.gcn_conv

    def recording(x, *args, **kwargs):
        widths.append(tuple(x.shape[1:]))
        return real(x, *args, **kwargs)

    monkeypatch.setattr(module, "gcn_conv", recording)
    _, tg, _ = _graph()
    tm = DIFFormer(F, HIDDEN, C, kernel=kernel, spmm_first="auto",
                   device="cpu")
    tm(tg.node_feat, tg.senders, tg.receivers)
    assert widths == [(1, HIDDEN)] * tm.num_layers
