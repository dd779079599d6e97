"""Rank functions that run the sharded ops on numpy inputs and return numpy
outputs, for ``launch.run_ranks`` (the port's tests and ``chip_smoke.py``
call them; a spawned rank imports them from here, never from a test).

:func:`run_checks` runs a list of cases in one spawn of the ranks: each
case is ``{"kind": name, **arguments}``, with ``"world": k`` to run on the
first k ranks only (``mesh.sub_mesh``; the others give None), ``kind`` one
of ``conv``
(:func:`conv_check`: the graph branch's product and its gradient with
respect to x), ``attention`` (:func:`attention_check`: the sharded linear
attention in one of its three forms and its gradients) and ``train``
(``api.train_sharded``). Global arrays [S·N_loc, ...] come in the
partition's padded node order; each rank takes its N_loc rows.
"""

from __future__ import annotations

import torch

from difformer_tpu_torch.kernels import spmm as K1
from difformer_tpu_torch.ops.linear_attention import (
    simple_attention,
    simple_attention_head_mean_factored,
)
from difformer_tpu_torch.parallel.api import rank_plan, train_sharded
from difformer_tpu_torch.parallel.mesh import sub_mesh
from difformer_tpu_torch.parallel.sharded_ops import sharded_conv


def _rows(mesh, a, n_loc, grad=False):
    t = torch.as_tensor(a[mesh.rank * n_loc:(mesh.rank + 1) * n_loc],
                        device=mesh.device).clone()
    return t.requires_grad_(grad)


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def conv_check(mesh, sg, x, cot):
    """This rank's rows of the sharded GCN product of x [S·N_loc, ...] over
    the exchange that ``sg``'s arrays pick, on the rank's plan, and of the
    gradient of ``Σ out · cot`` with respect to x; with K1's launches of
    the product and its backward."""
    rg = sg.rank_graph(mesh.rank, mesh.device)
    senders, halo = rg.senders_and_halo()
    plan = rank_plan(rg, mesh.group)
    xl = _rows(mesh, x, rg.nodes_per_shard, grad=True)
    K1.reset_launch_counts()
    out = sharded_conv(xl, senders, rg.receivers, rg.edge_weight,
                       edge_mask=rg.edge_mask, halo=halo,
                       axis_name=mesh.group, plan=plan)
    (out * _rows(mesh, cot, rg.nodes_per_shard)).sum().backward()
    return dict(out=_np(out), grad=_np(xl.grad), launches=dict(K1.LAUNCHES))


def attention_check(mesh, form, q, k, v, key_mask, cot, n_loc, w=None,
                    b=None):
    """This rank's rows of the sharded DIFFormer-s attention and the
    gradients of ``Σ out · cot``: ``form`` "plain" (``simple_attention``,
    [N, H, D]), "head_mean" (its head-mean form, [N, D]) or "factored"
    (``simple_attention_head_mean_factored`` of q, k, x = ``v`` [N, F] and
    the replicated ``w`` [F, H, D], ``b`` [H, D], whose gradients are this
    rank's parts: their sum over the ranks is the whole)."""
    ql, kl, vl = (_rows(mesh, a, n_loc, grad=True) for a in (q, k, v))
    mask = _rows(mesh, key_mask, n_loc)
    group = mesh.group
    wt = bt = None
    if form == "factored":
        wt, bt = (torch.as_tensor(a, device=mesh.device).clone()
                  .requires_grad_() for a in (w, b))
        out = simple_attention_head_mean_factored(
            ql, kl, vl, wt, bt, key_mask=mask, axis_name=group)
    else:
        out = simple_attention(ql, kl, vl, key_mask=mask, axis_name=group,
                               head_mean=form == "head_mean")
    (out * _rows(mesh, cot, n_loc)).sum().backward()
    return dict(out=_np(out), dq=_np(ql.grad), dk=_np(kl.grad),
                dv=_np(vl.grad), dw=_np(None if wt is None else wt.grad),
                db=_np(None if bt is None else bt.grad))


CHECKS = {"conv": conv_check, "attention": attention_check,
          "train": train_sharded}


def run_checks(mesh, cases):
    """[the result of each case] (the module's docstring)."""
    worlds = sorted({case.get("world", mesh.size) for case in cases})
    meshes = {k: mesh if k == mesh.size else sub_mesh(mesh, k)
              for k in worlds}
    out = []
    for case in cases:
        on = meshes[case.get("world", mesh.size)]
        args = {k: v for k, v in case.items() if k not in ("kind", "world")}
        out.append(None if on is None else CHECKS[case["kind"]](on, **args))
    return out

