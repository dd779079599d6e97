"""Carry weights between the JAX package and the port.

A copy of ``difformer_tpu/utils/torch_import.py:24-128``. The port's
DIFFormer names its parameters as the reference's ``state_dict`` does
(``node classification/difformer.py:147-226``):

    fcs.0.{weight,bias}      input Linear           <-> fc_in
    fcs.1.{weight,bias}      output Linear          <-> fc_out
    bns.{i}.{weight,bias}    LayerNorms (L+1)       <-> ln_{i}
    convs.{i}.W{q,k,v}.{weight,bias}                <-> conv_{i}.W{q,k,v}

so the JAX package's flax params (as numpy) become the port's
``state_dict`` and back. Linear weights are transposed: torch ``[out, in]``,
flax kernel ``[in, out]``.

The temporal models (``nn/temporal.py``) carry the JAX package's names
(``difformer_tpu/nn/temporal.py``), :func:`temporal_state_dict_from_params`
and :func:`temporal_params_from_state_dict`:

    weight, bias                          DConv [2, K, in, out], [out]
    conv_x_{z,r,h}.{weight,bias}          DCRNN's DConvs
    output_linear.{weight,bias}           DCRNN's head   <-> kernel, bias
    conv_{1,2}.lin.weight, .bias          GCNLayer       <-> TorchLinear_0
                                                             kernel, bias
    bn_{1,2}.{weight,bias}                TorchBatchNorm <-> BatchNorm_0
    bn_{1,2}.running_{mean,var}           its batch_stats (mean, var)
    lstm_{1,2}.weight_ih, weight_hh,      LSTMCell       <-> flax
        bias_hh, bias_ih                  OptimizedLSTMCell ii/if/ig/io
                                          (no bias) and hi/hf/hg/ho
    head.{weight,bias}                    MPNN-LSTM's head

LSTM gates stack in torch's order i, f, g, o; flax's cell has no input
bias, so ``bias_ih`` is zero.

DIFFormer-v2 (``nn/difformer_v2.py``) names its encoder as DIFFormer does,
and the JAX package's v2 modules carry v1's flax names (``fc_in``,
``ln_{i}``, ``conv_{i}.W{q,k,v}``, ``fc_out``), so the same mapping serves;
the graph-level head adds :func:`v2_state_dict_from_params`:

    encoder.<the mapping above>           <-> encoder/<flax names>
    lin.{weight,bias}                     <-> lin kernel, bias

and ``FeatEncoder`` (:func:`feat_encoder_state_dict_from_params`):
``embed_{i}.weight`` <-> ``embed_{i}`` embedding, ``scalar``/``proj``
Linears <-> TorchLinear kernel, bias.

The baseline zoo (``nn/gnns.py``) carries the JAX zoo's names
(``difformer_tpu/nn/gnns.py``), :func:`zoo_state_dict_from_params` and
:func:`zoo_params_from_state_dict`:

    {lin_i, lin_out, lin1, lin2, embed,   TorchLinear    <-> kernel, bias
     final_project, jk.att}.{weight,bias}
    lin.weight (, lin.bias)               flax's TorchLinear_0 (GCNLayer,
                                          SGC, one-layer MLP) or GAT's lin
    bn_i.{weight,bias}                    TorchBatchNorm <-> BatchNorm_0
    bn_i.running_{mean,var}               its batch_stats (mean, var)
    conv_i.bias, conv_i.att_{src,dst},    leaves as they are
        temp, kernel, bias (LINK)
    jk.lstm_{fwd,bwd}.*                   _JK_0's LSTMs, gates as above
"""

from __future__ import annotations

import numpy as np
import torch


def _np(v):
    if hasattr(v, "detach"):
        # .numpy() aliases the tensor's storage: copy, so that optimizer
        # steps on the live module cannot change the converted params
        return v.detach().cpu().numpy().copy()
    return np.asarray(v)


def params_from_torch_state_dict(state_dict) -> dict:
    """Port (reference) ``state_dict`` -> flax params tree of numpy arrays."""
    params: dict = {}

    def put(mod, leaf, value):
        params.setdefault(mod, {})[leaf] = value

    for key, v in state_dict.items():
        arr = _np(v)
        parts = key.split(".")
        if parts[0] == "fcs":
            mod = "fc_in" if parts[1] == "0" else "fc_out"
            if parts[2] == "weight":
                put(mod, "kernel", arr.T.copy())
            else:
                put(mod, "bias", arr)
        elif parts[0] == "bns":
            mod = f"ln_{parts[1]}"
            leaf = "scale" if parts[2] == "weight" else "bias"
            params.setdefault(mod, {}).setdefault("LayerNorm_0", {})[
                leaf] = arr
        elif parts[0] == "convs":
            mod, proj = f"conv_{parts[1]}", parts[2]
            if proj not in ("Wq", "Wk", "Wv"):
                raise KeyError(f"unexpected conv parameter {key!r}")
            sub = params.setdefault(mod, {}).setdefault(proj, {})
            if parts[3] == "weight":
                sub["kernel"] = arr.T.copy()
            else:
                sub["bias"] = arr
        else:
            raise KeyError(
                f"unrecognized state_dict key {key!r} (expected "
                f"fcs./bns./convs. per difformer.py:147-226)")
    return params


def torch_state_dict_from_params(params) -> dict:
    """Flax params tree -> ``state_dict`` of numpy arrays (inverse of
    :func:`params_from_torch_state_dict`)."""
    sd = {}
    for mod, sub in params.items():
        if mod == "fc_in":
            sd["fcs.0.weight"] = _np(sub["kernel"]).T.copy()
            sd["fcs.0.bias"] = _np(sub["bias"])
        elif mod == "fc_out":
            sd["fcs.1.weight"] = _np(sub["kernel"]).T.copy()
            sd["fcs.1.bias"] = _np(sub["bias"])
        elif mod.startswith("ln_"):
            i = mod[len("ln_"):]
            ln = sub["LayerNorm_0"]
            sd[f"bns.{i}.weight"] = _np(ln["scale"])
            sd[f"bns.{i}.bias"] = _np(ln["bias"])
        elif mod.startswith("conv_"):
            i = mod[len("conv_"):]
            for proj, p in sub.items():
                sd[f"convs.{i}.{proj}.weight"] = _np(p["kernel"]).T.copy()
                sd[f"convs.{i}.{proj}.bias"] = _np(p["bias"])
        else:
            raise KeyError(f"unrecognized param module {mod!r}")
    return sd


_GATES = ("i", "f", "g", "o")  # torch's order of the LSTM's gate blocks


def temporal_state_dict_from_params(params, batch_stats=None) -> dict:
    """A temporal model's flax params (and ``batch_stats``, MPNN-LSTM's
    BatchNorm statistics) -> the port's ``state_dict`` of numpy arrays."""
    sd = {}

    def walk(prefix, sub):
        for mod, p in sub.items():
            key = f"{prefix}{mod}"
            if not isinstance(p, dict):
                sd[key] = _np(p)                          # DConv weight/bias
            elif mod.startswith("lstm_"):
                sd[f"{key}.weight_ih"] = np.concatenate(
                    [_np(p[f"i{g}"]["kernel"]).T for g in _GATES])
                sd[f"{key}.weight_hh"] = np.concatenate(
                    [_np(p[f"h{g}"]["kernel"]).T for g in _GATES])
                sd[f"{key}.bias_hh"] = np.concatenate(
                    [_np(p[f"h{g}"]["bias"]) for g in _GATES])
                sd[f"{key}.bias_ih"] = np.zeros_like(sd[f"{key}.bias_hh"])
            elif "TorchLinear_0" in p:                    # GCNLayer
                sd[f"{key}.lin.weight"] = _np(
                    p["TorchLinear_0"]["kernel"]).T.copy()
                sd[f"{key}.bias"] = _np(p["bias"])
            elif "BatchNorm_0" in p:
                sd[f"{key}.weight"] = _np(p["BatchNorm_0"]["scale"])
                sd[f"{key}.bias"] = _np(p["BatchNorm_0"]["bias"])
            elif "kernel" in p:                           # TorchLinear
                sd[f"{key}.weight"] = _np(p["kernel"]).T.copy()
                sd[f"{key}.bias"] = _np(p["bias"])
            else:                                         # a DConv
                walk(f"{key}.", p)

    walk("", params)
    for mod, sub in (batch_stats or {}).items():
        stats = sub["BatchNorm_0"]
        sd[f"{mod}.running_mean"] = _np(stats["mean"])
        sd[f"{mod}.running_var"] = _np(stats["var"])
    return sd


def temporal_params_from_state_dict(state_dict):
    """The inverse of :func:`temporal_state_dict_from_params`: (params,
    batch_stats) of numpy arrays (batch_stats empty for a model without
    BatchNorm)."""
    params, stats = {}, {}

    def leaf(path, value):
        node = params
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value

    sd = {k: _np(v) for k, v in state_dict.items()}
    for key, arr in sd.items():
        parts = key.split(".")
        mod = parts[0]
        if len(parts) == 1:
            leaf(parts, arr)                              # DConv weight/bias
        elif mod.startswith("lstm_"):
            if parts[1] == "bias_ih":
                continue
            blocks = np.split(arr, 4)
            for g, block in zip(_GATES, blocks):
                if parts[1] == "weight_ih":
                    leaf([mod, f"i{g}", "kernel"], block.T.copy())
                elif parts[1] == "weight_hh":
                    leaf([mod, f"h{g}", "kernel"], block.T.copy())
                else:
                    leaf([mod, f"h{g}", "bias"], block)
        elif mod.startswith("conv_") and parts[1] == "lin":
            leaf([mod, "TorchLinear_0", "kernel"], arr.T.copy())
        elif mod.startswith("bn_"):
            if parts[1].startswith("running_"):
                name = "mean" if parts[1] == "running_mean" else "var"
                stats.setdefault(mod, {}).setdefault("BatchNorm_0", {})[
                    name] = arr
            else:
                leaf([mod, "BatchNorm_0",
                      "scale" if parts[1] == "weight" else "bias"], arr)
        elif mod.startswith("conv_x_") or (mod.startswith("conv_")
                                           and parts[1] == "bias"):
            leaf(parts, arr)                              # DConv, GCN bias
        elif parts[1] == "weight":
            leaf([mod, "kernel"], arr.T.copy())           # TorchLinear
        else:
            leaf([mod, "bias"], arr)
    return params, stats


def _linear_sd(prefix, p):
    return {f"{prefix}.weight": _np(p["kernel"]).T.copy(),
            f"{prefix}.bias": _np(p["bias"])}


def v2_state_dict_from_params(params) -> dict:
    """The JAX package's ``GraphLevelModel`` params (``encoder``, ``lin``),
    or a bare ``DIFFormerV2``'s, as the port's ``state_dict`` of numpy
    arrays."""
    if "encoder" not in params:
        return torch_state_dict_from_params(params)
    sd = {f"encoder.{k}": v
          for k, v in torch_state_dict_from_params(params["encoder"]).items()}
    sd.update(_linear_sd("lin", params["lin"]))
    return sd


def v2_params_from_state_dict(state_dict) -> dict:
    """The inverse of :func:`v2_state_dict_from_params`: the flax params
    tree (numpy) of a ``GraphLevelModel`` or, without ``encoder.`` keys, of
    a ``DIFFormerV2``."""
    enc = {k[len("encoder."):]: v for k, v in state_dict.items()
           if k.startswith("encoder.")}
    if not enc:
        return params_from_torch_state_dict(state_dict)
    lin = {"kernel": _np(state_dict["lin.weight"]).T.copy(),
           "bias": _np(state_dict["lin.bias"])}
    return {"encoder": params_from_torch_state_dict(enc), "lin": lin}


def feat_encoder_state_dict_from_params(params) -> dict:
    """The JAX package's ``FeatEncoder`` params as the port's
    ``state_dict`` of numpy arrays."""
    sd = {}
    for mod, p in params.items():
        if "embedding" in p:
            sd[f"{mod}.weight"] = _np(p["embedding"])
        else:
            sd.update(_linear_sd(mod, p))
    return sd


#: flax module names that the zoo's torch modules carry under another name
_ZOO_TORCH_NAME = {"_JK_0": "jk", "TorchLinear_0": "lin"}


def _lstm_sd(key, p):
    sd = {f"{key}.weight_ih": np.concatenate(
              [_np(p[f"i{g}"]["kernel"]).T for g in _GATES]),
          f"{key}.weight_hh": np.concatenate(
              [_np(p[f"h{g}"]["kernel"]).T for g in _GATES]),
          f"{key}.bias_hh": np.concatenate(
              [_np(p[f"h{g}"]["bias"]) for g in _GATES])}
    sd[f"{key}.bias_ih"] = np.zeros_like(sd[f"{key}.bias_hh"])
    return sd


def zoo_state_dict_from_params(params, batch_stats=None) -> dict:
    """A zoo model's flax params (and ``batch_stats``, its BatchNorms'
    statistics) -> the port's ``state_dict`` of numpy arrays."""
    sd = {}

    def walk(prefix, node):
        for name, value in node.items():
            if not isinstance(value, dict):
                sd[prefix + name] = _np(value)            # a leaf parameter
                continue
            key = prefix + _ZOO_TORCH_NAME.get(name, name)
            if name.startswith("lstm_"):
                sd.update(_lstm_sd(key, value))
            elif "BatchNorm_0" in value:
                sd[f"{key}.weight"] = _np(value["BatchNorm_0"]["scale"])
                sd[f"{key}.bias"] = _np(value["BatchNorm_0"]["bias"])
            elif "kernel" in value and not any(
                    isinstance(v, dict) for v in value.values()):
                sd[f"{key}.weight"] = _np(value["kernel"]).T.copy()
                if "bias" in value:
                    sd[f"{key}.bias"] = _np(value["bias"])
            else:
                walk(key + ".", value)

    walk("", params)

    def stats(prefix, node):
        for name, value in node.items():
            if "BatchNorm_0" in value:
                sd[f"{prefix}{name}.running_mean"] = _np(
                    value["BatchNorm_0"]["mean"])
                sd[f"{prefix}{name}.running_var"] = _np(
                    value["BatchNorm_0"]["var"])
            else:
                stats(f"{prefix}{_ZOO_TORCH_NAME.get(name, name)}.", value)

    stats("", batch_stats or {})
    return sd


def zoo_params_from_state_dict(state_dict):
    """The inverse of :func:`zoo_state_dict_from_params`: (params,
    batch_stats) of numpy arrays (batch_stats empty for a model without
    BatchNorm)."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    params, stats = {}, {}

    def put(tree, path, value):
        for part in path[:-1]:
            tree = tree.setdefault(part, {})
        tree[path[-1]] = value

    for key, arr in sd.items():
        parts = key.split(".")
        mod, leaf = parts[:-1], parts[-1]
        prefix = ".".join(mod)
        siblings = {k[len(prefix) + 1:] for k in sd
                    if mod and k.startswith(prefix + ".")}
        gat = ".".join(mod[:-1] + ["att_src"]) in sd
        if mod and mod[-1] == "lin" and not gat:
            mod = mod[:-1] + ["TorchLinear_0"]   # GAT's lin keeps its name
        mod = ["_JK_0" if m == "jk" else m for m in mod]
        if leaf == "bias_ih":
            continue
        if leaf in ("weight_ih", "weight_hh", "bias_hh"):
            side = "i" if leaf == "weight_ih" else "h"
            what = "bias" if leaf == "bias_hh" else "kernel"
            for g, block in zip(_GATES, np.split(arr, 4)):
                put(params, mod + [f"{side}{g}", what],
                    block.T.copy() if what == "kernel" else block)
        elif leaf.startswith("running_"):
            name = "mean" if leaf == "running_mean" else "var"
            put(stats, mod + ["BatchNorm_0", name], arr)
        elif mod and mod[-1].startswith("bn_"):
            put(params, mod + ["BatchNorm_0",
                               "scale" if leaf == "weight" else "bias"], arr)
        elif mod and "weight" in siblings:                # a Linear
            put(params, mod + ["kernel" if leaf == "weight" else "bias"],
                arr.T.copy() if leaf == "weight" else arr)
        else:
            put(params, mod + [leaf], arr)                # a leaf parameter
    return params, stats


def _is_temporal(model):
    from difformer_tpu_torch.nn.temporal import DCRNN, MPNNLSTM, DConv

    return isinstance(model, (DConv, DCRNN, MPNNLSTM))


def load_params(model: torch.nn.Module, params, batch_stats=None) -> None:
    """Load a flax params tree (numpy or JAX arrays) into the port's model,
    on the model's device: DIFFormer's, DIFFormer-v2's (bare or with the
    graph-level head), FeatEncoder's, or a temporal or zoo model's with
    its ``batch_stats`` (the model's own running statistics are kept when
    None)."""
    from difformer_tpu_torch.nn.common import FeatEncoder
    from difformer_tpu_torch.nn.difformer_v2 import (
        DIFFormerV2,
        GraphLevelModel,
    )

    from difformer_tpu_torch.nn.gnns import ZOO

    if _is_temporal(model) or isinstance(model, ZOO):
        convert = (temporal_state_dict_from_params if _is_temporal(model)
                   else zoo_state_dict_from_params)
        sd = convert(params, batch_stats)
        own = model.state_dict()
        sd = {k: sd[k] if k in sd else own[k] for k in own}
    elif isinstance(model, (DIFFormerV2, GraphLevelModel)):
        sd = v2_state_dict_from_params(params)
    elif isinstance(model, FeatEncoder):
        sd = feat_encoder_state_dict_from_params(params)
    else:
        sd = torch_state_dict_from_params(params)
    model.load_state_dict({k: torch.from_numpy(np.array(_np(v)))
                           for k, v in sd.items()})


def load_torch_checkpoint(path: str) -> dict:
    """A reference checkpoint file (``.pkl``/``.pt``/``.pth``, a pickled
    ``state_dict`` or module, ``node classification/
    test_large_dataset.py:85-98``) as a flax params tree, as
    ``difformer_tpu/utils/torch_import.py:load_torch_checkpoint``.

    The safe tensor-only loader goes first. Only for the errors of a
    legacy-format file or of an object the safe loader refuses does it
    unpickle in full, with a warning: a file made to fail the safe loader
    must not be unpickled silently."""
    import pickle
    import warnings

    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError) as e:
        msg = str(e)
        legacy = ("weights_only" in msg or "Unsupported" in msg
                  or "legacy" in msg.lower()
                  or isinstance(e, pickle.UnpicklingError))
        if not legacy:
            raise
        warnings.warn(
            f"safe (weights_only) load of {path!r} failed with: {msg!r}; "
            "falling back to full unpickling: only do this for checkpoint "
            "files you trust", stacklevel=2)
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):  # a whole module was saved
        sd = sd.state_dict()
    return params_from_torch_state_dict(sd)
