"""Carry weights between the JAX package and the port.

A copy of ``difformer_tpu/utils/torch_import.py:24-92``. The port's
DIFFormer names its parameters as the reference's ``state_dict`` does
(``node classification/difformer.py:147-226``):

    fcs.0.{weight,bias}      input Linear           <-> fc_in
    fcs.1.{weight,bias}      output Linear          <-> fc_out
    bns.{i}.{weight,bias}    LayerNorms (L+1)       <-> ln_{i}
    convs.{i}.W{q,k,v}.{weight,bias}                <-> conv_{i}.W{q,k,v}

so the JAX package's flax params (as numpy) become the port's
``state_dict`` and back. Linear weights are transposed: torch ``[out, in]``,
flax kernel ``[in, out]``.
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


def load_params(model: torch.nn.Module, params) -> None:
    """Load a flax params tree (numpy or JAX arrays) into the port's model,
    on the model's device."""
    sd = torch_state_dict_from_params(params)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
