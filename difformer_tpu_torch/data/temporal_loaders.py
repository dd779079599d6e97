"""Temporal graph dataset loaders (spatial-temporal track), a copy of
``difformer_tpu/data/temporal_loaders.py`` (json and numpy, no pandas), so
the same files give the same snapshots in both packages.

The reference uses torch_geometric_temporal's loaders
(``spatial-temporal/main.py:39-63``: chickenpox / wikimath / covid /
twitter-tennis), which download JSON files. These parsers read the same JSON
formats from disk (zero-egress) and emit ``TemporalSnapshot`` sequences with
lagged node features — matching torch_geometric_temporal's
``StaticGraphTemporalSignal``/``DynamicGraphTemporalSignal`` semantics.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from difformer_tpu_torch.data.graph import TemporalSnapshot


def _need(path, what):
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{what} not found at {path} (zero-egress env: place the "
            f"torch_geometric_temporal JSON there, or use synthetic data)"
        )
    return path


def load_chickenpox(data_dir, lags=4) -> List[TemporalSnapshot]:
    """Hungary chickenpox (static graph, weekly county counts): features =
    last ``lags`` standardized counts, target = next count."""
    path = _need(os.path.join(data_dir, "chickenpox.json"), "chickenpox")
    with open(path) as f:
        data = json.load(f)
    edges = np.asarray(data["edges"], np.int64).T               # [2, E]
    fx = np.asarray(data["FX"], np.float32)                     # [T, N]
    stacked = fx
    snaps = []
    for t in range(lags, stacked.shape[0] - 1):
        feat = stacked[t - lags:t].T                            # [N, lags]
        # the target is the reading of step t, as the JAX loader sets it
        snaps.append(TemporalSnapshot(
            node_feat=feat.copy(),
            edge_index=edges,
            edge_weight=np.ones(edges.shape[1], np.float32),
            target=stacked[t].copy(),
        ))
    return snaps


def load_wikimath(data_dir, lags=14) -> List[TemporalSnapshot]:
    """Wikipedia math visits (static weighted graph, daily)."""
    path = _need(os.path.join(data_dir, "wikivital_mathematics.json"),
                 "wikimath")
    with open(path) as f:
        data = json.load(f)
    edges = np.asarray(data["edges"], np.int64).T
    weights = np.asarray(data["weights"], np.float32)
    T = data["time_periods"]
    n = max(int(e) for pair in data["edges"] for e in pair) + 1
    y = np.zeros((T, n), np.float32)
    for t in range(T):
        y[t] = np.asarray(data[str(t)]["y"], np.float32)
    mu, sigma = y.mean(), y.std()
    y_std = (y - mu) / max(sigma, 1e-9)
    snaps = []
    for t in range(lags, T):
        feat = y_std[t - lags:t].T                              # [N, lags]
        snaps.append(TemporalSnapshot(
            node_feat=feat.copy(),
            edge_index=edges,
            edge_weight=weights,
            target=y_std[t].copy(),
        ))
    return snaps


def load_england_covid(data_dir, lags=8) -> List[TemporalSnapshot]:
    """England covid cases (dynamic graph: per-step edge lists/weights)."""
    path = _need(os.path.join(data_dir, "england_covid.json"),
                 "england covid")
    with open(path) as f:
        data = json.load(f)
    T = data["time_periods"]
    fx = np.asarray(data["y"], np.float32)                      # [T, N]
    mu, sigma = fx.mean(), fx.std()
    fx = (fx - mu) / max(sigma, 1e-9)
    snaps = []
    for t in range(lags, T - 1):
        edges = np.asarray(data["edge_mapping"]["edge_index"][str(t)],
                           np.int64).T
        w = np.asarray(data["edge_mapping"]["edge_weight"][str(t)],
                       np.float32)
        feat = fx[t - lags:t].T
        snaps.append(TemporalSnapshot(
            node_feat=feat.copy(),
            edge_index=edges,
            edge_weight=w,
            target=fx[t].copy(),
        ))
    return snaps


def _encode_tennis_features(x):
    """torch_geometric_temporal's ``encode_features`` (feature_mode=
    'encoded'): column 0 = degree -> one-hot of ceil(log(1+deg)) clipped to
    [0,4] (5 dims); column 1 = transitivity -> one-hot of floor(10*t) in
    [0,10] (11 dims). Total 16 dims — the ``d = 16`` the reference hardcodes
    (``spatial-temporal/main.py:53,58``)."""
    x = np.asarray(x, np.float64)
    deg = np.minimum(np.ceil(np.log(x[:, 0] + 1.0)), 4).astype(np.int64)
    trans = np.clip(np.floor(x[:, 1] * 10), 0, 10).astype(np.int64)
    out = np.zeros((x.shape[0], 16), np.float32)
    out[np.arange(len(x)), deg] = 1.0
    out[np.arange(len(x)), 5 + trans] = 1.0
    return out


def load_twitter_tennis(data_dir, event_id="rg17", feature_mode="encoded",
                        target_offset=1) -> List[TemporalSnapshot]:
    """Twitter tennis mention graphs (dynamic graph + dynamic features;
    reference ``twitter_rg``/``twitter_uo``, ``spatial-temporal/
    main.py:49-58``). Reads ``twitter_tennis_{event_id}.json`` in the
    torch_geometric_temporal layout: per-timestep ``edges``/``weights``/
    ``X``/``y`` either under ``data[str(t)]`` or as top-level per-key time
    maps. Targets are ``log(1+y)`` at ``t + target_offset``."""
    path = _need(os.path.join(data_dir, f"twitter_tennis_{event_id}.json"),
                 f"twitter tennis {event_id}")
    with open(path) as f:
        data = json.load(f)
    T = int(data["time_periods"])

    def at(key, t):
        if str(t) in data and key in data[str(t)]:
            return data[str(t)][key]
        return data[key][str(t)]

    snaps = []
    for t in range(T - target_offset):
        edges = np.asarray(at("edges", t), np.int64)
        if edges.shape[0] != 2:
            edges = edges.T
        w = np.asarray(at("weights", t), np.float32)
        x = np.asarray(at("X", t), np.float32)
        if feature_mode == "encoded":
            x = _encode_tennis_features(x)
        y = np.asarray(at("y", t + target_offset), np.float32)
        snaps.append(TemporalSnapshot(
            node_feat=x,
            edge_index=edges,
            edge_weight=w,
            target=np.log(1.0 + y),
        ))
    return snaps


LOADERS = {
    "chickenpox": load_chickenpox,
    "wikimath": load_wikimath,
    "covid": load_england_covid,
    "twitter_rg": lambda d, **kw: load_twitter_tennis(d, "rg17", **kw),
    "twitter_uo": lambda d, **kw: load_twitter_tennis(d, "uo17", **kw),
}


def load_temporal_dataset(name, data_dir, **kw):
    """The snapshots of temporal dataset ``name`` read from ``data_dir``;
    raises FileNotFoundError where its JSON file is missing and ValueError
    for an unknown name."""
    if name not in LOADERS:
        raise ValueError(f"unknown temporal dataset {name!r}")
    return LOADERS[name](data_dir, **kw)
