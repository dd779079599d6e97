"""Particle-physics graph datasets (graph-level prediction track), a numpy
copy of ``difformer_tpu/data/particle.py`` that builds the same graphs and
reads and writes the same ``.npz`` caches.

Reference: ``physical particle/datasets/{actstrack,tau3mu,synmol,plbind}.py``.
These are host-side preprocessing pipelines (pandas/pickle → per-event graph
construction via kNN/radius graphs) — kept in Python by design (SURVEY.md
§2.5: RDKit/BioPython preprocessing is host work). ``yaml``, ``pandas`` and
``rdkit`` are imported only by the functions that need them, so a processed
cache is read with numpy alone. Zero-egress: raw files
must already be on disk in the reference layout; processed graphs are cached
as one ``.npz`` per dataset.

Deviations (documented per SURVEY.md §7.3 policy):
  * The reference evaluates YAML filter strings with ``eval()``
    (``tau3mu.py:117,132-135``) — replaced by a safe comparator parser.
  * The reference's YAML files have the ``data:`` key commented out
    (``configs/actstrack.yml:1``) so its own ``yaml.safe_load(...)['data']``
    cannot run; ``load_data_config`` accepts both layouts.
  * Downloads prompt interactively in the reference (``utils/url.py:12-18``);
    here missing raw data raises with the expected path.
"""

from __future__ import annotations

import os
import pickle
import re
from itertools import combinations
from typing import Dict, List, Optional

import numpy as np

from difformer_tpu_torch.data.splits import get_random_idx_split
from difformer_tpu_torch.data.transforms import knn_graph, radius_graph

Z_BOSON_MASS = 91.1876  # GeV (actstrack.py:209)


def load_data_config(path: str) -> dict:
    """Parse a particle-track YAML; only the ``data:`` block is live
    (``configs/*.yml``). Tolerates the reference's commented-out ``data:``
    header (keys indented at top level)."""
    import yaml

    with open(path) as f:
        text = f.read()
    try:
        doc = yaml.safe_load(text)
    except yaml.YAMLError:
        doc = None
    if isinstance(doc, dict) and "data" in doc and isinstance(doc["data"], dict):
        return doc["data"]
    if isinstance(doc, dict):
        return doc
    # de-indent two spaces (commented "# data:" header layout)
    dedented = "\n".join(
        line[2:] if line.startswith("  ") else line
        for line in text.splitlines()
    )
    doc = yaml.safe_load(dedented)
    return doc.get("data", doc) if isinstance(doc, dict) else {}


_CMP = {
    "==": np.equal, "!=": np.not_equal, ">=": np.greater_equal,
    "<=": np.less_equal, ">": np.greater, "<": np.less,
}


def apply_filter(values, expr: str):
    """Safe replacement for the reference's ``eval('entry.'+k+v)``
    (tau3mu.py:117): expr like '==1', '!=0', '>=3'."""
    m = re.fullmatch(r"\s*(==|!=|>=|<=|>|<)\s*(-?\d+(?:\.\d+)?)\s*", expr)
    if not m:
        raise ValueError(f"unsupported filter expression {expr!r}")
    op, val = m.group(1), float(m.group(2))
    return _CMP[op](values, val)


class GraphListDataset:
    """List-of-graphs dataset with npz caching and reference-style splits.
    Items are ``(x [n,F], edge_index [2,e], y scalar)`` (compatible with
    ``train.graph_level.GraphLevelTrainer``); ``extras`` holds node_label /
    pos per graph where the source provides them."""

    def __init__(self, name: str):
        self.name = name
        self.graphs: List = []
        self.extras: List[Dict] = []
        self.idx_split: Optional[Dict[str, np.ndarray]] = None

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i):
        return self.graphs[i]

    def get_idx_split(self):
        return self.idx_split

    # -- caching ------------------------------------------------------------
    def save_cache(self, path):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        flat = {}
        for i, (x, ei, y) in enumerate(self.graphs):
            flat[f"x_{i}"] = x
            flat[f"ei_{i}"] = ei
            flat[f"y_{i}"] = np.asarray(y)
        # extras (node_label/pos/...) persist so cached and fresh builds
        # return identical datasets (key layout: e_{i}__{name})
        for i, ex in enumerate(self.extras):
            for k, v in (ex or {}).items():
                flat[f"e_{i}__{k}"] = np.asarray(v)
        flat["n_graphs"] = np.asarray(len(self.graphs))
        for k, v in (self.idx_split or {}).items():
            flat[f"split_{k}"] = v
        np.savez_compressed(path, **flat)

    @classmethod
    def load_cache(cls, name, path):
        ds = cls(name)
        with np.load(path, allow_pickle=False) as f:
            n = int(f["n_graphs"])
            ds.graphs = [
                (f[f"x_{i}"], f[f"ei_{i}"], float(f[f"y_{i}"]))
                for i in range(n)
            ]
            ds.extras = [{} for _ in range(n)]
            for k in f.files:
                if k.startswith("e_"):
                    idx, key = k[len("e_"):].split("__", 1)
                    ds.extras[int(idx)][key] = f[k]
            ds.idx_split = {
                k[len("split_"):]: f[k] for k in f.files
                if k.startswith("split_")
            } or None
        return ds


def invariant_mass(m, px1, py1, pz1, px2, py2, pz2):
    """Two-particle invariant mass (actstrack.py:194-199)."""
    first = m ** 2
    second = np.sqrt(m ** 2 + px1 ** 2 + py1 ** 2 + pz1 ** 2) * np.sqrt(
        m ** 2 + px2 ** 2 + py2 ** 2 + pz2 ** 2
    )
    third = px1 * px2 + py1 * py2 + pz1 * pz2
    return np.sqrt(2 * (first + second - third))


def get_signal_particles(particles, thres):
    """Opposite-charge pairs whose invariant mass is within ``thres`` of the
    Z-boson mass (actstrack.py:202-215). ``particles``: pandas DataFrame with
    particle_id, q, m, px, py, pz."""
    if len(particles) < 2:
        return []
    res = []
    for i, j in combinations(range(len(particles)), 2):
        a, b = particles.iloc[i], particles.iloc[j]
        if a["q"] * b["q"] > 0:
            continue
        im = invariant_mass(a["m"], a["px"], a["py"], a["pz"],
                            b["px"], b["py"], b["pz"])
        if abs(im - Z_BOSON_MASS) < thres:
            res.append([a["particle_id"], b["particle_id"], im])
    return res


def build_actstrack(root, data_config, *, tesla="2T", seed=42,
                    rng=None) -> GraphListDataset:
    """Process ActsTrack raw event pickles (actstrack.py:88-192):
    signal = event containing exactly one Z→ll candidate pair; hits of the
    signal particles get node_label 1; ``sample_tracks`` random tracks kept;
    pos scaled to the unit sphere; kNN(k=5, self-loops) graph; features =
    other_features ⊕ pos."""
    cache = os.path.join(root, "processed",
                         f"actstrack_{tesla}_processed.npz")
    if os.path.exists(cache):
        return GraphListDataset.load_cache("actstrack", cache)

    raw_dir = os.path.join(root, "raw")
    sig_p = os.path.join(raw_dir, f"signal_events_{tesla}.pkl")
    bkg_p = os.path.join(raw_dir, f"bkg_events_{tesla}.pkl")
    for p in (sig_p, bkg_p):
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"ActsTrack raw events not found at {p} (zero-egress env; "
                f"place the reference-layout raw files there)"
            )
    rng = rng or np.random.default_rng(seed)
    with open(sig_p, "rb") as f:
        signal_events = pickle.load(f)
    with open(bkg_p, "rb") as f:
        bkg_events = pickle.load(f)

    ds = GraphListDataset("actstrack")
    im_thres = float(data_config.get("im_thres", 2))
    sample_tracks = int(data_config.get("sample_tracks", 10))
    pos_features = data_config.get("pos_features", ["tx", "ty", "tz"])
    other_features = data_config.get(
        "other_features",
        ["tt", "tpx", "tpy", "tpz", "te", "deltapx", "deltapy", "deltapz",
         "deltae"],
    )

    def handle(events, is_signal):
        for initial, _, hits in events:
            if len(hits) == 0 or len(initial) == 0:
                continue
            hits = hits.copy()
            hits["node_label"] = 0
            y = 0.0
            signal_particles = []
            if is_signal:
                muons = initial[np.abs(initial["particle_type"]) == 13]
                electrons = initial[np.abs(initial["particle_type"]) == 11]
                if len(muons) < 2 and len(electrons) < 2:
                    continue
                info = np.array(
                    get_signal_particles(electrons, im_thres)
                    + get_signal_particles(muons, im_thres)
                )
                if info.shape[0] != 1:
                    continue
                signal_particles = list(info[:, :2].reshape(-1))
                hits.loc[hits["particle_id"].isin(signal_particles),
                         "node_label"] = 1
                y = 1.0
                if hits["node_label"].sum() == 0:
                    continue
            if sample_tracks:
                n_sample = sample_tracks - len(signal_particles)
                pool = hits["particle_id"].unique()
                chosen = list(rng.choice(pool, n_sample)) + signal_particles
                hits = hits[hits["particle_id"].isin(chosen)].reset_index(
                    drop=True
                )
            pos = hits[pos_features].to_numpy(np.float32)
            x = hits[other_features].to_numpy(np.float32)
            x = np.concatenate([x, pos], axis=1)        # actstrack.py:172
            pos = pos / 2955.5 * 100.0                  # actstrack.py:174
            norm = np.maximum(
                np.linalg.norm(pos, axis=-1, keepdims=True), 1e-6
            )
            pos = pos / norm
            ei = knn_graph(pos, k=5, include_self=True)
            ds.graphs.append((x, ei, y))
            ds.extras.append(
                {"pos": pos,
                 "node_label": hits["node_label"].to_numpy(np.float32)}
            )

    handle(signal_events, True)
    handle(bkg_events, False)
    split_cfg = data_config.get("split", {"train": 0.7, "valid": 0.15})
    ds.idx_split = get_random_idx_split(
        len(ds.graphs), split_cfg.get("train", 0.7),
        split_cfg.get("valid", 0.15), rng=seed,
    )
    ds.save_cache(cache)
    return ds


def build_tau3mu(root, data_config, *, seed=42) -> GraphListDataset:
    """Process the tau3mu pandas pickle (tau3mu.py:70-106): hit filters from
    YAML (safe-parsed), pos = (η, φ·π/180), radius graph r=1 with self-loops,
    features = other_features ⊕ pos."""
    cache = os.path.join(root, "processed", "tau3mu_processed.npz")
    if os.path.exists(cache):
        return GraphListDataset.load_cache("tau3mu", cache)

    import pandas as pd

    raw = os.path.join(root, "raw", "tau3mu_mixed.pkl")
    if not os.path.exists(raw):
        raise FileNotFoundError(
            f"tau3mu raw pickle not found at {raw} (zero-egress env)"
        )
    df = pd.read_pickle(raw)

    hit_filters = data_config.get(
        "hit_filters",
        {"mu_hit_station": "==1", "mu_hit_neighbor": "==0",
         "mu_hit_type": "!=0"},
    )
    sample_filter = data_config.get("sample_filters", {}).get("num_hits",
                                                             ">=3")
    other_features = data_config.get("other_features", ["mu_hit_bend"])

    ds = GraphListDataset("tau3mu")
    for entry in df.itertuples():
        n_hit = int(entry.n_mu_hit)
        mask = np.ones(n_hit, dtype=bool)
        for k, expr in hit_filters.items():
            mask &= apply_filter(np.asarray(getattr(entry, k)), expr)
        y = float(np.asarray(entry.y).reshape(-1)[0])
        if y == 1:
            node_label = np.asarray(entry.node_label)[mask]
            if not apply_filter(np.asarray(node_label.sum()), sample_filter):
                continue
        else:
            node_label = np.zeros(int(mask.sum()), np.float32)
            if not apply_filter(np.asarray(mask.sum()), sample_filter):
                continue
        eta = np.asarray(entry.mu_hit_sim_eta)[mask].reshape(-1, 1)
        phi = np.deg2rad(np.asarray(entry.mu_hit_sim_phi)[mask]).reshape(-1, 1)
        pos = np.concatenate([eta, phi], axis=1).astype(np.float32)
        x = np.stack(
            [np.asarray(getattr(entry, f))[mask] for f in other_features],
            axis=1,
        ).astype(np.float32)
        x = np.concatenate([x, pos], axis=1)
        ei = radius_graph(pos, 1.0, loop=True)
        ds.graphs.append((x, ei, y))
        ds.extras.append({"pos": pos,
                          "node_label": node_label.astype(np.float32)})

    split_cfg = data_config.get("split", {"train": 0.7, "valid": 0.15})
    ds.idx_split = get_random_idx_split(
        len(ds.graphs), split_cfg.get("train", 0.7),
        split_cfg.get("valid", 0.15), rng=seed,
    )
    ds.save_cache(cache)
    return ds


# reference synmol.py:23
SYNMOL_ATOM_TYPES = ["C", "N", "O", "S", "F", "P", "Cl", "Br", "Na", "Ca",
                     "I", "B", "H", "*"]


def _synmol_positions(raw_dir, idx, smiles, seed):
    """3-D conformer positions for molecule ``idx``. Ladder:

    1. RDKit = the reference's ETKDG embed + MMFF optimize
       (synmol.py:96-107) — parity-grade when the package is present;
    2. user-provided ``positions.npz`` (object array 'pos' of [n,3]
       arrays, or per-molecule 'pos_{idx}' keys);
    3. dependency-free fallback: ``data/smiles.smiles_conformer``
       (distance-geometry embed + spring relaxation — plausible geometry
       for the kNN graph, documented deviation from MMFF minima).

    Returns None when embedding fails (the reference skips those
    molecules)."""
    try:
        from rdkit import Chem
        from rdkit.Chem import AllChem
    except ImportError:
        pos_file = os.path.join(raw_dir, "positions.npz")
        if os.path.exists(pos_file):
            with np.load(pos_file, allow_pickle=True) as f:
                if f"pos_{idx}" in f.files:
                    return np.asarray(f[f"pos_{idx}"], np.float32)
                return np.asarray(f["pos"][idx], np.float32)
        from difformer_tpu_torch.data.smiles import SmilesError, smiles_conformer

        try:
            return smiles_conformer(smiles, seed=seed)
        except SmilesError:
            return None
    mol = Chem.MolFromSmiles(smiles)
    m = Chem.AddHs(mol)
    if AllChem.EmbedMolecule(m, randomSeed=seed) < 0:
        return None
    if AllChem.MMFFOptimizeMolecule(m, maxIters=1000) < 0:
        return None
    m = Chem.RemoveHs(m)
    return np.asarray(m.GetConformer().GetPositions(), np.float32)


def build_synmol_raw(root, data_config, *, seed=42) -> GraphListDataset:
    """Process the SynMol raw layout (synmol.py:72-125): one-hot atom nodes
    -> categorical index, attribution node labels, reference split protocol
    (shuffle train_index under np seed, last 1000 -> valid), features =
    atom-index ⊕ pos, pos×5, kNN(k=5, self-loops). Only the conformer
    coordinates need RDKit — everything else is numpy
    (see :func:`_synmol_positions` for the no-RDKit substitute)."""
    import pandas as pd

    raw = os.path.join(root, "raw")
    all_y = np.load(os.path.join(raw, "y_true.npz"), allow_pickle=True)["y"]
    all_x = np.load(os.path.join(raw, "x_true.npz"),
                    allow_pickle=True)["datadict_list"][0]
    all_exp = np.load(
        os.path.join(raw, "true_raw_attribution_datadicts.npz"),
        allow_pickle=True)["datadict_list"]
    mol_df = pd.read_csv(os.path.join(raw, "logic8_smiles.csv"))
    raw_split = dict(np.load(os.path.join(raw, "logic8_traintest_indices.npz"),
                             allow_pickle=True))

    # split protocol (synmol.py:127-146): shuffle train under the np seed,
    # last 1000 to valid
    np.random.seed(seed)
    train_val = raw_split["train_index"]
    order = np.arange(len(train_val))
    np.random.shuffle(order)
    split_of = {}
    for i in train_val[order[:-1000]]:
        split_of[int(i)] = "train"
    for i in train_val[order[-1000:]]:
        split_of[int(i)] = "valid"
    for i in raw_split["test_index"]:
        split_of[int(i)] = "test"

    ds = GraphListDataset("synmol")
    idx_split = {"train": [], "valid": [], "test": []}
    cnt = 0
    for idx, data in enumerate(all_x):
        onehot = np.asarray(data["nodes"])
        atom_idx = np.argwhere(onehot == 1)[:, 1].astype(np.float32)
        y = float(np.asarray(all_y[idx]).reshape(-1)[0])
        node_label = np.asarray(all_exp[idx][0]["nodes"][:, -1], np.float32)
        pos = _synmol_positions(raw, idx, mol_df.iloc[idx]["smiles"], seed)
        if pos is None:
            continue                         # embed/optimize failure skipped
        assert atom_idx.shape[0] == pos.shape[0], (idx, atom_idx.shape,
                                                   pos.shape)
        x = np.concatenate([atom_idx[:, None], pos], axis=1)  # synmol.py:113
        pos = pos * 5.0                                       # synmol.py:116
        ei = knn_graph(pos, k=min(5, pos.shape[0]), include_self=True)
        ds.graphs.append((x.astype(np.float32), ei, y))
        ds.extras.append({"pos": pos.astype(np.float32),
                          "node_label": node_label})
        idx_split[split_of[idx]].append(cnt)
        cnt += 1
    ds.idx_split = {k: np.asarray(v, np.int64) for k, v in idx_split.items()}
    return ds


def build_synmol(root, data_config, *, seed=42) -> GraphListDataset:
    """SynMol (synmol.py). Resolution order: our npz cache, the reference's
    processed ``data.pt`` (read without PyG), or the raw pipeline
    (:func:`build_synmol_raw` — RDKit only for conformers, with a
    positions-file substitute)."""
    cache = os.path.join(root, "processed", "synmol_processed.npz")
    if os.path.exists(cache):
        return GraphListDataset.load_cache("synmol", cache)
    pyg_cache = os.path.join(root, "processed", "data.pt")
    if os.path.exists(pyg_cache):
        from difformer_tpu_torch.data.pyg_interop import graph_list_from_pyg

        ds = graph_list_from_pyg("synmol", pyg_cache)
        ds.save_cache(cache)
        return ds
    if os.path.exists(os.path.join(root, "raw", "x_true.npz")):
        ds = build_synmol_raw(root, data_config, seed=seed)
        ds.save_cache(cache)
        return ds
    raise ImportError(
        f"SynMol data not found under {root} (zero-egress env): provide the "
        f"processed cache at {cache}, the reference's PyG artifact at "
        f"{pyg_cache}, or the raw layout (x_true.npz etc.; conformer "
        f"generation needs RDKit, synmol.py:96-107, or a positions.npz)"
    )


def build_plbind(root, data_config, *, seed=42) -> GraphListDataset:
    """PLBind (plbind.py). Resolution order: our npz cache, the reference's
    processed ``data.pt`` (read without PyG), or the full raw pipeline
    (``data/plbind.py`` — pure numpy; no BioPython/RDKit/pint needed)."""
    cache = os.path.join(root, "processed", "plbind_processed.npz")
    if os.path.exists(cache):
        return GraphListDataset.load_cache("plbind", cache)
    pyg_cache = os.path.join(root, "processed", "data.pt")
    if os.path.exists(pyg_cache):
        from difformer_tpu_torch.data.pyg_interop import graph_list_from_pyg

        ds = graph_list_from_pyg("plbind", pyg_cache)
        ds.save_cache(cache)
        return ds
    raw_index = os.path.join(root, "raw", "index",
                             "INDEX_general_PL_data.2020")
    if os.path.exists(raw_index):
        from difformer_tpu_torch.data.plbind import build_plbind_raw

        ds = build_plbind_raw(root, data_config)
        ds.save_cache(cache)
        return ds
    raise FileNotFoundError(
        f"PLBind data not found under {root} (zero-egress env): provide the "
        f"processed cache at {cache}, the reference's PyG artifact at "
        f"{pyg_cache}, or the raw layout at {os.path.join(root, 'raw')} "
        f"(index/pdb/split, plbind.py raw_file_names)"
    )


BUILDERS = {
    "actstrack": build_actstrack,
    "tau3mu": build_tau3mu,
    "synmol": build_synmol,
    "plbind": build_plbind,
}


def load_particle_dataset(name, root, config_path=None, **kw):
    cfg = load_data_config(config_path) if config_path else {}
    return BUILDERS[name](root, cfg, **kw)
