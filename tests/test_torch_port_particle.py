"""The port's particle-track data modules against the JAX package's, on the
CPU: ``data/particle.py`` (its config and filter parsers, the physics
helpers, the ``.npz`` cache in both directions and the four builders),
``data/smiles.py``, ``data/plbind.py`` and ``data/pyg_interop.py``, each
run on the fixtures that the JAX package's own tests build
(tests/test_particle.py, test_smiles.py, test_plbind.py,
test_pyg_interop.py), with exact equality of every array.
"""

import os
import pickle

import numpy as np
import pandas as pd
import pytest

from difformer_tpu.data import particle as JP
from difformer_tpu.data import plbind as JB
from difformer_tpu.data import pyg_interop as JI
from difformer_tpu.data import smiles as JS
from difformer_tpu_torch.data import particle as TP
from difformer_tpu_torch.data import plbind as TB
from difformer_tpu_torch.data import pyg_interop as TI
from difformer_tpu_torch.data import smiles as TS
from tests.test_particle import _fake_event
from tests.test_plbind import _write_fixture_complex, _write_fixture_dataset
from tests.test_pyg_interop import _write_fake_pyg_cache
import torch_port_helpers  # noqa: F401  (sets torch's threads)


def _same(a, b):
    """Equal values and dtypes, arrays or nested containers of them."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    else:
        assert type(a) is type(b) and a == b


def _same_ds(ours, theirs):
    assert ours.name == theirs.name and len(ours) == len(theirs)
    _same(ours.graphs, theirs.graphs)
    _same(ours.extras, theirs.extras)
    _same(ours.idx_split, theirs.idx_split)


# --------------------------------------------------------------------------
# parsers and physics
# --------------------------------------------------------------------------

@pytest.mark.parametrize("expr", ["==1", "!=0", ">=3", "<2.5", " > -1 "])
def test_apply_filter_matches_jax(expr):
    v = np.array([-1, 0, 1, 2, 3, 4])
    _same(TP.apply_filter(v, expr), JP.apply_filter(v, expr))


def test_apply_filter_refuses_code():
    for mod in (TP, JP):
        with pytest.raises(ValueError):
            mod.apply_filter(np.zeros(2), "__import__('os')")


@pytest.mark.parametrize("text", [
    "# data:\n  data_name: actstrack\n  im_thres: 2\n",
    "data:\n  data_name: tau3mu\n  split:\n    train: 0.6\n",
    "data_name: synmol\nsample_tracks: 4\n",
])
def test_load_data_config_matches_jax(tmp_path, text):
    p = tmp_path / "cfg.yml"
    p.write_text(text)
    assert TP.load_data_config(str(p)) == JP.load_data_config(str(p))


def test_invariant_mass_and_signal_particles_match_jax():
    rng = np.random.default_rng(0)
    args = rng.normal(size=(7, 20))
    _same(TP.invariant_mass(*args), JP.invariant_mass(*args))
    initial, _, _ = _fake_event(np.random.default_rng(1), True)
    for thres in (2.0, 50.0):
        _same(TP.get_signal_particles(initial, thres),
              JP.get_signal_particles(initial, thres))


# --------------------------------------------------------------------------
# the cache and the builders
# --------------------------------------------------------------------------

def _raw_actstrack(root, seed=0):
    rng = np.random.default_rng(seed)
    signal = [_fake_event(rng, True) for _ in range(4)]
    bkg = [_fake_event(rng, False) for _ in range(4)]
    raw = root / "raw"
    raw.mkdir(parents=True)
    for name, events in (("signal", signal), ("bkg", bkg)):
        with open(raw / f"{name}_events_2T.pkl", "wb") as f:
            pickle.dump(events, f)


def test_build_actstrack_matches_jax(tmp_path):
    cfg = {"im_thres": 2, "sample_tracks": 4}
    built = []
    for name, mod in (("ours", TP), ("theirs", JP)):
        _raw_actstrack(tmp_path / name)
        built.append(mod.build_actstrack(str(tmp_path / name), cfg,
                                         tesla="2T", seed=0))
    _same_ds(*built)
    assert len(built[0]) == 8
    # each package reads the cache the other wrote
    cache = os.path.join("processed", "actstrack_2T_processed.npz")
    _same_ds(TP.GraphListDataset.load_cache(
        "actstrack", str(tmp_path / "theirs" / cache)), built[1])
    _same_ds(JP.GraphListDataset.load_cache(
        "actstrack", str(tmp_path / "ours" / cache)), built[0])


def test_build_tau3mu_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    rows = []
    for i in range(6):
        n = int(rng.integers(5, 10))
        y = i % 2
        rows.append({
            "n_mu_hit": n, "y": y,
            "node_label": (np.arange(n) < 4).astype(np.int64) * y,
            "mu_hit_station": np.ones(n, np.int64),
            "mu_hit_neighbor": np.zeros(n, np.int64),
            "mu_hit_type": np.ones(n, np.int64),
            "mu_hit_sim_eta": rng.normal(size=n),
            "mu_hit_sim_phi": rng.uniform(-180, 180, size=n),
            "mu_hit_bend": rng.normal(size=n),
        })
    built = []
    for name, mod in (("ours", TP), ("theirs", JP)):
        raw = tmp_path / name / "raw"
        raw.mkdir(parents=True)
        pd.DataFrame(rows).to_pickle(raw / "tau3mu_mixed.pkl")
        built.append(mod.build_tau3mu(str(tmp_path / name), {}, seed=0))
    _same_ds(*built)
    assert len(built[0]) == 6


def _raw_synmol(root, n_mol=1010, positions=True):
    """The SynMol raw layout of tests/test_particle.py (one-hot atoms,
    attribution labels, a split, positions.npz) at ``n_mol`` molecules."""
    raw = root / "raw"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(0)
    n_types = len(JP.SYNMOL_ATOM_TYPES)
    sizes = rng.integers(4, 9, n_mol)
    datadicts, exp, ys, poses = [], [], [], []
    for n in sizes:
        onehot = np.zeros((n, n_types))
        onehot[np.arange(n), rng.integers(0, 4, n)] = 1
        datadicts.append({"nodes": onehot})
        exp.append([{"nodes": (rng.random(n) < 0.3).astype(
            np.float64)[:, None]}])
        ys.append(float(rng.integers(0, 2)))
        poses.append(rng.normal(size=(n, 3)))
    np.savez(raw / "y_true.npz", y=np.asarray(ys))
    np.savez(raw / "x_true.npz",
             datadict_list=np.asarray([datadicts], dtype=object))
    np.savez(raw / "true_raw_attribution_datadicts.npz",
             datadict_list=np.asarray(exp, dtype=object))
    pd.DataFrame({"smiles": ["C"] * n_mol}).to_csv(
        raw / "logic8_smiles.csv", index=False)
    idx = rng.permutation(n_mol)
    np.savez(raw / "logic8_traintest_indices.npz",
             train_index=idx[:n_mol - 5], test_index=idx[n_mol - 5:])
    if positions:
        np.savez(raw / "positions.npz", pos=np.asarray(poses, dtype=object))


def test_build_synmol_raw_matches_jax(tmp_path):
    built = []
    for name, mod in (("ours", TP), ("theirs", JP)):
        _raw_synmol(tmp_path / name)
        built.append(mod.BUILDERS["synmol"](str(tmp_path / name), {}))
    _same_ds(*built)
    assert len(built[0].idx_split["valid"]) == 1000


def test_synmol_conformer_fallback_matches_jax(tmp_path):
    """Without a positions file the numpy conformers of ``data/smiles.py``
    place the atoms (the molecules' SMILES are "C", one atom each, so the
    fixture's sizes are cut to 1)."""
    built = []
    for name, mod in (("ours", TP), ("theirs", JP)):
        root = tmp_path / name
        _raw_synmol(root, n_mol=1003, positions=False)
        raw = root / "raw"
        x = np.load(raw / "x_true.npz", allow_pickle=True)["datadict_list"]
        e = np.load(raw / "true_raw_attribution_datadicts.npz",
                    allow_pickle=True)["datadict_list"]
        for d in x[0]:
            d["nodes"] = d["nodes"][:1]
        for d in e:
            d[0]["nodes"] = d[0]["nodes"][:1]
        np.savez(raw / "x_true.npz", datadict_list=x)
        np.savez(raw / "true_raw_attribution_datadicts.npz",
                 datadict_list=e)
        built.append(mod.build_synmol_raw(str(root), {}, seed=3))
    _same_ds(*built)


def test_builders_read_the_pyg_cache_as_jax(tmp_path):
    built = []
    for name, mod in (("ours", TP), ("theirs", JP)):
        path = str(tmp_path / name / "processed" / "data.pt")
        _write_fake_pyg_cache(path)
        built.append(mod.BUILDERS["synmol"](str(tmp_path / name), {}))
    _same_ds(*built)


def test_build_plbind_matches_jax(tmp_path):
    cfg = {"pocket_cutoff": 8, "bin_thres": 100}
    built = []
    for name, mod in (("ours", TP), ("theirs", JP)):
        _write_fixture_dataset(str(tmp_path / name))
        built.append(mod.BUILDERS["plbind"](str(tmp_path / name), cfg))
    _same_ds(*built)
    assert len(built[0]) == 2


@pytest.mark.parametrize("name", ["actstrack", "tau3mu", "synmol", "plbind"])
def test_builders_raise_as_jax_without_data(tmp_path, name):
    for mod in (TP, JP):
        with pytest.raises((FileNotFoundError, ImportError)) as err:
            mod.load_particle_dataset(name, str(tmp_path / name))
        msg = str(err.value)
    with pytest.raises(type(err.value), match=msg[:20].replace("(", r"\(")):
        TP.load_particle_dataset(name, str(tmp_path / name))


# --------------------------------------------------------------------------
# smiles, plbind, pyg_interop
# --------------------------------------------------------------------------

SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "O=C(O)c1ccccc1OC(C)=O",
          "CC(C)(C)c1ccc(O)cc1", "[Na+].[Cl-]", "C1CCCCC1", "N#CC(Br)=C/F"]


@pytest.mark.parametrize("smi", SMILES)
def test_smiles_parse_and_conformer_match_jax(smi):
    _same(TS.parse_smiles(smi), JS.parse_smiles(smi))
    _same(TS.smiles_conformer(smi, seed=3), JS.smiles_conformer(smi, seed=3))


@pytest.mark.parametrize("bad", ["C(C", "C1CC", "CXC"])
def test_smiles_errors_match_jax(bad):
    for mod in (TS, JS):
        with pytest.raises(mod.SmilesError):
            mod.parse_smiles(bad)


@pytest.mark.parametrize("text", ["Kd=49uM", "Ki=3nM", "Kd~0.5mM",
                                  "Kd=2pM", "IC50=5uM", "Kd>100uM"])
def test_plbind_affinity_matches_jax(text):
    assert TB.parse_affinity(text) == JB.parse_affinity(text)
    value = JB.parse_affinity(text)
    if value is not None:
        assert TB.binary_affinity(value, 100) == JB.binary_affinity(value,
                                                                     100)


def test_plbind_stages_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(3, 9)), rng.normal(size=(3, 9))
    _same(TB.kabsch(a, b), JB.kabsch(a, b))
    coords = rng.normal(scale=3.0, size=(12, 3))
    elems = ["C", "N", "O", "S"] * 3
    _same(TB.shrake_rupley_sasa(coords, elems),
          JB.shrake_rupley_sasa(coords, elems))
    lig, rec = rng.normal(size=(2, 3)), rng.normal(scale=6.0, size=(9, 3))
    _same(TB.pocket_node_labels(lig, rec, cutoff=8.0),
          JB.pocket_node_labels(lig, rec, cutoff=8.0))
    _write_fixture_complex(str(tmp_path), "1abc", n_res=3)
    pdb = tmp_path / "raw" / "pdb" / "1abc" / "1abc_protein_processed.pdb"
    feats = [mod.receptor_features(mod.select_receptor_residues(
        mod.parse_pdb_residues(str(pdb)), np.zeros((1, 3)), cutoff=10.0))
        for mod in (TB, JB)]
    _same(*feats)


def test_pyg_interop_matches_jax(tmp_path):
    path = str(tmp_path / "processed" / "data.pt")
    _write_fake_pyg_cache(path)
    ours, theirs = TI.load_pyg_processed(path), JI.load_pyg_processed(path)
    _same(ours, theirs)
    for i in range(2):
        _same(TI.decollate(*ours[:2], i), JI.decollate(*theirs[:2], i))
    _same_ds(TI.graph_list_from_pyg("synmol", path),
             JI.graph_list_from_pyg("synmol", path))
