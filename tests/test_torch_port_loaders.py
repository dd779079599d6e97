"""The port's dataset readers (difformer_tpu_torch/data/loaders.py) against
the JAX package's on the same files: the fixtures of tests/test_loaders.py
(the reference layouts, written here from a seed), read by both
``load_dataset``s, must give exactly equal arrays of the same dtypes, equal
fixed splits, and the same missing-file errors, which name the path.
"""

import gzip
import json
import pickle

import numpy as np
import pytest
import scipy.sparse as sp

from difformer_tpu.data import loaders as jax_loaders
from difformer_tpu_torch.data import loaders
from difformer_tpu_torch.data.transforms import normalize_feat

import chip_smoke
import torch_port_helpers  # noqa: F401  (sets torch's threads)


def assert_same_array(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def assert_same_splits(a, b):
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same_splits(x, y)
        return
    if a is None:
        assert b is None
        return
    assert set(a) == set(b)
    for k in a:
        assert_same_array(a[k], b[k], f"split {k}")


def assert_same_dataset(port, ref, extras=()):
    assert port.name == ref.name
    assert set(port.graph) == set(ref.graph)
    for key in ("edge_index", "node_feat", "edge_feat"):
        assert_same_array(port.graph[key], ref.graph[key], key)
    assert int(port.graph["num_nodes"]) == int(ref.graph["num_nodes"])
    assert_same_array(port.label, ref.label, "label")
    assert_same_splits(port._fixed_splits, ref._fixed_splits)
    for ex in extras:
        assert_same_array(getattr(port, ex), getattr(ref, ex), ex)


def both(data_dir, name, sub_dataset=""):
    return (loaders.load_dataset(str(data_dir), name, sub_dataset),
            jax_loaders.load_dataset(str(data_dir), name, sub_dataset))


# --------------------------------------------------------------------------
# fixtures in the reference layouts
# --------------------------------------------------------------------------

def write_planetoid(root, name, seed, citeseer_gap=False):
    """ind.<name>.* raw files of a toy graph; ``citeseer_gap`` leaves test
    indices out of the range, as citeseer's isolated test nodes do."""
    n_train, n_test, n_allx, f, c = 20, 10, 40, 6, 3
    rng = np.random.default_rng(seed)
    raw = root / "Planetoid" / name / "raw"
    raw.mkdir(parents=True)
    x = sp.csr_matrix(rng.random((n_train, f)))
    allx = sp.csr_matrix(rng.random((n_allx, f)))
    tx = sp.csr_matrix(rng.random((n_test, f)))
    y = np.eye(c)[rng.integers(0, c, n_train)]
    ally = np.eye(c)[rng.integers(0, c, n_allx)]
    ty = np.eye(c)[rng.integers(0, c, n_test)]
    test_idx = np.arange(n_allx, n_allx + n_test)
    if citeseer_gap:
        test_idx = np.concatenate([test_idx[:5], test_idx[5:] + 3])
    n = int(test_idx.max()) + 1
    graph = {i: [int(j) for j in rng.integers(0, n, 3)] for i in range(n)}
    rng.shuffle(test_idx)
    for part, obj in [("x", x), ("y", y), ("tx", tx), ("ty", ty),
                      ("allx", allx), ("ally", ally), ("graph", graph)]:
        with open(raw / f"ind.{name}.{part}", "wb") as fh:
            pickle.dump(obj, fh)
    np.savetxt(raw / f"ind.{name}.test.index", test_idx, fmt="%d")


def write_csv_gz(path, arr, fmt):
    with gzip.open(path, "wt") as f:
        for row in np.atleast_2d(arr):
            f.write(",".join(fmt % v for v in np.atleast_1d(row)) + "\n")


def write_ogb(root, name, n=20, e=60, f=8, labels=None, node_feat=True,
              edge_feat=False, extras=(), split="time"):
    rng = np.random.default_rng(0)
    base = root / name.replace("-", "_")
    raw = base / "raw"
    raw.mkdir(parents=True)
    write_csv_gz(raw / "edge.csv.gz", rng.integers(0, n, (e, 2)), "%d")
    write_csv_gz(raw / "num-node-list.csv.gz", np.array([[n]]), "%d")
    write_csv_gz(raw / "num-edge-list.csv.gz", np.array([[e]]), "%d")
    if node_feat:
        write_csv_gz(raw / "node-feat.csv.gz", rng.normal(size=(n, f)),
                     "%.6f")
    if edge_feat:
        write_csv_gz(raw / "edge-feat.csv.gz", rng.uniform(size=(e, f)),
                     "%.6f")
    if labels is None:
        labels = rng.integers(0, 4, (n, 1))
    write_csv_gz(raw / "node-label.csv.gz", labels, "%d")
    for ex, vals in extras:
        write_csv_gz(raw / f"{ex}.csv.gz", vals.reshape(-1, 1), "%d")
    sd = base / "split" / split
    sd.mkdir(parents=True)
    for k, part in zip(("train", "valid", "test"),
                       np.array_split(rng.permutation(n), 3)):
        write_csv_gz(sd / f"{k}.csv.gz", part.reshape(-1, 1), "%d")


def masks(n, seed):
    rng = np.random.default_rng(seed)
    return rng.random((10, n)) > 0.5


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "pokec", "cora", "amazon-photo", "coauthor-cs", "roman-empire",
    "chameleon", "cornell", "fb100", "deezer-europe", "yelp-chi",
    "snap-patents", "twitch-e", "cifar10", "stl10", "mini"])
def test_missing_file_error_names_the_path(tmp_path, name):
    with pytest.raises(FileNotFoundError) as got:
        loaders.load_dataset(str(tmp_path), name)
    with pytest.raises(FileNotFoundError) as expect:
        jax_loaders.load_dataset(str(tmp_path), name)
    assert str(got.value) == str(expect.value)
    assert str(tmp_path) in str(got.value) and "not found at" in str(
        got.value)


def test_missing_ogb_layout_raises_as_the_reference(tmp_path, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_ogb(name, *args, **kwargs):
        if name.startswith("ogb"):
            raise ImportError("No module named 'ogb'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_ogb)
    with pytest.raises(FileNotFoundError) as got:
        loaders.load_dataset(str(tmp_path), "ogbn-arxiv")
    with pytest.raises(FileNotFoundError) as expect:
        jax_loaders.load_dataset(str(tmp_path), "ogbn-arxiv")
    assert str(got.value) == str(expect.value)
    assert "ogb package" in str(got.value)


def test_unknown_dataset_raises():
    with pytest.raises(ValueError, match="unknown dataset"):
        loaders.load_dataset("", "no-such-set")


@pytest.mark.parametrize("name", ["synthetic-100-400-8-3", "synthetic"])
def test_synthetic_dispatch(name):
    port, ref = both("", name)
    assert_same_dataset(port, ref)
    for run in range(2):
        assert_same_splits(port.get_idx_split("random", rng=run),
                           ref.get_idx_split("random", rng=run))
        assert_same_splits(
            port.get_idx_split("class", label_num_per_class=5, rng=run),
            ref.get_idx_split("class", label_num_per_class=5, rng=run))


@pytest.mark.parametrize("name,gap", [("cora", False), ("citeseer", True)])
def test_planetoid_raw_format(tmp_path, name, gap):
    write_planetoid(tmp_path, name, seed=3, citeseer_gap=gap)
    port, ref = both(tmp_path, name)
    assert_same_dataset(port, ref)
    fixed = port.get_idx_split("fixed")
    assert fixed["train"].shape[0] == 20


def test_chip_smoke_planetoid_files_read_the_same(tmp_path):
    """The raw files chip_smoke.py writes for its cli phase."""
    x, ei, y = chip_smoke.write_planetoid_cora(str(tmp_path), num_nodes=300,
                                               num_edges=900, feat_dim=24)
    port, ref = both(tmp_path, "cora")
    assert_same_dataset(port, ref)
    assert port.graph["num_nodes"] == 300
    np.testing.assert_array_equal(port.label, y)
    np.testing.assert_array_equal(port.graph["node_feat"], normalize_feat(x))
    np.testing.assert_array_equal(port.graph["edge_index"], ei)


def test_amazon_coauthor_npz_format(tmp_path):
    n, f = 30, 5
    rng = np.random.default_rng(1)
    adj = sp.random(n, n, density=0.1, format="csr", random_state=1)
    attr = sp.random(n, f, density=0.5, format="csr", random_state=2)
    for sub, fname in (("Amazon", "amazon_electronics_photo.npz"),
                       ("Coauthor", "ms_academic_phy.npz")):
        (tmp_path / sub).mkdir()
        np.savez(tmp_path / sub / fname,
                 adj_data=adj.data, adj_indices=adj.indices,
                 adj_indptr=adj.indptr, adj_shape=adj.shape,
                 attr_data=attr.data, attr_indices=attr.indices,
                 attr_indptr=attr.indptr, attr_shape=attr.shape,
                 labels=rng.integers(0, 3, n))
    for name in ("amazon-photo", "coauthor-physics"):
        assert_same_dataset(*both(tmp_path, name))


def test_heterophilous_and_filtered_npz_formats(tmp_path):
    n, f = 25, 4
    rng = np.random.default_rng(2)
    for sub, fname in (("heterophilous", "roman_empire.npz"),
                       ("heterophilous_graph", "squirrel_filtered.npz")):
        (tmp_path / sub).mkdir()
        np.savez(tmp_path / sub / fname,
                 edges=rng.integers(0, n, (60, 2)),
                 node_features=rng.random((n, f)).astype(np.float32),
                 node_labels=rng.integers(0, 3, n),
                 train_masks=masks(n, 1), val_masks=masks(n, 2),
                 test_masks=masks(n, 3))
    for name in ("roman-empire", "squirrel"):
        port, ref = both(tmp_path, name)
        assert_same_dataset(port, ref)
        assert len(port._fixed_splits) == 10


@pytest.mark.parametrize("name", ["cornell", "film"])
def test_geom_gcn_format(tmp_path, name):
    n = 12
    rng = np.random.default_rng(3)
    d = tmp_path / "geom-gcn" / name
    d.mkdir(parents=True)
    with open(d / "out1_graph_edges.txt", "w") as f:
        f.write("src\tdst\n")
        for a, b in rng.integers(0, n, (30, 2)):
            f.write(f"{a}\t{b}\n")
    with open(d / "out1_node_feature_label.txt", "w") as f:
        f.write("id\tfeat\tlabel\n")
        for i in range(n):
            if name == "film":
                feats = ",".join(str(v) for v in rng.choice(931, 4, False))
            else:
                feats = ",".join(str(v) for v in rng.integers(0, 2, 5))
            f.write(f"{i}\t{feats}\t{rng.integers(0, 3)}\n")
    splits = tmp_path / "geom-gcn" / "splits"
    splits.mkdir()
    for i in range(3):
        np.savez(splits / f"{name}_split_0.6_0.2_{i}.npz",
                 train_mask=masks(n, i)[0], val_mask=masks(n, i)[1],
                 test_mask=masks(n, i)[2])
    port, ref = both(tmp_path, name)
    assert_same_dataset(port, ref)
    assert len(port._fixed_splits) == 3


def test_mat_formats(tmp_path):
    from scipy.io import savemat

    n = 20
    rng = np.random.default_rng(4)
    (tmp_path / "facebook100").mkdir()
    savemat(tmp_path / "facebook100" / "Penn94.mat", {
        "A": sp.random(n, n, density=0.2, format="csc", random_state=4),
        "local_info": np.column_stack([
            rng.integers(1, 3, n), rng.integers(0, 3, n),
            rng.integers(1, 5, n), rng.integers(1, 4, n),
            rng.integers(1, 6, n), rng.integers(2000, 2010, n),
            rng.integers(1, 30, n)])})
    savemat(tmp_path / "YelpChi.mat", {
        "homo": sp.random(n, n, density=0.2, format="csc", random_state=5),
        "features": sp.csr_matrix(rng.random((n, 4))),
        "label": rng.integers(0, 2, (1, n))})
    savemat(tmp_path / "deezer-europe.mat", {
        "A": sp.random(n, n, density=0.2, format="csc", random_state=6),
        "features": sp.csr_matrix(rng.random((n, 5))),
        "label": rng.integers(0, 2, (1, n))})
    (tmp_path / "pokec").mkdir()
    savemat(tmp_path / "pokec" / "pokec.mat", {
        "edge_index": rng.integers(0, n, (2, 50)),
        "node_feat": rng.random((n, 6)),
        "label": rng.integers(0, 2, (1, n))})
    savemat(tmp_path / "snap_patents.mat", {
        "edge_index": rng.integers(0, n, (2, 40)),
        "node_feat": sp.csr_matrix(rng.random((n, 3))),
        "num_nodes": np.array([[n]]),
        "years": rng.integers(1975, 2000, (1, n))})
    for name in ("fb100", "yelp-chi", "deezer-europe", "pokec",
                 "snap-patents"):
        assert_same_dataset(*both(tmp_path, name))


@pytest.mark.parametrize("mature", ["ints", "bools"])
def test_twitch_raw_format(tmp_path, mature):
    n = 10
    d = tmp_path / "twitch" / "DE"
    d.mkdir(parents=True)
    (d / "musae_DE_edges.csv").write_text(
        "from,to\n" + "".join(f"{a},{b}\n" for a, b in
                              [(0, 1), (1, 2), (2, 3), (9, 4)]))
    values = [str(i % 2) if mature == "ints" else str(bool(i % 3))
              for i in range(n)]
    (d / "musae_DE_target.csv").write_text(
        "id,days,mature,views,partner,new_id\n" + "".join(
            f"{i},{10 * i},{v},{i * 7},False,{i}\n"
            for i, v in enumerate(values)))
    feats = {str(i): [int(i), int(i) + 1, 3200] for i in range(n)}
    (d / "musae_DE_features.json").write_text(json.dumps(feats))
    port, ref = both(tmp_path, "twitch-e")
    assert_same_dataset(port, ref)
    assert port.graph["node_feat"].shape == (n, 3170)


def test_ogb_raw_arxiv_layout_and_cache(tmp_path):
    years = np.random.default_rng(1).integers(2005, 2020, 20)
    write_ogb(tmp_path, "ogbn-arxiv", extras=[("node_year", years)])
    port = loaders.load_dataset(str(tmp_path), "ogbn-arxiv")
    cache = tmp_path / "ogbn_arxiv" / "processed_difformer_tpu.npz"
    assert cache.exists()
    ref = jax_loaders.load_ogb_raw(str(tmp_path), "ogbn-arxiv")  # the cache
    assert_same_dataset(port, ref, extras=("node_year",))
    cache.unlink()
    ref = jax_loaders.load_dataset(str(tmp_path), "ogbn-arxiv")
    cache.unlink()
    assert_same_dataset(port, ref, extras=("node_year",))
    port = loaders.load_dataset(str(tmp_path), "ogbn-arxiv")  # its cache
    assert_same_dataset(port, ref, extras=("node_year",))


def test_ogb_raw_proteins_and_arxiv_year(tmp_path):
    labels = np.random.default_rng(2).integers(0, 2, (20, 5))
    write_ogb(tmp_path, "ogbn-proteins", labels=labels, node_feat=False,
              edge_feat=True, extras=[("node_species", np.arange(20))],
              split="species")
    port = loaders.load_dataset(str(tmp_path), "ogbn-proteins")
    (tmp_path / "ogbn_proteins" / "processed_difformer_tpu.npz").unlink()
    ref = jax_loaders.load_dataset(str(tmp_path), "ogbn-proteins")
    assert_same_dataset(port, ref, extras=("node_species",))
    assert port.graph["edge_index"].shape == (2, 120)

    years = np.random.default_rng(3).integers(2000, 2020, 20)
    write_ogb(tmp_path, "ogbn-arxiv", extras=[("node_year", years)])
    port = loaders.load_dataset(str(tmp_path), "arxiv-year")
    (tmp_path / "ogbn_arxiv" / "processed_difformer_tpu.npz").unlink()
    ref = jax_loaders.load_dataset(str(tmp_path), "arxiv-year")
    assert_same_dataset(port, ref)
    assert_same_splits(port.get_idx_split(rng=1), ref.get_idx_split(rng=1))


def test_image_text_pickles(tmp_path):
    rng = np.random.default_rng(6)
    for name in ("stl10", "cifar10"):
        with open(tmp_path / f"{name}_embeddings.pkl", "wb") as f:
            pickle.dump((rng.normal(size=(40, 16)), rng.integers(0, 10, 40)),
                        f)
    with open(tmp_path / "mini_imagenet.pkl", "wb") as f:
        pickle.dump({"data": rng.normal(size=(30, 8)),
                     "labels": rng.integers(0, 5, 30)}, f)
    for name in ("stl10", "cifar10", "mini"):
        port, ref = both(tmp_path, name)
        assert_same_dataset(port, ref)
        assert port.graph["edge_index"] is None


def test_cifar10_is_cut_to_15000(tmp_path):
    x, y = chip_smoke.cifar10_embeddings(num=15010, dim=4, classes=10, seed=0)
    chip_smoke.write_cifar10_embeddings(str(tmp_path), x, y)
    port, ref = both(tmp_path, "cifar10")
    assert_same_dataset(port, ref)
    assert port.graph["node_feat"].shape == (15000, 4)
