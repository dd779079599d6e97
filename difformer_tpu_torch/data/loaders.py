"""Dataset readers and the ``load_dataset`` dispatcher, as
``difformer_tpu/data/loaders.py`` (the reference's ``load_dataset``,
``node classification/dataset.py:86-605``), giving the same arrays.

They read files already on disk under ``data_dir``, in the layout the
reference downloads into, and raise a ``FileNotFoundError`` naming the
missing path otherwise; nothing here opens a network connection.
``load_dataset('synthetic-N-E-F-C')`` makes a random graph instead.

Where the JAX package reads csv with pandas (twitch-e, and the OGB csv.gz
files when pandas is installed) these read with ``csv`` and numpy. The
20news reader (sklearn) and the ``ogb`` package route import their package
when called, and raise naming it where it is missing. The parsed OGB cache
(``processed_difformer_tpu.npz``) has the JAX package's name and layout,
so one data directory serves both packages.

Formats: Planetoid raw pickles (cora, citeseer, pubmed); npz graphs
(amazon-photo/computer, coauthor-cs/physics); geom-gcn heterophily
(cornell, texas, wisconsin, film); filtered chameleon/squirrel npz;
heterophilous npz (roman-empire, ...); .mat graphs (pokec, fb100,
deezer-europe, yelp-chi, snap-patents); twitch-e raw csv/json; OGB raw
csv.gz layouts (ogbn-arxiv, ogbn-proteins, ogbn-products, arxiv-year);
image and text embedding pickles and 20news
(``image and text/dataset.py:70-189``).
"""

from __future__ import annotations

import csv
import gzip
import json
import os
import pickle

import numpy as np

from difformer_tpu_torch.data.graph import NodeDataset
from difformer_tpu_torch.data.splits import even_quantile_labels


def _need(path, what):
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{what} not found at {path}. This environment has no network "
            f"access — place the reference-layout files there, or use a "
            f"'synthetic-*' dataset."
        )
    return path


# --------------------------------------------------------------------------
# Planetoid raw format
# --------------------------------------------------------------------------

def _parse_planetoid_index(path):
    return np.loadtxt(path, dtype=np.int64)


def load_planetoid(data_dir, name) -> NodeDataset:
    """Parse the raw Planetoid pickles (ind.<name>.{x,y,tx,ty,allx,ally,
    graph,test.index}) into an NCDataset-equivalent with the standard
    semi-supervised fixed split. Features are row-normalized like PyG's
    NormalizeFeatures transform (``dataset.py:441``)."""
    import scipy.sparse as sp

    root = os.path.join(data_dir, "Planetoid", name.lower(), "raw")
    if not os.path.exists(root):
        root = _need(os.path.join(data_dir, name.lower()), f"planetoid {name}")

    def rd(suffix):
        p = _need(os.path.join(root, f"ind.{name.lower()}.{suffix}"),
                  f"{name} {suffix}")
        with open(p, "rb") as f:
            return pickle.load(f, encoding="latin1")

    x, y, tx, ty, allx, ally = (rd(s) for s in
                                ["x", "y", "tx", "ty", "allx", "ally"])
    graph = rd("graph")
    test_idx = _parse_planetoid_index(
        os.path.join(root, f"ind.{name.lower()}.test.index")
    )
    test_idx_range = np.sort(test_idx)

    if name.lower() == "citeseer":
        # fill isolated test nodes (standard planetoid fix)
        full = np.arange(test_idx_range.min(), test_idx_range.max() + 1)
        tx_ext = sp.lil_matrix((len(full), x.shape[1]))
        tx_ext[test_idx_range - test_idx_range.min(), :] = tx
        tx = tx_ext
        ty_ext = np.zeros((len(full), y.shape[1]))
        ty_ext[test_idx_range - test_idx_range.min(), :] = ty
        ty = ty_ext

    features = sp.vstack((allx, tx)).tolil()
    features[test_idx, :] = features[test_idx_range, :]
    labels_oh = np.vstack((ally, ty))
    labels_oh[test_idx, :] = labels_oh[test_idx_range, :]
    labels = labels_oh.argmax(1)
    labels[labels_oh.sum(1) == 0] = -1

    n = features.shape[0]
    src, dst = [], []
    for k, nbrs in graph.items():
        for v in nbrs:
            src.append(k)
            dst.append(v)
    edge_index = np.stack([np.asarray(src), np.asarray(dst)])

    feat = np.asarray(features.todense(), np.float32)
    rowsum = feat.sum(1, keepdims=True)
    rowsum[rowsum == 0] = 1
    feat = feat / rowsum

    ds = NodeDataset(name)
    ds.graph = {"edge_index": edge_index, "node_feat": feat,
                "edge_feat": None, "num_nodes": n}
    ds.label = labels
    train_idx = np.arange(y.shape[0])
    val_idx = np.arange(y.shape[0], y.shape[0] + 500)
    ds._fixed_splits = {"train": train_idx, "valid": val_idx,
                        "test": test_idx_range}
    return ds


# --------------------------------------------------------------------------
# npz formats
# --------------------------------------------------------------------------

def load_amazon_coauthor(data_dir, name) -> NodeDataset:
    """amazon-photo/computer, coauthor-cs/physics npz (csr arrays)."""
    files = {
        "amazon-photo": "Amazon/amazon_electronics_photo.npz",
        "amazon-computer": "Amazon/amazon_electronics_computers.npz",
        "coauthor-cs": "Coauthor/ms_academic_cs.npz",
        "coauthor-physics": "Coauthor/ms_academic_phy.npz",
    }
    path = _need(os.path.join(data_dir, files[name]), name)
    import scipy.sparse as sp

    with np.load(path, allow_pickle=True) as f:
        adj = sp.csr_matrix(
            (f["adj_data"], f["adj_indices"], f["adj_indptr"]),
            shape=f["adj_shape"],
        )
        feat = sp.csr_matrix(
            (f["attr_data"], f["attr_indices"], f["attr_indptr"]),
            shape=f["attr_shape"],
        ).todense()
        labels = f["labels"]
    coo = adj.tocoo()
    ds = NodeDataset(name)
    ds.graph = {
        "edge_index": np.stack([coo.row, coo.col]).astype(np.int64),
        "node_feat": np.asarray(feat, np.float32),
        "edge_feat": None,
        "num_nodes": adj.shape[0],
    }
    ds.label = labels.astype(np.int64)
    return ds


def load_heterophilous(data_dir, name) -> NodeDataset:
    """roman-empire / amazon-ratings / minesweeper / tolokers / questions
    npz with 10 fixed mask splits (``dataset.py:582-605``)."""
    fname = name.replace("-", "_") + ".npz"
    path = _need(os.path.join(data_dir, "heterophilous", fname), name)
    data = np.load(path)
    ds = NodeDataset(name)
    ds.graph = {
        "edge_index": data["edges"].T.astype(np.int64),
        "node_feat": data["node_features"].astype(np.float32),
        "edge_feat": None,
        "num_nodes": data["node_features"].shape[0],
    }
    ds.label = data["node_labels"].astype(np.int64)
    ds._fixed_splits = [
        {
            "train": np.where(data["train_masks"][i])[0],
            "valid": np.where(data["val_masks"][i])[0],
            "test": np.where(data["test_masks"][i])[0],
        }
        for i in range(data["train_masks"].shape[0])
    ]
    return ds


def load_filtered_chameleon_squirrel(data_dir, name) -> NodeDataset:
    """chameleon/squirrel 'filtered' npz (``dataset.py:566-580``)."""
    path = _need(
        os.path.join(data_dir, "heterophilous_graph", f"{name}_filtered.npz"),
        name,
    )
    data = np.load(path)
    ds = NodeDataset(name)
    ds.graph = {
        "edge_index": data["edges"].T.astype(np.int64),
        "node_feat": data["node_features"].astype(np.float32),
        "edge_feat": None,
        "num_nodes": data["node_features"].shape[0],
    }
    ds.label = data["node_labels"].astype(np.int64)
    ds._fixed_splits = [
        {
            "train": np.where(data["train_masks"][i])[0],
            "valid": np.where(data["val_masks"][i])[0],
            "test": np.where(data["test_masks"][i])[0],
        }
        for i in range(data["train_masks"].shape[0])
    ]
    return ds


def load_geom_gcn(data_dir, name) -> NodeDataset:
    """cornell/texas/wisconsin/film raw graph files + geom-gcn split npzs
    (``dataset.py:513-564``)."""
    root = _need(os.path.join(data_dir, "geom-gcn", name), name)
    graph_file = os.path.join(root, "out1_graph_edges.txt")
    feat_file = os.path.join(root, "out1_node_feature_label.txt")
    edges = np.loadtxt(graph_file, skiprows=1, dtype=np.int64)
    feats, labels = [], []
    with open(feat_file) as f:
        next(f)
        rows = [line.rstrip().split("\t") for line in f]
    if name == "film":
        n = len(rows)
        feat = np.zeros((n, 931), np.float32)
        labels = np.zeros(n, np.int64)
        for r in rows:
            idx = int(r[0])
            for c in r[1].split(","):
                feat[idx, int(c)] = 1.0
            labels[idx] = int(r[2])
    else:
        feat = np.stack(
            [np.asarray(r[1].split(","), np.float32) for r in rows]
        )
        labels = np.asarray([int(r[2]) for r in rows], np.int64)
    ds = NodeDataset(name)
    ds.graph = {
        "edge_index": edges.T,
        "node_feat": feat,
        "edge_feat": None,
        "num_nodes": feat.shape[0],
    }
    ds.label = labels
    splits_dir = os.path.join(data_dir, "geom-gcn", "splits")
    if os.path.exists(splits_dir):
        ds._fixed_splits = []
        for i in range(10):
            p = os.path.join(
                splits_dir, f"{name}_split_0.6_0.2_{i}.npz"
            )
            if os.path.exists(p):
                with np.load(p) as sf:
                    ds._fixed_splits.append({
                        "train": np.where(sf["train_mask"])[0],
                        "valid": np.where(sf["val_mask"])[0],
                        "test": np.where(sf["test_mask"])[0],
                    })
        if not ds._fixed_splits:
            ds._fixed_splits = None
    return ds


# --------------------------------------------------------------------------
# .mat formats
# --------------------------------------------------------------------------

def load_pokec(data_dir) -> NodeDataset:
    from scipy.io import loadmat

    path = _need(os.path.join(data_dir, "pokec", "pokec.mat"), "pokec")
    mat = loadmat(path)
    ds = NodeDataset("pokec")
    ds.graph = {
        "edge_index": np.asarray(mat["edge_index"], np.int64),
        "node_feat": np.asarray(mat["node_feat"], np.float32),
        "edge_feat": None,
        "num_nodes": int(mat["node_feat"].shape[0]),
    }
    ds.label = np.asarray(mat["label"]).reshape(-1).astype(np.int64)
    return ds


def load_fb100(data_dir, sub_dataset="Penn94") -> NodeDataset:
    """fb100: gender target; features = one-hot categorical columns minus
    gender (``dataset.py:202-246``)."""
    from scipy.io import loadmat

    path = _need(
        os.path.join(data_dir, "facebook100", f"{sub_dataset}.mat"),
        f"fb100 {sub_dataset}",
    )
    mat = loadmat(path)
    A = mat["A"]
    metadata = mat["local_info"].astype(np.int64)
    coo = A.tocoo()
    edge_index = np.stack([coo.row, coo.col]).astype(np.int64)
    label = metadata[:, 1] - 1  # gender, {-1, 0, 1}
    feature_vals = np.hstack(
        (np.expand_dims(metadata[:, 0], 1), metadata[:, 2:])
    )
    feats = []
    for col in range(feature_vals.shape[1]):
        vals, inv = np.unique(feature_vals[:, col], return_inverse=True)
        oh = np.zeros((feature_vals.shape[0], len(vals)), np.float32)
        oh[np.arange(len(inv)), inv] = 1.0
        feats.append(oh)
    ds = NodeDataset(f"fb100-{sub_dataset}")
    ds.graph = {
        "edge_index": edge_index,
        "node_feat": np.hstack(feats).astype(np.float32),
        "edge_feat": None,
        "num_nodes": metadata.shape[0],
    }
    ds.label = label
    return ds


def load_yelpchi(data_dir) -> NodeDataset:
    """yelp-chi fraud graph .mat (``dataset.py:383-401``): homo adjacency,
    binary label, dense features."""
    from scipy.io import loadmat

    path = _need(os.path.join(data_dir, "YelpChi.mat"), "yelp-chi")
    mat = loadmat(path)
    A = mat["homo"]
    coo = A.tocoo()
    ds = NodeDataset("yelp-chi")
    feats = mat["features"]
    ds.graph = {
        "edge_index": np.stack([coo.row, coo.col]).astype(np.int64),
        "node_feat": np.asarray(
            feats.todense() if hasattr(feats, "todense") else feats,
            np.float32,
        ),
        "edge_feat": None,
        "num_nodes": A.shape[0],
    }
    ds.label = np.asarray(mat["label"]).reshape(-1).astype(np.int64)
    return ds


def load_snap_patents(data_dir, nclass=5) -> NodeDataset:
    """snap-patents .mat with quantile labels of year (``dataset.py:343-365``)."""
    from scipy.io import loadmat

    path = _need(os.path.join(data_dir, "snap_patents.mat"), "snap-patents")
    mat = loadmat(path)
    ds = NodeDataset("snap-patents")
    ds.graph = {
        "edge_index": np.asarray(mat["edge_index"], np.int64),
        "node_feat": np.asarray(
            mat["node_feat"].todense()
            if hasattr(mat["node_feat"], "todense") else mat["node_feat"],
            np.float32,
        ),
        "edge_feat": None,
        "num_nodes": int(mat["num_nodes"]),
    }
    years = np.asarray(mat["years"]).reshape(-1)
    ds.label = even_quantile_labels(years, nclass)
    return ds


def _read_csv(path):
    """(header, rows of strings) of a csv file with a header line."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        return header, [row for row in reader if row]


def _int_cell(cell):
    """A csv cell as pandas reads it into an int64 column: booleans as 0/1,
    integers as themselves."""
    text = cell.strip()
    if text in ("True", "False"):
        return int(text == "True")
    return int(float(text))


def load_twitch(data_dir, sub_dataset="DE") -> NodeDataset:
    """twitch-e raw musae csv/json (``load_data.py``): edges csv, one-hot
    feature json, binary 'mature' target."""
    root = _need(os.path.join(data_dir, "twitch", sub_dataset),
                 f"twitch {sub_dataset}")
    _, edge_rows = _read_csv(
        os.path.join(root, f"musae_{sub_dataset}_edges.csv"))
    edges = np.asarray([[int(c) for c in r] for r in edge_rows],
                       np.int64).reshape(-1, 2).T
    header, target_rows = _read_csv(
        os.path.join(root, f"musae_{sub_dataset}_target.csv"))
    with open(os.path.join(root, f"musae_{sub_dataset}_features.json")) as f:
        feats = json.load(f)
    n = len(target_rows)
    col = header.index("mature")
    label = np.asarray([_int_cell(r[col]) for r in target_rows], np.int64)
    dim = 3170  # musae one-hot vocabulary (load_data.py parity)
    x = np.zeros((n, dim), np.float32)
    for node, fs in feats.items():
        for fid in fs:
            if int(fid) < dim:
                x[int(node), int(fid)] = 1.0
    ds = NodeDataset(f"twitch-{sub_dataset}")
    ds.graph = {
        "edge_index": edges.astype(np.int64),
        "node_feat": x,
        "edge_feat": None,
        "num_nodes": n,
    }
    ds.label = label
    return ds


def load_deezer(data_dir) -> NodeDataset:
    from scipy.io import loadmat

    path = _need(os.path.join(data_dir, "deezer-europe.mat"), "deezer")
    mat = loadmat(path)
    A, lab, feat = mat["A"], mat["label"], mat["features"]
    coo = A.tocoo()
    ds = NodeDataset("deezer-europe")
    ds.graph = {
        "edge_index": np.stack([coo.row, coo.col]).astype(np.int64),
        "node_feat": np.asarray(feat.todense(), np.float32),
        "edge_feat": None,
        "num_nodes": lab.shape[1],
    }
    ds.label = np.asarray(lab).reshape(-1).astype(np.int64)
    return ds


# --------------------------------------------------------------------------
# OGB — direct parsing of the standard on-disk layout (no ogb package)
# --------------------------------------------------------------------------

# per-dataset metadata the ogb package reads from master.csv; pinned here so
# the raw csv.gz layout can be parsed standalone (reference dataset.py:250-292
# goes through NodePropPredDataset instead).
_OGB_META = {
    "ogbn-arxiv": {"split": "time", "inverse": False,
                   "extras": ["node_year"]},
    "ogbn-proteins": {"split": "species", "inverse": True,
                      "extras": ["node_species"]},
    "ogbn-products": {"split": "sales_ranking", "inverse": False,
                      "extras": []},
}


def _read_csv_gz(path, dtype):
    """Headerless csv.gz -> 2-D ndarray."""
    with gzip.open(path, "rt") as f:
        return np.loadtxt(f, dtype=dtype, delimiter=",", ndmin=2)


def load_ogb_raw(data_dir, name) -> NodeDataset:
    """Parse an OGB node-prop dataset from its standard extracted layout::

        <data_dir>/<name with _>/raw/{edge,node-feat,node-label,...}.csv.gz
        <data_dir>/<name with _>/split/<split_name>/{train,valid,test}.csv.gz

    i.e. exactly what ``ogbn-*.zip`` unpacks to — no ogb package needed.
    A parsed ``.npz`` cache is written next to ``raw/`` for fast reloads.
    Semantics match ``read_csv_graph_raw`` + ``NodePropPredDataset``
    (inverse-edge duplication for proteins; proteins node features = mean of
    incident edge features, reference dataset.py:284-287).
    """
    meta = _OGB_META[name]
    root = os.path.join(data_dir, name.replace("-", "_"))
    cache = os.path.join(root, "processed_difformer_tpu.npz")
    if os.path.exists(cache):
        z = np.load(cache, allow_pickle=False)
        ds = NodeDataset(name)
        ds.graph = {
            "edge_index": z["edge_index"],
            "node_feat": z["node_feat"],
            "edge_feat": z["edge_feat"] if z["edge_feat"].size else None,
            "num_nodes": int(z["num_nodes"]),
        }
        ds.label = z["label"]
        ds._fixed_splits = {k: z[f"split_{k}"]
                            for k in ("train", "valid", "test")}
        for ex in meta["extras"]:
            setattr(ds, ex, z[ex])
        return ds

    raw = _need(os.path.join(root, "raw"), f"{name} raw directory")
    edge = _read_csv_gz(os.path.join(raw, "edge.csv.gz"), np.int64).T
    num_nodes = int(_read_csv_gz(
        os.path.join(raw, "num-node-list.csv.gz"), np.int64)[0, 0])
    nf_path = os.path.join(raw, "node-feat.csv.gz")
    node_feat = (_read_csv_gz(nf_path, np.float32)
                 if os.path.exists(nf_path) else None)
    ef_path = os.path.join(raw, "edge-feat.csv.gz")
    edge_feat = (_read_csv_gz(ef_path, np.float32)
                 if os.path.exists(ef_path) else None)
    label = _read_csv_gz(os.path.join(raw, "node-label.csv.gz"), np.float32)
    if not (label != label.astype(np.int64)).any():
        label = label.astype(np.int64)

    if meta["inverse"]:
        edge = np.concatenate([edge, edge[::-1]], axis=1)
        if edge_feat is not None:
            edge_feat = np.concatenate([edge_feat, edge_feat], axis=0)

    ds = NodeDataset(name)
    ds.graph = {"edge_index": edge, "node_feat": node_feat,
                "edge_feat": edge_feat, "num_nodes": num_nodes}
    if node_feat is None and edge_feat is not None:
        # node feat = mean of incident edge feats (dataset.py:284-287)
        nf = np.zeros((num_nodes, edge_feat.shape[1]), np.float64)
        cnt = np.zeros(num_nodes, np.float64)
        np.add.at(nf, edge[0], edge_feat.astype(np.float64))
        np.add.at(cnt, edge[0], 1.0)
        ds.graph["node_feat"] = (
            nf / np.maximum(cnt[:, None], 1)).astype(np.float32)
    ds.label = label.reshape(-1) if label.shape[-1] == 1 else label

    split_dir = _need(os.path.join(root, "split", meta["split"]),
                      f"{name} split directory")
    ds._fixed_splits = {
        k: _read_csv_gz(
            os.path.join(split_dir, f"{k}.csv.gz"), np.int64).reshape(-1)
        for k in ("train", "valid", "test")
    }
    for ex in meta["extras"]:
        p = os.path.join(raw, f"{ex}.csv.gz")
        setattr(ds, ex,
                _read_csv_gz(p, np.int64).reshape(-1)
                if os.path.exists(p) else None)

    try:
        np.savez_compressed(
            cache,
            edge_index=ds.graph["edge_index"],
            node_feat=ds.graph["node_feat"],
            edge_feat=(ds.graph["edge_feat"]
                       if ds.graph["edge_feat"] is not None
                       else np.zeros(0, np.float32)),
            num_nodes=num_nodes, label=ds.label,
            **{f"split_{k}": v for k, v in ds._fixed_splits.items()},
            **{ex: getattr(ds, ex) for ex in meta["extras"]
               if getattr(ds, ex) is not None},
        )
    except OSError:
        pass  # read-only data dir: skip the cache
    return ds


def load_ogb(data_dir, name) -> NodeDataset:
    """ogbn-* loader: raw csv.gz layout first, ogb package as fallback."""
    root = os.path.join(data_dir, name.replace("-", "_"))
    if name in _OGB_META and (
        os.path.exists(os.path.join(root, "raw"))
        or os.path.exists(os.path.join(root, "processed_difformer_tpu.npz"))
    ):
        return load_ogb_raw(data_dir, name)
    try:
        from ogb.nodeproppred import NodePropPredDataset
    except ImportError as e:
        raise FileNotFoundError(
            f"{name}: no raw OGB layout under {root} and no ogb package. "
            f"Unpack the dataset zip (raw/ + split/) there — this "
            f"environment has no network access."
        ) from e
    d = NodePropPredDataset(name=name, root=data_dir)
    graph, label = d[0]
    ds = NodeDataset(name)
    ds.graph = {
        "edge_index": graph["edge_index"],
        "node_feat": graph["node_feat"],
        "edge_feat": graph.get("edge_feat"),
        "num_nodes": graph["num_nodes"],
    }
    if name == "ogbn-proteins" and ds.graph["node_feat"] is None:
        ef = ds.graph["edge_feat"]
        nf = np.zeros((ds.graph["num_nodes"], ef.shape[1]), np.float64)
        cnt = np.zeros(ds.graph["num_nodes"], np.float64)
        np.add.at(nf, ds.graph["edge_index"][0], ef)
        np.add.at(cnt, ds.graph["edge_index"][0], 1.0)
        ds.graph["node_feat"] = (nf / np.maximum(cnt[:, None], 1)).astype(
            np.float32
        )
    ds.label = label.reshape(-1) if label.shape[-1] == 1 else label
    split = d.get_idx_split()
    ds._fixed_splits = {
        "train": split["train"], "valid": split["valid"], "test": split["test"]
    }
    return ds


def load_arxiv_year(data_dir, nclass=5) -> NodeDataset:
    """arxiv-year: ogbn-arxiv graph, label = ``even_quantile_labels`` over
    node_year, random splits (reference dataset.py:326-340)."""
    ds = load_ogb(data_dir, "ogbn-arxiv")
    node_year = getattr(ds, "node_year", None)
    if node_year is None:
        raise FileNotFoundError(
            "arxiv-year needs raw/node_year.csv.gz from the ogbn-arxiv zip"
        )
    ds.name = "arxiv-year"
    ds.label = even_quantile_labels(
        np.asarray(node_year).reshape(-1), nclass
    ).astype(np.int64)
    ds._fixed_splits = None  # random splits, like the reference
    return ds


# --------------------------------------------------------------------------
# image/text track
# --------------------------------------------------------------------------

def load_image_text(data_dir, name) -> NodeDataset:
    """mini/20news/stl10/cifar10 (``image and text/dataset.py:70-189``):
    pretrained-embedding pickles (no graph — kNN built by the trainer)."""
    ds = NodeDataset(name)
    if name == "20news":
        from sklearn.datasets import fetch_20newsgroups
        from sklearn.feature_extraction.text import CountVectorizer, TfidfTransformer

        categories = ["alt.atheism", "comp.sys.ibm.pc.hardware",
                      "misc.forsale", "rec.autos", "rec.sport.hockey",
                      "sci.crypt", "sci.electronics", "sci.med", "sci.space",
                      "talk.politics.guns"]
        data = fetch_20newsgroups(data_home=data_dir, subset="all",
                                  categories=categories,
                                  download_if_missing=False)
        vectorizer = CountVectorizer(stop_words="english", min_df=0.05)
        X_counts = vectorizer.fit_transform(data.data)
        X = TfidfTransformer(norm="l2").fit_transform(X_counts)
        feat = np.asarray(X.todense(), np.float32)
        label = np.asarray(data.target, np.int64)
    elif name in ("stl10", "cifar10"):
        path = _need(os.path.join(data_dir, f"{name}_embeddings.pkl"), name)
        with open(path, "rb") as f:
            feat, label = pickle.load(f)
        feat = np.asarray(feat, np.float32)
        label = np.asarray(label, np.int64)
        if name == "cifar10":
            feat, label = feat[:15000], label[:15000]  # dataset.py:178-180
    elif name == "mini":
        path = _need(os.path.join(data_dir, "mini_imagenet.pkl"), name)
        with open(path, "rb") as f:
            d = pickle.load(f)
        feat = np.asarray(d["data"], np.float32)
        label = np.asarray(d["labels"], np.int64)
    else:
        raise ValueError(name)
    ds.graph = {"edge_index": None, "node_feat": feat, "edge_feat": None,
                "num_nodes": feat.shape[0]}
    ds.label = label
    return ds


# --------------------------------------------------------------------------
# dispatcher
# --------------------------------------------------------------------------

def load_dataset(data_dir: str, name: str, sub_dataset: str = "") -> NodeDataset:
    """Reference ``load_dataset`` dispatcher parity (dataset.py:86-130)."""
    name = name.lower()
    if name.startswith("synthetic"):
        from difformer_tpu_torch.data.synthetic import random_graph

        # synthetic-N-E-F-C
        parts = name.split("-")[1:]
        n, e, f, c = (int(p) for p in parts) if len(parts) == 4 else (
            2708, 10556, 1433, 7
        )
        x, ei, y = random_graph(n, e, f, c, seed=0, homophily=0.8)
        ds = NodeDataset(name)
        ds.graph = {"edge_index": ei, "node_feat": x, "edge_feat": None,
                    "num_nodes": n}
        ds.label = y
        return ds
    if name in ("cora", "citeseer", "pubmed"):
        return load_planetoid(data_dir, name)
    if name in ("amazon-photo", "amazon-computer", "coauthor-cs",
                "coauthor-physics"):
        return load_amazon_coauthor(data_dir, name)
    if name in ("roman-empire", "amazon-ratings", "minesweeper", "tolokers",
                "questions"):
        return load_heterophilous(data_dir, name)
    if name in ("chameleon", "squirrel"):
        return load_filtered_chameleon_squirrel(data_dir, name)
    if name in ("cornell", "texas", "wisconsin", "film"):
        return load_geom_gcn(data_dir, name)
    if name == "pokec":
        return load_pokec(data_dir)
    if name == "fb100":
        return load_fb100(data_dir, sub_dataset or "Penn94")
    if name == "deezer-europe":
        return load_deezer(data_dir)
    if name == "yelp-chi":
        return load_yelpchi(data_dir)
    if name == "snap-patents":
        return load_snap_patents(data_dir)
    if name == "twitch-e":
        return load_twitch(data_dir, sub_dataset or "DE")
    if name.startswith("ogbn-"):
        return load_ogb(data_dir, name)
    if name == "arxiv-year":
        return load_arxiv_year(data_dir)
    if name in ("mini", "20news", "stl10", "cifar10"):
        return load_image_text(data_dir, name)
    raise ValueError(f"unknown dataset {name!r}")
