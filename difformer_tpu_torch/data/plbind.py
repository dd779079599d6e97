"""PLBind raw preprocessing pipeline — protein-ligand binding affinity.

A numpy copy of ``difformer_tpu/data/plbind.py``: the same inputs give the
same arrays.

Reference: ``physical particle/datasets/plbind.py`` (EquiBind-derived). The
reference's *live* path (its many commented-out blocks are dead code) is:

    index file -> affinity parse/unit filter (plbind.py:236-251 unit_check)
    ligand sdf/mol2 -> coordinates (only used for chain selection)
    protein PDB -> per-chain residues with CA/N/C (get_receptor, :344-425)
    chain selection: chains within ``cutoff=10``Å of the ligand, skip waters
    residue features [amino-acid index, Shrake-Rupley SASA, CA b-factor]
    (rec_residue_featurizer, :477-493)
    pos = CA coords, centered (:216); y = affinity < bin_thres nM
    (binary_affinity, :42-44); kNN graph k=5 self-loops,
    flow='target_to_source' (:224)
    time-based splits from raw/split/timesplit_* name lists (:253-269)

This re-implementation is pure numpy — the reference's heavy deps are
replaced by first-party parsers:

  * BioPython ``PDBParser``       -> :func:`parse_pdb_residues` (fixed-column
    ATOM/HETATM records, first model, first altloc)
  * BioPython ``ShrakeRupley``    -> :func:`shrake_rupley_sasa` (same
    golden-spiral point algorithm, probe 1.4Å, 100 points, same radii table)
  * RDKit molecule reading        -> :func:`parse_sdf_coords` /
    :func:`parse_mol2_coords` (the live path only ever uses the ligand's
    *coordinates*; atom featurization is dead code)
  * pint unit registry            -> explicit molar-prefix table in
    :func:`parse_affinity`

Also provided because they are the dataset's defining geometry (even where
the reference currently comments out their call sites): :func:`kabsch`
(rigid alignment, plbind.py:496-533) and :func:`pocket_node_labels`
(distance-cutoff pocket extraction, get_pocket_nodes :319-323).

Documented deviation: when no chain passes the cutoff the reference appends
``np.argmin(min_distances)`` (an *index*) to a list of chain-id *strings*
(:399), so the membership test never matches and processing crashes on an
empty concatenation; we implement the evident intent (select the closest
non-water chain).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

# reference ``physical particle/utils/utils.py:52-54``
POSSIBLE_AMINO_ACIDS = [
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
    "HIP", "HIE", "TPO", "HID", "LEV", "MEU", "PTR", "GLV", "CYT", "SEP",
    "HIZ", "CYM", "GLM", "ASQ", "TYS", "CYX", "GLZ", "misc",
]

# Van-der-Waals radii (Å) — BioPython Bio.PDB.SASA.ATOMIC_RADII table
ATOMIC_RADII = {
    "H": 1.200, "HE": 1.400, "C": 1.700, "N": 1.550, "NA": 2.270,
    "O": 1.520, "F": 1.470, "MG": 1.730, "P": 1.800, "S": 1.800,
    "CL": 1.750, "K": 2.750, "CA": 2.310, "NI": 1.630, "CU": 1.400,
    "ZN": 1.390, "SE": 1.900, "BR": 1.850, "CD": 1.580, "I": 1.980,
    "HG": 1.550,
}
DEFAULT_RADIUS = 2.0

_MOLAR = {"fM": 1e-15, "pM": 1e-12, "nM": 1e-9, "uM": 1e-6, "mM": 1e-3,
          "M": 1.0}


def safe_index(lst: Sequence, e) -> int:
    """reference utils.py:77-81 — unknown values map to the last slot."""
    try:
        return lst.index(e)
    except ValueError:
        return len(lst) - 1


# ---------------------------------------------------------------------------
# affinity parsing (unit_check, plbind.py:236-251 + binary_affinity :42-44)
# ---------------------------------------------------------------------------

def parse_affinity(kd_ki: str) -> Optional[float]:
    """'Kd=49uM' -> molar value; None for the reference's rejects
    (IC50 entries, inequality bounds)."""
    if "IC" in kd_ki:
        return None
    if ">" in kd_ki or "<" in kd_ki:
        return None
    if "~" in kd_ki:
        val = kd_ki.split("~")[-1]
    elif "=" in kd_ki:
        val = kd_ki.split("=")[-1]
    else:
        raise ValueError(f"Affinity {kd_ki!r} is not in the correct format.")
    val = val.split("//")[0].strip()
    unit = val[-2:]
    if unit not in _MOLAR:
        if val[-1:] == "M":                      # bare molar
            return float(val[:-1])
        raise ValueError(f"unknown affinity unit in {kd_ki!r}")
    return float(val[:-2]) * _MOLAR[unit]


def binary_affinity(affinity_molar: float, thres: float = 100.0) -> float:
    """1.0 iff affinity < ``thres`` nM (plbind.py:42-44)."""
    return float(affinity_molar * 1e9 < thres)


def load_index(path: str) -> Dict[str, str]:
    """INDEX_general_PL_data.2020 -> {pdb code: Kd/Ki string}. The first 5
    whitespace-separated fields are code/resolution/year/-logK/Kd-Ki
    (plbind.py:139-141); comment lines start with '#'."""
    table = {}
    with open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) >= 5:
                table[parts[0]] = parts[4]
    return table


# ---------------------------------------------------------------------------
# ligand coordinates (read_molecule, plbind.py:281-316 — coords only)
# ---------------------------------------------------------------------------

def parse_sdf_coords(path: str) -> np.ndarray:
    """Atom coordinates from an SDF/MOL V2000 block: counts line at index 3
    ('natoms nbonds ...'), then natoms lines of 'x y z element ...'."""
    with open(path) as f:
        lines = f.read().splitlines()
    counts = lines[3]
    n_atoms = int(counts[:3])
    coords = np.empty((n_atoms, 3), np.float64)
    for i in range(n_atoms):
        ln = lines[4 + i]
        coords[i] = (float(ln[0:10]), float(ln[10:20]), float(ln[20:30]))
    return coords


def parse_mol2_coords(path: str) -> np.ndarray:
    """Atom coordinates from a TRIPOS mol2 @<TRIPOS>ATOM block."""
    coords = []
    in_atoms = False
    with open(path) as f:
        for line in f:
            if line.startswith("@<TRIPOS>"):
                in_atoms = line.strip() == "@<TRIPOS>ATOM"
                continue
            if in_atoms and line.strip():
                parts = line.split()
                coords.append([float(parts[2]), float(parts[3]),
                               float(parts[4])])
    return np.asarray(coords, np.float64)


def load_ligand_coords(lig_dir: str, name: str) -> np.ndarray:
    """Reference preference order: sdf first, mol2 fallback
    (plbind.py:153-156)."""
    sdf = os.path.join(lig_dir, f"{name}_ligand.sdf")
    mol2 = os.path.join(lig_dir, f"{name}_ligand.mol2")
    if os.path.exists(sdf):
        try:
            return parse_sdf_coords(sdf)
        except (ValueError, IndexError):
            pass
    return parse_mol2_coords(mol2)


# ---------------------------------------------------------------------------
# PDB parsing (replaces BioPython PDBParser for the fields the pipeline uses)
# ---------------------------------------------------------------------------

class Residue:
    __slots__ = ("resname", "chain", "resno", "atoms", "elements",
                 "ca", "n", "c", "ca_bfactor")

    def __init__(self, resname, chain, resno):
        self.resname = resname
        self.chain = chain
        self.resno = resno
        self.atoms: List[List[float]] = []
        self.elements: List[str] = []
        self.ca = None
        self.n = None
        self.c = None
        self.ca_bfactor = 0.0

    @property
    def is_amino(self):
        return self.ca is not None and self.n is not None and self.c is not None


def parse_pdb_residues(path: str) -> List[Residue]:
    """Fixed-column ATOM/HETATM parse: first model only (ENDMDL stops),
    first altloc conformer only (' ' or 'A'), grouped into residues in file
    order. Matches what the reference's get_receptor reads from BioPython:
    per-residue atom coords, CA/N/C positions, resname, chain id, residue
    number, CA b-factor."""
    residues: List[Residue] = []
    current_key = None
    with open(path) as f:
        for line in f:
            rec = line[:6]
            if rec == "ENDMDL":
                break
            if rec not in ("ATOM  ", "HETATM"):
                continue
            altloc = line[16]
            if altloc not in (" ", "A"):
                continue
            name = line[12:16].strip()
            resname = line[17:20].strip()
            chain = line[21]
            resno = int(line[22:26])
            icode = line[26]
            key = (chain, resno, icode, resname)
            if key != current_key:
                residues.append(Residue(resname, chain, resno))
                current_key = key
            r = residues[-1]
            xyz = [float(line[30:38]), float(line[38:46]), float(line[46:54])]
            element = line[76:78].strip().upper() or name[:1].upper()
            r.atoms.append(xyz)
            r.elements.append(element)
            if name == "CA":
                r.ca = xyz
                try:
                    r.ca_bfactor = float(line[60:66])
                except ValueError:
                    r.ca_bfactor = 0.0
            elif name == "N":
                r.n = xyz
            elif name == "C":
                r.c = xyz
    return residues


# ---------------------------------------------------------------------------
# Shrake-Rupley SASA (replaces Bio.PDB.SASA; probe 1.4Å, 100 points —
# reference utils.py:24-25)
# ---------------------------------------------------------------------------

def _golden_spiral(n: int) -> np.ndarray:
    """Unit-sphere test points, same golden-section spiral BioPython uses."""
    dl = np.pi * (3.0 - np.sqrt(5.0))
    dz = 2.0 / n
    k = np.arange(n)
    z = (1.0 - dz / 2.0) - k * dz
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    lon = k * dl
    return np.stack([np.cos(lon) * r, np.sin(lon) * r, z], axis=1)


def shrake_rupley_sasa(coords: np.ndarray, elements: Sequence[str], *,
                       probe_radius: float = 1.4, n_points: int = 100
                       ) -> np.ndarray:
    """Per-atom solvent-accessible surface area (Å²). For each atom, count
    golden-spiral points on its probe-expanded sphere not buried inside any
    neighbor's probe-expanded sphere."""
    from scipy.spatial import cKDTree

    coords = np.asarray(coords, np.float64)
    radii = np.array([ATOMIC_RADII.get(e, DEFAULT_RADIUS) for e in elements],
                     np.float64) + probe_radius
    n = coords.shape[0]
    sphere = _golden_spiral(n_points)
    tree = cKDTree(coords)
    max_r = radii.max()
    out = np.zeros(n, np.float64)
    for i in range(n):
        pts = coords[i] + radii[i] * sphere          # [P, 3]
        nbrs = tree.query_ball_point(coords[i], radii[i] + max_r)
        nbrs = [j for j in nbrs if j != i]
        exposed = np.ones(n_points, bool)
        if nbrs:
            d2 = ((pts[:, None, :] - coords[nbrs][None, :, :]) ** 2).sum(-1)
            exposed = ~(d2 < (radii[nbrs] ** 2)[None, :]).any(axis=1)
        out[i] = exposed.mean() * 4.0 * np.pi * radii[i] ** 2
    return out


# ---------------------------------------------------------------------------
# chain selection + residue features (get_receptor / rec_residue_featurizer)
# ---------------------------------------------------------------------------

def select_receptor_residues(residues: List[Residue],
                             lig_coords: np.ndarray, *,
                             cutoff: float = 10.0) -> List[Residue]:
    """The reference's chain logic (plbind.py:344-425): per chain keep only
    complete amino residues (CA+N+C); a chain is selected when its minimum
    atom distance to any ligand atom is < cutoff and it contains no water
    residue; if nothing qualifies, take the closest non-water chain
    (documented deviation — see module docstring)."""
    chains: Dict[str, List[Residue]] = {}
    has_water: Dict[str, bool] = {}
    order: List[str] = []
    for r in residues:
        if r.chain not in chains:
            chains[r.chain] = []
            has_water[r.chain] = False
            order.append(r.chain)
        if r.resname == "HOH":
            has_water[r.chain] = True
        if r.is_amino:
            chains[r.chain].append(r)

    min_dist = {}
    for cid in order:
        rs = chains[cid]
        if not rs:
            min_dist[cid] = np.inf
            continue
        atoms = np.concatenate([np.asarray(r.atoms) for r in rs])
        d = np.sqrt(
            ((lig_coords[:, None, :] - atoms[None, :, :]) ** 2).sum(-1)
        )
        min_dist[cid] = float(d.min())

    valid = [cid for cid in order
             if min_dist[cid] < cutoff and not has_water[cid]]
    if not valid:
        candidates = [cid for cid in order
                      if not has_water[cid] and chains[cid]] or order
        valid = [min(candidates, key=lambda c: min_dist[c])]

    out: List[Residue] = []
    for cid in order:
        if cid in valid:
            out.extend(chains[cid])
    if len(out) <= 1:
        raise ValueError("rec contains only 1 residue!")   # plbind.py:434
    return out


def receptor_features(residues: List[Residue]) -> np.ndarray:
    """[aa index, residue SASA, CA b-factor] per residue
    (rec_residue_featurizer, plbind.py:477-493). SASA is computed over the
    selected residues' atoms (the reference computes it on the structure
    after detaching invalid chains/residues)."""
    coords = np.concatenate([np.asarray(r.atoms) for r in residues])
    elements = [e for r in residues for e in r.elements]
    atom_sasa = shrake_rupley_sasa(coords, elements)
    feats = np.zeros((len(residues), 3), np.float32)
    off = 0
    for i, r in enumerate(residues):
        k = len(r.atoms)
        feats[i] = (safe_index(POSSIBLE_AMINO_ACIDS, r.resname),
                    atom_sasa[off:off + k].sum(), r.ca_bfactor)
        off += k
    return feats


# ---------------------------------------------------------------------------
# geometry utilities
# ---------------------------------------------------------------------------

def kabsch(A: np.ndarray, B: np.ndarray):
    """Rigid transform (R, t) minimizing ||R @ A + t - B||, 3xN convention
    with reflection correction — reference rigid_transform_Kabsch_3D
    (plbind.py:496-533)."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    if A.shape[0] != 3 or B.shape[0] != 3:
        raise ValueError(f"expected 3xN matrices, got {A.shape}, {B.shape}")
    ca = A.mean(axis=1, keepdims=True)
    cb = B.mean(axis=1, keepdims=True)
    H = (A - ca) @ (B - cb).T
    U, _, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:                  # reflection case
        R = (Vt.T @ np.diag([1.0, 1.0, -1.0])) @ U.T
    assert abs(np.linalg.det(R) - 1.0) < 1e-5
    t = -R @ ca + cb
    return R, t


def pocket_node_labels(lig_pos: np.ndarray, rec_pos: np.ndarray, *,
                       cutoff: float) -> np.ndarray:
    """Pocket extraction by distance cutoff (get_pocket_nodes,
    plbind.py:319-323): residue i is a pocket node iff its minimum distance
    to any ligand atom is < cutoff."""
    d = np.sqrt(((np.asarray(lig_pos)[:, None, :]
                  - np.asarray(rec_pos)[None, :, :]) ** 2).sum(-1))
    return (d.min(axis=0) < cutoff).astype(np.float32)


# ---------------------------------------------------------------------------
# end-to-end raw build
# ---------------------------------------------------------------------------

def load_time_splits(split_dir: str, complex_names: Sequence[str]):
    """raw/split/timesplit_* name lists -> index split dict
    (get_idx_split, plbind.py:253-269; 'unused' bucket included)."""
    def read(fname):
        with open(os.path.join(split_dir, fname)) as f:
            return set(f.read().splitlines())

    train = read("timesplit_no_lig_overlap_train")
    valid = read("timesplit_no_lig_overlap_val")
    test = read("timesplit_test")
    split = {"train": [], "valid": [], "test": [], "unused": []}
    for i, name in enumerate(complex_names):
        if name in train:
            split["train"].append(i)
        elif name in valid:
            split["valid"].append(i)
        elif name in test:
            split["test"].append(i)
        else:
            split["unused"].append(i)
    return {k: np.asarray(v, np.int64) for k, v in split.items()}


# complexes the reference hard-excludes (empty / unpicklable; plbind.py:275-279)
EXCLUDED_COMPLEXES = ("1a50", "3m1s", "3q4c")


def build_plbind_raw(root: str, data_config: dict, *, verbose=False):
    """Process the reference raw layout (root/raw/{index,pdb,split}) into a
    GraphListDataset — no BioPython, no RDKit, no pint, no PyG."""
    from difformer_tpu_torch.data.particle import GraphListDataset
    from difformer_tpu_torch.data.transforms import knn_graph

    pocket_cutoff = float(data_config.get("pocket_cutoff", 8))
    bin_thres = float(data_config.get("bin_thres", 100))
    chain_cutoff = 10.0                                     # plbind.py:173

    raw = os.path.join(root, "raw")
    index = load_index(os.path.join(raw, "index",
                                    "INDEX_general_PL_data.2020"))
    pdb_dir = os.path.join(raw, "pdb")
    names = sorted(
        d for d in os.listdir(pdb_dir)
        if d not in EXCLUDED_COMPLEXES
        and os.listdir(os.path.join(pdb_dir, d))
    )

    ds = GraphListDataset("plbind")
    kept = []
    for name in names:
        if name not in index:
            continue
        aff = parse_affinity(index[name])
        if aff is None:                       # IC50 / bound entries dropped
            continue
        lig_dir = os.path.join(pdb_dir, name)
        lig_coords = load_ligand_coords(lig_dir, name)
        residues = parse_pdb_residues(
            os.path.join(lig_dir, f"{name}_protein_processed.pdb"))
        residues = select_receptor_residues(residues, lig_coords,
                                            cutoff=chain_cutoff)
        x = receptor_features(residues)
        true_pos = np.asarray([r.ca for r in residues], np.float32)
        pos = true_pos - true_pos.mean(axis=0, keepdims=True)  # :216
        y = binary_affinity(aff, thres=bin_thres)

        # PyG flow='target_to_source' (:224): edges run node -> neighbor
        ei = knn_graph(pos, k=min(5, len(residues)), include_self=True)[::-1]
        ds.graphs.append((x, np.ascontiguousarray(ei), y))
        ds.extras.append({
            "pos": pos,
            "true_pos": true_pos,
            "affinity": np.float32(aff),
            "node_label": pocket_node_labels(lig_coords, true_pos,
                                             cutoff=pocket_cutoff),
        })
        kept.append(name)
        if verbose:
            print(f"plbind: {name} n_res={len(residues)} y={y}")

    ds.idx_split = load_time_splits(os.path.join(raw, "split"), kept)
    return ds
