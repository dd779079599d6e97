"""Minimal SMILES parsing + numpy 3-D conformer embedding.

A numpy copy of ``difformer_tpu/data/smiles.py``: the same inputs give the
same arrays.

The reference's SynMol pipeline needs one thing from RDKit: 3-D atom
coordinates for a kNN(5) graph (``physical particle/datasets/
synmol.py:96-117`` — ETKDG embed + MMFF optimize, positions then scaled
×5). This module provides a dependency-free fallback with the same I/O:
SMILES string in, ``[n_heavy, 3]`` float32 coordinates out.

Scope is deliberately the organic subset that covers the SynMol (logic8)
molecules: elements B/C/N/O/P/S/F/Cl/Br/I (+ bracket atoms incl. charges
and explicit H counts, which are parsed and discarded — the reference
removes Hs before taking positions), aromatic lowercase forms, branches,
ring closures (digits and %nn), and bond orders ``- = # : /\\``. It is a
geometry generator, not a chemistry toolkit: stereo descriptors are
accepted and ignored.

Embedding: classical multidimensional scaling on graph shortest-path
distances scaled by per-bond equilibrium lengths (covalent-radius sums
with order-dependent contraction), then damped gradient descent on a
spring model — bond-length springs, 1-3 angle spacers, and a soft
nonbonded repulsion floor. The output is *plausible* geometry (bond
lengths within a few percent, no atom overlaps), which is what the kNN
graph construction consumes; it is NOT an MMFF minimum. The RDKit path
remains the parity-grade primary when available
(``data/particle._synmol_positions``).
"""

from __future__ import annotations

import re

import numpy as np

# single-bond covalent radii, Å (Pyykkö & Atsumi 2009, rounded)
COVALENT_RADII = {
    "H": 0.32, "B": 0.85, "C": 0.75, "N": 0.71, "O": 0.63, "F": 0.64,
    "P": 1.11, "S": 1.03, "Cl": 0.99, "Br": 1.14, "I": 1.33,
    "Na": 1.55, "Ca": 1.71, "*": 0.75,
}
# bond-order length contraction relative to the single-bond radius sum
ORDER_SCALE = {1.0: 1.0, 1.5: 0.93, 2.0: 0.87, 3.0: 0.81}

_ORGANIC = ("Cl", "Br", "B", "C", "N", "O", "P", "S", "F", "I", "*",
            "b", "c", "n", "o", "p", "s")
_BRACKET = re.compile(
    r"\[(?P<iso>\d+)?(?P<sym>[A-Z][a-z]?|[a-z]|\*)(?P<chiral>@{1,2})?"
    r"(?P<hcount>H\d*)?(?P<charge>[+-]\d*|\++|-+)?(?::(?P<map>\d+))?\]")
_BOND_ORDER = {"-": 1.0, "=": 2.0, "#": 3.0, ":": 1.5, "/": 1.0, "\\": 1.0}


class SmilesError(ValueError):
    pass


def parse_smiles(s):
    """Parse a SMILES string → ``(symbols, aromatic_flags, bonds)`` where
    ``bonds`` is a list of ``(i, j, order)`` over heavy-atom indices
    (explicit-H bracket atoms are parsed but dropped, reference parity:
    ``Chem.RemoveHs`` before positions)."""
    symbols, aromatic = [], []
    bonds = []
    stack = []            # open branch anchors
    prev = None           # index of the atom the next bond attaches to
    pending = None        # explicit bond order for the next bond
    rings = {}            # ring-closure digit -> (atom, order)
    i, L = 0, len(s)

    def add_atom(sym, is_arom):
        symbols.append(sym)
        aromatic.append(is_arom)
        return len(symbols) - 1

    def add_bond(a, b, order, arom_pair):
        if order is None:
            order = 1.5 if arom_pair else 1.0
        bonds.append((a, b, order))

    while i < L:
        ch = s[i]
        if ch == "(":
            if prev is None:
                raise SmilesError(f"branch before any atom: {s}")
            stack.append(prev)
            i += 1
            continue
        if ch == ")":
            if not stack:
                raise SmilesError(f"unbalanced ')': {s}")
            prev = stack.pop()
            i += 1
            continue
        if ch in _BOND_ORDER:
            pending = _BOND_ORDER[ch]
            i += 1
            continue
        if ch == ".":
            prev = None
            pending = None
            i += 1
            continue
        if ch.isdigit() or ch == "%":
            if ch == "%":
                num = s[i + 1:i + 3]
                i += 3
            else:
                num = ch
                i += 1
            if prev is None:
                raise SmilesError(f"ring closure before any atom: {s}")
            if num in rings:
                a, o = rings.pop(num)
                order = pending if pending is not None else o
                add_bond(a, prev, order,
                         aromatic[a] and aromatic[prev])
            else:
                rings[num] = (prev, pending)
            pending = None
            continue
        if ch == "[":
            m = _BRACKET.match(s, i)
            if not m:
                raise SmilesError(f"bad bracket atom at {i}: {s}")
            sym = m.group("sym")
            is_arom = sym.islower()
            sym_n = sym.capitalize() if is_arom else sym
            i = m.end()
            if sym_n == "H":
                # explicit hydrogen atom: parse, bond, then drop — mark by
                # not materializing it (skip, keep prev unchanged)
                pending = None
                continue
            idx = add_atom(sym_n, is_arom)
        else:
            sym = None
            for cand in _ORGANIC:
                if s.startswith(cand, i):
                    sym = cand
                    break
            if sym is None:
                raise SmilesError(f"unrecognized token {ch!r} in {s}")
            i += len(sym)
            is_arom = sym.islower()
            idx = add_atom(sym.capitalize() if is_arom else sym, is_arom)
        if prev is not None:
            add_bond(prev, idx, pending, aromatic[prev] and aromatic[idx])
        prev = idx
        pending = None

    if stack:
        raise SmilesError(f"unbalanced '(': {s}")
    if rings:
        raise SmilesError(f"unclosed ring bond(s) {sorted(rings)}: {s}")
    return symbols, aromatic, bonds


def _bond_length(a, b, order):
    r = COVALENT_RADII.get(a, 0.75) + COVALENT_RADII.get(b, 0.75)
    return r * ORDER_SCALE.get(order, 1.0)


def embed_conformer(symbols, bonds, *, seed=0, iters=400):
    """Distance-geometry embedding → ``[n, 3]`` float32 coordinates.

    MDS on shortest-path distances (path-summed equilibrium bond lengths)
    seeds the geometry; damped gradient descent on bond springs + 1-3
    spacers + a nonbonded repulsion floor relaxes it.
    """
    n = len(symbols)
    rng = np.random.default_rng(seed)
    if n == 1:
        return np.zeros((1, 3), np.float32)
    lengths = {}
    adj = [[] for _ in range(n)]
    for a, b, o in bonds:
        lo = _bond_length(symbols[a], symbols[b], o)
        lengths[(a, b)] = lengths[(b, a)] = lo
        adj[a].append(b)
        adj[b].append(a)

    # all-pairs shortest path in summed bond lengths (BFS-Dijkstra on the
    # small molecular graph)
    INF = 1e9
    D = np.full((n, n), INF)
    for src in range(n):
        D[src, src] = 0.0
        frontier = [(0.0, src)]
        import heapq

        while frontier:
            d, u = heapq.heappop(frontier)
            if d > D[src, u]:
                continue
            for v in adj[u]:
                nd = d + lengths[(u, v)]
                if nd < D[src, v]:
                    D[src, v] = nd
                    heapq.heappush(frontier, (nd, v))
    if np.any(D >= INF):
        # disconnected components ('.' fragments): place them apart by
        # replacing INF with a large finite separation
        D[D >= INF] = D[D < INF].max() + 3.0

    # classical MDS to 3-D
    J = np.eye(n) - 1.0 / n
    Bm = -0.5 * J @ (D ** 2) @ J
    w, V = np.linalg.eigh(Bm)
    top = np.argsort(w)[::-1][:3]
    pos = V[:, top] * np.sqrt(np.maximum(w[top], 1e-6))[None, :]
    pos = pos + rng.normal(scale=0.05, size=pos.shape)   # break symmetry

    # 1-3 spacer targets (angle surrogate): ideal distance from the law of
    # cosines at ~109.5° (sp3-ish); aromatic/rings converge to planar-ish
    # geometry from the MDS seed + repulsion
    pairs13 = set()
    for c in range(n):
        nb = adj[c]
        for x in range(len(nb)):
            for y in range(x + 1, len(nb)):
                a, b = nb[x], nb[y]
                la, lb = lengths[(c, a)], lengths[(c, b)]
                d13 = np.sqrt(la * la + lb * lb
                              - 2 * la * lb * np.cos(np.deg2rad(109.5)))
                pairs13.add((min(a, b), max(a, b), d13))

    bond_idx = np.array([(a, b) for a, b, _ in bonds], np.int64).reshape(-1, 2)
    bond_len = np.array([lengths[(a, b)] for a, b, _ in bonds])
    p13 = (np.array([(a, b) for a, b, _ in pairs13], np.int64).reshape(-1, 2)
           if pairs13 else np.zeros((0, 2), np.int64))
    l13 = np.array([d for _, _, d in pairs13]) if pairs13 else np.zeros(0)
    bonded = {(min(a, b), max(a, b)) for a, b, _ in bonds}
    bonded |= {(a, b) for a, b, _ in pairs13}

    lr = 0.05
    for it in range(iters):
        g = np.zeros_like(pos)
        # bond springs
        if len(bond_idx):
            d = pos[bond_idx[:, 0]] - pos[bond_idx[:, 1]]
            r = np.linalg.norm(d, axis=1) + 1e-9
            f = ((r - bond_len) / r)[:, None] * d
            np.add.at(g, bond_idx[:, 0], f)
            np.add.at(g, bond_idx[:, 1], -f)
        # 1-3 spacers (weaker)
        if len(p13):
            d = pos[p13[:, 0]] - pos[p13[:, 1]]
            r = np.linalg.norm(d, axis=1) + 1e-9
            f = 0.3 * ((r - l13) / r)[:, None] * d
            np.add.at(g, p13[:, 0], f)
            np.add.at(g, p13[:, 1], -f)
        # nonbonded repulsion floor at 2.0 Å (quadratic below the floor)
        diff = pos[:, None, :] - pos[None, :, :]
        dist = np.linalg.norm(diff, axis=2) + 1e-9
        close = (dist < 2.0)
        np.fill_diagonal(close, False)
        for a, b in bonded:
            close[a, b] = close[b, a] = False
        if close.any():
            pen = np.where(close, (dist - 2.0) / dist, 0.0)
            g += 0.2 * (pen[:, :, None] * diff).sum(axis=1)
        pos = pos - lr * g
    return (pos - pos.mean(axis=0)).astype(np.float32)


def smiles_conformer(smiles, *, seed=0):
    """SMILES → heavy-atom 3-D coordinates (the `_synmol_positions`
    fallback contract). Raises :class:`SmilesError` on unparsable input."""
    symbols, _, bonds = parse_smiles(smiles)
    return embed_conformer(symbols, bonds, seed=seed)
