"""Iso-surface extraction: marching tetrahedra (counterpart of
transhuman_tpu/mesh_ops/marching.py).

Replaces PyMCubes' C++ marching cubes (reference call:
`if_mesh_renderer.py:103`).  Marching *tetrahedra* splits each grid cube
into 6 tetrahedra and triangulates each independently: the case logic is
fully derivable (no 256-entry lookup tables), has no ambiguous saddle
cases, and vectorizes over the whole grid with bulk boolean indexing.
Output meshes are watertight over the same iso-level; triangle counts are
~2x MC.

Two routes, as in the JAX package: the C++ one (``native/marching_tet.cc``,
built by ``native/build.py`` on first use), the default, and the numpy one
(``use_native=False``), whose output equals the JAX package's numpy path
bit for bit.  The C++ route orders vertices otherwise (in the order it
meets their edges); its vertex set and triangle count are the numpy
route's.  A failed build raises: the numpy route is reached only by asking
for it.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import build as native

# 6-tetrahedra decomposition of the unit cube; corners indexed 0..7 as
# (x, y, z) bits: corner i = (i & 1, (i >> 1) & 1, (i >> 2) & 1)
_CUBE_TETS = np.array(
    [
        [0, 5, 1, 3],
        [0, 5, 3, 7],
        [0, 5, 7, 4],
        [0, 7, 3, 2],
        [0, 7, 2, 6],
        [0, 7, 6, 4],
    ],
    np.int64,
)

_CORNER_OFFSETS = np.array(
    [[(i & 1), ((i >> 1) & 1), ((i >> 2) & 1)] for i in range(8)], np.int64
)

# triangulation of a tetrahedron by inside-mask case (bit i = corner i inside).
# each triangle is a triple of edges, an edge is a (corner, corner) pair.
_TET_CASES = {}
for case in range(16):
    inside = [bool(case & (1 << i)) for i in range(4)]
    n_in = sum(inside)
    ins = [i for i in range(4) if inside[i]]
    outs = [i for i in range(4) if not inside[i]]
    tris = []
    if n_in == 1:
        a = ins[0]
        e = [(a, o) for o in outs]
        tris = [(e[0], e[1], e[2])]
    elif n_in == 3:
        a = outs[0]
        e = [(i, a) for i in ins]
        tris = [(e[0], e[2], e[1])]
    elif n_in == 2:
        a, b = ins
        c, d = outs
        # quad on edges a-c, a-d, b-d, b-c
        e = [(a, c), (a, d), (b, d), (b, c)]
        tris = [(e[0], e[1], e[2]), (e[0], e[2], e[3])]
    _TET_CASES[case] = tris


def _march_native(grid: np.ndarray, threshold: float):
    """The C++ route: (vertices (N,3) float32, triangles (M,3) int64)."""
    lib = native.library("marching")
    g = np.ascontiguousarray(grid, np.float32)
    vp, tp = ctypes.c_void_p(), ctypes.c_void_p()
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.mt_march(g.ctypes.data, *g.shape, ctypes.c_float(threshold),
                      ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(tp),
                      ctypes.byref(nt))
    if rc != 0:
        raise MemoryError("mt_march failed")
    # an empty iso-surface: the C side returns NULL pointers and zero counts
    try:
        verts = (np.ctypeslib.as_array(
            ctypes.cast(vp, ctypes.POINTER(ctypes.c_float)),
            (nv.value, 3)).copy() if nv.value
            else np.zeros((0, 3), np.float32))
        tris = (np.ctypeslib.as_array(
            ctypes.cast(tp, ctypes.POINTER(ctypes.c_int64)),
            (nt.value, 3)).copy() if nt.value
            else np.zeros((0, 3), np.int64))
    finally:
        lib.mt_free(vp, tp)
    return verts, tris


def marching_tetrahedra(grid: np.ndarray, threshold: float,
                        use_native: bool = True):
    """grid: (X, Y, Z) scalar field.  Returns (vertices (N,3) float32 in
    index coordinates, triangles (M,3) int64).  Vertices lie on grid edges,
    linearly interpolated to the iso-level; shared edges are merged.  The
    C++ route by default, the numpy route with use_native False."""
    if use_native:
        return _march_native(grid, threshold)
    return _marching_tetrahedra_np(grid, threshold)


def _marching_tetrahedra_np(grid: np.ndarray, threshold: float):
    grid = np.asarray(grid, np.float32)
    nx, ny, nz = grid.shape
    cx, cy, cz = nx - 1, ny - 1, nz - 1
    if min(cx, cy, cz) < 1:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    # cube base coordinates, flattened
    bx, by, bz = np.meshgrid(
        np.arange(cx), np.arange(cy), np.arange(cz), indexing="ij"
    )
    base = np.stack([bx.ravel(), by.ravel(), bz.ravel()], 1)  # (C, 3)

    # per-corner linear indices into the flat grid
    def flat_idx(coords):
        return (coords[:, 0] * ny + coords[:, 1]) * nz + coords[:, 2]

    gflat = grid.ravel()
    corner_idx = np.stack(
        [flat_idx(base + _CORNER_OFFSETS[i]) for i in range(8)], 1
    )  # (C, 8)
    corner_in = gflat[corner_idx] > threshold  # (C, 8)

    # skip cubes fully in/out early
    any_in = corner_in.any(1)
    mixed = any_in & ~corner_in.all(1)
    corner_idx = corner_idx[mixed]
    corner_in = corner_in[mixed]

    edge_key_list = []  # (K, 2) global grid-vertex index pairs per triangle corner
    for tet in _CUBE_TETS:
        vidx = corner_idx[:, tet]  # (C, 4) global vertex indices
        vin = corner_in[:, tet]  # (C, 4)
        case = (
            vin[:, 0].astype(np.int64)
            + 2 * vin[:, 1]
            + 4 * vin[:, 2]
            + 8 * vin[:, 3]
        )
        for c in range(1, 15):
            tris = _TET_CASES[c]
            if not tris:
                continue
            sel = np.nonzero(case == c)[0]
            if sel.size == 0:
                continue
            v = vidx[sel]
            for tri in tris:
                tri_edges = np.stack(
                    [np.stack([v[:, e[0]], v[:, e[1]]], 1) for e in tri], 1
                )  # (S, 3, 2)
                edge_key_list.append(tri_edges)

    if not edge_key_list:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    tri_edges = np.concatenate(edge_key_list, 0)  # (T, 3, 2)
    # canonical edge key: sorted pair
    lo = np.minimum(tri_edges[..., 0], tri_edges[..., 1])
    hi = np.maximum(tri_edges[..., 0], tri_edges[..., 1])
    keys = lo.astype(np.int64) * (nx * ny * nz) + hi
    uniq, inv = np.unique(keys.ravel(), return_inverse=True)
    triangles = inv.reshape(-1, 3)

    # interpolate unique edge vertices
    ulo = (uniq // (nx * ny * nz)).astype(np.int64)
    uhi = (uniq % (nx * ny * nz)).astype(np.int64)
    v_lo = gflat[ulo]
    v_hi = gflat[uhi]
    t = np.clip((threshold - v_lo) / np.where(v_hi == v_lo, 1.0, v_hi - v_lo), 0, 1)

    def to_coord(flat):
        x = flat // (ny * nz)
        rem = flat % (ny * nz)
        return np.stack([x, rem // nz, rem % nz], 1).astype(np.float32)

    p_lo = to_coord(ulo)
    p_hi = to_coord(uhi)
    verts = p_lo + t[:, None] * (p_hi - p_lo)

    # drop degenerate triangles (two corners merged to the same edge vertex)
    good = (
        (triangles[:, 0] != triangles[:, 1])
        & (triangles[:, 1] != triangles[:, 2])
        & (triangles[:, 0] != triangles[:, 2])
    )
    return verts.astype(np.float32), triangles[good]
