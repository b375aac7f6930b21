"""SMPL body model: numpy linear blend skinning with per-vertex blend matrices.

The same math as transhuman_tpu/geometry/smpl.py (reference
``lib/utils/SMPL.py``), kept in the port so that it runs without the JAX
package installed; tests hold the two equal.  ``SMPLModel.synthetic`` builds
the seeded stand-in body used where the licensed SMPL pickle is absent.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass

import numpy as np

N_VERTS = 6890
N_JOINTS = 24
N_SHAPE = 10

_SEX_FILES = {
    "male": "basicmodel_m_lbs_10_207_0_v1.0.0.pkl",
    "female": "basicModel_f_lbs_10_207_0_v1.0.0.pkl",
    "neutral": "SMPL_NEUTRAL.pkl",
}


def rodrigues(r: np.ndarray) -> np.ndarray:
    """Axis-angle vectors (N,3) -> rotation matrices (N,3,3)."""
    r = np.asarray(r, dtype=np.float64).reshape(-1, 3)
    angle = np.linalg.norm(r + 1e-8, axis=1, keepdims=True)
    rot_dir = r / angle
    cos = np.cos(angle)[:, None]
    sin = np.sin(angle)[:, None]
    rx, ry, rz = np.split(rot_dir, 3, axis=1)
    zeros = np.zeros_like(rx)
    k = np.concatenate([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                       axis=1).reshape(-1, 3, 3)
    return (np.eye(3)[None] + sin * k + (1 - cos) * np.matmul(k, k)).astype(
        np.float32)


class _ChumpyStub:
    """Stands in for chumpy classes while unpickling a raw SMPL download;
    their data term is kept under 'x'."""

    def __init__(self, *a, **k):
        pass


def _unchumpy(v):
    if isinstance(v, _ChumpyStub):
        x = v.__dict__.get("x")
        if x is None:
            raise ValueError("chumpy object without an 'x' data term")
        return np.asarray(x)
    return v


def load_smpl_pickle(path: str) -> dict:
    """An SMPL pickle, chumpy-cleaned or raw.  A pickle can run code: load
    only the licensed SMPL files you put there yourself."""

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.split(".")[0] == "chumpy":
                return _ChumpyStub
            return super().find_class(module, name)

    with open(path, "rb") as f:
        data = _Unpickler(f, encoding="latin1").load()
    return {k: _unchumpy(v) for k, v in data.items()}


@dataclass
class SMPLModel:
    v_template: np.ndarray  # (Nv, 3)
    shapedirs: np.ndarray  # (Nv, 3, 10)
    posedirs: np.ndarray  # (Nv, 3, 207)
    J_regressor: np.ndarray  # (24, Nv) dense
    weights: np.ndarray  # (Nv, 24)
    parent: np.ndarray  # (23,) parent joint of joints 1..23
    faces: np.ndarray  # (F, 3) int32

    @classmethod
    def load(cls, model_dir: str, sex: str = "neutral") -> "SMPLModel":
        data = load_smpl_pickle(os.path.join(model_dir, _SEX_FILES[sex]))
        j_reg = data["J_regressor"]
        if hasattr(j_reg, "todense"):
            j_reg = np.array(j_reg.todense())
        kintree = data["kintree_table"].astype("int64")
        id_to_col = {kintree[1, i].item(): i for i in range(kintree.shape[1])}
        parent = np.array(
            [id_to_col[kintree[0, it]] for it in range(1, kintree.shape[1])])
        return cls(
            v_template=np.asarray(data["v_template"], dtype=np.float32),
            shapedirs=np.asarray(data["shapedirs"], dtype=np.float32),
            posedirs=np.asarray(data["posedirs"], dtype=np.float32),
            J_regressor=np.asarray(j_reg, dtype=np.float32),
            weights=np.asarray(data["weights"], dtype=np.float32),
            parent=parent,
            faces=np.asarray(data["f"], dtype=np.int32),
        )

    @classmethod
    def synthetic(cls, seed: int = 0, n_verts: int = N_VERTS) -> "SMPLModel":
        """A seeded SMPL stand-in: a 1.7 m vertical cylinder of vertices on a
        24-joint chain."""
        rng = np.random.default_rng(seed)
        theta = rng.uniform(0, 2 * np.pi, n_verts)
        h = rng.uniform(-0.85, 0.85, n_verts)
        r = 0.15 + 0.1 * rng.random(n_verts)
        v_template = np.stack(
            [r * np.cos(theta), h, r * np.sin(theta)], 1).astype(np.float32)
        parent = np.arange(0, N_JOINTS - 1)
        joints_y = np.linspace(-0.8, 0.8, N_JOINTS)
        j_reg = np.zeros((N_JOINTS, n_verts), dtype=np.float32)
        for j in range(N_JOINTS):
            idx = np.argsort(np.abs(v_template[:, 1] - joints_y[j]))[:8]
            j_reg[j, idx] = 1.0 / 8.0
        d = np.abs(v_template[:, 1:2] - joints_y[None, :])
        w = np.exp(-(d**2) / 0.02)
        weights = (w / w.sum(1, keepdims=True)).astype(np.float32)
        shapedirs = (rng.standard_normal((n_verts, 3, N_SHAPE)) * 0.01).astype(
            np.float32)
        posedirs = (rng.standard_normal((n_verts, 3, 207)) * 0.001).astype(
            np.float32)
        faces = rng.integers(0, n_verts, (13776, 3)).astype(np.int32)
        return cls(v_template, shapedirs, posedirs, j_reg, weights, parent,
                   faces)

    def __call__(self, pose: np.ndarray, beta: np.ndarray, v_template=None):
        """LBS: (verts (Nv,3), joints (24,3), T (Nv,4,4)); pose (72,) axis-
        angle or (24,3,3) rotations, beta (10,)."""
        v_template = self.v_template if v_template is None else v_template
        n_verts = v_template.shape[0]
        beta = np.asarray(beta, dtype=np.float32).reshape(-1)
        v_shaped = (self.shapedirs.reshape(-1, N_SHAPE).dot(beta[:, None])
                    .reshape(n_verts, 3) + v_template)
        J = self.J_regressor.dot(v_shaped)  # (24, 3)
        pose = np.asarray(pose)
        if pose.shape == (N_JOINTS, 3, 3):
            R = pose.astype(np.float32)
        else:
            R = rodrigues(pose.reshape(N_JOINTS, 3))
        lrotmin = (R[1:] - np.eye(3, dtype=np.float32)[None]).reshape(-1, 1)
        v_posed = v_shaped + self.posedirs.reshape(-1, 207).dot(
            lrotmin).reshape(n_verts, 3)

        j_rel = J.copy()
        j_rel[1:] = J[1:] - J[self.parent]
        g_local = np.zeros((N_JOINTS, 4, 4), dtype=np.float32)
        g_local[:, :3, :3] = R
        g_local[:, :3, 3] = j_rel
        g_local[:, 3, 3] = 1.0
        G = [g_local[0]]
        for i in range(1, N_JOINTS):
            G.append(G[self.parent[i - 1]].dot(g_local[i]))
        G = np.stack(G, axis=0)
        joints = G[:, :3, 3].copy()
        g_adj = G.copy()
        g_adj[:, :3, 3] -= np.einsum("jab,jb->ja", G[:, :3, :3], J)

        T = self.weights.dot(g_adj.reshape(N_JOINTS, -1)).reshape(n_verts, 4, 4)
        v_h = np.concatenate([v_posed, np.ones((n_verts, 1), np.float32)], 1)
        v = np.einsum("vab,vb->va", T, v_h)[:, :3]
        return v.astype(np.float32), joints.astype(np.float32), T.astype(
            np.float32)
