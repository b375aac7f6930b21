"""K-means vertex -> cluster grouping for TransHE token pooling (host numpy).

The same algorithm and table format as transhuman_tpu/geometry/clusters.py,
kept in the port so that the port runs without the JAX package installed
(tests hold the two equal).  Pooling is one (C, V) row-normalised one-hot
matrix product, exactly the per-cluster mean.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

# from_kmeans' assignments by (template digest, shape, clusters, seed,
# iters): an entry point without a k-means dict runs the same k-means at
# every start, ~1.5 s on the card machine's host, and a process that
# starts several (chip_smoke.py runs some 60) pays it once
_KMEANS = {}


@dataclass
class ClusterSpec:
    vert2cluster: np.ndarray  # (V,) int32 cluster id of each vertex
    num_clusters: int

    def __post_init__(self):
        self.vert2cluster = np.asarray(self.vert2cluster, dtype=np.int32)
        counts = np.bincount(self.vert2cluster, minlength=self.num_clusters)
        if (counts == 0).any():
            raise ValueError("every cluster must own at least one vertex")
        n_verts = self.vert2cluster.shape[0]
        pool = np.zeros((self.num_clusters, n_verts), dtype=np.float32)
        pool[self.vert2cluster, np.arange(n_verts)] = (
            1.0 / counts[self.vert2cluster])
        self.pool_matrix = pool  # (C, V): rows are mean-pooling weights

    @classmethod
    def load_reference_dict(cls, path: str) -> "ClusterSpec":
        """A reference kmeans_dict npy ({'pc2voxel_ind': (V,),
        'dict_voxel2pc_ind': {cid: [vidx]}}); a pickled dict, so load only
        files you trust."""
        d = np.load(path, allow_pickle=True).item()
        num = len(d["dict_voxel2pc_ind"])
        if sorted(d["dict_voxel2pc_ind"]) != list(range(num)):
            raise ValueError(f"{path}: cluster ids are not 0..{num - 1}")
        return cls(np.asarray(d["pc2voxel_ind"], dtype=np.int32), num)

    @classmethod
    def from_kmeans(cls, verts: np.ndarray, num_clusters: int, seed: int = 0,
                    iters: int = 50) -> "ClusterSpec":
        """Lloyd's k-means over the canonical vertices, no cluster empty;
        computed once per process for the same inputs."""
        verts = np.asarray(verts)
        key = (hashlib.sha256(np.ascontiguousarray(verts).tobytes())
               .hexdigest(), verts.shape, verts.dtype.str, num_clusters,
               seed, iters)
        if key not in _KMEANS:
            _KMEANS[key] = cls._kmeans(verts, num_clusters, seed, iters)
        return cls(_KMEANS[key].copy(), num_clusters)

    @staticmethod
    def _kmeans(verts: np.ndarray, num_clusters: int, seed: int,
                iters: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        n = verts.shape[0]
        centers = verts[rng.choice(n, num_clusters, replace=False)].copy()
        assign = np.zeros(n, dtype=np.int64)
        for _ in range(iters):
            d2 = ((verts[:, None, :] - centers[None]) ** 2).sum(-1)
            new_assign = d2.argmin(1)
            if (new_assign == assign).all():
                break
            assign = new_assign
            for c in range(num_clusters):
                m = assign == c
                if m.any():
                    centers[c] = verts[m].mean(0)
                else:  # re-seed an empty cluster at the farthest point
                    centers[c] = verts[d2.min(1).argmax()]
        # fill any cluster left empty from the nearest vertex whose own
        # cluster keeps at least one member
        counts = np.bincount(assign, minlength=num_clusters)
        for c in range(num_clusters):
            if counts[c] == 0:
                for v in np.argsort(((verts - centers[c]) ** 2).sum(-1)):
                    if counts[assign[v]] > 1:
                        counts[assign[v]] -= 1
                        assign[v] = c
                        counts[c] += 1
                        break
        return assign.astype(np.int32)

    def save_reference_dict(self, path: str):
        """Write the table in the reference's kmeans_dict npy format (what
        load_reference_dict reads)."""
        v2pc = {
            int(c): np.where(self.vert2cluster == c)[0].tolist()
            for c in range(self.num_clusters)
        }
        np.save(path, {"pc2voxel_ind": self.vert2cluster.astype(np.int64),
                       "dict_voxel2pc_ind": v2pc})


def normalize_positions(x: np.ndarray, box: float = 1.5) -> np.ndarray:
    """Coordinates in the fixed [-box, box]^3 box mapped to [-1, 1]."""
    lo, hi = -box, box
    return (((x - lo) / (hi - lo)) - 0.5) * 2.0
