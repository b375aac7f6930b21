"""Minimal binary PLY mesh writer and reader (a copy of
transhuman_tpu/mesh_ops/ply.py, which replaces the reference's trimesh export,
lib/visualizers/if_nerf_mesh.py:25-35)."""

from __future__ import annotations

import numpy as np


def save_ply(path: str, vertices: np.ndarray, faces: np.ndarray):
    """vertices: (N, 3) float; faces: (M, 3) int."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {len(vertices)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(vertices.astype("<f4").tobytes())
        face_block = np.empty((len(faces), 13), np.uint8)
        face_block[:, 0] = 3
        face_block[:, 1:] = faces.astype("<i4").view(np.uint8).reshape(-1, 12)
        f.write(face_block.tobytes())


def load_ply(path: str):
    """Read back a PLY written by save_ply (also handles ascii from other
    tools minimally). Returns (vertices, faces)."""
    with open(path, "rb") as f:
        header = b""
        # CRLF-tolerant; readline() returning b'' (EOF) must raise, not spin
        while not header.replace(b"\r\n", b"\n").endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise ValueError(f"not a PLY file (no end_header): {path}")
            header += line
            if len(header) > 1 << 20:
                raise ValueError(f"unreasonable PLY header (>1MB): {path}")
        lines = header.decode("ascii").splitlines()
        n_v = n_f = 0
        binary = any("binary_little_endian" in l for l in lines)
        for l in lines:
            if l.startswith("element vertex"):
                n_v = int(l.split()[-1])
            elif l.startswith("element face"):
                n_f = int(l.split()[-1])
        if binary:
            verts = np.frombuffer(f.read(n_v * 12), "<f4").reshape(n_v, 3)
            raw = np.frombuffer(f.read(n_f * 13), np.uint8).reshape(n_f, 13)
            faces = raw[:, 1:].copy().view("<i4").reshape(n_f, 3)
        else:
            data = f.read().decode("ascii").split()
            verts = np.array(data[: n_v * 3], np.float32).reshape(n_v, 3)
            rest = data[n_v * 3 :]
            faces = np.array(
                [rest[i * 4 + 1 : i * 4 + 4] for i in range(n_f)], np.int64
            )
        return verts, faces
