"""Mesh extraction from density grids and PLY export (counterpart of
transhuman_tpu/mesh_ops; the reference's PyMCubes + trimesh stage,
if_mesh_renderer.py:98-113)."""
