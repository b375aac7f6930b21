"""Free-viewpoint frame writing, MJPG/AVI video assembly and the mesh
rasterizer."""
