"""The port's host C++ code, each library built with g++ on first use by
``build.py``: the image codec (``imgcodec.cc``), marching tetrahedra
(``marching_tet.cc``), CRC32C (``crc32c.cc``) and the mesh rasterizer
(``rasterize.cc``)."""
