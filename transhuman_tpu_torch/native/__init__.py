"""The port's host C++ code: the image codec (``imgcodec.cc``), built on
first use by ``build.py``."""
