"""Frame sequence -> video (counterpart of transhuman_tpu/viz/video.py;
parity: the reference's gen_freeview_video.py).

The JAX package tries imageio's mp4 writer and falls back to an MJPG/AVI
file beside the asked-for path.  The card's machine has no imageio, so the
port writes that AVI always (``viz/avi.py``, the port's own JPEG encoder),
reading the frames with its own PNG reader (``data/image_io.py``):

    python -m transhuman_tpu_torch.viz.video FRAME_DIR OUT [--fps 30]
"""

from __future__ import annotations

import os
import re
import sys
from typing import List

import numpy as np

from ..data.image_io import read_png
from .avi import MJPGWriter


def _numeric_key(name: str):
    """Natural sort key: 'frame10000.png' must come AFTER 'frame9999.png'
    even when the zero padding widens past %04d (lexical sort would splice
    frames 10000+ before 9999 in very long sequences)."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


def _rgb(img: np.ndarray) -> np.ndarray:
    # (H, W, 3): a grey PNG replicated, an alpha channel dropped
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3]


def frames_to_video(frame_dir: str, out_path: str, fps: int = 30) -> str:
    """Encode the PNG frames of ``frame_dir``, in natural order, as MJPG in
    ``splitext(out_path)[0] + ".avi"`` (the file the JAX package returns
    where no mp4 writer works) and return that path, saying so in one line
    on stderr where another container was asked for."""
    frames: List[str] = sorted(
        (f for f in os.listdir(frame_dir) if f.endswith(".png")),
        key=_numeric_key)
    if not frames:
        raise ValueError(f"no frames in {frame_dir}")
    avi_path = os.path.splitext(out_path)[0] + ".avi"
    if avi_path != out_path:
        print(f"no mp4 writer in the port: writing MJPG/AVI ({avi_path})",
              file=sys.stderr)
    paths = [os.path.join(frame_dir, f) for f in frames]
    first = _rgb(read_png(paths[0]))
    with MJPGWriter(avi_path, first.shape[1], first.shape[0], fps) as w:
        w.append(first)  # frame 0 already decoded for the dims
        for p in paths[1:]:
            w.append(_rgb(read_png(p)))
    return avi_path


def main(argv=None):
    """Standalone frames -> video tool (parity: gen_freeview_video.py)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m transhuman_tpu_torch.viz.video",
        description=frames_to_video.__doc__)
    p.add_argument("frame_dir")
    p.add_argument("out_path")
    p.add_argument("--fps", type=int, default=30)
    a = p.parse_args(argv)
    print(f"wrote {frames_to_video(a.frame_dir, a.out_path, fps=a.fps)}")


if __name__ == "__main__":
    main()
