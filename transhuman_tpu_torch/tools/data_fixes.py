"""Small dataset-preparation fixes (counterpart of
transhuman_tpu/tools/data_fixes.py; the reference's standalone scripts
``third_parties/clean_ch.py`` -> cleansmpl and
``lib/utils/modify_313_315_filename.py`` -> rename313).  Host only.

    python -m transhuman_tpu_torch.tools.data_fixes rename313 data/zju_mocap/CoreView_313
    python -m transhuman_tpu_torch.tools.data_fixes cleanmask data/zju_mocap/CoreView_387
    python -m transhuman_tpu_torch.tools.data_fixes cleansmpl SMPL_NEUTRAL.pkl out_dir/

``--dry_run`` counts what rename313 and cleanmask would change and changes
nothing.  The masks go through the port's own PNG reader and writer
(data/image_io.py, utils/png.py), the pickle through its chumpy-free
unpickler (geometry/smpl.py): no OpenCV and no chumpy.
"""

from __future__ import annotations

import argparse
import os
import pickle
import re

import numpy as np

from ..data.image_io import read_png
from ..geometry.smpl import load_smpl_pickle
from ..utils.png import write_png


def rename_313_315(root: str, dry_run: bool = False) -> int:
    """Rename 313/315-style frame files ('..._000000_xxx.jpg', the frame
    number the 5th '_' token) to '{frame}{ext}', in every Camera* directory
    of the image root and of its mask/ and mask_cihp/ trees, the three
    roots the reference script walks.  Returns the files renamed."""
    n = 0
    roots = [root] + [
        os.path.join(root, sub)
        for sub in ("mask", "mask_cihp")
        if os.path.isdir(os.path.join(root, sub))
    ]
    for r in roots:
        for cam in sorted(os.listdir(r)):
            cdir = os.path.join(r, cam)
            if not os.path.isdir(cdir) or not cam.startswith("Camera"):
                continue
            for f in sorted(os.listdir(cdir)):
                parts = f.split("_")
                if len(parts) > 4 and re.fullmatch(r"\d+",
                                                   parts[4].split(".")[0]):
                    dst = parts[4].split(".")[0] + os.path.splitext(f)[1]
                    if not dry_run:
                        os.rename(os.path.join(cdir, f),
                                  os.path.join(cdir, dst))
                    n += 1
    return n


def clean_smpl_pickle(path: str, out_dir: str) -> str:
    """The SMPL pickle at path with its chumpy objects replaced by numpy
    arrays, written as a plain pickle under out_dir (the reference's
    clean_ch.py); returns the path written."""
    data = load_smpl_pickle(path)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, os.path.basename(path))
    with open(out, "wb") as f:
        pickle.dump(data, f)
    return out


def clean_channel_masks(root: str, dry_run: bool = False) -> int:
    """Rewrite every multi-channel PNG under root's mask/ and mask_cihp/
    trees as a single-channel 0/1 mask, 1 where any channel is non-zero
    (the loader reads channel 0 only); returns the files rewritten.  No
    reference analog: some ZJU-MoCap copies ship RGB masks."""
    n = 0
    for sub in ("mask", "mask_cihp"):
        mdir = os.path.join(root, sub)
        if not os.path.isdir(mdir):
            continue
        for dirpath, _, files in os.walk(mdir):
            for f in files:
                if not f.endswith(".png"):
                    continue
                p = os.path.join(dirpath, f)
                m = read_png(p)
                if m.ndim == 2:
                    continue
                if not dry_run:
                    write_png(p, (m != 0).any(-1).astype(np.uint8))
                n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m transhuman_tpu_torch.tools.data_fixes")
    p.add_argument("cmd", choices=["rename313", "cleanmask", "cleansmpl"])
    p.add_argument("root")
    p.add_argument("out_dir", nargs="?", default="output",
                   help="cleansmpl only: output directory")
    p.add_argument("--dry_run", action="store_true")
    args = p.parse_args(argv)
    if args.cmd == "cleansmpl":
        out = clean_smpl_pickle(args.root, args.out_dir)
        print(f"cleansmpl: wrote {out}")
        return out
    if args.cmd == "rename313":
        n = rename_313_315(args.root, args.dry_run)
    else:
        n = clean_channel_masks(args.root, args.dry_run)
    print(f"{args.cmd}: {n} files {'(dry run)' if args.dry_run else 'updated'}")
    return n


if __name__ == "__main__":
    main()
