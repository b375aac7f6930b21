"""Regenerate the canonical-SMPL k-means cluster table (the asset the
reference precomputes under kmeans_dict/; counterpart of
transhuman_tpu/tools/make_kmeans.py).  Host only: no card is needed.

    python -m transhuman_tpu_torch.tools.make_kmeans --smpl_dir data/smplx/smpl \
        [--num_clusters 300] [--seed 0] OUT_DIR

writes ``OUT_DIR/kmeans_dict_<num_clusters>.npy`` (the reference's format,
``ClusterSpec.load_reference_dict`` reads it) from Lloyd's k-means over
the SMPL template's vertices (``geometry/clusters.py::from_kmeans``).
"""

from __future__ import annotations

import argparse
import os

from ..geometry.clusters import ClusterSpec
from ..geometry.smpl import SMPLModel


def main(argv=None) -> str:
    """Returns the path written."""
    p = argparse.ArgumentParser(
        prog="python -m transhuman_tpu_torch.tools.make_kmeans")
    p.add_argument("--smpl_dir", required=True,
                   help="the directory of SMPL_NEUTRAL.pkl")
    p.add_argument("--num_clusters", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("out_dir")
    args = p.parse_args(argv)

    smpl = SMPLModel.load(args.smpl_dir)
    spec = ClusterSpec.from_kmeans(smpl.v_template, args.num_clusters,
                                   seed=args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, f"kmeans_dict_{args.num_clusters}.npy")
    spec.save_reference_dict(path)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
