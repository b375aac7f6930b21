"""Offline dynamic-mesh video (a copy of transhuman_tpu/tools/
render_mesh_video.py; parity: render_mesh_dynamic.py +
gen_freeview_video.py): rasterize exported .ply meshes with normal-map
shading along the 360-degree spherical path, one PNG per mesh, and assemble
them as an MJPG/AVI (``viz/video.py``; the port has no mp4 writer).

Usage:
    python -m transhuman_tpu_torch.tools.render_mesh_video \
        --mesh_dir out/mesh --annots data/zju_mocap/CoreView_387/annots.npy \
        --ratio 0.5 --hw 512 512 out_dir
"""

from __future__ import annotations


def main(argv=None):
    """Returns the video's path."""
    import argparse
    import glob
    import os

    import numpy as np

    from ..geometry.cameras import gen_path_virt, load_cam
    from ..viz.mesh_render import render_mesh_sequence
    from ..viz.video import frames_to_video

    p = argparse.ArgumentParser(
        prog="python -m transhuman_tpu_torch.tools.render_mesh_video")
    p.add_argument("--mesh_dir", required=True)
    p.add_argument("--annots", required=True)
    p.add_argument("--ratio", type=float, default=0.5)
    p.add_argument("--hw", type=int, nargs=2, default=[512, 512])
    p.add_argument("--render_views", type=int, default=100)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("out_dir")
    args = p.parse_args(argv)

    plys = sorted(glob.glob(os.path.join(args.mesh_dir, "*.ply")))
    if not plys:
        raise SystemExit(f"no .ply files in {args.mesh_dir}")
    K_list, RT = load_cam(args.annots, args.ratio)
    w2c = gen_path_virt(RT, render_views=args.render_views)
    frames = render_mesh_sequence(plys, np.asarray(K_list[0], np.float32),
                                  w2c, tuple(args.hw), args.out_dir)
    print(f"rendered {len(frames)} frames")
    out = frames_to_video(args.out_dir,
                          os.path.join(args.out_dir, "mesh.mp4"),
                          fps=args.fps)
    print("video:", out)
    return out


if __name__ == "__main__":
    main()
