"""ZJU-MoCap dataset (counterpart of transhuman_tpu/data/zju.py; reference
``lib/datasets/light_stage/can_smpl.py``), with numpy and the port's own
codec in place of OpenCV and imageio:

* index = (human, frame, target camera) triples from ``annots.npy`` and the
  per-human (begin, interval, count) catalog (``catalog.py``);
* per view: the JPEG decoded (``image_io.imread_rgb``), the union of the
  ``mask`` and ``mask_cihp`` PNG layers (``read_mask_png``), on the target
  a 5 px border band marked 100; then ``_process``: u8 -> [0, 1] float32,
  undistort (a cached remap plan per camera and size), the ``ratio``
  resize (area for images, nearest for masks), the epoch-seeded colour
  jitter at train, the background masked out;
* input views: a random ``train_num_views`` at train, ``test.input_view``
  at test; the processed views LRU-cached for jitter-off items;
* rasterised vertex visibility per view, all ones where the file is missing
  (or with ``rasterize False``); with ``depth_map`` and ``depth_vizmap``
  also each view's depth map (``{depth_root}/{human}/{cam dir}/{frame}.pt``,
  a torch tensor file), from which the prologue takes the visibility;
* the target frame's SMPL vertices, world -> SMPL transform and LBS blend
  rotations; at train with ``rot_ratio`` > 0 the canonical augmentation;
* rays: patches or single rays at train, the frame's box at eval.

CoreView_313/315 use the compact 21-camera layout (``CAM_IDX_313``,
``Camera (N)`` directories, the frame number the 5th ``_`` token of the
annots' image names); CoreView_396 keeps its vertices and params under
``vertices``/``params``.  The item methods are the synthetic dataset's:
``get_train_sample``, ``get_eval_item``, ``get_perform_item`` and
``get_mesh_item``; their frames and rays are CPU tensors.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..geometry.cameras import gen_path_virt, load_cam
from ..geometry.rays import world_bounds
from ..geometry.smpl import SMPLModel, rodrigues
from ..render.pipeline import FrameInputs
from ..train.loss import TrainSample
from ..utils.cache import ByteLRU
from . import catalog
from .aug import transform_can_smpl
from .image_io import imread_rgb, read_mask_png
from .imgproc import (
    dilate,
    erode,
    remap_linear,
    remap_plan,
    resize_area,
    resize_nearest,
    undistort_maps,
)
from .jitter import color_jitter
from .ray_sampling import (
    EvalItem,
    sample_eval_rays,
    sample_train_rays,
    sample_train_rays_random,
)

SPECIAL_HUMANS = ("CoreView_313", "CoreView_315")
# 313/315 annots use the compact 21-camera layout: K/R/T/ims rows align with
# this list, which maps compact index -> on-set camera number - 1 (cameras
# 20/21 of the 23 on set are absent)
CAM_IDX_313 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
               18, 21, 22]


def mark_border(msk: np.ndarray, border: int = 5) -> np.ndarray:
    """msk with 100 where a border x border box dilation and erosion differ
    by 1: the band around the subject's outline."""
    out = msk.copy()
    out[(dilate(msk, border) - erode(msk, border)) == 1] = 100
    return out


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


class ZJUDataset:
    """split: 'train' | 'test'."""

    def __init__(self, cfg: Config, split: str,
                 smpl: Optional[SMPLModel] = None,
                 human_info: Optional[dict] = None):
        if cfg.time_steps != 1:
            # the reference parses time_steps but asserts == 1 at run time
            # (if_clight_renderer.py:412)
            raise ValueError(
                f"time_steps={cfg.time_steps} is unsupported: the reference "
                "itself asserts time_steps == 1 (if_clight_renderer.py:412)")
        self.cfg = cfg
        self.split = split
        self.data_root = cfg.data_root
        self.rasterize_root = cfg.rasterize_root
        self.ratio = cfg.ratio
        if smpl is None:
            smpl = SMPLModel.load(cfg.smpl_dir)
        self.smpl = smpl
        self.epoch = 0
        # remap plans per (human, cam, size): ~40 MB each at 1024x1024
        self._ud_cache = ByteLRU(int(1.5 * 1024**3))
        # processed input views (jitter-off items only): eval items come in
        # runs of len(test.target_view) that share their input views
        self._iv_cache = ByteLRU(128 * 1024 * 1024)
        self._render_w2c: Dict[str, list] = {}

        if human_info is None:
            human_info = catalog.get_human_info(split, cfg.test.mode)
        self.human_list = list(human_info)
        missing = [h for h in self.human_list if not os.path.exists(
            os.path.join(self.data_root, h, "annots.npy"))]
        if missing:
            if len(missing) == len(self.human_list):
                raise FileNotFoundError(
                    f"no annots.npy for any of {self.human_list} under "
                    f"{self.data_root!r}")
            print(f"WARNING: skipping humans missing from disk: {missing}")
            self.human_list = [h for h in self.human_list if h not in missing]
        self.human2idx = {h: i for i, h in enumerate(self.human_list)}

        self.cams: Dict[str, dict] = {}
        self.ims: List[str] = []
        self.cam_inds: List[int] = []
        self.start_end: Dict[str, dict] = {}
        self.human2frame_cam: Dict[str, tuple] = {}
        for human in self.human_list:
            root = os.path.join(self.data_root, human)
            annots = np.load(os.path.join(root, "annots.npy"),
                             allow_pickle=True).item()
            self.cams[human] = annots["cams"]
            num_cams = len(self.cams[human]["K"])
            if human in SPECIAL_HUMANS and num_cams != len(CAM_IDX_313):
                raise ValueError(
                    f"{human}: annots list {num_cams} cameras but the "
                    f"compact {len(CAM_IDX_313)}-camera layout is required "
                    "(see CAM_IDX_313)")
            target_view = (list(range(num_cams)) if split == "train"
                           else list(cfg.test.target_view))
            info = human_info[human]
            i0, intv, ni = info["begin_i"], info["i_intv"], info["ni"]
            frames = annots["ims"][i0:i0 + ni][::intv]
            ims = np.array([np.array(fd["ims"])[target_view]
                            for fd in frames])
            cam_inds = np.array([np.array(target_view, dtype=np.int64)
                                 for _ in frames])
            self.human2frame_cam[human] = ims.shape
            ims_flat = ims.ravel().tolist()
            if human in SPECIAL_HUMANS:
                # "Camera (N)/..._XXXX.jpg": the frame number is the 5th
                # '_'-separated token
                ims_flat = [os.path.join(root, p.split("/")[0],
                                         p.split("/")[1].split("_")[4]
                                         + ".jpg") for p in ims_flat]
            else:
                ims_flat = [os.path.join(root, p) for p in ims_flat]
            self.ims.extend(ims_flat)
            self.cam_inds.extend(cam_inds.ravel().tolist())
            first = int(os.path.basename(ims_flat[0])[:-4])
            last = int(os.path.basename(ims_flat[-1])[:-4])
            self.start_end[human] = {"start": first, "end": last,
                                     "length": last - first + 1,
                                     "intv": intv}

    def __len__(self):
        return len(self.ims)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def frame_sampler_indices(self, full_eval: Optional[bool] = None):
        fe = self.cfg.test.full_eval if full_eval is None else full_eval
        if self.cfg.test.sampler != "FrameSampler":
            # only the reference's FrameSampler decimates
            fe = True
        return catalog.frame_sampler_indices(
            [self.human2frame_cam[h] for h in self.human_list],
            full_eval=fe, interval=self.cfg.test.frame_interval)

    # -- files -----------------------------------------------------------
    @staticmethod
    def _cam_dir(human, cam_id_1based):
        if human in SPECIAL_HUMANS:
            return f"Camera ({cam_id_1based})"
        return f"Camera_B{cam_id_1based}"

    def _load_mask(self, human, cam_dir, frame_file):
        stem = frame_file[:-4] + ".png"
        msk = None
        for layer in ("mask", "mask_cihp"):
            p = os.path.join(self.data_root, human, layer, cam_dir, stem)
            if os.path.exists(p):
                m = read_mask_png(p)
                msk = m if msk is None else (msk | m)
        if msk is None:
            raise FileNotFoundError(f"no mask for {human}/{cam_dir}/{stem}")
        return msk

    def _remap_plan(self, human, cam_ind, hw):
        """The cached remap plan of a camera at a size, or None for zero
        distortion (the undistort would be the identity)."""
        key = (human, cam_ind, hw)
        hit = self._ud_cache.get(key)
        if hit is None:
            cams = self.cams[human]
            K = np.array(cams["K"][cam_ind], np.float32)
            D = np.array(cams["D"][cam_ind], np.float32)
            mx, my = undistort_maps(K, D, hw)
            hit = (None,) if mx is None else (remap_plan(mx, my, hw),)
            self._ud_cache.put(key, hit)
        return hit[0]

    def _process(self, img_u8, msk, human, cam_ind, jitter_seed=None):
        """u8 -> [0,1] -> undistort -> resize -> jitter -> mask the
        background.  Returns (img (H,W,3) f32, msk (H,W) u8, K, R, T)."""
        img = np.multiply(img_u8, np.float32(1.0 / 255.0), dtype=np.float32)
        cams = self.cams[human]
        K = np.array(cams["K"][cam_ind], np.float32).copy()
        plan = self._remap_plan(human, cam_ind, img.shape[:2])
        if plan is not None:
            img = remap_linear(img, plan)
            msk = remap_linear(msk, plan)
        R = np.array(cams["R"][cam_ind], np.float32)
        T = (np.array(cams["T"][cam_ind], np.float32) / 1000.0).reshape(3)
        H, W = int(img.shape[0] * self.ratio), int(img.shape[1] * self.ratio)
        K[:2] *= self.ratio
        img = resize_area(img, (W, H))
        msk = resize_nearest(msk, (W, H))
        if jitter_seed is not None:
            img = color_jitter(img, jitter_seed)
        if self.cfg.mask_bkgd:
            img[msk == 0] = 1.0 if self.cfg.white_bkgd else 0.0
        return img, msk, K, R, T

    def _vertices(self, human, frame: int):
        d = "vertices" if "396" in human else self.cfg.vertices
        return np.load(os.path.join(self.data_root, human, d,
                                    f"{frame}.npy")).astype(np.float32)

    def _params(self, human, frame: int):
        d = "params" if "396" in human else self.cfg.params
        return np.load(os.path.join(self.data_root, human, d, f"{frame}.npy"),
                       allow_pickle=True).item()

    def _vizmap(self, human, cam_id_1based, frame_str):
        n = self.smpl.v_template.shape[0]
        if not self.cfg.rasterize:
            # every vertex visible in every view (if_clight_renderer.py:
            # 176-181)
            return np.ones(n, np.float32)
        p = os.path.join(self.rasterize_root, human, "visibility",
                         self._cam_dir(human, cam_id_1based),
                         f"{frame_str}.npy")
        try:
            return np.load(p).astype(np.float32)
        except (FileNotFoundError, OSError):
            return np.ones(n, np.float32)

    @property
    def _depth_vis(self) -> bool:
        # depth maps feed visibility only with both keys set
        return self.cfg.depth_map and self.cfg.depth_vizmap

    def _depthmap(self, human, cam_id_1based, frame_str):
        """(H, W) float32 depth map of a view: the reference's torch tensor
        file ``{depth_root}/{human}/{cam dir}/{frame}.pt`` (can_smpl.py:
        463-475), stored (H, W), (1, H, W) or (H, W, 1)."""
        p = os.path.join(self.cfg.depth_root, human,
                         self._cam_dir(human, cam_id_1based),
                         f"{frame_str}.pt")
        d = np.asarray(torch.load(p, map_location="cpu", weights_only=True))
        if d.ndim == 3:  # (1, H, W) or (H, W, 1)
            d = d[0] if d.shape[0] == 1 else d[..., 0]
        return d.astype(np.float32)

    def _input_view(self, human, v, frame_file, frame_str, jseed):
        """One processed input view (img, K, R, T, vizmap, depth or None);
        LRU-cached by (human, view, frame) when jitter is off."""
        key = (human, v, frame_file)
        if jseed is None:
            hit = self._iv_cache.get(key)
            if hit is not None:
                return hit
        cam_id = (CAM_IDX_313[v] + 1) if human in SPECIAL_HUMANS else (v + 1)
        cam_dir = self._cam_dir(human, cam_id)
        iimg = imread_rgb(os.path.join(self.data_root, human, cam_dir,
                                       frame_file))
        imsk = self._load_mask(human, cam_dir, frame_file)
        iimg, _, iK, iR, iT = self._process(iimg, imsk, human, v, jseed)
        out = (iimg, iK, iR, iT, self._vizmap(human, cam_id, frame_str),
               self._depthmap(human, cam_id, frame_str)
               if self._depth_vis else None)
        if jseed is None:
            self._iv_cache.put(key, out)
        return out

    # -- items -------------------------------------------------------------
    def _pick_input_views(self, human, rng):
        num_cams = len(self.cams[human]["K"])
        if self.split == "train":
            return rng.permutation(num_cams)[:self.cfg.train_num_views].tolist()
        return list(self.cfg.test.input_view)

    def _frame_meta(self, index):
        path = self.ims[index]
        human = path.split("/")[-3]
        frame_file = os.path.basename(path)
        return path, human, frame_file, int(frame_file[:-4])

    def _build_frame(self, index, rng, jitter: bool, train: bool = False):
        """(FrameInputs, (tgt_img, tgt_msk, K, R, T, can_bounds), meta)."""
        path, human, frame_file, frame_index = self._frame_meta(index)
        cam_ind = self.cam_inds[index]
        zfill = len(frame_file[:-4])

        # the target view (its mask lives under the image's own camera dir)
        tgt_img = imread_rgb(path)
        tgt_cam_dir = os.path.basename(os.path.dirname(path))
        tgt_msk = mark_border(self._load_mask(human, tgt_cam_dir, frame_file))
        jseed = (index + self.epoch * self.cfg.seed) if jitter else None
        tgt_img, tgt_msk, tK, tR, tT = self._process(tgt_img, tgt_msk, human,
                                                     cam_ind, jseed)

        # the input views (time_steps 1: the painting frame is the target's)
        views = self._pick_input_views(human, rng)
        frame_str = str(frame_index).zfill(zfill)
        ivs = [self._input_view(human, v, frame_file, frame_str, jseed)
               for v in views]

        # SMPL of the target frame
        verts_world = self._vertices(human, frame_index)
        params = self._params(human, frame_index)
        Rh = rodrigues(np.asarray(params["Rh"]).reshape(1, 3))[0]
        Th = np.asarray(params["Th"], np.float32).reshape(3)
        verts_smpl = (verts_world - Th) @ Rh
        _, _, blend = self.smpl(params["poses"],
                                np.asarray(params["shapes"]).reshape(-1))

        # transform_can_smpl (can_smpl.py:244): training only; the fields are
        # set whenever rot_ratio > 0 (the identity included)
        aug = {}
        if train and self.cfg.rot_ratio > 0:
            verts_smpl, a_center, a_rot, a_trans = transform_can_smpl(
                verts_smpl, rng, self.cfg.rot_ratio)
            aug = dict(aug_center=_t(a_center), aug_rot=_t(a_rot),
                       aug_trans=_t(a_trans))

        frame = FrameInputs(
            images=_t(np.stack([iv[0] for iv in ivs])),
            vizmaps=_t(np.stack([iv[4] for iv in ivs])),
            K=_t(np.stack([iv[1] for iv in ivs])),
            R=_t(np.stack([iv[2] for iv in ivs])),
            T=_t(np.stack([iv[3] for iv in ivs])),
            verts_world=_t(verts_world),
            tar_verts_smpl=_t(np.asarray(verts_smpl, np.float32)),
            blend_rot=_t(blend[:, :3, :3]),
            Rh=_t(Rh), Th=_t(Th),
            depth_maps=(_t(np.stack([iv[5] for iv in ivs]))
                        if self._depth_vis else None),
            **aug)
        can_bounds = world_bounds(verts_world, self.cfg.big_box)
        meta = dict(human=human, human_idx=self.human2idx.get(human, 0),
                    frame_index=frame_index, cam_ind=cam_ind, path=path)
        return frame, (tgt_img, tgt_msk, tK, tR, tT, can_bounds), meta

    def get_train_sample(self, index) -> TrainSample:
        rng = np.random.default_rng(index + self.epoch * self.cfg.seed)
        frame, target, _ = self._build_frame(index, rng,
                                             jitter=self.cfg.jitter,
                                             train=True)
        tgt_img, tgt_msk, tK, tR, tT, can_bounds = target
        if not self.cfg.patch.use_patch_sampling:
            rr = sample_train_rays_random(
                tgt_img, tgt_msk, tK, tR, tT.reshape(3, 1), can_bounds, rng,
                n_rays=self.cfg.N_rand, body_ratio=self.cfg.body_sample_ratio,
                face_ratio=self.cfg.face_sample_ratio)
            return TrainSample(frame=frame, rays=rr.rays,
                               target_rgb=_t(rr.rgb))
        tr = sample_train_rays(
            tgt_img, tgt_msk, tK, tR, tT.reshape(3, 1), can_bounds, rng,
            n_patches=self.cfg.patch.N_patches,
            patch_size=self.cfg.patch.size,
            subject_ratio=self.cfg.patch.sample_subject_ratio)
        return TrainSample(frame=frame, rays=tr.rays,
                           target_patches=_t(tr.target_patches),
                           ray_pixel_idx=_t(tr.ray_pixel_idx))

    def _eval_item(self, frame, target, meta, R, T) -> EvalItem:
        tgt_img, tgt_msk, tK, _, _, can_bounds = target
        return EvalItem(
            frame=frame,
            eval_rays=sample_eval_rays(tgt_img, tK, R, T.reshape(3, 1),
                                       can_bounds),
            target_img=tgt_img, target_msk=tgt_msk, human=meta["human"],
            human_idx=meta["human_idx"], frame_index=meta["frame_index"],
            cam_ind=meta["cam_ind"])

    def get_eval_item(self, index) -> EvalItem:
        rng = np.random.default_rng(index)
        frame, target, meta = self._build_frame(index, rng, jitter=False)
        return self._eval_item(frame, target, meta, target[3], target[4])

    def get_perform_item(self, index, render_views: Optional[int] = None
                         ) -> EvalItem:
        """The free-viewpoint item (can_smpl_perform.py:44-89): the target
        camera replaced by a frame-indexed pose on a 360-degree path around
        the subject; the intrinsics stay the target camera's."""
        rng = np.random.default_rng(index)
        frame, target, meta = self._build_frame(index, rng, jitter=False)
        human = meta["human"]
        if human not in self._render_w2c:
            n_frames = self.human2frame_cam[human][0]
            _, RT = load_cam(os.path.join(self.data_root, human,
                                          "annots.npy"), self.ratio)
            self._render_w2c[human] = gen_path_virt(
                RT, render_views=render_views or n_frames)
        path = self._render_w2c[human]
        w2c = path[meta["frame_index"] % len(path)]
        return self._eval_item(frame, target, meta,
                               w2c[:3, :3].astype(np.float32),
                               w2c[:3, 3].astype(np.float32))

    def get_mesh_item(self, index):
        """(frame, the world AABB (2, 3), meta) for mesh reconstruction
        (can_smpl_mesh.py:61-97)."""
        rng = np.random.default_rng(index)
        frame, target, meta = self._build_frame(index, rng, jitter=False)
        return frame, target[5], meta
