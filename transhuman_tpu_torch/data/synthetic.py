"""Synthetic in-memory data: the seeded body of ``testing`` seen by
``train_num_views + 1`` circular cameras, the last of them the target
(counterpart of transhuman_tpu/data/synthetic.py; train samples in patch
mode only).

An eval item renders every pixel of the target view whose ray meets the
body's box (inflated 0.05 m), with the target image as ground truth; the
frames are identical, and ``frame_sampler_indices`` decimates them as the
reference's FrameSampler does.  A mesh item is the frame and that box.
Each train sample draws ``patch.N_patches`` patches of ``patch.size`` pixels
around the body's projected centroid in the target view, from a numpy RNG
seeded by the index and the epoch, and casts a ray through every patch
pixel.  Rays that miss the body's bounding box are invalid: mask False,
pixel index -1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..geometry.rays import get_near_far, get_rays
from ..render.pipeline import FrameInputs, RayBundle
from ..testing import synthetic_scene
from ..train.loss import TrainSample
from .ray_sampling import EvalItem, sample_eval_rays


class SyntheticDataset:
    def __init__(self, cfg: Config, split: str = "train", n_frames: int = 8,
                 image_hw: tuple = (128, 128), n_verts: int = 6890):
        if split == "train" and not cfg.patch.use_patch_sampling:
            raise NotImplementedError(
                "the synthetic scene has no masks and samples patches only; "
                "the non-patch sampler runs on dataset zju")
        self.cfg = cfg
        self.split = split
        self.n_frames = n_frames
        self.hw = image_hw
        self.frame_all, self.smpl, self.cluster = synthetic_scene(
            n_views=cfg.train_num_views + 1, image_hw=image_hw,
            n_verts=n_verts, n_clusters=cfg.num_class)
        self.epoch = 0

    def __len__(self):
        return self.n_frames

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def frame_sampler_indices(self, full_eval=None):
        """The reference FrameSampler's decimation: every
        cfg.test.frame_interval-th frame, or all of them with full_eval (or
        another cfg.test.sampler)."""
        fe = self.cfg.test.full_eval if full_eval is None else full_eval
        if self.cfg.test.sampler != "FrameSampler":
            fe = True
        step = 1 if fe else max(1, self.cfg.test.frame_interval)
        return np.arange(0, self.n_frames, step)

    def _frame_and_target(self):
        f, v = self.frame_all, self.cfg.train_num_views
        frame = FrameInputs(
            images=f.images[:v], vizmaps=f.vizmaps[:v], K=f.K[:v],
            R=f.R[:v], T=f.T[:v], verts_world=f.verts_world,
            tar_verts_smpl=f.tar_verts_smpl, blend_rot=f.blend_rot,
            Rh=f.Rh, Th=f.Th)
        tgt = tuple(x[v].numpy() for x in (f.images, f.K, f.R, f.T))
        verts = f.verts_world.numpy()
        bounds = np.stack([verts.min(0) - 0.05, verts.max(0) + 0.05])
        return frame, tgt, bounds

    def get_train_sample(self, index) -> TrainSample:
        rng = np.random.default_rng(index + self.epoch * self.cfg.seed)
        frame, (timg, tK, tR, tT), bounds = self._frame_and_target()
        ps, npatch = self.cfg.patch.size, self.cfg.patch.N_patches
        h, w = self.hw
        ray_o, ray_d = get_rays(h, w, tK, tR, tT.reshape(3, 1))
        # patches near the subject's projected centroid
        c3 = frame.verts_world.numpy().mean(0)
        cam = tR @ c3 + tT.reshape(3)
        cx, cy = (tK @ cam)[:2] / cam[2]
        rays_o, rays_d, pix = [], [], []
        target = np.zeros((npatch, ps, ps, 3), np.float32)
        for p in range(npatch):
            jy, jx = rng.integers(-ps, ps + 1, 2)
            y0 = int(np.clip(cy - ps // 2 + jy, 0, h - ps))
            x0 = int(np.clip(cx - ps // 2 + jx, 0, w - ps))
            target[p] = timg[y0:y0 + ps, x0:x0 + ps]
            yy, xx = np.meshgrid(range(y0, y0 + ps), range(x0, x0 + ps),
                                 indexing="ij")
            rays_o.append(ray_o[yy, xx].reshape(-1, 3))
            rays_d.append(ray_d[yy, xx].reshape(-1, 3))
            pix.append(p * ps * ps + np.arange(ps * ps, dtype=np.int32))
        ro, rd = np.concatenate(rays_o), np.concatenate(rays_d)
        near_m, far_m, mask = get_near_far(bounds, ro, rd)
        cap = npatch * ps * ps
        near = np.zeros(cap, np.float32)
        far = np.full(cap, 1e-3, np.float32)
        near[mask] = near_m
        far[mask] = far_m
        pix_idx = np.concatenate(pix)
        pix_idx[~mask] = -1
        t = torch.from_numpy
        return TrainSample(
            frame=frame,
            rays=RayBundle(ray_o=t(ro), ray_d=t(rd), near=t(near),
                           far=t(far), mask=t(mask)),
            target_patches=t(target),
            ray_pixel_idx=t(pix_idx),
        )

    def get_eval_item(self, index) -> EvalItem:
        frame, (timg, tK, tR, tT), bounds = self._frame_and_target()
        h, w = self.hw
        return EvalItem(
            frame=frame,
            eval_rays=sample_eval_rays(timg, tK, tR, tT.reshape(3, 1),
                                       bounds),
            target_img=timg, target_msk=np.ones((h, w), np.uint8),
            human="synthetic", human_idx=0, frame_index=int(index),
            cam_ind=0)

    def get_perform_item(self, index, render_views=None) -> EvalItem:
        return self.get_eval_item(index)

    def get_mesh_item(self, index):
        """(frame, the body's box inflated 0.05 m (2, 3), meta) for mesh
        reconstruction."""
        frame, _, bounds = self._frame_and_target()
        return frame, bounds, dict(human="synthetic", human_idx=0,
                                   frame_index=int(index), cam_ind=0)
