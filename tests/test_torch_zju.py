"""The port's ZJU-MoCap dataset against the JAX package's on the CPU, on fake
on-disk datasets in the reference's layout (as tests/test_zju_data.py and
tests/test_zju_313_layout.py write them): non-zero distortion, jitter, a
palette ``mask_cihp`` layer, visibility files for some cameras only; and the
313 compact layout.  Then one eval forward and one train step on ZJU items
through both packages with bridged weights."""

import os

import cv2
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tests._torch_codings import (
    cut_after_scans,
    cv2_progressive,
    encode_png,
    pil_jpeg,
    with_exif,
)
from transhuman_tpu.cli.run import evaluate_frames as jax_evaluate_frames
from transhuman_tpu.config import Config as JConfig
from transhuman_tpu.data import aug as jaug
from transhuman_tpu.data import catalog as jcatalog
from transhuman_tpu.data.zju import ZJUDataset as JZJU
from transhuman_tpu.evals.evaluator import Evaluator as JEvaluator
from transhuman_tpu.geometry import cameras as jcameras
from transhuman_tpu.geometry.clusters import ClusterSpec as JClusterSpec
from transhuman_tpu.geometry.smpl import SMPLModel as JSMPL
from transhuman_tpu.render.pipeline import RenderPipeline as JPipeline
from transhuman_tpu.render.pipeline import to_smpl as jto_smpl
from transhuman_tpu.testing import init_params, synthetic_setup
from transhuman_tpu.train import step as jstep
from transhuman_tpu.utils import cache as jcache
from transhuman_tpu_torch import kernels, weights
from transhuman_tpu_torch.cli import common
from transhuman_tpu_torch.cli import run as run_cli
from transhuman_tpu_torch.config import Config
from transhuman_tpu_torch.data import aug, catalog
from transhuman_tpu_torch.data.zju import CAM_IDX_313, ZJUDataset
from transhuman_tpu_torch.evals.evaluator import Evaluator
from transhuman_tpu_torch.geometry import cameras
from transhuman_tpu_torch.geometry.clusters import (
    ClusterSpec,
    normalize_positions,
)
from transhuman_tpu_torch.geometry.smpl import SMPLModel
from transhuman_tpu_torch.models.network import TransHumanNet
from transhuman_tpu_torch.render.pipeline import RenderPipeline, to_smpl
from transhuman_tpu_torch.train import step as tstep
from transhuman_tpu_torch.utils import cache

NV, NF, NC = 128, 3, 4  # vertices, frames, cameras
H_FULL = W_FULL = 64
HUMAN = "CoreView_377"
EMBED, DEPTH, HEADS, K, NCL, NS = 12, 1, 2, 3, 16, 4
# float32 images: jitter-off items go through the same float32 operations
# in both packages; the jitter adds HSV round trips
IMG_TOL, IMG_TOL_JITTER = 1e-6, 2e-5


def _camera(c, n, f=60.0):
    th = 2 * np.pi * c / n
    R = np.array([[np.cos(th), 0, -np.sin(th)], [0, 1, 0],
                  [np.sin(th), 0, np.cos(th)]])
    pos = np.array([-2.5 * np.sin(th), 0, -2.5 * np.cos(th)])
    K = np.array([[f, 0, W_FULL / 2], [0, f, H_FULL / 2], [0, 0, 1]])
    return K, R, (-R @ pos).reshape(3, 1) * 1000.0


def _smooth_image(rng, h, w):
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    ph = rng.random(3) * 6
    img = np.stack([np.sin(5 * x + ph[0]) * np.cos(3 * y),
                    np.cos(4 * x * y + ph[1]), np.sin(7 * y + 2 * x + ph[2])],
                   -1)
    img = (img + 1) * 120 + rng.normal(0, 6, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _body_mask(smpl, verts, K, R, T):
    """0/1 mask of the projected vertices' bounding rectangle."""
    cam = verts @ R.T + T.reshape(1, 3) / 1000.0
    uv = cam @ K.T
    uv = uv[:, :2] / uv[:, 2:]
    x0, y0 = np.floor(uv.min(0)).astype(int)
    x1, y1 = np.ceil(uv.max(0)).astype(int)
    m = np.zeros((H_FULL, W_FULL), np.uint8)
    m[max(y0, 0):y1, max(x0, 0):x1] = 1
    return m


def _write_palette_png(path, msk):
    """A palette mask: index 1 is red 0 (background to imageio's channel 0
    test), index 2 red 200."""
    idx = np.where(msk > 0, 2, 0).astype(np.uint8)
    idx[::3, ::2] = np.where(msk[::3, ::2] > 0, 1, 0)
    im = Image.fromarray(idx, mode="P")
    im.putpalette([0, 0, 0, 0, 128, 0, 200, 30, 30] + [0] * 759)
    im.save(path)


def _write_frame(path, img, c, f, codings):
    """One view's frame: a q92 baseline JPEG, or with codings the coding of
    camera c at frame f (_CODINGS); returns the file name's extension."""
    if not codings:
        cv2.imwrite(path + ".jpg", img[..., ::-1],
                    [cv2.IMWRITE_JPEG_QUALITY, 92])
        return ".jpg"
    kind = _CODINGS[f % 2][c % 4]
    if kind == "png_rgb":
        data = encode_png(img, 8, 2)
    elif kind == "png_rgba16":
        data = encode_png(np.concatenate([img, img[..., :1]], -1).astype(
            np.int64) * 256 + (np.arange(img.size * 4 // 3) % 256).reshape(
                *img.shape[:2], 4), 16, 6)
    elif kind == "png_adam7":
        data = encode_png(img, 8, 2, interlace=True)
    elif kind == "png_grey16_adam7":
        data = encode_png(img[..., 1:2].astype(np.int64) * 256 + 77, 16, 0,
                          interlace=True)
    elif kind == "progressive":
        data = cv2_progressive(img, 92, "420")
    elif kind == "cmyk":
        data = pil_jpeg(np.asarray(Image.fromarray(img).convert("CMYK")),
                        92, 0, mode="CMYK")
    elif kind == "exif3":
        data = with_exif(pil_jpeg(img, 92, 2, progressive=True,
                                  optimize=True), 3)
    else:  # a progressive file cut after 4 scans: block smoothing
        data = cut_after_scans(pil_jpeg(img, 92, 2, progressive=True), 4)
    ext = ".png" if kind.startswith("png") else ".jpg"
    with open(path + ext, "wb") as fh:
        fh.write(data)
    return ext


# codings of the views of even and odd frames (an input view reads the
# target's file name, so a frame's views share their extension)
_CODINGS = (("progressive", "cmyk", "exif3", "truncated"),
            ("png_rgb", "png_rgba16", "png_adam7", "png_grey16_adam7"))


def write_fake_zju(root, human=HUMAN, layout="regular", n_cams=NC, seed=0,
                   codings=False):
    """A fake human in the reference's layout under root; returns its SMPL
    stand-in's vertex count.  With codings, the frames of even frame
    indices are progressive, CMYK, EXIF-3 and truncated progressive JPEGs
    (cameras 0-3), those of odd indices PNG frames (RGB, 16-bit RGBA, Adam7
    RGB, Adam7 16-bit grey), and the masks of cameras 0 and 2 Adam7 PNGs."""
    rng = np.random.default_rng(seed)
    smpl = JSMPL.synthetic(n_verts=NV)
    hdir = os.path.join(root, human)
    cams = {"K": [], "D": [], "R": [], "T": []}
    for c in range(n_cams):
        K, R, T = _camera(c, n_cams)
        cams["K"].append(K)
        cams["R"].append(R)
        cams["T"].append(T)
        # most cameras distort; one does not
        d = np.zeros((5, 1)) if c == 2 else np.array(
            [[-0.08 + 0.01 * c], [0.02], [0.001], [-0.0015], [0.004]])
        cams["D"].append(d)
    vdir, pdir = "new_vertices", "new_params"
    ims = []
    frames = range(1, NF + 1) if layout == "313" else range(NF)
    for f in frames:
        if layout == "313":
            entries = []
            for c in range(n_cams):
                dc = CAM_IDX_313[c] + 1
                entries.append(f"Camera ({dc})/CoreView_313_Camera_({dc})_"
                               f"{f:04d}_2019.jpg")
        else:
            ext = ".png" if codings and f % 2 else ".jpg"
            entries = [f"Camera_B{c + 1}/{f:06d}{ext}"
                       for c in range(n_cams)]
        ims.append({"ims": entries})
        poses = (rng.standard_normal((1, 72)) * 0.05).astype(np.float32)
        params = {"poses": poses, "shapes": np.zeros((1, 10), np.float32),
                  "Rh": (rng.standard_normal((1, 3)) * 0.1).astype(np.float32),
                  "Th": (rng.standard_normal((1, 3)) * 0.05).astype(
                      np.float32)}
        verts, _, _ = smpl(poses.reshape(-1), np.zeros(10))
        from transhuman_tpu.geometry.smpl import rodrigues

        Rh = rodrigues(params["Rh"].reshape(1, 3))[0]
        verts_world = verts @ Rh.T + params["Th"].reshape(1, 3)
        os.makedirs(os.path.join(hdir, vdir), exist_ok=True)
        os.makedirs(os.path.join(hdir, pdir), exist_ok=True)
        np.save(os.path.join(hdir, vdir, f"{f}.npy"), verts_world)
        np.save(os.path.join(hdir, pdir, f"{f}.npy"), params)
        for c in range(n_cams):
            if layout == "313":
                cdir = f"Camera ({CAM_IDX_313[c] + 1})"
                stem = f"{f:04d}"
            else:
                cdir, stem = f"Camera_B{c + 1}", f"{f:06d}"
            os.makedirs(os.path.join(hdir, cdir), exist_ok=True)
            img = _smooth_image(rng, H_FULL, W_FULL)
            _write_frame(os.path.join(hdir, cdir, stem), img, c, f, codings)
            msk = _body_mask(smpl, verts_world, *[np.asarray(x) for x in (
                cams["K"][c], cams["R"][c], cams["T"][c])])
            mdir = os.path.join(hdir, "mask", cdir)
            os.makedirs(mdir, exist_ok=True)
            if codings and c % 2 == 0:
                with open(os.path.join(mdir, stem + ".png"), "wb") as fh:
                    fh.write(encode_png(msk[..., None] * 255, 8, 0,
                                        interlace=True))
            else:
                cv2.imwrite(os.path.join(mdir, stem + ".png"), msk * 255)
            if c % 2 == 0:  # a palette CIHP layer on some cameras
                cdir2 = os.path.join(hdir, "mask_cihp", cdir)
                os.makedirs(cdir2, exist_ok=True)
                grown = cv2.dilate(msk, np.ones((3, 3), np.uint8))
                _write_palette_png(os.path.join(cdir2, stem + ".png"), grown)
            if c != 1:  # no visibility files for camera 1: the fallback
                vis = os.path.join(root, "raster", human, "visibility", cdir)
                os.makedirs(vis, exist_ok=True)
                np.save(os.path.join(vis, stem + ".npy"),
                        rng.random(NV) > 0.3)
    np.save(os.path.join(hdir, "annots.npy"), {"cams": cams, "ims": ims})


def _opts(root, extra=()):
    return ["data_root", str(root), "rasterize_root",
            os.path.join(str(root), "raster"), "ratio", "0.5",
            "train_num_views", "2", "test.input_view", "0,1",
            "test.target_view", "2,3", "patch.N_patches", "2",
            "patch.size", "8", "N_rand", "64", "num_class", str(NCL),
            "N_samples", str(NS), "vit_depth", str(DEPTH),
            "test.frame_interval", "2", *extra]


@pytest.fixture(scope="module")
def zju_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("zju")
    write_fake_zju(str(root))
    return str(root)


@pytest.fixture(scope="module")
def zju313_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("zju313")
    write_fake_zju(str(root), "CoreView_313", "313", n_cams=len(CAM_IDX_313),
                   seed=1)
    return str(root)


@pytest.fixture(scope="module")
def zju_codings_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("zju_codings")
    write_fake_zju(str(root), codings=True, seed=2)
    return str(root)


INFO = {HUMAN: {"begin_i": 0, "i_intv": 1, "ni": NF}}
INFO313 = {"CoreView_313": {"begin_i": 0, "i_intv": 1, "ni": NF}}


def _pair(root, split, extra=(), info=INFO):
    opts = _opts(root, extra)
    j = JZJU(JConfig().merge_opts(opts), split, smpl=JSMPL.synthetic(
        n_verts=NV), human_info=info)
    t = ZJUDataset(Config().merge_opts(opts), split,
                   smpl=SMPLModel.synthetic(n_verts=NV), human_info=info)
    return j, t


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_frame(t, j, img_tol):
    np.testing.assert_allclose(_np(t.images), np.asarray(j.images),
                               atol=img_tol, rtol=0)
    for f in ("vizmaps", "K", "R", "T", "verts_world", "tar_verts_smpl",
              "blend_rot", "Rh", "Th"):
        np.testing.assert_array_equal(_np(getattr(t, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in ("aug_center", "aug_rot", "aug_trans"):
        jv, tv = getattr(j, f), getattr(t, f)
        assert (jv is None) == (tv is None), f
        if jv is not None:
            np.testing.assert_array_equal(_np(tv), np.asarray(jv))


def _same_rays(t, j):
    for f in ("ray_o", "ray_d", "near", "far", "mask"):
        np.testing.assert_array_equal(_np(getattr(t, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)


@pytest.mark.parametrize("jitter", [False, True])
def test_train_samples_equal_the_jax_dataset(zju_root, jitter):
    j, t = _pair(zju_root, "train", ["jitter", str(jitter)])
    assert len(t) == len(j) == NF * NC
    for epoch, index in ((0, 0), (3, 5), (1, NF * NC - 1)):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        js, ts = j.get_train_sample(index), t.get_train_sample(index)
        _same_frame(ts.frame, js.frame, IMG_TOL_JITTER if jitter else IMG_TOL)
        _same_rays(ts.rays, js.rays)
        np.testing.assert_array_equal(ts.ray_pixel_idx.numpy(),
                                      js.ray_pixel_idx)
        np.testing.assert_allclose(ts.target_patches.numpy(),
                                   js.target_patches, rtol=0,
                                   atol=IMG_TOL_JITTER if jitter else IMG_TOL)
        assert ts.rays.mask.any()
    # the vizmaps: loaded for cameras 0, 2, 3; all ones for camera 1
    j.set_epoch(0)
    t.set_epoch(0)


def test_items_from_concurrent_loader_threads_equal_serial_ones(zju_root):
    """The dataset's caches (remap plans, input views, ray grids) are shared
    by loader threads: 12 threads on 8 cores, a short switch interval, the
    same items as one thread makes."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    _, serial = _pair(zju_root, "test")
    want = [serial.get_eval_item(i) for i in range(len(serial))]
    _, shared = _pair(zju_root, "test")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(12) as pool:
            futs = [pool.submit(shared.get_eval_item, i)
                    for i in list(range(len(shared))) * 3]
            got = [f.result(timeout=120) for f in futs]
    finally:
        sys.setswitchinterval(old)
    for k, item in enumerate(got):
        ref = want[k % len(want)]
        np.testing.assert_array_equal(item.frame.images.numpy(),
                                      ref.frame.images.numpy())
        np.testing.assert_array_equal(item.target_img, ref.target_img)
        np.testing.assert_array_equal(item.eval_rays.pix_idx,
                                      ref.eval_rays.pix_idx)


def test_distortion_jitter_and_visibility_are_exercised(zju_root):
    _, t = _pair(zju_root, "train")
    assert t._remap_plan(HUMAN, 0, (H_FULL, W_FULL)) is not None
    assert t._remap_plan(HUMAN, 2, (H_FULL, W_FULL)) is None
    viz = {c: t._vizmap(HUMAN, c + 1, "000000") for c in range(NC)}
    assert (viz[1] == 1).all() and not (viz[0] == 1).all()
    # the palette layer's red-0 entry reads as background
    cihp = t._load_mask(HUMAN, "Camera_B1", "000000.jpg")
    mask = cv2.imread(os.path.join(zju_root, HUMAN, "mask", "Camera_B1",
                                   "000000.png"), 0)
    assert cihp.sum() > (mask > 0).sum()  # the union grew the mask


def test_non_patch_rays_equal_the_jax_dataset(zju_root):
    j, t = _pair(zju_root, "train", ["patch.use_patch_sampling", "False"])
    for index in (1, 7):
        js, ts = j.get_train_sample(index), t.get_train_sample(index)
        _same_rays(ts.rays, js.rays)
        np.testing.assert_allclose(ts.target_rgb.numpy(), js.target_rgb,
                                   rtol=0, atol=IMG_TOL_JITTER)
        assert ts.target_patches is None and ts.rays.mask.sum() == 64


def test_rot_ratio_aug_and_to_smpl_equal_the_jax_package(zju_root):
    j, t = _pair(zju_root, "train", ["rot_ratio", "1.0", "jitter", "False"])
    js, ts = j.get_train_sample(4), t.get_train_sample(4)
    _same_frame(ts.frame, js.frame, IMG_TOL)
    assert not np.array_equal(js.frame.aug_rot, np.eye(3))
    pts = np.random.default_rng(3).standard_normal((50, 3)).astype(
        np.float32)
    want = jto_smpl(js.frame, pts)
    got = to_smpl(ts.frame, torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    # eval frames carry no augmentation
    _, te = _pair(zju_root, "test", ["rot_ratio", "1.0"])
    assert te.get_eval_item(0).frame.aug_rot is None


def _same_eval_item(ti, ji):
    _same_frame(ti.frame, ji.frame, IMG_TOL)
    for f in ("pix_idx", "mask_at_box", "rgb"):
        np.testing.assert_array_equal(getattr(ti.eval_rays, f),
                                      getattr(ji.eval_rays, f), err_msg=f)
    _same_rays(ti.eval_rays.rays, ji.eval_rays.rays)
    np.testing.assert_allclose(ti.target_img, ji.target_img, atol=IMG_TOL,
                               rtol=0)
    np.testing.assert_array_equal(ti.target_msk, ji.target_msk)
    assert (ti.human, ti.human_idx, ti.frame_index, ti.cam_ind) == (
        ji.human, ji.human_idx, ji.frame_index, ji.cam_ind)


def test_eval_perform_and_mesh_items_equal_the_jax_dataset(zju_root):
    j, t = _pair(zju_root, "test")
    assert len(t) == len(j) == NF * 2
    for index in (0, 3):
        _same_eval_item(t.get_eval_item(index), j.get_eval_item(index))
        _same_eval_item(t.get_perform_item(index), j.get_perform_item(index))
        tf, tb, tm = t.get_mesh_item(index)
        jf, jb, jm = j.get_mesh_item(index)
        _same_frame(tf, jf, IMG_TOL)
        np.testing.assert_array_equal(tb, jb)
        assert tm == jm
    # the border band, and the undistort's blends of {0, 1, 100}
    msk = t.get_eval_item(1).target_msk
    assert 100 in msk and len(np.unique(msk)) > 3


def test_frame_sampler_indices_equal_the_jax_dataset(zju_root):
    for extra in ([], ["test.full_eval", "True"],
                  ["test.frame_interval", "3"],
                  ["test.sampler", "Other"]):
        j, t = _pair(zju_root, "test", extra)
        for fe in (None, True, False):
            np.testing.assert_array_equal(t.frame_sampler_indices(fe),
                                          j.frame_sampler_indices(fe))


def test_313_layout_equals_the_jax_dataset(zju313_root):
    j, t = _pair(zju313_root, "test", ["test.target_view", "3,20"],
                 info=INFO313)
    assert t.ims == j.ims and t.start_end == j.start_end
    assert os.path.basename(os.path.dirname(t.ims[1])) == "Camera (23)"
    _same_eval_item(t.get_eval_item(1), j.get_eval_item(1))
    jt, tt = _pair(zju313_root, "train", info=INFO313)
    js, ts = jt.get_train_sample(30), tt.get_train_sample(30)
    _same_frame(ts.frame, js.frame, IMG_TOL_JITTER)
    _same_rays(ts.rays, js.rays)


def test_catalog_split_skips_humans_missing_from_disk(zju_root, capsys):
    opts = _opts(zju_root)
    j = JZJU(JConfig().merge_opts(opts), "train",
             smpl=JSMPL.synthetic(n_verts=NV))
    t = ZJUDataset(Config().merge_opts(opts), "train",
                   smpl=SMPLModel.synthetic(n_verts=NV))
    assert t.human_list == j.human_list == [HUMAN]
    assert t.ims == j.ims and len(t) == NC  # frames [0:300][::30]
    assert capsys.readouterr().out.count("skipping humans missing") == 2
    with pytest.raises(FileNotFoundError, match="no annots.npy"):
        ZJUDataset(Config().merge_opts(_opts("/nonexistent")), "train",
                   smpl=SMPLModel.synthetic(n_verts=NV))
    with pytest.raises(ValueError, match="time_steps"):
        ZJUDataset(Config().merge_opts(opts + ["time_steps", "2"]), "train",
                   smpl=SMPLModel.synthetic(n_verts=NV), human_info=INFO)


def test_copied_modules_equal_the_jax_modules(zju_root):
    for name in ("TRAIN", "TEST_MODEL_O_MOTION_O", "TEST_MODEL_O_MOTION_X",
                 "TEST_MODEL_X_MOTION_X"):
        assert getattr(catalog, name) == getattr(jcatalog, name)
    for mode in ("model_o_motion_o", "model_x_motion_x"):
        assert (catalog.get_human_info("test", mode)
                == jcatalog.get_human_info("test", mode))
    shape = [(10, 4), (7, 3)]
    for fe, iv in ((False, 3), (True, 30), (False, 30)):
        np.testing.assert_array_equal(
            catalog.frame_sampler_indices(shape, fe, iv),
            jcatalog.frame_sampler_indices(shape, fe, iv))
    xyz = np.random.default_rng(0).standard_normal((20, 3)).astype(
        np.float32)
    for ratio in (0.0, 0.5, 1.0):
        for seed in range(4):
            got = aug.transform_can_smpl(xyz, np.random.default_rng(seed),
                                         ratio)
            want = jaug.transform_can_smpl(xyz, np.random.default_rng(seed),
                                           ratio)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    Ks, RTs = cameras.load_cam(os.path.join(zju_root, HUMAN, "annots.npy"))
    jK, jRT = jcameras.load_cam(os.path.join(zju_root, HUMAN, "annots.npy"))
    np.testing.assert_array_equal(np.array(Ks), np.array(jK))
    np.testing.assert_array_equal(np.array(RTs), np.array(jRT))
    np.testing.assert_array_equal(np.array(cameras.gen_path_virt(RTs, 7)),
                                  np.array(jcameras.gen_path_virt(jRT, 7)))
    for mod in (cache, jcache):
        lru = mod.ByteLRU(100)
        lru.put("a", np.zeros(10, np.float32))
        lru.put("b", np.zeros(10, np.float32))
        assert lru.get("a") is not None
        lru.put("c", np.zeros(10, np.float32))  # evicts b, the oldest
        assert lru.get("b") is None and len(lru) == 2
        with pytest.raises(ValueError):
            lru.put("d", None)
        assert not lru.get("a").flags.writeable


def test_make_dataset_builds_zju_from_the_config(zju_root):
    cfg = Config().merge_opts(["dataset", "zju", *_opts(zju_root)])
    data = common.make_dataset(cfg, "train", smpl=SMPLModel.synthetic(
        n_verts=NV))
    assert isinstance(data, ZJUDataset) and data.human_list == [HUMAN]


# ----------------------------------------------------- forward and step
@pytest.fixture(scope="module")
def bridged(zju_root):
    """The JAX pipeline with init params and the port's pipeline with the
    same weights, over the fake human's SMPL stand-in and clusters."""
    jmodel, _, jframe, jsmpl, _ = synthetic_setup(
        n_views=2, image_hw=(32, 32), n_verts=NV, n_clusters=NCL,
        n_samples=NS, chunk_rays=64, embed_dim=EMBED, vit_depth=DEPTH,
        vit_heads=HEADS, knn_k=K)
    params = init_params(jmodel, jframe, NCL, jax.random.PRNGKey(0))
    jcluster = JClusterSpec.from_kmeans(jsmpl.v_template, NCL, iters=3)
    table = weights.reference_pe_table(normalize_positions(
        jcluster.pool_matrix @ jsmpl.v_template, 1.5), EMBED)
    jpipe = JPipeline(jmodel, jcluster, jsmpl.v_template, n_samples=NS,
                      chunk_rays=64, pe_table=table)
    sd = weights.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]), DEPTH)

    def port_pipe():
        net = TransHumanNet(embed_dim=EMBED, vit_depth=DEPTH,
                            vit_heads=HEADS, knn_k=K)
        weights.load_reference_state_dict(net, sd)
        return RenderPipeline(net.eval(), ClusterSpec(jcluster.vert2cluster,
                                                      NCL),
                              SMPLModel.synthetic(n_verts=NV).v_template,
                              n_samples=NS, chunk_rays=64, device="cpu")

    return jpipe, params, port_pipe


def _eval_forward_matches(root, bridged, tmp_path, extra=()):
    """evaluate_frames through both packages on the fake human at root;
    returns the frames rendered."""
    jpipe, params, port_pipe = bridged
    j, t = _pair(root, "test", extra)
    frames = {}

    def collect(key, ev):
        def per_frame(item, out):
            frames.setdefault(key, []).append(
                (item.frame_index, np.asarray(out["rgb_map"]), ev.psnr[-1]))
            return {}
        return per_frame

    jev = JEvaluator(str(tmp_path / "jax"))
    tev = Evaluator(str(tmp_path / "port"))
    opts = _opts(root, ["pad_bucket", "256", *extra])
    jax_evaluate_frames(JConfig().merge_opts(opts), jpipe, params, j, jev,
                        collect("jax", jev))
    kernels.reset_launch_counts()
    run_cli.evaluate_frames(Config().merge_opts(_opts(root, extra)),
                            port_pipe(), t, tev, collect("port", tev))
    assert len(frames["port"]) == len(frames["jax"])
    for (fj, rj, pj), (ft, rt, pt) in zip(frames["jax"], frames["port"]):
        assert fj == ft and rt.shape == rj.shape and np.isfinite(rt).all()
        # tests/test_torch_eval.py's bounds
        np.testing.assert_allclose(rt, rj, atol=2e-3)
        assert pt == pytest.approx(pj, abs=0.05)
    return [f for f, _, _ in frames["port"]]


def test_zju_eval_forward_matches_the_jax_package(zju_root, bridged,
                                                  tmp_path):
    # frames 0 and 2 (test.frame_interval 2), target cameras 2 and 3
    assert _eval_forward_matches(zju_root, bridged, tmp_path) == [0, 0, 2, 2]


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def test_zju_train_step_matches_the_jax_package(zju_root, bridged):
    jpipe, params, port_pipe = bridged
    j, t = _pair(zju_root, "train", ["jitter", "False"])
    js, ts = j.get_train_sample(2), t.get_train_sample(2)
    key = jax.random.PRNGKey(0)
    jfn = jstep.make_sample_loss(jpipe, None, perturb=False)
    (jl, _), jg = jax.value_and_grad(jfn, has_aux=True)(params, js, key)
    pipe = port_pipe()
    tl, stats = tstep.make_sample_loss(pipe, perturb=False)(ts, seed=0)
    tl.backward()
    assert "mse_loss" in stats
    tg = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
          for n, p in pipe.model.named_parameters()}
    tg = _leaves(weights.jax_params_from_state_dict(tg)["params"])
    jg = _leaves(jg["params"])
    # tests/test_torch_train.py's bounds
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert set(tg) == set(jg)
    for k, want in jg.items():
        assert (np.linalg.norm(tg[k] - want)
                <= 1e-3 * np.linalg.norm(want) + 1e-10), k


def test_zju_non_patch_step_takes_the_masked_mse(zju_root, bridged):
    """patch.use_patch_sampling False: the step's loss is the unweighted
    masked MSE of the single rays' colours (the JAX package's
    random_ray_losses, held against JAX in tests/test_torch_train.py), and
    its gradient reaches the network."""
    _, _, port_pipe = bridged
    _, t = _pair(zju_root, "train", ["jitter", "False",
                                      "patch.use_patch_sampling", "False"])
    ts = t.get_train_sample(2)
    pipe = port_pipe()
    loss, stats = tstep.make_sample_loss(pipe, perturb=False,
                                         patch_mode=False)(ts, seed=0)
    with torch.no_grad():
        rgb = pipe.render_train(ts.frame, ts.rays, 0,
                                sample_jitter=False)["rgb_map"]
    want = ((rgb - ts.target_rgb) ** 2).mean()  # every ray is valid here
    assert ts.rays.mask.all() and "img_loss" in stats
    torch.testing.assert_close(loss.detach(), want, rtol=1e-6, atol=0)
    loss.backward()
    assert any(p.grad is not None and p.grad.abs().sum() > 0
               for p in pipe.model.parameters())


# ------------------------------------- a tree of mixed image codings
def test_mixed_codings_are_on_disk(zju_codings_root):
    """The tree holds each coding _CODINGS names, and the port reads each
    frame as cv2 does (the EXIF-3 view rotated, its shape kept)."""
    from transhuman_tpu_torch.data.image_io import imread_rgb

    cam = os.path.join(zju_codings_root, HUMAN, "Camera_B{}")
    with open(os.path.join(cam.format(3), "000000.jpg"), "rb") as fh:
        assert fh.read(4) == b"\xff\xd8\xff\xe1"  # the EXIF APP1 first
    with open(os.path.join(zju_codings_root, HUMAN, "mask", "Camera_B1",
                           "000000.png"), "rb") as fh:
        assert fh.read(29)[28] == 1  # IHDR interlace: Adam7
    for c in range(NC):
        for f, ext in ((0, ".jpg"), (1, ".png")):
            p = os.path.join(cam.format(c + 1), f"{f:06d}{ext}")
            want = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
            got = imread_rgb(p)
            assert got.shape == want.shape == (H_FULL, W_FULL, 3), p
            np.testing.assert_array_equal(got, want, err_msg=p)


def test_mixed_coding_train_samples_equal_the_jax_dataset(zju_codings_root):
    j, t = _pair(zju_codings_root, "train", ["jitter", "False"])
    assert len(t) == len(j) == NF * NC
    for index in range(NF * NC):  # every view of every frame a target
        j.set_epoch(index)
        t.set_epoch(index)
        js, ts = j.get_train_sample(index), t.get_train_sample(index)
        _same_frame(ts.frame, js.frame, IMG_TOL)
        _same_rays(ts.rays, js.rays)
        np.testing.assert_array_equal(ts.ray_pixel_idx.numpy(),
                                      js.ray_pixel_idx)
        np.testing.assert_allclose(ts.target_patches.numpy(),
                                   js.target_patches, rtol=0, atol=IMG_TOL)


def test_mixed_coding_eval_items_equal_the_jax_dataset(zju_codings_root):
    j, t = _pair(zju_codings_root, "test")
    assert len(t) == len(j) == NF * 2
    for index in range(len(t)):
        _same_eval_item(t.get_eval_item(index), j.get_eval_item(index))
    _same_eval_item(t.get_perform_item(1), j.get_perform_item(1))


def test_mixed_coding_eval_forward_matches_the_jax_package(
        zju_codings_root, bridged, tmp_path):
    # every frame: 0 and 2 of JPEG codings, 1 of PNG frames
    assert _eval_forward_matches(zju_codings_root, bridged, tmp_path,
                                 ["test.frame_interval", "1"]) == [
        0, 0, 1, 1, 2, 2]
