"""The mesh reconstruction and light_stage slice: the port's marching
tetrahedra, PLY reader and writer, voxelizer, grid and synthetic mesh items
against the JAX package's, bit for bit; render_sigma and extract_mesh
against the JAX package's extract_mesh (compact_ratio None) with the same
bridged weights on a tiny model, each marching route (numpy, C++) against
the same route of the JAX package; the run entry point's reconstruction and
light_stage on the CPU, and the mesh video of its PLY."""

import os

import jax
import numpy as np
import pytest
import torch

from transhuman_tpu.config import Config as JConfig
from transhuman_tpu.data.synthetic import SyntheticDataset as JDataset
from transhuman_tpu.mesh_ops import marching as jmarching
from transhuman_tpu.mesh_ops import ply as jply
from transhuman_tpu.mesh_ops import reconstruct as jreconstruct
from transhuman_tpu.render.pipeline import RenderPipeline as JPipeline
from transhuman_tpu.testing import init_params, synthetic_setup
from transhuman_tpu.tools import voxelize_mesh as jvox
from transhuman_tpu_torch import kernels, weights
from transhuman_tpu_torch.cli import run as run_cli
from transhuman_tpu_torch.cli import train as train_cli
from transhuman_tpu_torch.config import Config
from transhuman_tpu_torch.data.synthetic import SyntheticDataset
from transhuman_tpu_torch.geometry.clusters import normalize_positions
from transhuman_tpu_torch.mesh_ops import marching, ply, reconstruct
from transhuman_tpu_torch.models.network import TransHumanNet
from transhuman_tpu_torch.render.pipeline import RenderPipeline
from transhuman_tpu_torch.tools import voxelize_mesh as vox

HW, NV, NC, NS, EMBED, DEPTH, HEADS, K = 32, 400, 20, 8, 24, 1, 2, 4
OPTS = ["H", str(2 * HW), "W", str(2 * HW), "num_class", str(NC),
        "N_samples", str(NS), "vit_depth", str(DEPTH)]
VOXEL = (0.06, 0.06, 0.06)  # tests/test_cli_e2e.py's override
# the largest |sigma port - sigma JAX| allowed: float32 decodes of the same
# points through two frameworks, sigma up to ~0.54 here (4.1e-6 measured)
SIGMA_ATOL = 1e-4


def sphere_field(n=24, radius=8.0):
    g = np.arange(n, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    c = (n - 1) / 2
    return radius - np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)


def _fields():
    rng = np.random.default_rng(3)
    return {
        "sphere": (sphere_field(), 0.0),
        "random": (rng.normal(0, 1, (9, 11, 7)).astype(np.float32), 0.3),
        "empty": (np.zeros((5, 5, 5), np.float32), 1.0),
        "full": (np.full((5, 5, 5), 10.0, np.float32), 1.0),
        "flat": (np.ones((1, 4, 4), np.float32), 0.5),
    }


@pytest.mark.parametrize("name", sorted(_fields()))
def test_marching_equals_the_jax_numpy_path(name):
    """The port's numpy route (use_native False) against the JAX
    package's, bit for bit; the C++ routes are held against each other in
    tests/test_torch_native.py."""
    field, th = _fields()[name]
    want_v, want_t = jmarching._marching_tetrahedra_np(field, th)
    got_v, got_t = marching.marching_tetrahedra(field, th, use_native=False)
    assert got_v.dtype == want_v.dtype and got_t.dtype == want_t.dtype
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_t, want_t)
    if name == "sphere":
        assert len(got_t) > 100
    if name in ("empty", "full", "flat"):
        assert got_v.shape == (0, 3) and got_t.shape == (0, 3)


def _sphere_mesh(n=16, radius=5.0):
    return jmarching._marching_tetrahedra_np(sphere_field(n, radius), 0.0)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ply_round_trips_against_the_jax_package(tmp_path, writer):
    v, t = _sphere_mesh()
    path = str(tmp_path / "m.ply")
    (ply if writer == "port" else jply).save_ply(path, v, t)
    other = str(tmp_path / "o.ply")
    (jply if writer == "port" else ply).save_ply(other, v, t)
    assert open(path, "rb").read() == open(other, "rb").read()
    for mod in (ply, jply):
        got_v, got_t = mod.load_ply(path)
        np.testing.assert_array_equal(got_v, v)
        np.testing.assert_array_equal(got_t, t)
    # an ascii PLY of another tool reads the same through both
    asc = tmp_path / "a.ply"
    asc.write_text("ply\nformat ascii 1.0\nelement vertex 3\n"
                   "property float x\nproperty float y\nproperty float z\n"
                   "element face 1\nproperty list uchar int vertex_indices\n"
                   "end_header\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    for a, b in zip(ply.load_ply(str(asc)), jply.load_ply(str(asc))):
        np.testing.assert_array_equal(a, b)
    (tmp_path / "bad.ply").write_bytes(b"ply\nno header end")
    for mod in (ply, jply):
        with pytest.raises(ValueError, match="not a PLY"):
            mod.load_ply(str(tmp_path / "bad.ply"))


@pytest.mark.parametrize("voxel", [1.0, 0.5])
def test_voxelize_equals_the_jax_tool(voxel):
    """On a sphere mesh, and at 0.5 on the interior-cavity case of
    tests/test_tools.py: the occupancy and the origin bit for bit."""
    v, t = _sphere_mesh()
    occ, origin = vox.voxelize(v, t, voxel=voxel)
    want_occ, want_origin = jvox.voxelize(v, t, voxel=voxel)
    np.testing.assert_array_equal(occ, want_occ)
    np.testing.assert_array_equal(origin, want_origin)
    c = ((np.array([7.5] * 3) - origin) / voxel).astype(int)
    assert occ[c[0], c[1], c[2]] == 1 and occ[0, 0, 0] == 0


@pytest.mark.parametrize("bounds, voxel", [
    ([[-0.31, -0.93, -0.27], [0.33, 0.91, 0.29]], (0.005,) * 3),
    ([[-0.3, -0.9, -0.3], [0.3, 0.9, 0.3]], (0.06, 0.04, 0.05)),
    ([[0.1, 0.2, 0.3], [0.1, 0.25, 0.31]], (0.01,) * 3),
])
def test_make_grid_is_bit_equal(bounds, voxel):
    b = np.asarray(bounds, np.float32)
    got = reconstruct.make_grid(b, voxel)
    want = jreconstruct.make_grid(b, voxel)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_list_overrides_keep_the_item_type():
    cfg = Config().merge_opts(["voxel_size", "[0.06, 0.06, 0.06]",
                               "test.input_view", "0,7,15"])
    assert cfg.voxel_size == [0.06, 0.06, 0.06]
    assert all(type(x) is float for x in cfg.voxel_size)
    assert cfg.test.input_view == [0, 7, 15]
    assert all(type(x) is int for x in cfg.test.input_view)
    assert Config().merge_opts(["voxel_size", "0.01,0.02,0.03"]).voxel_size \
        == JConfig().merge_opts(["voxel_size", "[0.01, 0.02, 0.03]"]).voxel_size
    with pytest.raises(ValueError, match="bad value"):
        Config().merge_opts(["test.input_view", "0.5,1"])


@pytest.fixture(scope="module")
def datasets():
    jdata = JDataset(JConfig().merge_opts(list(OPTS)), "test",
                     image_hw=(HW, HW), n_verts=NV)
    tdata = SyntheticDataset(Config().merge_opts(list(OPTS)), "test",
                             image_hw=(HW, HW), n_verts=NV)
    return jdata, tdata


def test_mesh_items_equal_the_jax_dataset(datasets):
    jdata, tdata = datasets
    jframe, jbounds, jmeta = jdata.get_mesh_item(5)
    tframe, tbounds, tmeta = tdata.get_mesh_item(5)
    assert tmeta == jmeta == {"human": "synthetic", "human_idx": 0,
                              "frame_index": 5, "cam_ind": 0}
    assert tbounds.dtype == np.asarray(jbounds).dtype
    np.testing.assert_array_equal(tbounds, np.asarray(jbounds))
    for f in ("images", "vizmaps", "K", "R", "T", "verts_world",
              "tar_verts_smpl", "blend_rot", "Rh", "Th"):
        np.testing.assert_array_equal(getattr(tframe, f).numpy(),
                                      np.asarray(getattr(jframe, f)), f)


def _clear_threshold(sigma, margin=2e-3):
    """An iso-level near the median of the positive sigmas that no sigma
    lies within margin / 2 of: the two packages' inside/outside decisions
    then agree, and so do their meshes' topologies."""
    s = np.unique(sigma[sigma > 0])
    mids = (s[1:] + s[:-1]) / 2
    ok = np.nonzero(np.diff(s) > margin)[0]
    assert ok.size, "no gap in sigma to put a threshold in"
    return float(mids[ok[np.argmin(np.abs(mids[ok] - np.median(s)))]])


@pytest.fixture(scope="module")
def pipes(datasets):
    """The JAX pipeline (dense, compact_ratio None) with its params, and the
    port's pipeline on the CPU with the same bridged weights."""
    jdata, tdata = datasets
    jmodel, _, jframe, jsmpl, _ = synthetic_setup(
        n_views=3, image_hw=(HW, HW), n_verts=NV, n_clusters=NC,
        n_samples=NS, chunk_rays=32, embed_dim=EMBED, vit_depth=DEPTH,
        vit_heads=HEADS, knn_k=K)
    params = init_params(jmodel, jframe, NC, jax.random.PRNGKey(0))
    table = weights.reference_pe_table(normalize_positions(
        jdata.cluster.pool_matrix @ jsmpl.v_template, 1.5), EMBED)
    jpipe = JPipeline(jmodel, jdata.cluster, jsmpl.v_template, n_samples=NS,
                      chunk_rays=32, pe_table=table)
    net = TransHumanNet(embed_dim=EMBED, vit_depth=DEPTH, vit_heads=HEADS,
                        knn_k=K)
    weights.load_reference_state_dict(net, weights.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]), DEPTH))
    tpipe = RenderPipeline(net.eval(), tdata.cluster, tdata.smpl.v_template,
                           n_samples=NS, chunk_rays=32, device="cpu")
    return jpipe, params, tpipe


@pytest.fixture(scope="module")
def meshes(datasets, pipes):
    """Both packages' extract_mesh on frame 0 at 0.06 m voxels, at a
    threshold no sigma lies near: the JAX one through its numpy marching,
    the port's through its default, the C++ marching."""
    jdata, tdata = datasets
    jpipe, params, tpipe = pipes
    jframe, bounds, _ = jdata.get_mesh_item(0)
    tframe, _, _ = tdata.get_mesh_item(0)
    mp = pytest.MonkeyPatch()
    mp.setattr(jmarching, "_load_native", lambda: None)
    try:
        _, _, jcube = jreconstruct.extract_mesh(jpipe, params, jframe, bounds,
                                                voxel_size=VOXEL)
        th = _clear_threshold(jcube)
        jmesh = jreconstruct.extract_mesh(jpipe, params, jframe, bounds,
                                          voxel_size=VOXEL, mesh_th=th)
    finally:
        mp.undo()
    kernels.reset_launch_counts()
    tmesh = reconstruct.extract_mesh(tpipe, tframe, bounds, voxel_size=VOXEL,
                                     mesh_th=th)
    return jmesh, tmesh, th, jframe, tframe, bounds


def _world(verts_idx, bounds, pad=10):
    """extract_mesh's index -> world transform."""
    lb = bounds[0] - pad * np.asarray(VOXEL)
    return (verts_idx * np.asarray(VOXEL, np.float32)
            + lb.astype(np.float32))


@pytest.mark.parametrize("route", ["numpy", "native"])
def test_extract_mesh_matches_the_jax_package(meshes, pipes, route):
    """Each marching route against the same route of the JAX package on
    each package's own sigma grid: the port's numpy marching against the
    JAX extract_mesh's (numpy), the port's extract_mesh (its C++ marching)
    against the JAX package's C++ marching."""
    (jv, jt, jcube), (tv, tt, tcube), th, _, _, bounds = meshes
    if route == "numpy":
        tv, tt = marching.marching_tetrahedra(tcube, th, use_native=False)
        tv = _world(tv, bounds)
    else:
        jv, jt = jmarching._march_native(jmarching._load_native(), jcube,
                                         th)
        jv = _world(jv, bounds)
    tpipe = pipes[2]
    assert tcube.shape == jcube.shape and tcube.dtype == np.float32
    assert np.isfinite(tcube).all()
    err = float(np.abs(tcube - jcube).max())
    assert err <= SIGMA_ATOL, err
    # a culled point is exactly 0 in both, and so is the pad
    np.testing.assert_array_equal(tcube == 0, jcube == 0)
    st = tpipe.last_frame_stats
    assert st["points"] == tcube[10:-10, 10:-10, 10:-10].size
    assert 0 < st["survivors"] == int((tcube != 0).sum()) < st["points"]
    # the same topology (no sigma within 1e-3 of th): the same triangles;
    # vertices move by |d sigma| / |sigma step| of a voxel
    assert len(tt) > 50
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=0.01 * VOXEL[0])
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(),
                                                    0)


def test_render_sigma_matches_the_jax_package(meshes, pipes):
    """render_sigma on points off the grid (random, across the cull shell)
    against the JAX render_sigma_dense: culled points exactly 0."""
    jpipe, params, tpipe = pipes
    _, _, _, jframe, tframe, bounds = meshes
    rng = np.random.default_rng(5)
    pts = rng.uniform(bounds[0], bounds[1], (1000, 3)).astype(np.float32)
    got = tpipe.render_sigma(tframe, torch.from_numpy(pts)).numpy()
    cp = jpipe.chunk_rays * jpipe.n_samples
    pad = (-len(pts)) % cp
    mask = np.arange(len(pts) + pad) < len(pts)
    want, over = jpipe.render_sigma_dense(
        params, jframe, np.pad(pts, ((0, pad), (0, 0))), mask)
    want = np.asarray(want)[:len(pts)]
    assert int(np.asarray(over)[0]) == 0
    assert np.abs(got - want).max() <= SIGMA_ATOL
    np.testing.assert_array_equal(got == 0, want == 0)
    d = torch.cdist(torch.from_numpy(pts).double(),
                    tframe.tar_verts_smpl.double()).min(dim=1).values
    far = (d > tpipe.cull_distance + 1e-5).numpy()
    assert far.any() and (~far).any()
    assert (got[far] == 0).all()
    assert tpipe.last_frame_stats == {"points": 1000,
                                      "survivors": int((got != 0).sum())}


def test_render_sigma_reads_a_zero_view_code(meshes, pipes, monkeypatch):
    """The view code is a zero vector of width 6 * view_freqs + 3, as the
    JAX package's (jnp.zeros), not embed_viewdir of a zero direction, whose
    cos terms are 1; sigma does not read it, so only this pins it."""
    tpipe = pipes[2]
    tframe = meshes[4]
    seen = []
    decode = type(tpipe.model).decode

    def spy(self, rep, pix, vde, mask=None):
        seen.append(vde.clone())
        return decode(self, rep, pix, vde, mask)

    monkeypatch.setattr(type(tpipe.model), "decode", spy)
    pts = torch.from_numpy(tframe.verts_world.numpy()[:300] + 0.01)
    tpipe.render_sigma(tframe, pts)
    assert seen and all(v.shape[-1] == 6 * tpipe.model.view_freqs + 3
                        and not v.any() for v in seen)


def test_render_sigma_truncates_and_chunks(meshes, pipes):
    """With use_truncation, points whose nearest cluster centre is knn_sigma
    or farther decode to 0; the chunking (here 256 points) leaves sigma as
    one chunk of everything gives."""
    tpipe = pipes[2]
    tframe, bounds = meshes[4], meshes[5]
    rng = np.random.default_rng(6)
    pts = torch.from_numpy(rng.uniform(bounds[0], bounds[1], (700, 3))
                           .astype(np.float32))
    base = tpipe.render_sigma(tframe, pts)
    whole = RenderPipeline.__new__(RenderPipeline)
    whole.__dict__.update(tpipe.__dict__)
    whole.chunk_rays = 1000
    np.testing.assert_allclose(whole.render_sigma(tframe, pts).numpy(),
                               base.numpy(), rtol=0, atol=1e-5)
    centers = tpipe.prologue(tframe).centers
    d0 = torch.cdist(pts.double(), centers.double()).min(dim=1).values
    ks = float(d0[base != 0].median())
    net = tpipe.model
    saved = net.use_truncation, net.knn_sigma
    net.use_truncation, net.knn_sigma = True, ks
    try:
        got = tpipe.render_sigma(tframe, pts)
    finally:
        net.use_truncation, net.knn_sigma = saved
    off = (d0 > ks + 1e-5) | (base == 0)
    on = (d0 < ks - 1e-5) & (base != 0)
    assert on.any() and (off & (base != 0)).any()
    assert (got[off] == 0).all()
    np.testing.assert_array_equal(got[on].numpy(), base[on].numpy())


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 1-step checkpoint written by the train entry point on the CPU."""
    root = tmp_path_factory.mktemp("cli")
    opts = list(OPTS) + ["patch.size", "6", "patch.N_patches", "2",
                         "trained_model_dir", str(root / "tm"),
                         "result_dir", str(root / "res"),
                         "kmeans_dir", str(root / "none"),
                         "voxel_size", "[0.04, 0.04, 0.04]",
                         "dataset", "synthetic", "ep_iter", "1",
                         "record_dir", str(root / "rec")]
    train_cli.main(["--device", "cpu", "--steps", "1", *opts])
    return root, opts


def test_run_entry_point_reconstructs_and_voxelizes(trained, capsys):
    root, opts = trained
    paths = run_cli.main(["--type", "reconstruction", "--device", "cpu",
                          *opts, "mesh_th", "1e9"])
    assert len(paths) == 1 and paths[0].endswith(
        "epoch_-1/debug/mesh/synthetic_frame0000.ply")
    v, t = ply.load_ply(paths[0])
    assert len(v) == len(t) == 0  # no sigma reaches 1e9
    _, bounds, _ = SyntheticDataset(Config().merge_opts(opts), "test",
                                    image_hw=(HW, HW)).get_mesh_item(0)
    # an iso-level the 1-step model's sigma (~10, the init's bias) crosses
    paths = run_cli.main(["--type", "reconstruction", "--device", "cpu",
                          *opts, "mesh_th", "5"])
    v, t = ply.load_ply(paths[0])
    assert len(t) > 100 and t.max() < len(v)
    lo = bounds[0] - 10 * 0.04
    hi = bounds[1] + 10 * 0.04
    assert (v >= lo - 1e-4).all() and (v <= hi + 1e-4).all()
    log = capsys.readouterr().out
    assert f"wrote {paths[0]} ({len(v)} verts, {len(t)} tris)" in log

    out = run_cli.main(["--type", "light_stage", "--ply", paths[0],
                        "--device", "cuda", *opts])
    assert out == paths[0] + ".occupancy.npy"
    d = np.load(out, allow_pickle=True).item()
    assert d["voxel"] == 0.04
    want, origin = jvox.voxelize(v, t, 0.04)
    np.testing.assert_array_equal(d["occupancy"], want)
    np.testing.assert_array_equal(d["origin"], origin)
    occ = d["occupancy"]
    assert occ.any()
    assert not (occ[0].any() or occ[-1].any() or occ[:, 0].any()
                or occ[:, -1].any() or occ[:, :, 0].any()
                or occ[:, :, -1].any())
    custom = str(root / "occ.npy")
    assert run_cli.main(["--type", "light_stage", "--ply", paths[0],
                         "--occupancy_out", custom, *opts]) == custom


def test_mesh_video_of_a_reconstructed_ply(trained, tmp_path):
    """A PLY the run entry point reconstructs: the port's rasterizer equals
    the JAX package's bit for bit on it (and its numpy route within the JAX
    test's bounds); tools/render_mesh_video renders it along the spherical
    path and writes one PNG per mesh and their AVI."""
    from tests.test_avi_writer import parse_avi
    from tests.test_torch_native import cameras, check_rasterizer
    from tests.test_torch_zju import _camera
    from transhuman_tpu_torch.data.image_io import read_png
    from transhuman_tpu_torch.tools import render_mesh_video

    root, opts = trained
    ply_path = run_cli.main(["--type", "reconstruction", "--device", "cpu",
                             *opts, "mesh_th", "5"])[0]
    v, t = ply.load_ply(ply_path)
    assert len(t) > 100
    centred = (v - v.mean(0)).astype(np.float32)
    check_rasterizer(centred, t, cameras(0))  # one view: _render_np is slow

    mesh_dir = tmp_path / "mesh"
    mesh_dir.mkdir()
    for i in range(2):
        ply.save_ply(str(mesh_dir / f"f{i}.ply"), centred, t)
    cams = {"K": [], "R": [], "T": [], "D": []}
    for c in range(4):
        K, R, T = _camera(c, 4)
        for k, x in zip("KRTD", (K, R, T, np.zeros((5, 1)))):
            cams[k].append(x)
    np.save(tmp_path / "annots.npy", {"cams": cams, "ims": []})
    out = render_mesh_video.main([
        "--mesh_dir", str(mesh_dir), "--annots", str(tmp_path / "annots.npy"),
        "--ratio", "1.0", "--hw", "64", "64", "--render_views", "8",
        str(tmp_path / "video")])
    assert out == str(tmp_path / "video" / "mesh.avi")
    frames = sorted(p for p in os.listdir(tmp_path / "video")
                    if p.endswith(".png"))
    assert frames == ["mesh0000.png", "mesh0001.png"]
    assert read_png(str(tmp_path / "video" / frames[0])).shape == (64, 64, 3)
    assert len(parse_avi(out)["frames"]) == 2
