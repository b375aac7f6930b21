"""Each module of the PyTorch port against its JAX counterpart, on the same
numpy inputs and, for the network, the same weights: the Flax parameters
bridged with ``weights.state_dict_from_jax`` and loaded strictly.  All in
float32 on the CPU; tolerances are stated where they are looser than 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transhuman_tpu import config as jcfg
from transhuman_tpu.data import ray_sampling as jrs
from transhuman_tpu.geometry import clusters as jclusters
from transhuman_tpu.geometry import rays as jrays
from transhuman_tpu.geometry import smpl as jsmpl
from transhuman_tpu.models import embedder as jemb
from transhuman_tpu.models import layers as jlayers
from transhuman_tpu.models.network import TransHumanNet as JNet
from transhuman_tpu.ops import sampling as jsampling
from transhuman_tpu.render import volume as jvolume
from transhuman_tpu.tools.convert_checkpoint import (
    reference_pe_table as tool_pe_table,
)
from transhuman_tpu_torch import config as tcfg
from transhuman_tpu_torch import weights
from transhuman_tpu_torch.data import ray_sampling as trs
from transhuman_tpu_torch.geometry import clusters as tclusters
from transhuman_tpu_torch.geometry import rays as trays
from transhuman_tpu_torch.geometry import smpl as tsmpl
from transhuman_tpu_torch.models import embedder as temb
from transhuman_tpu_torch.models import layers as tlayers
from transhuman_tpu_torch.models.network import TransHumanNet as TNet
from transhuman_tpu_torch.ops import sampling as tsampling
from transhuman_tpu_torch.render import volume as tvolume

V, HW, EMBED, DEPTH, HEADS, C, K = 2, 32, 24, 2, 2, 12, 4


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def nets():
    """(jax model, params, port model) sharing bridged weights."""
    rng = np.random.default_rng(3)
    jnet = JNet(embed_dim=EMBED, vit_depth=DEPTH, vit_heads=HEADS, knn_k=K)
    images = rng.random((V, HW, HW, 3), dtype=np.float32)
    params = jnet.init(
        jax.random.PRNGKey(0), jnp.asarray(images), jnp.zeros((C, 3)),
        jnp.zeros((8, 3)), jnp.zeros((C, 3)), jnp.zeros((C, 3, 3)),
        jnp.zeros((8, 27)),
    )
    sd = weights.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]), DEPTH)
    tnet = TNet(embed_dim=EMBED, vit_depth=DEPTH, vit_heads=HEADS, knn_k=K)
    weights.load_reference_state_dict(tnet, sd)
    return jnet, params, tnet.eval(), sd


def test_bridge_is_the_reference_layout_and_strict(nets):
    _, _, tnet, sd = nets
    live = weights.live_state_dict(sd)
    assert set(tnet.state_dict()) == set(live)
    assert len(sd) > len(live)  # dead reference keys were dropped
    bad = dict(live, extra_key=torch.zeros(1))
    with pytest.raises(RuntimeError, match="extra_key"):
        weights.load_reference_state_dict(tnet, bad)
    missing = {k: v for k, v in live.items() if k != "fc_1.bias"}
    with pytest.raises(RuntimeError, match="fc_1.bias"):
        weights.load_reference_state_dict(tnet, missing)


def test_checkpoint_file_roundtrip(nets, tmp_path):
    _, _, tnet, sd = nets
    path = tmp_path / "w.pth"
    torch.save({"net": {"module." + k: v for k, v in sd.items()},
                "epoch": 7}, path)
    other = TNet(embed_dim=EMBED, vit_depth=DEPTH, vit_heads=HEADS, knn_k=K)
    assert weights.load_checkpoint_file(other, str(path)) == 7
    for k, v in other.state_dict().items():
        torch.testing.assert_close(v, tnet.state_dict()[k], rtol=0, atol=0)


def test_vendored_checkpoint_mappings_equal_the_jax_package(nets):
    """The port's copies of the numpy-only mappings give the JAX package's
    results bit for bit, both ways, on a tiny model's init parameters."""
    from transhuman_tpu.tools import convert_checkpoint as jconv
    from transhuman_tpu.tools import export_checkpoint as jexp
    from transhuman_tpu_torch.tools import convert_checkpoint as tconv
    from transhuman_tpu_torch.tools import export_checkpoint as texp

    _, params, _, _ = nets
    tree = jax.tree_util.tree_map(np.asarray, params["params"])
    want, got = jexp.export_state_dict(tree, DEPTH), texp.export_state_dict(
        tree, DEPTH)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back_j = jconv.convert_state_dict(want, strict=True)
    back_t = tconv.convert_state_dict(got, strict=True)
    flat_j = jax.tree_util.tree_leaves_with_path(back_j)
    flat_t = jax.tree_util.tree_leaves_with_path(back_t)
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, a), (_, b) in zip(flat_t, flat_j):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # and the round trip gives the init parameters back
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(back_t["params"]),
            jax.tree_util.tree_leaves_with_path(tree)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert (tconv.official_key_inventory(DEPTH)
            == jconv.official_key_inventory(DEPTH))
    assert tconv.DROP_PATTERNS == jconv.DROP_PATTERNS


def test_encoder_matches_flax(nets, rng):
    """Tolerance 2e-4, as tests/test_convert_parity.py: batch-statistic
    normalisation of random activations divides by small variances."""
    jnet, params, tnet, _ = nets
    x = rng.random((V, HW, HW, 3), dtype=np.float32)
    jh, jp = jnet.apply(params, jnp.asarray(x), method="encode_views")
    with torch.no_grad():
        th, tp = tnet.encode_views(_t(x))
    np.testing.assert_allclose(tp.numpy(), _np(jp), atol=2e-4)
    np.testing.assert_allclose(th.numpy(), _np(jh), atol=2e-4)


def test_transhe_matches_flax(nets, rng):
    jnet, params, tnet, _ = nets
    tokens = rng.standard_normal((V, C, EMBED)).astype(np.float32)
    pe = weights.reference_pe_table(
        rng.uniform(-1, 1, (C, 3)).astype(np.float32), EMBED)
    want = jnet.apply(params, jnp.asarray(tokens), jnp.asarray(pe),
                      method="refine_tokens")
    with torch.no_grad():
        got = tnet.refine_tokens(_t(tokens), _t(pe))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4)


def test_heads_match_flax(nets, rng):
    jnet, params, tnet, _ = nets
    n = 50
    rep = rng.standard_normal((V, n, EMBED + 63)).astype(np.float32)
    pix = rng.standard_normal((V, n, 384)).astype(np.float32)
    vde = rng.standard_normal((n, 27)).astype(np.float32)
    mask = rng.random(n) < 0.7
    want = jnet.apply(params, *map(jnp.asarray, (rep, pix, vde, mask)),
                      method="decode")
    with torch.no_grad():
        got = tnet.decode(_t(rep), _t(pix), _t(vde), _t(mask))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4)
    assert (got.numpy()[~mask] == 0).all()


def test_network_query_matches_flax(nets, rng):
    jnet, params, tnet, _ = nets
    n = 40
    pts = (rng.standard_normal((n, 3)) * 0.3).astype(np.float32)
    centers = (rng.standard_normal((C, 3)) * 0.3).astype(np.float32)
    rot = np.stack([np.linalg.qr(m)[0] for m in
                    rng.standard_normal((C, 3, 3))]).astype(np.float32)
    tokens = rng.standard_normal((V, C, EMBED)).astype(np.float32)
    pix = rng.standard_normal((V, n, 384)).astype(np.float32)
    vde = rng.standard_normal((n, 27)).astype(np.float32)
    args = (pts, centers, rot, tokens, pix, vde)
    want = jnet.apply(params, *map(jnp.asarray, args), method="query")
    with torch.no_grad():
        got = tnet.query(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4)


def test_layers_match_flax(rng):
    x = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)  # NHWC
    bn = jlayers.BatchStatNorm()
    jp = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32), jp)
    want = bn.apply(jp, jnp.asarray(x))
    tbn = tlayers.BatchStatNorm(5)
    tbn.weight.data = _t(_np(jp["params"]["scale"]))
    tbn.bias.data = _t(_np(jp["params"]["bias"]))
    xt = _t(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        np.testing.assert_allclose(
            tbn(xt).permute(0, 2, 3, 1).numpy(), _np(want), atol=1e-5)
    up = tlayers.upsample_align_corners(xt, (20, 23)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(
        up.numpy(), _np(jlayers.upsample_align_corners(jnp.asarray(x),
                                                       (20, 23))), atol=1e-5)
    mp = tlayers.max_pool_3x3_s2(xt).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(
        mp.numpy(), _np(jlayers.max_pool_3x3_s2(jnp.asarray(x))))


def test_embedders_match_jax(rng):
    x = rng.uniform(-2, 2, (17, 3)).astype(np.float32)
    np.testing.assert_allclose(temb.embed_viewdir(_t(x)).numpy(),
                               _np(jemb.embed_viewdir(jnp.asarray(x))),
                               atol=1e-6)
    # the pi*2^9 band: |x| <= 2 gives arguments up to ~3.2e3, so sin/cos
    # of two libms differ by a few ulp of the argument
    np.testing.assert_allclose(temb.embed_dparf(_t(x)).numpy(),
                               _np(jemb.embed_dparf(jnp.asarray(x))),
                               atol=2e-4)


def test_sampling_matches_jax(rng):
    K = np.array([[[30, 0, 16], [0, 28, 15], [0, 0, 1]]] * 2, np.float32)
    R = np.stack([np.linalg.qr(m)[0] for m in rng.standard_normal((2, 3, 3))]
                 ).astype(np.float32)
    T = np.array([[0, 0, 2.5], [0.1, 0, 2.4]], np.float32)
    xyz = rng.standard_normal((300, 3)).astype(np.float32)
    xyz[0] = -T[0] @ R[0]  # on camera 0's centre: the |z| clamp
    juv, jz = jsampling.project_points(*map(jnp.asarray, (xyz, K, R, T)))
    tuv, tz = tsampling.project_points(*map(_t, (xyz, K, R, T)))
    np.testing.assert_allclose(tz.numpy(), _np(jz), atol=1e-5)
    assert np.isfinite(tuv.numpy()).all()
    ok = np.abs(_np(jz)) > 1e-2  # off the principal planes, where uv is
    # a well-conditioned quotient
    np.testing.assert_allclose(tuv.numpy()[ok], _np(juv)[ok], rtol=1e-5,
                               atol=1e-4)
    # non-square map, uv inside and outside the image
    feat = rng.standard_normal((2, 7, 9, 5)).astype(np.float32)
    uv = rng.uniform(-5, 40, (2, 300, 2)).astype(np.float32)
    want = jsampling.sample_feature_map(jnp.asarray(feat), jnp.asarray(uv),
                                        (28, 36))
    got = tsampling.sample_feature_map(_t(feat), _t(uv), (28, 36))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)


def test_volume_matches_jax(rng):
    r, s = 40, 9
    o = rng.standard_normal((r, 3)).astype(np.float32)
    d = rng.standard_normal((r, 3)).astype(np.float32)
    near = rng.uniform(1, 2, r).astype(np.float32)
    far = near + rng.uniform(0.5, 2, r).astype(np.float32)
    jp, jz = jvolume.sample_along_rays(*map(jnp.asarray, (o, d, near, far)),
                                       s)
    tp, tz = tvolume.sample_along_rays(*map(_t, (o, d, near, far)), s)
    np.testing.assert_allclose(tz.numpy(), _np(jz), atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), _np(jp), atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    _, jit_z = tvolume.sample_along_rays(*map(_t, (o, d, near, far)), s,
                                         generator=gen)
    mids = 0.5 * (tz[:, 1:] + tz[:, :-1])
    assert (jit_z[:, 1:] >= mids - 1e-6).all()
    assert (jit_z[:, :-1] <= mids + 1e-6).all()

    raw = rng.standard_normal((r, s, 4)).astype(np.float32) * 3
    for white in (False, True):
        want = jvolume.composite(jnp.asarray(raw), jz, jnp.asarray(d), white)
        got = tvolume.composite(_t(raw), tz, _t(d), white)
        for key in ("rgb_map", "acc_map", "depth_map", "weights"):
            np.testing.assert_allclose(got[key].numpy(), _np(want[key]),
                                       atol=1e-5, err_msg=key)


def test_geometry_equals_the_jax_package(rng):
    js, ts = jsmpl.SMPLModel.synthetic(n_verts=500), tsmpl.SMPLModel.synthetic(
        n_verts=500)
    for f in ("v_template", "shapedirs", "posedirs", "J_regressor", "weights",
              "parent", "faces"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    pose, beta = rng.normal(0, 0.3, 72), rng.normal(0, 1, 10)
    for a, b in zip(ts(pose, beta), js(pose, beta)):
        np.testing.assert_array_equal(a, b)
    jc = jclusters.ClusterSpec.from_kmeans(js.v_template, 20, iters=5)
    tc = tclusters.ClusterSpec.from_kmeans(ts.v_template, 20, iters=5)
    np.testing.assert_array_equal(tc.vert2cluster, jc.vert2cluster)
    np.testing.assert_array_equal(tc.pool_matrix, jc.pool_matrix)
    np.testing.assert_array_equal(
        tclusters.normalize_positions(ts.v_template, 1.5),
        jclusters.normalize_positions(js.v_template, 1.5))
    for big in (False, True):
        np.testing.assert_array_equal(trays.world_bounds(ts.v_template, big),
                                      jrays.world_bounds(js.v_template, big))


def test_eval_rays_match_jax():
    """The port's dense six-plane test gives the JAX package's projected-hull
    rays exactly."""
    smpl = tsmpl.SMPLModel.synthetic(n_verts=400)
    K = np.array([[40, 0, 24], [0, 40, 20], [0, 0, 1]], np.float32)
    th = 0.4
    R = np.array([[np.cos(th), 0, -np.sin(th)], [0, 1, 0],
                  [np.sin(th), 0, np.cos(th)]], np.float32)
    T = np.array([[0.05], [0.1], [2.6]], np.float32)
    bounds = trays.world_bounds(smpl.v_template, False)
    j = jrs.sample_eval_rays(None, K, R, T, bounds, hw=(40, 48))
    t = trs.sample_eval_rays(None, K, R, T, bounds, hw=(40, 48))
    assert t.pix_idx.size > 100
    np.testing.assert_array_equal(t.pix_idx, j.pix_idx)
    np.testing.assert_array_equal(t.mask_at_box, j.mask_at_box)
    for f in ("ray_o", "ray_d", "near", "far", "mask"):
        np.testing.assert_array_equal(getattr(t.rays, f).numpy(),
                                      np.asarray(getattr(j.rays, f)))


def test_pe_table_equals_the_converter_tool(rng):
    x = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    for d in (24, 192):
        np.testing.assert_array_equal(weights.reference_pe_table(x, d),
                                      tool_pe_table(x, d))


def _assert_fields_equal(t, j, path=""):
    """Every field of the port's config section t equals the JAX package's
    field of the same name, nested sections field by field."""
    for f in tcfg.dataclasses.fields(t):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if tcfg.dataclasses.is_dataclass(tv):
            _assert_fields_equal(tv, jv, f"{path}{f.name}.")
        else:
            assert tv == jv, path + f.name


def test_config_defaults_equal_the_jax_package():
    j, t = jcfg.Config(), tcfg.Config()
    _assert_fields_equal(t, j)
    assert t.test.input_view == j.test.input_view
    assert (t.mesh_th, t.voxel_size) == (j.mesh_th, j.voxel_size)
    assert (t.H_render, t.W_render) == (j.H_render, j.W_render)
    o = t.merge_opts(["H", "64", "ratio", "0.25", "white_bkgd", "True",
                      "test.input_view", "0,7", "pad_bucket", "64"])
    assert (o.H_render, o.white_bkgd, o.test.input_view) == (16, True, [0, 7])
    assert t.H == 1024 and t.test.input_view == [0, 7, 15]  # t unchanged
    with pytest.raises(ValueError, match="unknown"):
        t.merge_opts(["no_such_key", "1"])
    o = t.merge_opts(["train.scheduler.warmup_epochs", "2", "patch.size",
                      "8", "perturb", "0", "train.optim", "sgd"])
    assert (o.train.scheduler.warmup_epochs, o.patch.size, o.perturb,
            o.train.optim) == (2, 8, 0.0, "sgd")
    assert t.train.scheduler.warmup_epochs == 300 and t.patch.size == 20
