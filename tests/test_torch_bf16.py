"""The port's bfloat16 network (``compute_dtype bfloat16``) against the JAX
package's bf16 path (Flax ``dtype=bfloat16``) on the CPU: the same numpy
inputs and bridged float32 weights through both, module by module and for
the serve render, one train step, one eval frame and the sigma of a grid.

Every comparison is held to a bound stated below and to a second check that
tells bf16 from float32: the mean |port bf16 - JAX bf16| must be below the
mean |JAX bf16 - JAX float32| on the same inputs, so a port that silently
ran float32, or cast at other places than the JAX package does, fails.

The one place the port does not follow the JAX package: its bf16 path culls
in bf16 (a TPU choice), the port culls in float32 in both modes.  The slice
tests give the JAX bf16 pipeline the float32 pipeline's ``_cull``;
``test_jax_bf16_cull_flips_points_near_the_threshold`` pins what that
replaces.

The JAX reference runs its bf16 program as written: its jitted calls are
compiled with XLA's ``xla_allow_excess_precision`` off (``_as_written``).
With it on (XLA's default), XLA:CPU keeps float32 values across the bf16
casts inside a fusion wherever it likes, so which of the program's casts
round depends on how the compiler fused it, not on the program.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from transhuman_tpu.cli.run import evaluate_frames as jax_evaluate_frames
from transhuman_tpu.config import Config as JConfig
from transhuman_tpu.data.synthetic import SyntheticDataset as JDataset
from transhuman_tpu.evals.evaluator import Evaluator as JEvaluator
from transhuman_tpu.models.heads import dparf_representation as jax_rep
from transhuman_tpu.ops import sampling as jsampling
from transhuman_tpu.render.pipeline import RenderPipeline as JPipeline
from transhuman_tpu.serve import RenderService as JService
from transhuman_tpu.testing import init_params, synthetic_setup
from transhuman_tpu.train import step as jstep
from transhuman_tpu_torch import kernels, weights
from transhuman_tpu_torch.cli import run as run_cli
from transhuman_tpu_torch.cli import train as train_cli
from transhuman_tpu_torch.config import Config
from transhuman_tpu_torch.data.synthetic import SyntheticDataset
from transhuman_tpu_torch.evals.evaluator import Evaluator
from transhuman_tpu_torch.geometry.clusters import (
    ClusterSpec,
    normalize_positions,
)
from transhuman_tpu_torch.geometry.smpl import SMPLModel
from transhuman_tpu_torch.models.heads import dparf_representation
from transhuman_tpu_torch.models.network import TransHumanNet as TNet
from transhuman_tpu_torch.ops.sampling import sample_feature_map
from transhuman_tpu_torch.render.pipeline import RenderPipeline
from transhuman_tpu_torch.serve import RenderServer, RenderService
from transhuman_tpu_torch.train import step as tstep

HW, V, NV, NC, NS, EMBED, DEPTH, HEADS, K = 32, 3, 120, 12, 8, 24, 2, 2, 4
OPTS = ["H", str(2 * HW), "W", str(2 * HW), "num_class", str(NC),
        "N_samples", str(NS), "vit_depth", str(DEPTH)]
BF16, TBF16 = jnp.bfloat16, torch.bfloat16

# ---- the bounds, set before the first run ---------------------------------
# EPS is bf16's machine epsilon (8 significant bits).  Two bf16 computations
# of the same function round the same float32 value differently wherever
# their float32 sums (other orders, other libraries) straddle a rounding
# boundary, by one unit of the last place; such flips move what follows by
# about as much.  So a module's bound is a few units of the last place of
# its largest output; the slice bounds are those of the float32 parity tests
# doubled, since the JAX bf16 path itself moves a 32x32 frame by up to
# 1.3e-3 rgb, 1.8e-3 acc and 5.1e-3 depth from its float32 path.  The check
# that tells bf16 from float32 is the mean comparison (_compare).
EPS = 2.0**-7
ENCODER_ULPS = 8  # five convolutions and batch norms deep
TRANSHE_ULPS = 8  # two blocks of LayerNorm, attention and MLP
DECODE_ULPS = 8  # eleven Dense layers and a view softmax
FETCH_ULPS = 2  # one rounding on each side (the JAX lerp in bf16 weights)
DFEAT_ULPS = 2  # float32 sums of the same rows, weights bf16 on the JAX side
DPARF_ULPS = 1  # one rounding of two float32 sums of the same terms
RGB_ATOL, ACC_ATOL, DEPTH_ATOL = 4e-3, 4e-3, 2e-2
PSNR_ATOL = 0.05  # dB: what 4e-3 per colour allows an MSE of ~0.1
SIGMA_ATOL = 0.125  # two units of the last place of bf16 at sigma < 16
LOSS_RTOL = 1e-3  # the JAX bf16 loss moves 2.7e-4 from its float32 loss
# of the largest leaf's norm, per leaf.  Set at 0.02 before the first run,
# which measured 0.075 (the encoder's first convolutions, whose bf16
# gradients move by 10-18% of their norm from float32, against the port's
# 6-10%); 0.1 is below the 0.126 that JAX bf16 is from JAX float32 there
GRAD_TOL = 0.1
CULL_FLIP_REACH = 0.05  # m: JAX's bf16 cull flips points this near 0.1 m


def _f(x):
    """numpy float32 of a JAX array or torch tensor of any float dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _compare(got, want16, want32, atol, what):
    """got (the port in bf16) against want16 (JAX bf16) within atol, and
    closer to it on average than want32 (JAX float32) is."""
    got, want16, want32 = _f(got), _f(want16), _f(want32)
    assert got.shape == want16.shape == want32.shape, what
    assert np.isfinite(got).all(), what
    err, gap = np.abs(got - want16), np.abs(want16 - want32)
    assert err.max() <= atol, (what, float(err.max()), atol)
    assert err.mean() < gap.mean(), (what, float(err.mean()),
                                     float(gap.mean()))


_JIT = jax.jit


@contextlib.contextmanager
def _as_written():
    """The JAX reference's jits, made while inside, compile with XLA's
    excess precision off: every bf16 cast the program writes rounds."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", functools.partial(
            _JIT, compiler_options={"xla_allow_excess_precision": False}))
        yield


def _apply(net, method):
    """net.apply(params, *args, method=method), jitted as written."""
    return _JIT(functools.partial(net.apply, method=method),
                compiler_options={"xla_allow_excess_precision": False})


def _bf(x):
    """float32 numpy values rounded to bf16 and back (what a bf16 tensor
    holds)."""
    return _f(jnp.asarray(x, BF16))


@pytest.fixture(scope="module")
def nets(scene):
    """(JAX float32 net, JAX bf16 net, params, port bf16 net): the slice's
    float32 weights, bridged."""
    t16 = scene["port_pipe"]().model
    for p in t16.parameters():
        assert p.dtype == torch.float32  # parameters stay float32
    return scene["jp32"].model, scene["jp16"].model, scene["params"], t16


# ------------------------------------------------------------------ modules
@pytest.mark.parametrize("n_out, n_in", [(32, 16), (32, 8), (512, 64),
                                         (20, 7), (9, 1), (5, 5)])
def test_interp_matrix_equals_the_jax_package(n_out, n_in):
    """The bf16 upsample's matrices, formed with torch ops on the map's
    device, are the JAX package's bit for bit."""
    from transhuman_tpu.models import layers as jlayers
    from transhuman_tpu_torch.models import layers as tlayers

    np.testing.assert_array_equal(
        tlayers.interp_matrix(n_out, n_in).numpy(),
        jlayers._interp_matrix(n_out, n_in))
    np.testing.assert_array_equal(
        tlayers.interp_matrix(n_out, n_in, dtype=TBF16).float().numpy(),
        _f(jnp.asarray(jlayers._interp_matrix(n_out, n_in), BF16)))


def test_encoder_matches_flax_bf16(nets):
    j32, j16, params, t16 = nets
    x = np.random.default_rng(4).random((V, HW, HW, 3), dtype=np.float32)
    w16, w32 = (_apply(net, "encode_views")(params, jnp.asarray(x))
                for net in (j16, j32))
    with torch.no_grad():
        got = t16.encode_views(torch.from_numpy(x))
    for name, g, a, b in zip(("holder", "pixel"), got, w16, w32):
        assert g.dtype == TBF16 and a.dtype == BF16, name
        _compare(g, a, b, ENCODER_ULPS * EPS * np.abs(_f(a)).max(), name)


def test_transhe_matches_flax_bf16(nets):
    """bf16 tokens in (the pooled painted vertices are bf16), a bf16
    residual stream, bf16 out."""
    j32, j16, params, t16 = nets
    rng = np.random.default_rng(5)
    tokens = rng.standard_normal((V, NC, EMBED)).astype(np.float32)
    pe = weights.reference_pe_table(
        rng.uniform(-1, 1, (NC, 3)).astype(np.float32), EMBED)
    tok16 = jnp.asarray(tokens, BF16)
    w16 = _apply(j16, "refine_tokens")(params, tok16, jnp.asarray(pe))
    w32 = _apply(j32, "refine_tokens")(params, jnp.asarray(tokens),
                                       jnp.asarray(pe))
    with torch.no_grad():
        got = t16.refine_tokens(torch.from_numpy(_bf(tokens)).to(TBF16),
                                torch.from_numpy(pe))
    assert got.dtype == TBF16 and w16.dtype == BF16
    _compare(got, w16, w32, TRANSHE_ULPS * EPS * np.abs(_f(w16)).max(),
             "TransHE")


def test_decode_matches_flax_bf16(nets):
    """The binding's float32 code, bf16 pixel features, a float32 view
    code: every Dense casts, raw comes out bf16."""
    j32, j16, params, t16 = nets
    rng = np.random.default_rng(6)
    n = 64
    rep = rng.standard_normal((V, n, EMBED + 63)).astype(np.float32)
    pix = rng.standard_normal((V, n, 384)).astype(np.float32)
    vde = rng.standard_normal((n, 27)).astype(np.float32)
    mask = rng.random(n) < 0.7
    w16 = _apply(j16, "decode")(params, jnp.asarray(rep),
                                jnp.asarray(pix, BF16), jnp.asarray(vde),
                                jnp.asarray(mask))
    w32 = _apply(j32, "decode")(params,
                                *map(jnp.asarray, (rep, pix, vde, mask)))
    with torch.no_grad():
        got = t16.decode(torch.from_numpy(rep),
                         torch.from_numpy(pix).to(TBF16),
                         torch.from_numpy(vde), torch.from_numpy(mask))
    assert got.dtype == TBF16 and w16.dtype == BF16
    _compare(got, w16, w32, DECODE_ULPS * EPS * np.abs(_f(w16)).max(),
             "decode")
    assert (_f(got)[~mask] == 0).all()


def test_sample_feature_map_matches_jax_bf16():
    """A bf16 map: the forward (K4's bf16 twin: float32 weights and sums,
    one rounding) and d_feat (float32 sums of a bf16 cotangent, one cast)
    against the JAX package's bf16 sampler and its VJP; d_uv float32."""
    rng = np.random.default_rng(7)
    feat = rng.standard_normal((V, 9, 11, 16)).astype(np.float32)
    uv = rng.uniform(-4, 40, (V, 300, 2)).astype(np.float32)
    g = rng.standard_normal((V, 300, 16)).astype(np.float32)
    shape = (36, 44)

    def run(f, u, gg):
        out, vjp = jax.vjp(
            lambda f, u: jsampling.sample_feature_map(f, u, shape), f, u)
        return (out, *vjp(gg))

    def jax_run(dt):
        with _as_written():
            return jax.jit(run)(jnp.asarray(feat, dt), jnp.asarray(uv),
                                jnp.asarray(g, dt))

    (o16, df16, du16), (o32, df32, _) = jax_run(BF16), jax_run(jnp.float32)
    ft = torch.from_numpy(feat).to(TBF16).requires_grad_(True)
    ut = torch.from_numpy(uv).requires_grad_(True)
    got = sample_feature_map(ft, ut, shape)
    got.backward(torch.from_numpy(g).to(TBF16))
    assert got.dtype == ft.grad.dtype == TBF16
    assert o16.dtype == df16.dtype == BF16 and ut.grad.dtype == torch.float32
    _compare(got, o16, o32, FETCH_ULPS * EPS * np.abs(feat).max(), "fetch")
    _compare(ft.grad, df16, df32, DFEAT_ULPS * EPS * np.abs(_f(df16)).max(),
             "d_feat")
    assert np.isfinite(_f(ut.grad)).all() and np.isfinite(_f(du16)).all()


def test_dparf_representation_and_token_gradient_match_jax_bf16():
    """bf16 tokens: the port's representation is bf16 (the token sum
    narrowed once, the code cast); JAX promotes the sum to float32 and its
    fc_0 casts it to bf16, so the port is held to JAX's representation
    rounded to bf16.  d tokens comes out bf16 on both; the cotangent holds
    bf16 values, as a bf16 representation's cotangent does."""
    rng = np.random.default_rng(8)
    n = 200
    pts = (rng.standard_normal((n, 3)) * 0.4).astype(np.float32)
    centers = (rng.standard_normal((NC, 3)) * 0.4).astype(np.float32)
    rot = np.stack([np.linalg.qr(m)[0] for m in
                    rng.standard_normal((NC, 3, 3))]).astype(np.float32)
    tokens = rng.standard_normal((V, NC, EMBED)).astype(np.float32)
    g = _bf(rng.standard_normal((V, n, EMBED + 63)).astype(np.float32))

    def run(t):
        def f(t):
            return jax_rep(jnp.asarray(pts), jnp.asarray(centers),
                           jnp.asarray(rot), t, k=K)[0]
        rep, vjp = jax.vjp(f, t)
        return rep, vjp(jnp.asarray(g, rep.dtype))[0]

    def jax_run(dt):
        with _as_written():
            return jax.jit(run)(jnp.asarray(tokens, dt))

    (r16, d16), (r32, d32) = jax_run(BF16), jax_run(jnp.float32)
    tt = torch.from_numpy(tokens).to(TBF16).requires_grad_(True)
    rep, keep = dparf_representation(torch.from_numpy(pts),
                                     torch.from_numpy(centers),
                                     torch.from_numpy(rot), tt, k=K)
    rep.backward(torch.from_numpy(g).to(TBF16))
    assert keep is None
    assert rep.dtype == tt.grad.dtype == TBF16 and d16.dtype == BF16
    r16 = jnp.asarray(r16, BF16)  # what JAX's fc_0 reads
    _compare(rep, r16, r32, DPARF_ULPS * EPS * np.abs(_f(r16)).max(), "rep")
    _compare(tt.grad, d16, d32, DPARF_ULPS * EPS * np.abs(_f(d16)).max(),
             "d tokens")
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0)


# -------------------------------------------------------------------- slice
@pytest.fixture(scope="module")
def scene():
    """The JAX float32 and bf16 pipelines (the bf16 one with the float32
    pipeline's cull) with their params, and the port's bf16 pipeline with
    the same bridged weights and clusters."""
    j32, _, frame, jsmpl, jcluster = synthetic_setup(
        n_views=V, image_hw=(HW, HW), n_verts=NV, n_clusters=NC,
        n_samples=NS, chunk_rays=8, embed_dim=EMBED, vit_depth=DEPTH,
        vit_heads=HEADS, knn_k=K)
    j16 = j32.clone(dtype=BF16)
    # init_params' Flax init, jitted: one compile, not one per operation
    with _as_written():
        params = jax.jit(init_params, static_argnums=(0, 2))(
            j32, frame, NC, jax.random.PRNGKey(0))
    table = weights.reference_pe_table(normalize_positions(
        jcluster.pool_matrix @ jsmpl.v_template, 1.5), EMBED)
    jp32, jp16, jp16_cull = (
        JPipeline(m, jcluster, jsmpl.v_template, n_samples=NS, chunk_rays=8,
                  pe_table=table) for m in (j32, j16, j16))
    jp16._cull = jp32._cull  # the port's float32 cull
    sd = weights.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]), DEPTH)

    def port_pipe(dtype=TBF16, cluster=None, verts=None):
        net = TNet(embed_dim=EMBED, vit_depth=DEPTH, vit_heads=HEADS,
                   knn_k=K, compute_dtype=dtype)
        weights.load_reference_state_dict(net, sd)
        return RenderPipeline(
            net.eval(), cluster or ClusterSpec(jcluster.vert2cluster, NC),
            SMPLModel.synthetic(n_verts=NV).v_template if verts is None
            else verts, n_samples=NS, chunk_rays=8)

    return dict(frame=frame, params=params, jp32=jp32, jp16=jp16,
                jp16_cull=jp16_cull, port_pipe=port_pipe, smpl=jsmpl)


def _request(frame, target=1):
    return {
        "images": np.asarray(frame.images), "K": np.asarray(frame.K),
        "R": np.asarray(frame.R), "T": np.asarray(frame.T),
        "verts_world": np.asarray(frame.verts_world),
        "blend_rot": np.asarray(frame.blend_rot),
        "tK": np.asarray(frame.K[target]), "tR": np.asarray(frame.R[target]),
        "tT": np.asarray(frame.T[target]), "H": HW, "W": HW,
    }


@pytest.fixture(scope="module")
def jax_renders(scene):
    """The request through the JAX service: float32, bf16 with the float32
    cull, and bf16 with its own bf16 cull."""
    req = _request(scene["frame"])
    jcfg = JConfig().merge_opts(["pad_bucket", "64"] + OPTS)
    with _as_written():
        return {key: JService(jcfg, scene[key], scene["params"],
                              scene["smpl"]).render(req)
                for key in ("jp16", "jp32", "jp16_cull")}


def test_serve_render_matches_the_jax_bf16_service(scene, jax_renders):
    req = _request(scene["frame"])
    w16, w32 = jax_renders["jp16"], jax_renders["jp32"]
    pipe = scene["port_pipe"]()
    kernels.reset_launch_counts()
    svc = RenderService(Config().merge_opts(OPTS), pipe,
                        SMPLModel.synthetic(n_verts=NV))
    got = svc.render(req)
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0)
    assert got["acc"].max() > 0.05  # the body is in view
    for key, atol in (("rgb", RGB_ATOL), ("acc", ACC_ATOL),
                      ("depth", DEPTH_ATOL)):
        _compare(got[key], w16[key], w32[key], atol, key)
    pro = pipe.prologue(frame_to_port(scene["frame"]))
    assert pro.tokens.dtype == pro.pixel_map.dtype == TBF16
    assert pro.centers.dtype == pro.rot.dtype == torch.float32


def test_serve_reports_its_compute_dtype(scene):
    import json
    import urllib.request

    svc = RenderService(Config().merge_opts(OPTS), scene["port_pipe"](),
                        SMPLModel.synthetic(n_verts=NV))
    server = RenderServer(svc, port=0)
    server.start()
    try:
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/healthz", timeout=30).read())
    finally:
        server.shutdown()
    assert health["compute_dtype"] == "bfloat16"


def test_jax_bf16_cull_flips_points_near_the_threshold(scene, jax_renders):
    """What the float32 cull replaces: the JAX bf16 pipeline's cull against
    its float32 one over 20,000 points in the body's box +-0.15 m.  It
    flips points both ways, all within CULL_FLIP_REACH of the 0.1 m
    threshold, and it moves the JAX bf16 render from float32 by more than
    the bf16 network does; the port's cull is the same bits in both
    compute dtypes.  Prints the counts (pytest -s)."""
    frame = scene["frame"]
    verts = np.asarray(frame.tar_verts_smpl)
    rng = np.random.default_rng(9)
    pts = rng.uniform(verts.min(0) - 0.15, verts.max(0) + 0.15,
                      (20000, 3)).astype(np.float32)
    keep16 = np.asarray(scene["jp16_cull"]._cull(jnp.asarray(pts),
                                                 jnp.asarray(verts)))
    keep32 = np.asarray(scene["jp32"]._cull(jnp.asarray(pts),
                                            jnp.asarray(verts)))
    flips = keep16 != keep32
    d = np.sqrt(((pts[:, None, :].astype(np.float64) - verts[None]) ** 2)
                .sum(-1)).min(1)
    assert flips.sum() > 0, "the JAX bf16 cull agrees with float32 here"
    assert (keep16 & ~keep32).any() and (keep32 & ~keep16).any()
    reach = float(np.abs(d[flips] - 0.1).max())
    assert reach < CULL_FLIP_REACH, (int(flips.sum()), reach)
    dev = {k: {c: float(np.abs(jax_renders[k][c]
                                - jax_renders["jp32"][c]).max())
               for c in ("rgb", "acc", "depth")}
           for k in ("jp16_cull", "jp16")}
    assert dev["jp16_cull"]["rgb"] > dev["jp16"]["rgb"], dev
    print(f"JAX bf16 cull: {int(flips.sum())} of {len(pts)} points flipped "
          f"({int((keep16 & ~keep32).sum())} admitted, "
          f"{int((keep32 & ~keep16).sum())} dropped), up to {reach:.4f} m "
          f"from the threshold; max |JAX bf16 - JAX float32| with the bf16 "
          f"cull {dev['jp16_cull']}, with the float32 cull {dev['jp16']}")
    tp16, tp32 = scene["port_pipe"](), scene["port_pipe"](torch.float32)
    t = torch.from_numpy
    np.testing.assert_array_equal(tp16._cull(t(pts), t(verts)).numpy(),
                                  tp32._cull(t(pts), t(verts)).numpy())
    np.testing.assert_array_equal(tp32._cull(t(pts), t(verts)).numpy(),
                                  keep32)


def test_sigma_matches_the_jax_bf16_pipeline(scene):
    """render_sigma over a grid across the cull shell: float32 out, the
    culled points exactly 0 on both sides (one float32 cull)."""
    frame = scene["frame"]
    verts = np.asarray(frame.verts_world)
    axes = [np.linspace(lo - 0.12, hi + 0.12, n, dtype=np.float32)
            for lo, hi, n in zip(verts.min(0), verts.max(0), (9, 17, 9))]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    cp = NS * 8
    pad = (-len(pts)) % cp
    padded = np.pad(pts, ((0, pad), (0, 0)))
    mask = np.arange(len(padded)) < len(pts)
    want = {}
    for key in ("jp16", "jp32"):
        with _as_written():
            s, over = jax.jit(scene[key].render_sigma_dense)(
                scene["params"], frame, padded, mask)
        assert int(np.asarray(over)[0]) == 0
        want[key] = np.asarray(s)[:len(pts)]
    pipe = scene["port_pipe"]()
    got = pipe.render_sigma(frame_to_port(frame), torch.from_numpy(pts))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy() == 0, want["jp16"] == 0)
    assert 0 < pipe.last_frame_stats["survivors"] < len(pts)
    _compare(got, want["jp16"], want["jp32"], SIGMA_ATOL, "sigma")


def frame_to_port(frame):
    """A JAX FrameInputs as the port's (CPU tensors)."""
    from transhuman_tpu_torch.render.pipeline import FrameInputs

    return FrameInputs(**{k: torch.from_numpy(np.asarray(getattr(frame, k)))
                          for k in ("images", "vizmaps", "K", "R", "T",
                                    "verts_world", "tar_verts_smpl",
                                    "blend_rot", "Rh", "Th")})


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32) for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def train_runs(scene):
    """One sample's loss, gradients and first Adam update, jitter off, in
    the JAX package (float32 and bf16) and the port (bf16)."""
    opts = OPTS + ["patch.size", "4", "patch.N_patches", "2", "ep_iter", "4"]
    jdata = JDataset(JConfig().merge_opts(list(opts)), "train", n_frames=2,
                     image_hw=(HW, HW), n_verts=NV)
    tdata = SyntheticDataset(Config().merge_opts(list(opts)), n_frames=2,
                             image_hw=(HW, HW), n_verts=NV)
    js, ts = jdata.get_train_sample(0), tdata.get_train_sample(0)
    params, key = scene["params"], jax.random.PRNGKey(0)
    out = {}
    for tag in ("jp32", "jp16"):
        jfn = jstep.make_sample_loss(scene[tag], None, perturb=False)
        with _as_written():
            (jl, _), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
                params, js, key)
        # the JAX step's update of that gradient: its optimizer (clip at
        # 40, then Adam under the schedule) at count 0
        tx, _ = jstep.make_optimizer(iters_per_epoch=4)

        def update(g, p, tx=tx):
            return optax.apply_updates(p, tx.update(g, tx.init(p), p)[0])

        out[tag] = (float(jl), _leaves(jg["params"]),
                    _leaves(jax.jit(update)(jg, params)["params"]))
    pipe = scene["port_pipe"]()
    opt, sched = tstep.make_optimizer(pipe.model.parameters(),
                                      iters_per_epoch=4)
    state = tstep.TrainState(pipe.model, opt, sched)
    p0 = {n: p.detach().clone() for n, p in pipe.model.named_parameters()}
    stats = tstep.make_train_step(pipe, perturb=False)(state, ts, 0)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in pipe.model.named_parameters()}
    for g in grads.values():
        assert g.dtype == torch.float32
    out["port"] = (stats["loss"], _leaves(
        weights.jax_params_from_state_dict(grads)["params"]), _leaves(
        weights.jax_params_from_state_dict(pipe.model.state_dict())[
            "params"]))
    return out, _leaves(params["params"])


def test_train_loss_and_gradients_match_jax_bf16(train_runs):
    """The loss within LOSS_RTOL; each gradient leaf within GRAD_TOL of the
    largest leaf's norm (one leaf's float32 gradient is ~0 and moves by
    1e5 of itself in bf16); all leaves closer to JAX bf16 on average than
    JAX float32 is."""
    out, _ = train_runs
    (l32, g32, _), (l16, g16, _), (lt, gt, _) = (out["jp32"], out["jp16"],
                                                 out["port"])
    assert np.isfinite(lt) and lt > 0
    assert abs(lt - l16) <= LOSS_RTOL * abs(l16), (lt, l16, l32)
    assert set(gt) == set(g16) == set(g32)
    gmax = max(np.linalg.norm(g) for g in g16.values())
    for k in g16:
        assert np.linalg.norm(gt[k] - g16[k]) <= GRAD_TOL * gmax, k
    cat = [np.concatenate([d[k].ravel() for k in sorted(g16)])
           for d in (gt, g16, g32)]
    _compare(*cat, np.inf, "gradients")


def test_train_update_matches_jax_bf16(train_runs):
    """Adam's first update is -lr g / (|g| + 1e-8): +-lr wherever the sign
    of the gradient is the same, anywhere in [-lr, lr] elsewhere; the port
    agrees with JAX bf16 on the sign at least as often as JAX float32
    does."""
    out, p0 = train_runs
    lr = 7e-4 / 300
    (_, g32, u32), (_, g16, u16), (_, gt, ut) = (out["jp32"], out["jp16"],
                                                 out["port"])
    flips_port = flips_f32 = total = 0
    for k, p in p0.items():
        dt, d16, d32 = ut[k] - p, u16[k] - p, u32[k] - p
        slack = 2 * np.spacing(np.abs(p).astype(np.float32))
        assert (np.abs(dt) <= lr * 1.001 + slack).all(), k
        sure = np.abs(g16[k]) > 1e-6
        flips_port += int((np.sign(dt) != np.sign(d16))[sure].sum())
        flips_f32 += int((np.sign(d32) != np.sign(d16))[sure].sum())
        total += int(sure.sum())
    assert total > 0
    assert flips_port <= flips_f32, (flips_port, flips_f32, total)


def test_eval_frame_matches_the_jax_bf16_package(scene, tmp_path):
    """One eval frame through both packages' evaluate_frames: rgb and
    PSNR."""
    opts = OPTS + ["test.frame_interval", "8"]
    jdata = JDataset(JConfig().merge_opts(list(opts)), "test",
                     image_hw=(HW, HW), n_verts=NV)
    tdata = SyntheticDataset(Config().merge_opts(list(opts)), "test",
                             image_hw=(HW, HW), n_verts=NV)

    def collect(store, ev):
        def per_frame(item, o):
            store.append((np.asarray(o["rgb_map"]), ev.psnr[-1]))
            return {}
        return per_frame

    runs = {}
    for tag in ("jp16", "jp32"):
        # the dataset's own clusters, as the eval CLI builds its pipeline
        jp = JPipeline(scene[tag].model, jdata.cluster,
                       scene["smpl"].v_template, n_samples=NS, chunk_rays=8,
                       pe_table=weights.reference_pe_table(
                           normalize_positions(jdata.cluster.pool_matrix
                                               @ scene["smpl"].v_template,
                                               1.5), EMBED))
        if tag == "jp16":
            jp._cull = scene["jp32"]._cull
        ev = JEvaluator(str(tmp_path / tag))
        runs[tag] = []
        with _as_written():
            jax_evaluate_frames(
                JConfig().merge_opts(opts + ["pad_bucket", "64"]), jp,
                scene["params"], jdata, ev, collect(runs[tag], ev))
    pipe = scene["port_pipe"](cluster=tdata.cluster,
                              verts=tdata.smpl.v_template)
    ev = Evaluator(str(tmp_path / "port"))
    runs["port"] = []
    run_cli.evaluate_frames(Config().merge_opts(opts), pipe, tdata, ev,
                            collect(runs["port"], ev))
    assert len(runs["port"]) == len(runs["jp16"]) == 1
    (rgb, psnr), (rgb16, psnr16), (rgb32, _) = (runs["port"][0],
                                                runs["jp16"][0],
                                                runs["jp32"][0])
    assert rgb.max() > 0.05  # the body is in view
    _compare(rgb, rgb16, rgb32, RGB_ATOL, "eval rgb")
    assert psnr == pytest.approx(psnr16, abs=PSNR_ATOL)


# ------------------------------------------------------- config and CLIs
def test_compute_dtype_other_than_float32_or_bfloat16_fails_by_name():
    cfg = Config().merge_opts(["compute_dtype", "float16"])
    with pytest.raises(ValueError, match="float16"):
        TNet.from_config(cfg)
    net = TNet.from_config(Config().merge_opts(["compute_dtype", "bfloat16",
                                                "vit_depth", "1"]))
    assert net.compute_dtype == TBF16
    assert net.encoder.compute_dtype == net.ViT.compute_dtype == TBF16
    with pytest.raises(ValueError, match="float16"):
        train_cli.main(["--device", "cpu", "--steps", "1",
                        "compute_dtype", "float16"])


def test_entry_points_run_in_bf16_on_the_cpu(tmp_path):
    """train, then evaluate and reconstruction from its checkpoint, all with
    compute_dtype bfloat16 and --device cpu."""
    opts = ["H", "48", "W", "48", "num_class", "20", "vit_depth", "1",
            "N_samples", "4", "compute_dtype", "bfloat16"]
    ckpt = str(tmp_path / "latest.pth")
    state, records = train_cli.main(
        ["--device", "cpu", "--steps", "1", "--out", ckpt, *opts,
         "patch.size", "6", "patch.N_patches", "2"])
    assert state.model.compute_dtype == TBF16
    assert all(np.isfinite(r["loss"]) for r in records)
    for n, p in state.model.named_parameters():
        assert p.dtype == torch.float32, n
        assert n == "ViT.mask_token" or (
            p.grad is not None and p.grad.dtype == torch.float32), n
    res = str(tmp_path / "res")
    summary = run_cli.main(["--type", "evaluate", "--device", "cpu",
                            "--weights", ckpt, "result_dir", res,
                            "test.frame_interval", "8", *opts])
    assert np.isfinite(summary["psnr"])
    paths = run_cli.main(["--type", "reconstruction", "--device", "cpu",
                          "--weights", ckpt, "result_dir", res,
                          "voxel_size", "0.06,0.06,0.06", "mesh_th", "9",
                          *opts])
    assert len(paths) == 1
