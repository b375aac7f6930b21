"""Shared set-up of the port's batch, train-cull, remat and radii tests
(tests/test_torch_batch*.py, test_torch_train_cull.py, test_torch_radii.py):
one small synthetic scene, its JAX model built to pool BatchNorm over the
vmapped 'batch' axis (as the JAX train CLI builds it), seeded JAX weights
bridged into the port, and the train data of both packages.

JAX references run as their own tests run them: jitted, float32 products
in full precision (tests/conftest.py), bf16 programs compiled with XLA's
excess precision off (``as_written``), and the JAX bf16 pipeline given the
float32 pipeline's cull, as the port culls in float32 in both modes.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from transhuman_tpu.cli.train import stack_samples
from transhuman_tpu.config import Config as JConfig
from transhuman_tpu.data.synthetic import SyntheticDataset as JDataset
from transhuman_tpu.render.pipeline import RenderPipeline as JPipeline
from transhuman_tpu.testing import init_params, synthetic_setup
from transhuman_tpu.train import step as jstep
from transhuman_tpu_torch import weights
from transhuman_tpu_torch.config import Config
from transhuman_tpu_torch.data.synthetic import SyntheticDataset
from transhuman_tpu_torch.geometry.clusters import (
    ClusterSpec,
    normalize_positions,
)
from transhuman_tpu_torch.geometry.smpl import SMPLModel
from transhuman_tpu_torch.models.network import TransHumanNet
from transhuman_tpu_torch.render.pipeline import RenderPipeline
from transhuman_tpu_torch.train import step as tstep

HW, NV, NC, NS, EMBED, DEPTH, HEADS, K = 32, 128, 16, 4, 12, 2, 2, 3
OPTS = ["num_class", str(NC), "patch.size", "4", "patch.N_patches", "2",
        "ep_iter", "4"]
N_FRAMES = 4
BF16 = jnp.bfloat16
COMPUTE = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# float32 train bounds (PERF.md section 2, tests/test_torch_train.py): the
# loss within 1e-5 relative; each gradient leaf within 1e-3 of its norm
# (+1e-10 for leaves that are zero); Adam's first update within 1% of lr
# where the gradient's sign is sure and within 2 lr anywhere
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-3, 1e-10
# bf16 train bounds of tests/test_torch_bf16.py: the loss within 1e-3
# relative, each leaf within 0.1 of the largest leaf's norm, and nearer JAX
# bf16 on average than JAX float32 is
BF16_LOSS_RTOL, BF16_GRAD_TOL = 1e-3, 0.1


_JIT = jax.jit


@contextlib.contextmanager
def as_written():
    """JAX jits made inside compile with XLA's excess precision off: every
    bf16 cast the program writes rounds (tests/test_torch_bf16.py)."""
    saved = jax.jit
    jax.jit = functools.partial(
        _JIT, compiler_options={"xla_allow_excess_precision": False})
    try:
        yield
    finally:
        jax.jit = saved


def leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32) for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


class Scene:
    """The JAX float32 and bf16 pipelines (BatchNorm pooled over 'batch'),
    their params, both packages' train data, and port pipelines with the
    same bridged weights."""

    def __init__(self):
        j32, _, frame, jsmpl, jcluster = synthetic_setup(
            n_views=3, image_hw=(HW, HW), n_verts=NV, n_clusters=NC,
            n_samples=NS, embed_dim=EMBED, vit_depth=DEPTH, vit_heads=HEADS,
            knn_k=K, axis_name="batch")
        self.frame, self.smpl, self.cluster = frame, jsmpl, jcluster
        self.params = init_params(j32, frame, NC, jax.random.PRNGKey(0))
        self.table = weights.reference_pe_table(normalize_positions(
            jcluster.pool_matrix @ jsmpl.v_template, 1.5), EMBED)
        self.jmodel = {"float32": j32, "bfloat16": j32.clone(dtype=BF16)}
        self.sd = weights.state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, self.params["params"]), DEPTH)
        self.jdata = JDataset(JConfig().merge_opts(list(OPTS)), "train",
                              n_frames=N_FRAMES, image_hw=(HW, HW),
                              n_verts=NV)
        self.tdata = SyntheticDataset(Config().merge_opts(list(OPTS)),
                                      n_frames=N_FRAMES, image_hw=(HW, HW),
                                      n_verts=NV)

    def jax_pipe(self, dtype="float32", batch_axis=True, **kw):
        """A JAX pipeline; in bf16 with the float32 pipeline's cull.  Its
        model pools BatchNorm over 'batch' (train steps) or, without
        batch_axis, runs outside any vmap (renders)."""
        model = self.jmodel[dtype]
        if not batch_axis:
            model = model.clone(axis_name=None)
        pipe = JPipeline(model, self.cluster,
                         self.smpl.v_template, n_samples=NS,
                         pe_table=self.table, **kw)
        if dtype == "bfloat16":
            pipe._cull = self.jax_pipe("float32", batch_axis, **kw)._cull
        return pipe

    def port_pipe(self, dtype="float32", **kw):
        net = TransHumanNet(embed_dim=EMBED, vit_depth=DEPTH,
                            vit_heads=HEADS, knn_k=K,
                            compute_dtype=COMPUTE[dtype])
        weights.load_reference_state_dict(net, self.sd)
        return RenderPipeline(net.eval(), ClusterSpec(self.cluster.vert2cluster,
                                                      NC),
                              SMPLModel.synthetic(n_verts=NV).v_template,
                              n_samples=NS, **kw, device="cpu")

    def samples(self, b):
        """(JAX batch (stacked), port samples): train samples 0..b-1, the
        images of sample i scaled by 1 - 0.2 i and lifted by 0.1 i.  The
        synthetic scene's frame has one set of images, and BatchNorm pooled
        over equal samples would equal BatchNorm of each alone.  (Fresh
        noise images per sample were tried first: on seeds 100 and 101 the
        JAX float32 encoder gradient lies 1.7% from its own float64 one,
        where the port's lies 3e-6 from its float64 one; this scene keeps
        the float32 reference near its float64 one.)"""
        self.jdata.set_epoch(0)
        self.tdata.set_epoch(0)
        js = [self.jdata.get_train_sample(i) for i in range(b)]
        ts = [self.tdata.get_train_sample(i) for i in range(b)]
        for i in range(b):
            img = ts[i].frame.images.numpy() * np.float32(1 - 0.2 * i) \
                + np.float32(0.1 * i)
            js[i] = js[i].replace(frame=js[i].frame.replace(images=img))
            ts[i].frame.images = torch.from_numpy(img)
        return stack_samples(js), ts


def jax_step(scene, pipe, batch, accum_steps=1):
    """The JAX package's step on a stacked batch, jitter off: (loss,
    gradients, stats, updated params).  The gradients are the step's own
    ``accum_value_and_grad`` of its ``local_step`` loss (vmapped with
    axis_name 'batch', the batch mean); the stats and the update come from
    ``make_train_step`` (mesh None)."""
    sample_loss = jstep.make_sample_loss(pipe, None, perturb=False)
    b = jax.tree_util.tree_leaves(batch)[0].shape[0]
    key = jax.random.PRNGKey(0)
    rngs = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(b))

    def loss_fn(params, mb_batch, mb_rngs):
        losses, stats = jax.vmap(functools.partial(sample_loss, params),
                                 axis_name="batch")(mb_batch, mb_rngs)
        return jnp.mean(losses), jax.tree.map(jnp.mean, stats)

    (loss, _), grads = jax.jit(functools.partial(
        jstep.accum_value_and_grad, loss_fn, accum_steps=accum_steps))(
        scene.params, batch, rngs)
    tx, _ = jstep.make_optimizer(iters_per_epoch=4)
    train = jstep.make_train_step(pipe, tx, perturb=False, donate=False,
                                  accum_steps=accum_steps)
    state, stats = train(jstep.init_state(scene.params, tx), batch, key)
    return (float(loss), leaves(grads["params"]),
            {k: float(v) for k, v in stats.items()},
            leaves(state.params["params"]))


def port_step(scene, pipe, samples, accum_steps=1):
    """The port's step on a list of samples, jitter off: (loss, gradients,
    stats, updated params) as jax_step gives them."""
    opt, sched = tstep.make_optimizer(pipe.model.parameters(),
                                      iters_per_epoch=4)
    state = tstep.TrainState(pipe.model, opt, sched)
    stats = tstep.make_train_step(pipe, perturb=False,
                                  accum_steps=accum_steps)(state, samples, 0)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in pipe.model.named_parameters()}
    # the mean loss of the microbatches, as the step's stats hold it
    return (stats["loss"],
            leaves(weights.jax_params_from_state_dict(grads)["params"]),
            stats,
            leaves(weights.jax_params_from_state_dict(
                pipe.model.state_dict())["params"]))


def check_f32(port, ref, p0):
    """The float32 train bounds: loss, each gradient leaf, the update."""
    (tl, tg, _, tp), (jl, jg, _, jp) = port, ref
    assert np.isfinite(tl) and tl > 0
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert set(tg) == set(jg)
    for k, want in jg.items():
        scale = np.linalg.norm(want)
        assert np.linalg.norm(tg[k] - want) <= GRAD_RTOL * scale + GRAD_ATOL, k
    # Adam's first update is -lr g / (|g| + 1e-8): +-lr where the sign of g
    # is sure (|g| > 1e-6 and the two gradients within half of it, the
    # rule of chip_smoke.py's train parity), anywhere in [-lr, lr] elsewhere
    lr = 7e-4 / 300
    tight = total = 0
    for k, p in p0.items():
        dt, dj, g = tp[k] - p, jp[k] - p, jg[k]
        slack = 2 * np.spacing(np.abs(p).astype(np.float32))
        sure = (np.abs(g) > 1e-6) & (np.abs(tg[k] - g) < 0.5 * np.abs(g))
        assert (np.abs(dt - dj)[sure] <= 0.01 * lr + slack[sure]).all(), k
        assert (np.abs(dt - dj) <= 2 * lr + slack).all(), k
        tight += sure.sum()
        total += g.size
    assert tight >= 0.75 * total, (tight, total)


def check_bf16(port, ref16, ref32, p0):
    """The bf16 train bounds: the loss, each leaf within BF16_GRAD_TOL of
    the largest leaf's norm, all leaves nearer JAX bf16 on average than JAX
    float32 is, and Adam's update signs agreeing with JAX bf16 at least as
    often as JAX float32's do."""
    (tl, tg, _, tp), (l16, g16, _, p16), (l32, g32, _, p32) = port, ref16, \
        ref32
    assert np.isfinite(tl) and tl > 0
    assert abs(tl - l16) <= BF16_LOSS_RTOL * abs(l16), (tl, l16, l32)
    assert set(tg) == set(g16) == set(g32)
    gmax = max(np.linalg.norm(g) for g in g16.values())
    for k in g16:
        assert np.linalg.norm(tg[k] - g16[k]) <= BF16_GRAD_TOL * gmax, k
    cat = [np.concatenate([d[k].ravel() for k in sorted(g16)])
           for d in (tg, g16, g32)]
    assert np.abs(cat[0] - cat[1]).mean() < np.abs(cat[1] - cat[2]).mean()
    flips_port = flips_f32 = 0
    for k, p in p0.items():
        sure = np.abs(g16[k]) > 1e-6
        d16 = np.sign(p16[k] - p)
        flips_port += int((np.sign(tp[k] - p) != d16)[sure].sum())
        flips_f32 += int((np.sign(p32[k] - p) != d16)[sure].sum())
    assert flips_port <= flips_f32, (flips_port, flips_f32)
