"""Training on a batch of samples (``train.batch_size``, ``accum_steps``)
against the JAX package on the CPU, in float32: the encoder's BatchNorm
pooled over the batch, the batch step at B = 2 and 3 and at B = 4 in two
microbatches, the error for a batch the microbatches do not divide, and the
train entry point at batch 2.  The same numpy inputs and bridged weights go
through both packages (tests/_torch_batch_setup.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_batch_setup as S
from transhuman_tpu.train import step as jstep
from transhuman_tpu_torch.cli import train as tcli
from transhuman_tpu_torch.render.pipeline import FrameInputs, fold_in
from transhuman_tpu_torch.train import step as tstep

# the pooled encoder against JAX's: float32 sums over the B*V maps in one
# order here and as per-sample means pmean'd there, relative to the largest
# output; a per-sample loop (each sample normalised alone) must miss it
ENCODER_RTOL = 1e-5


@pytest.fixture(scope="module")
def scene():
    return S.Scene()


def _frames(scene, b):
    """b port frames: the scene's frame with the images of train sample i."""
    _, ts = scene.samples(b)
    return [t.frame for t in ts]


def test_batched_encoder_pools_batchnorm_like_jax(scene):
    """B = 3 samples through encode_batch against the JAX encoder vmapped
    over axis 'batch' (pmean of each sample's mean and mean square);
    encoding each sample alone differs by more than the bound."""
    frames = _frames(scene, 3)
    images = np.stack([f.images.numpy() for f in frames])
    model, params = scene.jmodel["float32"], scene.params
    want = jax.jit(jax.vmap(
        lambda im: model.apply(params, im, method="encode_views"),
        axis_name="batch"))(jnp.asarray(images))
    pipe = scene.port_pipe()
    with torch.no_grad():
        pooled = pipe.encode_batch(frames)
        alone = [pipe.model.encode_views(f.images) for f in frames]
    for m in range(2):  # the holder map, then the pixel map
        w = np.asarray(want[m])
        scale = np.abs(w).max()
        got = np.stack([p[m].numpy() for p in pooled])
        err = np.abs(got - w).max() / scale
        assert err <= ENCODER_RTOL, (m, err)
        loop = np.stack([a[m].numpy() for a in alone])
        assert np.abs(loop - w).max() / scale > 10 * ENCODER_RTOL, m


def test_batch_of_unequal_images_is_refused(scene):
    frames = _frames(scene, 2)
    small = FrameInputs(**{**vars(frames[1]),
                           "images": frames[1].images[:, :16]})
    with pytest.raises(ValueError, match="images of one shape"):
        scene.port_pipe().encode_batch([frames[0], small])


@pytest.fixture(scope="module")
def p0(scene):
    return S.leaves(scene.params["params"])


@pytest.mark.parametrize("b,accum", [(2, 1), (3, 1), (4, 2)])
def test_batch_step_matches_jax(scene, p0, b, accum):
    """The loss, each gradient leaf and the first Adam update of one step
    on b samples in accum microbatches (strided, BatchNorm pooled within
    each), jitter off, raw_noise_std 0, at the float32 train bounds; the
    stats carry the JAX step's keys and values."""
    jb, ts = scene.samples(b)
    ref = S.jax_step(scene, scene.jax_pipe(), jb, accum)
    port = S.port_step(scene, scene.port_pipe(), ts, accum)
    S.check_f32(port, ref, p0)
    stats = dict(port[2])
    assert stats.pop("lr") == pytest.approx(7e-4 / 300)
    assert stats.keys() == ref[2].keys()
    for k in stats:
        np.testing.assert_allclose(stats[k], ref[2][k], rtol=S.LOSS_RTOL)


def test_accumulation_changes_batchnorm_membership_as_jax_does(scene):
    """B = 4 in 2 microbatches is not B = 4 in one (each microbatch pools
    its own statistics), in both packages alike."""
    jb, ts = scene.samples(4)
    one = S.port_step(scene, scene.port_pipe(), ts, 1)[0]
    two = S.port_step(scene, scene.port_pipe(), ts, 2)[0]
    assert abs(one - two) > 5 * S.LOSS_RTOL * one  # beyond rounding
    sample_loss = jstep.make_sample_loss(scene.jax_pipe(), None,
                                         perturb=False)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)

    def loss(batch):
        return jnp.mean(jax.vmap(functools.partial(sample_loss, scene.params),
                                 axis_name="batch")(batch, keys)[0])

    np.testing.assert_allclose(one, float(jax.jit(loss)(jb)),
                               rtol=S.LOSS_RTOL)


def test_batch_not_divisible_by_accum_steps_raises(scene):
    """As the JAX step raises (accum_value_and_grad)."""
    jb, ts = scene.samples(3)
    with pytest.raises(ValueError, match="not divisible by accum_steps 2"):
        jstep.accum_value_and_grad(lambda *a: None, scene.params, jb,
                                   jnp.zeros((3, 2), jnp.uint32), 2)
    pipe = scene.port_pipe()
    opt, sched = tstep.make_optimizer(pipe.model.parameters())
    step = tstep.make_train_step(pipe, accum_steps=2)
    with pytest.raises(ValueError, match="batch 3 not divisible by "
                                         "accum_steps 2"):
        step(tstep.TrainState(pipe.model, opt, sched), ts, 0)


def test_per_sample_seeds_do_not_depend_on_accumulation(scene):
    """Sample i renders with fold_in(step seed, i) whatever the split: with
    the jitter on, a batch of 2 in 2 microbatches of one sample gives each
    sample the draws it gets alone at that seed and index."""
    _, ts = scene.samples(2)
    pipe = scene.port_pipe()
    step = tstep.make_train_step(pipe, accum_steps=2)
    seen = []
    render = pipe.render_train_batch

    def spy(frames, rays, seeds, sample_jitter=True):
        seen.extend(seeds)
        return render(frames, rays, seeds, sample_jitter)

    pipe.render_train_batch = spy
    opt, sched = tstep.make_optimizer(pipe.model.parameters())
    step(tstep.TrainState(pipe.model, opt, sched), ts, 7)
    assert seen == [fold_in(7, 0), fold_in(7, 1)]


def test_train_entry_point_trains_batches(tmp_path, capsys):
    """2 steps at train.batch_size 2 on the CPU: each step takes 2 samples
    of the seeded permutation."""
    taken = []
    state, records = tcli.main([
        "--device", "cpu", "--steps", "2", "H", "64", "W", "64",
        "num_class", "20", "vit_depth", "1", "N_samples", "8", "patch.size",
        "6", "patch.N_patches", "2", "ep_iter", "2", "train.batch_size",
        "2", "dataset", "synthetic", "trained_model_dir",
        str(tmp_path / "tm"), "record_dir", str(tmp_path / "rec")],
        dataset=_Recording(taken))
    assert [r["step"] for r in records] == [0, 1] and state.step == 2
    assert all(np.isfinite(r["loss"]) for r in records)
    perm = np.random.default_rng(123).permutation(8)
    assert sorted(taken) == sorted(perm[:4].tolist())
    assert "cull_survivors" not in capsys.readouterr().out


class _Recording:
    """The synthetic train data, noting which samples are taken."""

    def __init__(self, taken):
        from transhuman_tpu_torch.config import Config
        from transhuman_tpu_torch.data.synthetic import SyntheticDataset

        cfg = Config().merge_opts(["H", "64", "W", "64", "num_class", "20",
                                   "patch.size", "6", "patch.N_patches", "2"])
        self.data = SyntheticDataset(cfg, "train", image_hw=(32, 32))
        self.smpl = self.data.smpl
        self.taken = taken

    def __len__(self):
        return len(self.data)

    def set_epoch(self, epoch):
        self.data.set_epoch(epoch)

    def get_train_sample(self, index):
        self.taken.append(int(index))
        return self.data.get_train_sample(index)
