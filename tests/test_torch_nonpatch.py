"""Non-patch training on the synthetic scene (``patch.use_patch_sampling
False``: N_rand single rays and the masked MSE) in the port against the
JAX package on the CPU: the train sample array for array, a sample's loss
and gradient at the train bounds (tests/_torch_batch_setup.py's scene), and
the train entry point end to end."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_batch_setup as S
from transhuman_tpu.cli.train import stack_samples
from transhuman_tpu.config import Config as JConfig
from transhuman_tpu.data.synthetic import SyntheticDataset as JDataset
from transhuman_tpu.train import step as jstep
from transhuman_tpu_torch import weights
from transhuman_tpu_torch.cli import train as tcli
from transhuman_tpu_torch.config import Config
from transhuman_tpu_torch.data.synthetic import SyntheticDataset
from transhuman_tpu_torch.train import step as tstep

N_RAND = 48
OPTS = S.OPTS + ["patch.use_patch_sampling", "False", "N_rand", str(N_RAND)]


@pytest.fixture(scope="module")
def datasets():
    return (JDataset(JConfig().merge_opts(list(OPTS)), "train",
                     n_frames=S.N_FRAMES, image_hw=(S.HW, S.HW),
                     n_verts=S.NV),
            SyntheticDataset(Config().merge_opts(list(OPTS)),
                             n_frames=S.N_FRAMES, image_hw=(S.HW, S.HW),
                             n_verts=S.NV))


@pytest.mark.parametrize("epoch", [0, 1])
def test_non_patch_sample_equals_jax(datasets, epoch):
    """The rays, their mask and the target colours of each sample equal the
    JAX package's array for array (both draw from numpy's
    default_rng(index + epoch * seed)); no patch fields."""
    jdata, tdata = datasets
    jdata.set_epoch(epoch)
    tdata.set_epoch(epoch)
    for i in range(S.N_FRAMES):
        want, got = jdata.get_train_sample(i), tdata.get_train_sample(i)
        assert got.target_patches is None and got.ray_pixel_idx is None
        for f in ("ray_o", "ray_d", "near", "far", "mask"):
            a, b = np.asarray(getattr(want.rays, f)), getattr(got.rays,
                                                               f).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, f)
        assert got.rays.ray_o.shape == (N_RAND, 3)
        np.testing.assert_array_equal(got.target_rgb.numpy(),
                                      np.asarray(want.target_rgb))
        np.testing.assert_array_equal(got.frame.images.numpy(),
                                      np.asarray(want.frame.images))


def test_non_patch_step_matches_jax(datasets):
    """The loss of a non-patch sample (the unweighted masked MSE over N_rand
    rays) and its gradient, jitter off, against the JAX package's (its
    sample loss vmapped over a batch of one, as its step runs it) at the
    train bounds of PERF.md: the loss within 1e-5 relative, each gradient
    leaf within 1e-3 of its norm + 1e-5 of the largest leaf's (TransHE's
    LayerNorm leaves here are ~1e-3 of the largest)."""
    jdata, tdata = datasets
    jdata.set_epoch(0)
    tdata.set_epoch(0)
    scene = S.Scene()
    jb = stack_samples([jdata.get_train_sample(1)])
    ts = tdata.get_train_sample(1)
    jloss = jstep.make_sample_loss(scene.jax_pipe(), None, patch_mode=False,
                                   perturb=False)

    def batch_loss(params):
        losses, _ = jax.vmap(functools.partial(jloss, params),
                             axis_name="batch")(jb, jax.random.PRNGKey(0)[
                                 None])
        return jnp.mean(losses)

    want, jg = jax.jit(jax.value_and_grad(batch_loss))(scene.params)
    pipe = scene.port_pipe()
    loss, stats = tstep.make_sample_loss(pipe, perturb=False,
                                         patch_mode=False)(ts, seed=0)
    loss.backward()
    assert "img_loss" in stats and np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(want), rtol=S.LOSS_RTOL)
    tg = S.leaves(weights.jax_params_from_state_dict(
        {n: (p.grad if p.grad is not None else torch.zeros_like(p))
         for n, p in pipe.model.named_parameters()})["params"])
    jg = S.leaves(jg["params"])
    assert set(tg) == set(jg)
    gmax = max(np.linalg.norm(g) for g in jg.values())
    for k, g in jg.items():
        assert (np.linalg.norm(tg[k] - g)
                <= S.GRAD_RTOL * np.linalg.norm(g) + 1e-5 * gmax), k


def test_train_entry_point_trains_without_patches(tmp_path):
    state, records = tcli.main([
        "--device", "cpu", "--steps", "2", "H", "64", "W", "64",
        "num_class", "20", "vit_depth", "1", "N_samples", "8", "N_rand",
        "64", "patch.use_patch_sampling", "False", "dataset", "synthetic",
        "trained_model_dir", str(tmp_path / "tm"), "record_dir",
        str(tmp_path / "rec")])
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["loss"] > 0 for r in records)
    assert state.step == 2
