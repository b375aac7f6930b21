"""The patch loss of a train sample with padding rays (index -1), port
against the JAX package on the CPU.

The JAX ``unpack_patches`` (transhuman_tpu/train/loss.py) scatters with
``.at[idx].set(..., mode="drop")``, and JAX wraps a negative index before
it drops out-of-range ones: a padding ray's -1 lands on the last pixel of
the last patch, where it overwrites a valid ray's colour and takes that
ray's gradient away.  Its own docstring, and the reference's
``_unpack_imgs`` (if_nerf_clight.py:94-106), drop padding rays; the port
does so.  These tests pin the one-pixel difference, and hold the port's
train step against the JAX step fed the same sample with its -1 indices
replaced by P*ps*ps, which ``mode="drop"`` does drop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_zju import (  # noqa: F401  (fixtures)
    _leaves,
    _pair,
    bridged,
    zju_root,
)
from transhuman_tpu.train import step as jstep
from transhuman_tpu.train.loss import unpack_patches as jax_unpack
from transhuman_tpu_torch import weights
from transhuman_tpu_torch.train import step as tstep
from transhuman_tpu_torch.train.loss import unpack_patches


@pytest.fixture(scope="module")
def padded(zju_root):  # noqa: F811
    """(index, JAX sample, port sample) of the first train sample (jitter
    off) with padding rays and a valid ray on the last patch pixel."""
    j, t = _pair(zju_root, "train", ["jitter", "False"])
    for index in range(len(t)):
        ts = t.get_train_sample(index)
        idx = ts.ray_pixel_idx.numpy()
        last = int(np.prod(ts.target_patches.shape[:3])) - 1
        if (idx < 0).any() and (idx == last).any():
            return index, j.get_train_sample(index), ts
    pytest.fail("no train sample has padding rays and a covered last pixel")


def test_jax_unpack_wraps_a_padding_ray_onto_the_last_pixel(padded):
    """Every valid ray at 0.5, every padding ray at 0: the JAX patches
    hold 0 at the last pixel of the last patch, the port's 0.5; no other
    pixel differs."""
    index, js, ts = padded
    idx = ts.ray_pixel_idx.numpy()
    np.testing.assert_array_equal(np.asarray(js.ray_pixel_idx), idx)
    shape = tuple(ts.target_patches.shape)
    colours = np.where((idx >= 0)[:, None], 0.5, 0.0).astype(np.float32)
    colours = np.repeat(colours, 3, 1)
    jp = np.asarray(jax_unpack(jnp.asarray(colours), jnp.asarray(idx),
                               shape))
    tp = unpack_patches(torch.from_numpy(colours), ts.ray_pixel_idx,
                        shape).numpy()
    diff = np.argwhere((jp != tp).any(-1))
    assert diff.tolist() == [[shape[0] - 1, shape[1] - 1, shape[2] - 1]], (
        index, diff.tolist())
    assert (jp[-1, -1, -1] == 0).all() and (tp[-1, -1, -1] == 0.5).all()
    # with the padding indices past the raster, JAX drops them too
    dropped = np.where(idx < 0, int(np.prod(shape[:3])), idx)
    np.testing.assert_array_equal(np.asarray(jax_unpack(
        jnp.asarray(colours), jnp.asarray(dropped), shape)), tp)


def test_padded_train_step_equals_the_jax_step_with_padding_dropped(
        padded, bridged):  # noqa: F811
    """The port's train step on the padded sample against the JAX step on
    the same sample with -1 -> P*ps*ps, at the train bounds of PERF.md
    section 2: loss 1e-4 relative, each gradient leaf 1e-3 of its norm +
    1e-5 of the largest leaf's."""
    _, js, ts = padded
    jpipe, params, port_pipe = bridged
    size = int(np.prod(ts.target_patches.shape[:3]))
    jidx = np.asarray(js.ray_pixel_idx)
    js = js.replace(ray_pixel_idx=jnp.asarray(np.where(jidx < 0, size, jidx),
                                              jidx.dtype))
    jfn = jstep.make_sample_loss(jpipe, None, perturb=False)
    (jl, _), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        params, js, jax.random.PRNGKey(0))
    pipe = port_pipe()
    tl, _ = tstep.make_sample_loss(pipe, perturb=False)(ts, seed=0)
    tl.backward()
    tg = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
          for n, p in pipe.model.named_parameters()}
    tg = _leaves(weights.jax_params_from_state_dict(tg)["params"])
    jg = _leaves(jg["params"])
    assert abs(float(tl.detach()) - float(jl)) <= 1e-4 * abs(float(jl))
    assert set(tg) == set(jg)
    largest = max(np.linalg.norm(v) for v in jg.values())
    for k, want in jg.items():
        assert (np.linalg.norm(tg[k] - want)
                <= 1e-3 * np.linalg.norm(want) + 1e-5 * largest), k
