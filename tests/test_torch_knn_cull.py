"""Port's nearest-neighbour ops and the cull (K1's plain version) against the
JAX package: ops/knn.py and the Pallas kernel min_dist2_fused in interpret
mode.  The CUDA kernel itself is held against the plain version on a card
in tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transhuman_tpu.experiments.cull import TILE_N, min_dist2_fused
from transhuman_tpu.ops import knn as jknn
from transhuman_tpu_torch.kernels import cull
from transhuman_tpu_torch.kernels import build as kbuild
from transhuman_tpu_torch.ops import knn as tknn

# f32 rounding of the expanded |p|^2 + |r|^2 - 2 p.r form at |p|^2 <~ 20
D2_ATOL = 1e-5


def _pts(rng, n, scale=1.0):
    return (rng.standard_normal((n, 3)) * scale).astype(np.float32)


def test_pairwise_dist2_matches_jax(rng):
    p, r = _pts(rng, 200), _pts(rng, 50, 0.5)
    want = np.asarray(jknn.pairwise_dist2(jnp.asarray(p), jnp.asarray(r)))
    got = tknn.pairwise_dist2(torch.from_numpy(p), torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), want, atol=D2_ATOL)
    assert (got >= 0).all()


def test_topk_min_ties_break_to_lowest_index():
    d = torch.tensor([[3.0, 1.0, 1.0, 0.5, 1.0, 0.5],
                      [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]])
    vals, idx = tknn.topk_min(d, 4)
    jv, ji = jknn.topk_min(jnp.asarray(d.numpy()), 4)
    assert idx.tolist() == [[3, 5, 1, 2], [0, 1, 2, 3]]
    assert idx.tolist() == np.asarray(ji).tolist()
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_dparf_dense_weights_matches_jax(rng):
    p, c = _pts(rng, 128, 0.4), _pts(rng, 40, 0.4)
    aux = rng.standard_normal((40, 12)).astype(np.float32)
    d2 = np.array(jknn.pairwise_dist2(jnp.asarray(p), jnp.asarray(c)))
    want = jknn.dparf_dense_weights(jnp.asarray(d2), 7, 0.5,
                                    aux=jnp.asarray(aux))
    got = tknn.dparf_dense_weights(torch.from_numpy(d2), 7, 0.5,
                                   aux=torch.from_numpy(aux))
    for g, w in zip(got, want):  # w_dense, dist, aux_k, w_knn; same d2 in
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("n_verts", [7, 1500, 2100])
def test_min_dist_and_excess_match_jax(rng, n_verts):
    p, r = _pts(rng, 300), _pts(rng, n_verts, 0.5)
    bias = (rng.random(n_verts) * 0.01).astype(np.float32)
    want = np.asarray(jknn.min_dist(jnp.asarray(p), jnp.asarray(r)))
    got = tknn.min_dist(torch.from_numpy(p), torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    want = np.asarray(jknn.min_excess2(jnp.asarray(p), jnp.asarray(r),
                                       jnp.asarray(bias)))
    got = cull.min_excess2_plain(torch.from_numpy(p), torch.from_numpy(r),
                                 torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, atol=D2_ATOL)


@pytest.mark.parametrize("n_verts", [7, 1500])
def test_plain_cull_matches_pallas_kernel(rng, n_verts):
    """The port's plain twin of K1 vs the TPU kernel it replaces, run in
    interpret mode as tests/test_cull_kernel.py runs it (vert counts far
    from the kernel's 1024 tile)."""
    p, r = _pts(rng, TILE_N * 2), _pts(rng, n_verts, 0.5)
    want = np.asarray(min_dist2_fused(jnp.asarray(p), jnp.asarray(r),
                                      interpret=True))
    got = cull.min_excess2_plain(torch.from_numpy(p), torch.from_numpy(r),
                                 torch.zeros(n_verts))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_shell_cull_matches_jax_predicate(rng):
    """The CPU route of the pipeline's cull is the JAX predicate
    sqrt(min d^2) < c, decision for decision away from the threshold."""
    verts = _pts(rng, 900, 0.3)
    p = verts[rng.integers(0, 900, 4000)] + _pts(rng, 4000, 0.07)
    want = np.asarray(jknn.min_dist(jnp.asarray(p), jnp.asarray(verts))) < 0.1
    got = cull.shell_cull(torch.from_numpy(p), torch.from_numpy(verts), 0.1)
    d = np.sqrt(((p[:, None] - verts[None]) ** 2).sum(-1).min(1))
    far = np.abs(d - 0.1) > 1e-5
    assert 0.2 < want.mean() < 0.95  # the shell cuts through the points
    np.testing.assert_array_equal(got.numpy()[far], want[far])


def test_cpu_tensors_never_launch_the_kernel(rng):
    cull.min_excess2_cuda.launches = 0
    p, r = torch.from_numpy(_pts(rng, 64)), torch.from_numpy(_pts(rng, 9))
    cull.shell_cull(p, r, 0.1)
    assert cull.min_excess2_cuda.launches == 0
    assert not kbuild.loaded()
    with pytest.raises(ValueError, match="CUDA tensor"):
        cull.min_excess2_cuda(p, r, torch.zeros(9))

