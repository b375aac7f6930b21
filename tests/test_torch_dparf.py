"""DPaRF binding: the port's plain twin of kernel K2 against the JAX package's
composition (models/heads.py::dparf_representation) and against the Pallas
kernel it replaces (experiments/dparf.py::dparf_fused, interpret mode).  The
CUDA kernel is held against the plain twin on a card in
tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transhuman_tpu.experiments.dparf import TILE, dparf_fused
from transhuman_tpu.models.heads import dparf_representation as jax_rep
from transhuman_tpu_torch.kernels import dparf as kdparf
from transhuman_tpu_torch.models.heads import dparf_representation

N, C, V, D = TILE, 300, 3, 192


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((N, 3)).astype(np.float32) * 0.4
    centers = rng.standard_normal((C, 3)).astype(np.float32) * 0.4
    rot = np.stack([np.linalg.qr(m)[0] for m in rng.standard_normal((C, 3, 3))])
    tokens = rng.standard_normal((V, C, D)).astype(np.float32)
    return pts, centers, rot.astype(np.float32), tokens


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def plain(data):
    return kdparf.dparf_plain(*_t(*data))


def test_plain_matches_jax_composition(data, plain):
    """Tolerances of tests/test_dparf_kernel.py: tok 2e-5, pe 2e-4 (the
    pi*2^9 band amplifies f32 rounding of the local coordinates)."""
    tok, pe, dist, _, _ = plain
    rep, keep = jax_rep(*map(jnp.asarray, data))
    assert keep is None
    np.testing.assert_allclose(tok.numpy(), np.asarray(rep[..., :D]),
                               atol=2e-5)
    np.testing.assert_allclose(pe.numpy(), np.asarray(rep[0, :, D:]),
                               atol=2e-4)
    assert dist.shape == (N, 7)
    assert (torch.diff(dist, dim=1) >= 0).all()


def test_plain_matches_pallas_kernel(data, plain):
    tok, pe, dist, _, _ = plain
    jt, jp, jd = dparf_fused(*map(jnp.asarray, data), interpret=True)
    np.testing.assert_allclose(tok.numpy(), np.asarray(jt), atol=2e-5)
    np.testing.assert_allclose(pe.numpy(), np.asarray(jp), atol=2e-4)
    # sqrt of a small expanded-form d^2 magnifies its f32 rounding
    np.testing.assert_allclose(dist.numpy(), np.asarray(jd), atol=1e-5)


def test_representation_routes_cpu_to_plain(data, plain):
    kdparf.dparf_cuda.launches = 0
    pts, centers, rot, tokens = _t(*data)
    rep, keep = dparf_representation(pts, centers, rot, tokens,
                                     knn_sigma=0.3)
    assert kdparf.dparf_cuda.launches == 0
    assert rep.shape == (V, N, D + 63)
    torch.testing.assert_close(rep[..., :D], plain[0], rtol=0, atol=0)
    torch.testing.assert_close(keep, plain[2][:, 0] < 0.3)


def test_ties_order_by_lowest_index():
    """Equidistant centres: the neighbour order (hence each neighbour's local
    code and the weights) must follow the lowest index, as in the JAX
    package; a point at the origin is 1 from every unit-axis centre."""
    centers = np.array([[0, 0, 2], [1, 0, 0], [0, 1, 0], [-1, 0, 0],
                        [0, -1, 0], [0, 0, 1], [0, 0, -1], [3, 0, 0]],
                       np.float32)
    rot = np.stack([np.eye(3, dtype=np.float32) * (i + 1) for i in range(8)])
    tokens = np.arange(2 * 8 * 4, dtype=np.float32).reshape(2, 8, 4)
    pts = np.zeros((1, 3), np.float32)
    tok, pe, dist, _, _ = kdparf.dparf_plain(*_t(pts, centers, rot, tokens),
                                             k=5)
    rep, _ = jax_rep(*map(jnp.asarray, (pts, centers, rot, tokens)), k=5)
    np.testing.assert_allclose(tok.numpy(), np.asarray(rep[..., :4]),
                               atol=1e-6)
    np.testing.assert_allclose(pe.numpy(), np.asarray(rep[0, :, 4:]),
                               atol=1e-6)
    # neighbours 1, 2, 3, 4, 5: all at distance 1, equal weights 1/5
    np.testing.assert_allclose(tok.numpy()[:, 0],
                               tokens[:, 1:6].mean(axis=1), atol=1e-6)
    np.testing.assert_allclose(dist.numpy(), np.ones((1, 5)), atol=1e-6)

