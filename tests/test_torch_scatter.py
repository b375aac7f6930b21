"""The backward of the bilinear feature fetch: the plain twin of kernel K3
against the Pallas kernel it replaces
(transhuman_tpu/experiments/streamscatter.py::dfeat_scatter_sorted, interpret
mode, as tests/test_streamscatter.py runs it), and the port's
sample_feature_map Function against jax.vjp of the JAX package's custom VJP.
The CUDA kernel is held against the plain twin on a card in
tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transhuman_tpu.experiments.streamscatter import (
    BLOCK_B,
    W_SPAN,
    dfeat_scatter_sorted,
)
from transhuman_tpu.ops.sampling import sample_feature_map as jax_sfm
from transhuman_tpu_torch import kernels
from transhuman_tpu_torch.kernels import scatter
from transhuman_tpu_torch.ops.sampling import sample_feature_map

HF = WF = 64
HW = HF * WF
C = 384
N = 2 * BLOCK_B
_HI = HW - WF - 2  # largest base id whose four taps stay in the map
ID_PATTERNS = {  # tests/test_streamscatter.py's patterns
    "uniform": lambda rng: rng.integers(0, _HI, N),
    "clustered": lambda rng: np.repeat(rng.integers(0, _HI // 8, N // 8) * 8,
                                       8),
    "window_boundary": lambda rng: np.clip(
        rng.integers(-8, 8, N) + W_SPAN, 0, _HI),
    "all_equal": lambda rng: np.full(N, 7),
}


def _w4(rng, n):
    wx = rng.random(n).astype(np.float32)
    wy = rng.random(n).astype(np.float32)
    return np.stack(
        [(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy], axis=1)


@pytest.mark.parametrize("pattern", sorted(ID_PATTERNS))
def test_plain_twin_matches_the_pallas_kernel(pattern):
    rng = np.random.default_rng(3)
    ids = np.sort(ID_PATTERNS[pattern](rng).astype(np.int32))
    g = rng.standard_normal((N, C)).astype(np.float32)
    w4 = _w4(rng, N)
    want, _ = dfeat_scatter_sorted(jnp.asarray(ids), jnp.asarray(g),
                                   jnp.asarray(w4), HW, WF)
    # the twin takes unsorted ids: give it a shuffled copy
    perm = rng.permutation(N)
    got = scatter.dfeat_scatter(torch.from_numpy(ids[perm])[None],
                                torch.from_numpy(g[perm])[None],
                                torch.from_numpy(w4[perm])[None], HW, 1, WF)
    assert got.shape == (1, HW, C) and got.dtype == torch.float32
    # test_streamscatter.py's tolerance against its numpy oracle: float32
    # sums of up to N weighted rows in two orders
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("view, bad", [(1, -1), (0, HW - WF - 1)])
def test_plain_twin_refuses_ids_outside_the_map(view, bad):
    """As the kernel's wrapper does (tests/test_torch_kernels.py): a tap
    outside one view's map is an error, not a write into the next view's."""
    rng = np.random.default_rng(4)
    ids = ID_PATTERNS["uniform"](rng).astype(np.int32).reshape(2, -1)
    ids[view, 5] = bad
    g = torch.ones((2, ids.shape[1], 8))
    w4 = torch.from_numpy(_w4(rng, ids.size).reshape(2, -1, 4))
    with pytest.raises(IndexError, match="must lie in"):
        scatter.dfeat_scatter(torch.from_numpy(ids), g, w4, HW, 1, WF)


V, HFS, WFS, CS, NS = 2, 8, 10, 16, 300
IMAGE = (16, 20)  # feature maps at half the image size on both axes


@pytest.fixture(scope="module")
def sampling_inputs():
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((V, HFS, WFS, CS)).astype(np.float32)
    # inside the image, past every border (clamped), and on the borders
    uv = rng.uniform(-4, 24, (V, NS, 2)).astype(np.float32)
    uv[:, :20, 0] = 0.0
    uv[:, 20:40, 0] = IMAGE[1] * (WFS - 1) / WFS  # fx == Wf - 1 exactly
    uv[:, 40:60, 1] = IMAGE[0] * (HFS - 1) / HFS
    g = rng.standard_normal((V, NS, CS)).astype(np.float32)
    return feat, uv, g


@pytest.mark.parametrize("uv_grad", [True, False])
def test_sampling_backward_matches_jax_vjp(sampling_inputs, uv_grad):
    feat, uv, g = sampling_inputs
    out_j, vjp = jax.vjp(lambda f, u: jax_sfm(f, u, IMAGE), jnp.asarray(feat),
                         jnp.asarray(uv))
    d_feat_j, d_uv_j = vjp(jnp.asarray(g))

    kernels.reset_launch_counts()
    ft = torch.from_numpy(feat).requires_grad_(True)
    ut = torch.from_numpy(uv).requires_grad_(uv_grad)
    out = sample_feature_map(ft, ut, IMAGE)
    out.backward(torch.from_numpy(g))
    assert kernels.launch_counts()["dfeat_scatter"] == 0  # CPU: plain twin
    # forward: the same 2x2 lerp; d_feat: 4-tap sums in another order
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=1e-5)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(d_feat_j),
                               atol=2e-5)
    if uv_grad:
        # d_uv: a 16-channel dot product per point; clamped points get 0
        np.testing.assert_allclose(ut.grad.numpy(), np.asarray(d_uv_j),
                                   atol=2e-5)
        assert (ut.grad.numpy()[:, :20, 0] == 0).all()  # fx == 0 clamps
        assert np.abs(ut.grad.numpy()).max() > 0
    else:
        assert ut.grad is None
