"""The hand-written CUDA kernels against their plain PyTorch twins, on a card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch with CUDA and nvcc:

    python -m pytest tests/test_torch_kernels.py --noconftest -p no:cacheprovider

(--noconftest: tests/conftest.py configures JAX).  Without a card the tests
marked ``cuda`` skip; the argument checks that need no card run anywhere.
"""

import numpy as np
import pytest
import torch

from transhuman_tpu_torch import kernels
from transhuman_tpu_torch.kernels import cull, dparf


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (hand-written CUDA kernel)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, seed, scale=1.0, device="cpu"):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(device)


def _dparf_inputs(n, c, v, d, device, seed=0):
    rng = np.random.default_rng(seed)
    rot = np.stack([np.linalg.qr(m)[0] for m in rng.standard_normal((c, 3, 3))])
    return (_rand((n, 3), seed + 1, 0.4, device),
            _rand((c, 3), seed + 2, 0.4, device),
            torch.from_numpy(rot.astype(np.float32)).to(device),
            _rand((v, c, d), seed + 3, 1.0, device))


def test_wrappers_refuse_cpu_tensors():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cull.min_excess2_cuda(x, x, torch.zeros(4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        dparf.dparf_cuda(x, x, torch.zeros(4, 3, 3), torch.zeros(1, 4, 8))
    assert kernels.launch_counts() == {"min_excess2": 0, "dparf": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("n, m", [(1, 7), (1000, 1500), (5000, 6890)])
def test_cull_kernel_matches_plain(cuda, n, m):
    """Ragged point and vertex counts (neither a multiple of the block or the
    1,024-reference tile), with a per-reference bias."""
    p, r = _rand((n, 3), 0, 0.5, cuda), _rand((m, 3), 1, 0.4, cuda)
    b = torch.from_numpy(np.random.default_rng(2).random(m).astype(
        np.float32) * 0.01).to(cuda)
    n0 = cull.min_excess2_cuda.launches
    got = cull.min_excess2_cuda(p, r, b)
    assert cull.min_excess2_cuda.launches == n0 + 1
    want = cull.min_excess2_plain(p, r, b)
    # the plain version's expanded form rounds ~1e-6 at |p|^2 ~ 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n, k", [(256, 7), (1000, 4), (3, 1)])
def test_dparf_kernel_matches_plain(cuda, n, k):
    args = _dparf_inputs(n, 300, 3, 192, cuda)
    n0 = dparf.dparf_cuda.launches
    got = dparf.dparf(*args, k=k)
    assert dparf.dparf_cuda.launches == n0 + 1
    want = dparf.dparf_plain(*args, k=k)
    # tok: 7-term sums in another order; pe: the pi*2^9 band magnifies f32
    # rounding of the local coordinates; dist: sqrt of d^2 formed two ways
    for g, w, atol in zip(got, want, (1e-4, 5e-4, 1e-5)):
        torch.testing.assert_close(g, w, atol=atol, rtol=0)


@pytest.mark.cuda
def test_dparf_kernel_ties_go_to_the_lowest_index(cuda):
    centers = torch.tensor([[0, 0, 2], [1, 0, 0], [0, 1, 0], [-1, 0, 0],
                            [0, -1, 0], [0, 0, 1], [0, 0, -1], [3, 0, 0]],
                           dtype=torch.float32, device=cuda)
    rot = torch.stack([torch.eye(3) * (i + 1) for i in range(8)]).to(cuda)
    tokens = torch.arange(2 * 8 * 4, dtype=torch.float32,
                          device=cuda).reshape(2, 8, 4)
    pts = torch.zeros(1, 3, device=cuda)
    got = dparf.dparf_cuda(pts, centers, rot, tokens, k=5)
    want = dparf.dparf_plain(pts, centers, rot, tokens, k=5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    torch.testing.assert_close(got[0][:, 0], tokens[:, 1:6].mean(dim=1))


@pytest.mark.cuda
def test_kernel_arguments_are_checked(cuda):
    pts, centers, rot, tokens = _dparf_inputs(64, 20, 2, 16, cuda)
    with pytest.raises(ValueError, match="k=9"):
        dparf.dparf_cuda(pts, centers, rot, tokens, k=9)
    with pytest.raises(ValueError, match="n_freqs"):
        dparf.dparf_cuda(pts, centers, rot, tokens, n_freqs=4)
    with pytest.raises(TypeError, match="float32"):
        dparf.dparf_cuda(pts.double(), centers, rot, tokens)
    with pytest.raises(ValueError, match="contiguous"):
        cull.min_excess2_cuda(pts.t().contiguous().t(), centers,
                              torch.zeros(20, device=cuda))
    out = cull.min_excess2_cuda(pts[:0], centers, torch.zeros(20, device=cuda))
    assert out.shape == (0,)
