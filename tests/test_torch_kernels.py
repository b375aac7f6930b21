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
from transhuman_tpu_torch.kernels import cull, dparf, gather, scatter


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
    with pytest.raises(ValueError, match="CUDA tensor"):
        scatter.dfeat_scatter_cuda(torch.zeros(1, 4, dtype=torch.int32),
                                   torch.zeros(1, 4, 8), torch.zeros(1, 4, 4),
                                   64, 1, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gather.feature_gather_cuda(torch.zeros(1, 64, 8),
                                   torch.zeros(1, 4, dtype=torch.int32),
                                   torch.zeros(1, 4, 1), (0,))
    assert kernels.launch_counts() == {"min_excess2": 0, "dparf": 0,
                                       "dfeat_scatter": 0,
                                       "feature_gather": 0}


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
    # the neighbours and their weights, for the token gradient
    torch.testing.assert_close(got[3].long(), want[3], atol=0, rtol=0)
    torch.testing.assert_close(got[4], want[4], atol=1e-5, rtol=0)


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
    for g, w in zip(got[:3] + got[4:], want[:3] + want[4:]):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    assert got[3].tolist() == [[1, 2, 3, 4, 5]] == want[3].tolist()
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


HF = WF = 64
N_SCATTER = 1000  # ragged: not a multiple of the kernel's 64-row segments
_HI = HF * WF - WF - 2  # largest base id whose four taps stay in the map
ID_PATTERNS = {  # the id patterns of tests/test_streamscatter.py
    "uniform": lambda rng, n: rng.integers(0, _HI, n),
    "clustered": lambda rng, n: np.repeat(
        rng.integers(0, _HI // 8, -(-n // 8)) * 8, 8)[:n],
    "window_boundary": lambda rng, n: np.clip(
        rng.integers(-8, 8, n) + 1024, 0, _HI),
    "all_equal": lambda rng, n: np.full(n, 7),
}


def _scatter_inputs(pattern, v, n, c, device, seed=3):
    rng = np.random.default_rng(seed)
    ids = np.stack([ID_PATTERNS[pattern](rng, n) for _ in range(v)])
    wx, wy = rng.random((2, v, n)).astype(np.float32)
    w4 = np.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy,
                   wx * wy], axis=-1)
    g = rng.standard_normal((v, n, c)).astype(np.float32)
    return (torch.from_numpy(ids.astype(np.int32)).to(device),
            torch.from_numpy(g).to(device), torch.from_numpy(w4).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [384, 192])
@pytest.mark.parametrize("pattern", sorted(ID_PATTERNS))
def test_dfeat_scatter_kernel_matches_plain(cuda, pattern, c):
    """Unsorted ids (the wrapper sorts), two views, both train widths."""
    ids, g, w4 = _scatter_inputs(pattern, 2, N_SCATTER, c, cuda)
    n0 = scatter.dfeat_scatter_cuda.launches
    got = scatter.dfeat_scatter(ids, g, w4, HF * WF, 1, WF)
    assert scatter.dfeat_scatter_cuda.launches == n0 + 1
    want = scatter.dfeat_scatter_plain(ids, g, w4, HF * WF, 1, WF)
    # float32 sums whose order the atomics change from run to run; the
    # all_equal texel sums ~1000 rows of magnitude ~1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


def _knn_near_ties(pts, centers, k: int):
    """(N,) bool: a gap among the k+1 nearest squared distances (float64)
    within 1e-6 relative + 1e-6 absolute, where the kernel's and the plain
    version's d^2 forms may rank two neighbours differently."""
    d2 = torch.cdist(pts.double(), centers.double()) ** 2
    top = torch.topk(d2, min(k + 1, d2.shape[1]), largest=False).values
    gaps = top[:, 1:] - top[:, :-1]
    return (gaps <= 1e-6 * top[:, 1:] + 1e-6).any(dim=1)


@pytest.mark.cuda
def test_dparf_token_gradient_matches_autograd(cuda):
    """The K2 Function's backward against autograd through the plain
    composition; near-tie points get a zero cotangent on both sides."""
    pts, centers, rot, tokens = _dparf_inputs(4096, 300, 3, 192, cuda)
    g = _rand((3, 4096, 192), 7, 1.0, cuda)
    g[:, _knn_near_ties(pts, centers, 7)] = 0.0
    tk = tokens.clone().requires_grad_(True)
    n0 = dparf.dparf_cuda.launches
    (dparf.dparf(pts, centers, rot, tk)[0] * g).sum().backward()
    assert dparf.dparf_cuda.launches == n0 + 1
    tp = tokens.clone().requires_grad_(True)
    (dparf.dparf_plain(pts, centers, rot, tp)[0] * g).sum().backward()
    # a sum over ~100 points per centre of weighted cotangents, two orders
    torch.testing.assert_close(tk.grad, tp.grad, atol=1e-4, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="tokens only"):
        dparf.dparf(pts.clone().requires_grad_(True), centers, rot, tokens)


@pytest.mark.cuda
def test_dfeat_scatter_arguments_are_checked(cuda):
    ids, g, w4 = _scatter_inputs("uniform", 1, 100, 8, cuda)
    with pytest.raises(TypeError, match="int32"):
        scatter.dfeat_scatter_cuda(ids.long(), g, w4, HF * WF, 1, WF)
    with pytest.raises(ValueError, match="want"):
        scatter.dfeat_scatter_cuda(ids, g, w4[:, :50], HF * WF, 1, WF)
    out = scatter.dfeat_scatter_cuda(ids[:, :0], g[:, :0], w4[:, :0],
                                     HF * WF, 1, WF)
    assert out.shape == (1, HF * WF, 8) and not out.any()


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [-1, HF * WF - WF - 1])
def test_dfeat_scatter_refuses_ids_outside_the_map(cuda, bad):
    """A base id below 0, or one whose last tap (+WF+1) reaches hw, is
    refused before the launch, as index_add_ refuses it."""
    ids, g, w4 = _scatter_inputs("uniform", 2, 100, 8, cuda)
    ids[1, 37] = bad
    n0 = scatter.dfeat_scatter_cuda.launches
    with pytest.raises(IndexError, match="must lie in"):
        scatter.dfeat_scatter_cuda(ids, g, w4, HF * WF, 1, WF)
    assert scatter.dfeat_scatter_cuda.launches == n0


def _gather_inputs(taps, v, n, c, device, seed=5):
    """A (v, HF*WF, c) map, base ids with every fifth one -1 (a zero row),
    and weights: bilinear for 4 taps, random or ones for 1."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((v, HF * WF, c)).astype(np.float32)
    ids = rng.integers(0, _HI, (v, n)).astype(np.int32)
    ids[:, ::5] = -1
    if taps == "bilinear":
        wx, wy = rng.random((2, v, n)).astype(np.float32)
        w = np.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy,
                      wx * wy], axis=-1)
        offsets = (0, 1, WF, WF + 1)
    else:
        w = (rng.random((v, n, 1)).astype(np.float32) if taps == "weighted"
             else np.ones((v, n, 1), np.float32))
        offsets = (0,)
    t = torch.from_numpy
    return (t(src).to(device), t(ids).to(device), t(w).to(device), offsets)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [384, 192, 6])
@pytest.mark.parametrize("taps", ["bilinear", "weighted", "rows"])
def test_feature_gather_kernel_matches_plain(cuda, taps, c):
    """K4's three forms (the bilinear fetch; T3's weighted and T5's plain
    row gather), masked ids, the float4 (c % 4 == 0) and scalar paths."""
    src, ids, w, offsets = _gather_inputs(taps, 3, N_SCATTER, c, cuda)
    n0 = gather.feature_gather_cuda.launches
    got = gather.feature_gather(src, ids, w, offsets)
    assert gather.feature_gather_cuda.launches == n0 + 1
    want = gather.feature_gather_plain(src, ids, w, offsets)
    # fused multiply-adds against rounded products: at most four roundings
    # of sums below ~5 (ulp 4.8e-7)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
    assert not got[:, ::5].any()  # masked ids: zero rows
    if taps == "rows":
        v = torch.arange(3, device=cuda)[:, None]
        keep = ids >= 0
        assert torch.equal(got[keep], src[v.expand_as(ids)[keep],
                                          ids[keep].long()])


@pytest.mark.cuda
def test_feature_gather_arguments_are_checked(cuda):
    src, ids, w, offsets = _gather_inputs("bilinear", 2, 100, 8, cuda)
    with pytest.raises(TypeError, match="int32"):
        gather.feature_gather_cuda(src, ids.long(), w, offsets)
    with pytest.raises(ValueError, match="1 or 4 taps"):
        gather.feature_gather_cuda(src, ids, w, offsets[:2])
    ids[1, 37] = HF * WF - WF - 1  # its last tap reaches HF * WF
    n0 = gather.feature_gather_cuda.launches
    with pytest.raises(IndexError, match="must lie in"):
        gather.feature_gather_cuda(src, ids, w, offsets)
    assert gather.feature_gather_cuda.launches == n0
    out = gather.feature_gather_cuda(src, ids[:, :0], w[:, :0], offsets)
    assert out.shape == (2, 0, 8)
