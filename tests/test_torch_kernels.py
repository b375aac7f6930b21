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
    with pytest.raises(ValueError, match="CUDA tensor"):
        gather.feature_sample_cuda(torch.zeros(1, 8, 8, 4),
                                   torch.zeros(1, 4, 2), (16, 16))
    assert kernels.launch_counts() == {"min_excess2": 0, "dparf": 0,
                                       "dfeat_scatter": 0,
                                       "feature_gather": 0, "dparf_bf16": 0,
                                       "dfeat_scatter_bf16": 0,
                                       "feature_sample_bf16": 0}


def test_kernel_ab_inputs_are_seeded_and_it_needs_a_card(monkeypatch):
    """The A/B tool's inputs (chip_smoke.py phase 3's) are the same on
    every call; without a card the tool stops before building anything."""
    from transhuman_tpu_torch.tools import kernel_ab

    a = kernel_ab.phase3_inputs("cpu", 64)
    b = kernel_ab.phase3_inputs("cpu", 64)
    assert [tuple(t.shape) for t in a] == [(64, 3), (6890, 3), (300, 3),
                                           (300, 3, 3), (3, 300, 192)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        kernel_ab.main(["--parent", "."])


@pytest.mark.cuda
@pytest.mark.parametrize("n, m", [(1, 7), (1000, 1500), (5000, 6890)])
def test_cull_kernel_matches_plain(cuda, n, m):
    """Ragged point and vertex counts (neither a multiple of the block's 128
    points or the 2,048-reference tile), with a per-reference bias."""
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
@pytest.mark.parametrize("m", [1, 31, 6890, 10000])
@pytest.mark.parametrize("n", [1, 5000])
def test_cull_kernel_edges(cuda, n, m):
    """M below the 16 reference splits of a block (1), not a multiple of
    them (31), a chunk's vertices (6,890) and several 2,048-reference tiles
    (10,000); N not a multiple of the 4 points per thread; biases of 0.2 to
    0.6, larger than many d^2, so that minima go negative."""
    p, r = _rand((n, 3), 3, 0.5, cuda), _rand((m, 3), 4, 0.4, cuda)
    b = torch.from_numpy(0.2 + np.random.default_rng(5).random(m).astype(
        np.float32) * 0.4).to(cuda)
    got = cull.min_excess2_cuda(p, r, b)
    want = cull.min_excess2_plain(p, r, b)
    assert n == 1 or bool((want < 0).any())
    # both expanded forms, summed in other orders: a few ulps of |p|^2 <~ 4
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


def _assert_dparf_matches_plain(got, want, pts, centers, k):
    """K2's outputs against the plain twin's: dist everywhere, the rest off
    kNN near-ties (d^2 formed two ways may rank those differently)."""
    ok = ~_knn_near_ties(pts, centers, k)
    torch.testing.assert_close(got[2], want[2], atol=1e-5, rtol=0)
    assert torch.equal(got[3].long()[ok], want[3][ok])
    torch.testing.assert_close(got[4][ok], want[4][ok], atol=1e-5, rtol=0)
    torch.testing.assert_close(got[0][:, ok], want[0][:, ok], atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(got[1][ok], want[1][ok], atol=5e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("c, k, n, d", [
    (8, 8, 37, 192),      # C == k
    (33, 5, 1001, 192),   # C not a multiple of 32; N ragged to 8 per block
    (300, 7, 2051, 20),   # D % 4 != 0: the scalar token path
    (1000, 8, 517, 192),  # C above 32 K
    *[(300, kk, 259, 192) for kk in range(1, 9)],  # every k, one kernel
])
def test_dparf_kernel_shapes(cuda, c, k, n, d):
    args = _dparf_inputs(n, c, 3, d, cuda, seed=c + k)
    got = dparf.dparf_cuda(*args, k=k)
    want = dparf.dparf_plain(*args, k=k)
    _assert_dparf_matches_plain(got, want, args[0], args[1], k)


@pytest.mark.cuda
def test_dparf_kernel_misaligned_tokens_take_the_scalar_path(cuda):
    pts, centers, rot, tokens = _dparf_inputs(300, 300, 3, 192, cuda)
    buf = torch.empty(tokens.numel() + 1, device=cuda)
    shifted = buf[1:].view(tokens.shape)  # contiguous, 4 bytes off 16
    shifted.copy_(tokens)
    got = dparf.dparf_cuda(pts, centers, rot, shifted, k=7)
    want = dparf.dparf_plain(pts, centers, rot, tokens, k=7)
    _assert_dparf_matches_plain(got, want, pts, centers, 7)


@pytest.mark.cuda
def test_dparf_kernel_exact_ties_match_the_plain_argmin(cuda):
    """Dyadic points and centres (multiples of 1/8), so that every d^2 is
    exact in both forms and many tie exactly.  At the origin centres 5, 6,
    37 and 38 tie nearest: 5 and 37 belong to one lane (met in two
    rounds), 5 and 6 to neighbouring lanes (met in one shuffle).  The
    indices equal the plain twin's iterative argmin everywhere."""
    rng = np.random.default_rng(11)
    c, k = 70, 7
    # every coordinate in +-{2..8}/8: no random centre within 0.25 of 0
    centers = (rng.integers(2, 9, (c, 3)) * rng.choice([-1, 1], (c, 3))
               ).astype(np.float32) / 8
    for j, (x, y) in ((5, (1, 1)), (6, (1, -1)), (37, (-1, 1)),
                      (38, (-1, -1))):
        centers[j] = (x / 8, y / 8, 0)
    pts = rng.integers(-8, 9, (500, 3)).astype(np.float32) / 8
    pts[0] = 0
    rot = np.stack([np.linalg.qr(m)[0] for m in
                    rng.standard_normal((c, 3, 3))]).astype(np.float32)
    tokens = rng.standard_normal((3, c, 192)).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda) for a in (pts, centers, rot, tokens)]
    got = dparf.dparf_cuda(*args, k=k)
    want = dparf.dparf_plain(*args, k=k)
    assert got[3][0, :4].tolist() == [5, 6, 37, 38]
    assert torch.equal(got[3].long(), want[3])
    for g, w, atol in zip(got[:3] + got[4:], want[:3] + want[4:],
                          (1e-4, 5e-4, 1e-5, 1e-5)):
        torch.testing.assert_close(g, w, atol=atol, rtol=0)


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
    # float32 sums in another order (segments of sorted rows, then taps);
    # the all_equal texel sums ~1000 rows of magnitude ~1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    # no atomics: every sum in a fixed order, the same bits on every call
    assert torch.equal(got, scatter.dfeat_scatter(ids, g, w4, HF * WF, 1, WF))


# (hw, dx, dy, largest base id): the bilinear taps on maps one texel wide
# (dx = 0) and one tall (dy = 0), and the TPU scatter probe's taps +0..+3
TAP_LAYOUTS = {
    "one_column": (64, 0, 1, 62),
    "one_row": (64, 1, 0, 62),
    "probe_t7": (4104, 1, 2, 4100),
}


@pytest.mark.cuda
@pytest.mark.parametrize("c", [384, 192, 6])
@pytest.mark.parametrize("layout", sorted(TAP_LAYOUTS) + ["map_edges"])
def test_dfeat_scatter_kernel_tap_layouts(cuda, layout, c):
    """Base ids anywhere their taps allow: on maps one texel wide or tall
    (two offsets coincide and both taps land on one texel), in the T7 form,
    and on the last base column and row of a 64x64 map; C = 6 takes the
    scalar path.  Two calls give the same bits."""
    rng = np.random.default_rng(8)
    if layout == "map_edges":
        hw, dx, dy = HF * WF, 1, WF
        col = rng.integers(0, HF - 1, N_SCATTER) * WF + WF - 2
        row = (HF - 2) * WF + rng.integers(0, WF - 1, N_SCATTER)
        ids = np.where(rng.random(N_SCATTER) < 0.5, col, row)
        ids[:50] = _HI
    else:
        hw, dx, dy, hi = TAP_LAYOUTS[layout]
        ids = rng.integers(0, hi + 1, N_SCATTER)
        ids[:50] = hi
    _, g, w4 = _scatter_inputs("uniform", 2, N_SCATTER, c, cuda)
    ids = torch.from_numpy(np.stack([ids, ids[::-1]]).astype(np.int32)).to(
        cuda)
    got = scatter.dfeat_scatter(ids, g, w4, hw, dx, dy)
    want = scatter.dfeat_scatter_plain(ids, g, w4, hw, dx, dy)
    # the one_column / one_row texels sum up to ~60 rows of magnitude ~1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    assert torch.equal(got, scatter.dfeat_scatter(ids, g, w4, hw, dx, dy))


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


SF_IMAGE = (128, 160)  # maps at half the image size on both axes


def _sampling_uv(rng, n, hf, wf):
    """uv (3, n, 2) image pixels: inside the image, on every border (x and
    y at 0 and at the last texel exactly), past the borders, far outside
    (the clamped projections of points on a camera's principal plane)."""
    h_img, w_img = SF_IMAGE
    uv = np.stack([rng.uniform(-8, w_img + 8, (3, n)),
                   rng.uniform(-8, h_img + 8, (3, n))], axis=-1)
    uv[:, 0:16, 0] = 0.0
    uv[:, 16:32, 0] = w_img * (wf - 1) / max(wf, 1)
    uv[:, 32:48, 1] = 0.0
    uv[:, 48:64, 1] = h_img * (hf - 1) / max(hf, 1)
    uv[:, 64:80] = rng.choice([-1e12, 1e12], (3, 16, 2))
    return uv.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [384, 192, 6])
@pytest.mark.parametrize("hf, wf", [(64, 80), (64, 1), (1, 80)])
def test_feature_sample_is_the_id_form_bit_for_bit(cuda, hf, wf, c):
    """K4's sampling form forms _sample_taps' ids and _bilinear_w4's weights
    itself: it equals the id form launched on them (computed by torch on the
    card) bit for bit, and the plain twin within the id form's tolerance;
    maps one texel wide or tall; C = 6 takes the scalar path."""
    from transhuman_tpu_torch.kernels.gather import _bilinear_w4, _sample_taps

    rng = np.random.default_rng(hf + wf + c)
    feat = _rand((3, hf, wf, c), 9, 1.0, cuda)
    uv = torch.from_numpy(_sampling_uv(rng, N_SCATTER, hf, wf)).to(cuda)
    n0 = gather.feature_gather_cuda.launches
    got = gather.feature_sample(feat, uv, SF_IMAGE)
    assert gather.feature_gather_cuda.launches == n0 + 1
    _, _, base, wx, wy, dx, dy = _sample_taps(feat.shape, uv, SF_IMAGE)
    ids = gather.feature_gather(feat.reshape(3, hf * wf, c), base,
                                _bilinear_w4(wx, wy), (0, dx, dy, dy + dx))
    assert torch.equal(got, ids)
    want = gather.feature_sample_plain(feat, uv, SF_IMAGE)
    # fused multiply-adds against rounded products (as the id form)
    scale = float(feat.abs().max())
    torch.testing.assert_close(got, want, atol=1e-6 * scale + 1e-7, rtol=0)


@pytest.mark.cuda
def test_sample_feature_map_forward_is_one_launch_without_a_sync(cuda):
    """The forward on the card is one K4 launch and never waits for the
    card: it runs under set_sync_debug_mode("error"), with and without a
    gradient asked for."""
    from transhuman_tpu_torch.kernels import build
    from transhuman_tpu_torch.ops.sampling import sample_feature_map

    build.library()  # built and loaded before the guarded region
    rng = np.random.default_rng(10)
    feat = _rand((3, 64, 80, 384), 11, 1.0, cuda)
    uv = torch.from_numpy(_sampling_uv(rng, 4096, 64, 80)).to(cuda)
    want = gather.feature_sample_plain(feat, uv, SF_IMAGE)
    for grad in (False, True):
        f = feat.clone().requires_grad_(grad)
        torch.cuda.synchronize()
        n0 = gather.feature_gather_cuda.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = sample_feature_map(f, uv, SF_IMAGE)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert gather.feature_gather_cuda.launches == n0 + 1
        assert out.requires_grad == grad
        torch.testing.assert_close(out.detach(), want, atol=1e-5, rtol=0)


# --------------------------------------------------------------- bf16 forms
BF16 = torch.bfloat16


def test_bf16_forms_refuse_cpu_tensors():
    before = kernels.launch_counts()
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dparf.dparf_bf16_cuda(x, x, torch.zeros(4, 3, 3),
                              torch.zeros(1, 4, 8, dtype=BF16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        scatter.dfeat_scatter_bf16_cuda(
            torch.zeros(1, 4, dtype=torch.int32),
            torch.zeros(1, 4, 8, dtype=BF16), torch.zeros(1, 4, 4), 64, 1, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gather.feature_sample_bf16_cuda(torch.zeros(1, 8, 8, 8, dtype=BF16),
                                        torch.zeros(1, 4, 2), (16, 16))
    assert kernels.launch_counts() == before


@pytest.mark.cuda
def test_each_entry_refuses_the_other_dtype(cuda):
    """A bf16 tensor handed to a float32-only entry, and a float32 one to a
    bf16 form, is a TypeError, not a launch."""
    before = kernels.launch_counts()
    pts, centers, rot, tokens = _dparf_inputs(64, 20, 2, 16, cuda)
    ids, g, w4 = _scatter_inputs("uniform", 2, 64, 8, cuda)
    feat = _rand((2, 64, 64, 8), 12, 1.0, cuda)
    uv = torch.zeros((2, 16, 2), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        cull.min_excess2_cuda(pts.to(BF16), centers,
                              torch.zeros(20, device=cuda))
    with pytest.raises(TypeError, match="float32"):
        dparf.dparf_cuda(pts, centers, rot, tokens.to(BF16))
    with pytest.raises(TypeError, match="bfloat16"):
        dparf.dparf_bf16_cuda(pts, centers, rot, tokens)
    with pytest.raises(TypeError, match="float32"):
        dparf.dparf_bf16_cuda(pts.to(BF16), centers, rot, tokens.to(BF16))
    with pytest.raises(TypeError, match="float32"):
        scatter.dfeat_scatter_cuda(ids, g.to(BF16), w4, HF * WF, 1, WF)
    with pytest.raises(TypeError, match="bfloat16"):
        scatter.dfeat_scatter_bf16_cuda(ids, g, w4, HF * WF, 1, WF)
    with pytest.raises(TypeError, match="float32"):
        gather.feature_gather_cuda(feat.reshape(2, -1, 8).to(BF16),
                                   ids[:, :16].contiguous(),
                                   w4[:, :16].contiguous(), (0, 1, 64, 65))
    with pytest.raises(TypeError, match="float32"):
        gather.feature_sample_cuda(feat.to(BF16), uv, SF_IMAGE)
    with pytest.raises(TypeError, match="bfloat16"):
        gather.feature_sample_bf16_cuda(feat, uv, SF_IMAGE)
    assert kernels.launch_counts() == before


def _rounded(x):
    """x rounded to bf16: the bf16 forms' inputs, widened exactly by the
    float32 oracle."""
    return x.to(BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("c, n", [(384, 32768), (192, 6890)])
def test_feature_sample_bf16_is_the_f32_form_cast(cuda, c, n):
    """K4's bf16 form at the serve pixel shape (C = 384, a 32,768-point
    chunk) and the painting shape (C = 192, 6,890 vertices) of 3 512x512
    maps: feature_sample_cuda on the widened map, then one RNE cast, bit
    for bit; C = 6 odd widths take the scalar path (below)."""
    rng = np.random.default_rng(c)
    feat = _rounded(_rand((3, 512, 512, c), 13, 1.0, cuda))
    h_img = w_img = 512
    uv = np.stack([rng.uniform(-8, w_img + 8, (3, n)),
                   rng.uniform(-8, h_img + 8, (3, n))], axis=-1)
    uv = torch.from_numpy(uv.astype(np.float32)).to(cuda)
    n0 = gather.feature_sample_bf16_cuda.launches
    got = gather.feature_sample(feat, uv, (h_img, w_img))
    assert gather.feature_sample_bf16_cuda.launches == n0 + 1
    assert got.dtype == BF16
    want = gather.feature_sample_cuda(feat.float(), uv,
                                      (h_img, w_img)).to(BF16)
    assert torch.equal(got, want)
    torch.testing.assert_close(
        got.float(), gather.feature_sample_plain(feat, uv, (h_img,
                                                            w_img)).float(),
        atol=2**-7 * float(feat.float().abs().max()), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [6, 8, 20])
def test_feature_sample_bf16_scalar_and_odd_widths(cuda, c):
    """Widths that are not a multiple of the 8-channel word (6, 20) take
    the scalar path; 8 is one word; maps one texel wide or tall too."""
    for hf, wf in ((64, 80), (64, 1), (1, 80)):
        rng = np.random.default_rng(hf + wf + c)
        feat = _rounded(_rand((3, hf, wf, c), 14, 1.0, cuda))
        uv = torch.from_numpy(_sampling_uv(rng, N_SCATTER, hf, wf)).to(cuda)
        got = gather.feature_sample_bf16_cuda(feat, uv, SF_IMAGE)
        want = gather.feature_sample_cuda(feat.float(), uv, SF_IMAGE)
        assert torch.equal(got, want.to(BF16)), (hf, wf)


@pytest.mark.cuda
@pytest.mark.parametrize("tag, n, c", [("pixel", 153600, 384),
                                       ("paint", 6890, 192)])
def test_dfeat_scatter_bf16_is_the_f32_form_cast(cuda, tag, n, c):
    """K3's bf16 form at both train shapes (3 512x512 maps; the pixel
    fetch's 153,600 points of 384 channels, the painting fetch's 6,890 of
    192): the float32 form on the widened rows, then one RNE cast, bit for
    bit; two calls give the same bits."""
    rng = np.random.default_rng(n)
    hw, wf = 512 * 512, 512
    # clustered base ids, as a train batch's (~30 points per touched texel)
    ids = np.stack([np.repeat(rng.integers(0, hw - wf - 2, -(-n // 30)),
                              30)[:n] for _ in range(3)])
    wx, wy = rng.random((2, 3, n)).astype(np.float32)
    w4 = np.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy,
                   wx * wy], axis=-1)
    ids = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    w4 = torch.from_numpy(w4).to(cuda)
    g = _rounded(_rand((3, n, c), 15, 1.0, cuda))
    n0 = scatter.dfeat_scatter_bf16_cuda.launches
    got = scatter.dfeat_scatter(ids, g, w4, hw, 1, wf)
    assert scatter.dfeat_scatter_bf16_cuda.launches == n0 + 1
    assert got.dtype == BF16
    again = scatter.dfeat_scatter_bf16_cuda(ids, g, w4, hw, 1, wf)
    want = scatter.dfeat_scatter_cuda(ids, g.float(), w4, hw, 1, wf)
    assert torch.equal(got, want.to(BF16))
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [6, 8])
def test_dfeat_scatter_bf16_tap_layouts(cuda, c):
    """The bf16 form on T7's taps and the 4-tap layouts of the float32
    tests, scalar (C = 6) and one word (C = 8) wide."""
    ids, g, w4 = _scatter_inputs("clustered", 2, N_SCATTER, c, cuda)
    g = _rounded(g)
    for dx, dy in ((1, WF), (1, 2), (0, WF), (1, 0)):
        got = scatter.dfeat_scatter_bf16_cuda(ids, g, w4, HF * WF, dx, dy)
        want = scatter.dfeat_scatter_cuda(ids, g.float(), w4, HF * WF, dx,
                                          dy)
        assert torch.equal(got, want.to(BF16)), (dx, dy)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [7, 4, 1])
@pytest.mark.parametrize("d", [192, 20])
def test_dparf_bf16_is_the_f32_form_cast(cuda, k, d):
    """K2 with bf16 tokens at the render chunk (32,768 points, C = 300,
    V = 3, D = 192) and D = 20 (the scalar path): tok is the float32 form's
    on the widened tokens cast once, and pe, dist, idx and w are its
    outputs, bit for bit."""
    n = 32768 if d == 192 else 1000
    pts, centers, rot, tokens = _dparf_inputs(n, 300, 3, d, cuda)
    tokens = _rounded(tokens)
    n0 = dparf.dparf_bf16_cuda.launches
    got = dparf.dparf(pts, centers, rot, tokens, k=k)
    assert dparf.dparf_bf16_cuda.launches == n0 + 1
    want = dparf.dparf_cuda(pts, centers, rot, tokens.float(), k=k)
    assert got[0].dtype == BF16
    assert torch.equal(got[0], want[0].to(BF16))
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_dparf_bf16_token_gradient_is_float32_summed(cuda):
    """The token gradient of bf16 tokens: the float32 gradient of the
    widened tokens cast once."""
    pts, centers, rot, tokens = _dparf_inputs(4096, 300, 3, 192, cuda)
    g = _rounded(_rand((3, 4096, 192), 16, 1.0, cuda))
    t16 = _rounded(tokens).requires_grad_(True)
    (dparf.dparf(pts, centers, rot, t16, k=7)[0].float() * g.float()
     ).sum().backward()
    t32 = _rounded(tokens).float().requires_grad_(True)
    (dparf.dparf(pts, centers, rot, t32, k=7)[0] * g.float()).sum().backward()
    assert t16.grad.dtype == BF16
    assert torch.equal(t16.grad, t32.grad.to(BF16))
