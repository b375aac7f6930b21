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
                                       "feature_sample_bf16": 0,
                                       "feature_sample_int8": 0}


def test_kernel_ab_inputs_are_seeded_and_it_needs_a_card(monkeypatch):
    """The A/B tool's inputs (chip_smoke.py phase 3's) are the same on
    every call; without a card the tool stops before building anything."""
    from transhuman_tpu_torch.tools import kernel_ab

    a = kernel_ab.phase3_inputs("cpu", 64)
    b = kernel_ab.phase3_inputs("cpu", 64)
    assert [tuple(t.shape) for t in a] == [(64, 3), (6890, 3), (300, 3),
                                           (300, 3, 3), (3, 300, 192)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # the survivor-size inputs (the median chunk's cull survivors of the
    # serve request), here at a 16x16 request: one chunk
    s1 = kernel_ab.survivor_inputs("cpu", (16, 16))
    s2 = kernel_ab.survivor_inputs("cpu", (16, 16))
    n = s1["pts"].shape[0]
    assert s1["counts"] == s2["counts"] and n in s1["counts"]
    assert 0 < n <= kernel_ab.N_CHUNK
    assert [tuple(s1[k].shape) for k in ("pts", "centers", "rot", "uv")] == [
        (n, 3), (300, 3), (300, 3, 3), (3, n, 2)]
    assert all(torch.equal(s1[k], s2[k])
               for k in ("pts", "centers", "rot", "uv"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        kernel_ab.main(["--parent", "."])


def _in_threads(n_threads: int, fn):
    """Run fn in n_threads threads at once with a short switch interval;
    join each within 60 s."""
    import sys
    import threading

    start = threading.Barrier(n_threads)

    def run():
        start.wait()
        fn()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)


def test_launch_counts_add_up_across_threads():
    """count_launches loses no update when 16 threads count at once."""
    from transhuman_tpu_torch.kernels import build

    def wrapper():
        pass

    wrapper.launches = 0

    def count():
        for _ in range(2000):
            build.count_launches(wrapper)
        build.count_launches(wrapper, 3)

    _in_threads(16, count)
    assert wrapper.launches == 16 * 2003
    build.reset_launches([wrapper])
    assert wrapper.launches == 0


@pytest.mark.cuda
def test_kernel_launch_counts_add_up_across_threads(cuda):
    """R threads each launch K1 N times on the card (as the shares of a
    ray-sharded render do): the count comes out R·N."""
    r, n = 4, 50
    p, ref = _rand((1000, 3), 0, 0.5, cuda), _rand((700, 3), 1, 0.4, cuda)
    b = torch.zeros(700, device=cuda)
    cull.min_excess2_cuda(p, ref, b)  # build and load before the threads
    kernels.reset_launch_counts()

    def launch():
        with torch.cuda.device(cuda):
            for _ in range(n):
                cull.min_excess2_cuda(p, ref, b)

    _in_threads(r, launch)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["min_excess2"] == r * n


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


def _exact_tie_inputs(device, n=500, d=192):
    """Dyadic points and 70 centres (multiples of 1/8): every d^2 is exact
    in both forms and many tie exactly; centres 5, 6, 37 and 38 tie nearest
    to point 0, the origin."""
    rng = np.random.default_rng(11)
    c = 70
    # every coordinate in +-{2..8}/8: no random centre within 0.25 of 0
    centers = (rng.integers(2, 9, (c, 3)) * rng.choice([-1, 1], (c, 3))
               ).astype(np.float32) / 8
    for j, (x, y) in ((5, (1, 1)), (6, (1, -1)), (37, (-1, 1)),
                      (38, (-1, -1))):
        centers[j] = (x / 8, y / 8, 0)
    pts = rng.integers(-8, 9, (n, 3)).astype(np.float32) / 8
    pts[0] = 0
    rot = np.stack([np.linalg.qr(m)[0] for m in
                    rng.standard_normal((c, 3, 3))]).astype(np.float32)
    tokens = rng.standard_normal((3, c, d)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (pts, centers, rot,
                                                      tokens)]


@pytest.mark.cuda
def test_dparf_kernel_exact_ties_match_the_plain_argmin(cuda):
    """Dyadic points and centres (multiples of 1/8), so that every d^2 is
    exact in both forms and many tie exactly.  At the origin centres 5, 6,
    37 and 38 tie nearest: 5 and 37 belong to one lane (met in two
    rounds), 5 and 6 to neighbouring lanes (met in one shuffle).  The
    indices equal the plain twin's iterative argmin everywhere."""
    k = 7
    args = _exact_tie_inputs(cuda)
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
@pytest.mark.parametrize("c, n", [(384, 32768), (192, 6890), (384, 26321),
                                  (768, 4901), (384, 1), (24, 1001),
                                  (16, 333), (8, 97)])
def test_feature_sample_bf16_is_the_f32_form_cast(cuda, c, n):
    """K4's bf16 form at the serve pixel shape (C = 384, a 32,768-point
    chunk, and about a chunk's cull survivors), the painting shape (C =
    192, 6,890 vertices), C = 768 (a row wider than a warp's 96 words) and
    rows of 3, 2 and 1 word (C = 24, 16, 8: groups of 32, 48 and 96 rows),
    at ragged point counts, of 3 512x512 maps: feature_sample_cuda on the
    widened map, then one RNE cast, bit for bit; odd widths take the scalar
    path (below)."""
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
@pytest.mark.parametrize("c", [6, 8, 16, 20, 24, 40, 100, 200])
@pytest.mark.parametrize("n", [N_SCATTER, 97])
def test_feature_sample_bf16_scalar_and_odd_widths(cuda, c, n):
    """Widths that are not a multiple of the 8-channel word (6, 20, 100)
    take the scalar path (groups of 16, 4 and 1 rows, 200 of two chunks); 8,
    16, 24, 40 and 200 are words of rows that fill a warp's 96 words or
    not; ragged row counts; maps one texel wide or tall too; a map and rows
    2 bytes off 16 take the scalar path whatever the width."""
    for hf, wf in ((64, 80), (64, 1), (1, 80)):
        rng = np.random.default_rng(hf + wf + c)
        feat = _rounded(_rand((3, hf, wf, c), 14, 1.0, cuda))
        uv = torch.from_numpy(_sampling_uv(rng, n, hf, wf)).to(cuda)
        got = gather.feature_sample_bf16_cuda(feat, uv, SF_IMAGE)
        want = gather.feature_sample_cuda(feat.float(), uv, SF_IMAGE)
        assert torch.equal(got, want.to(BF16)), (hf, wf)
    buf = torch.empty(feat.numel() + 1, dtype=BF16, device=cuda)
    shifted = buf[1:].view(feat.shape)
    shifted.copy_(feat)
    got = gather.feature_sample_bf16_cuda(shifted, uv, SF_IMAGE)
    assert torch.equal(got, want.to(BF16))


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


def _bf16_edge_ids(case, rng, hw, wf):
    """(2, n) base ids of one view pair, unsorted, at an edge of the bf16
    form's design: its segments (at most 64 sorted positions of one run,
    cut at multiples of 64), its long segments (at least 8 positions, a
    slot each) and short ones (summed from their rows), its runs table."""
    hi = hw - wf - 2  # the largest base id whose taps lie in the map
    if case == "run_longer_than_seg":  # 200 equal ids: 4 segments
        ids = np.concatenate([np.full(200, 77), rng.integers(0, hi, 300)])
    elif case == "run_crosses_a_tile":  # sorted, runs straddle 64, 128
        ids = np.repeat(np.arange(100, 140), [3, 11, 5, 61, 9, 2, 7, 70] * 5)
    elif case == "every_id_distinct":
        ids = rng.permutation(hi)[:700]
    elif case == "one_position":
        ids = np.array([hi // 2])
    elif case == "last_texels":  # the last base column and row, and hi
        col = rng.integers(0, hw // wf - 1, 300) * wf + wf - 2
        row = (hw // wf - 2) * wf + rng.integers(0, wf - 1, 300)
        ids = np.concatenate([col, row, np.full(40, hi)])
    else:  # "run_lengths": every run length from 1 to 70, shuffled
        ids = np.repeat(rng.choice(hi, 70, replace=False), np.arange(1, 71))
    ids = rng.permutation(ids)
    return np.stack([ids, rng.permutation(ids)])


BF16_EDGES = ["run_longer_than_seg", "run_crosses_a_tile", "every_id_distinct",
              "one_position", "last_texels", "run_lengths"]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 192, 384, 768, 20])
@pytest.mark.parametrize("case", BF16_EDGES)
def test_dfeat_scatter_bf16_design_edges(cuda, case, c):
    """K3's bf16 form at the edges of its design, at C = 8 (one word a
    row), 192 and 384 (the train widths), 768 (two chunks of 32 words) and
    20 (the scalar path): the float32 form on the widened rows, cast, bit
    for bit, and two calls give the same bits; with ``ids_in_map`` too."""
    rng = np.random.default_rng(len(case) * 1000 + c)
    hw, wf = HF * WF, WF
    ids = _bf16_edge_ids(case, rng, hw, wf)
    v, n = ids.shape
    wx, wy = rng.random((2, v, n)).astype(np.float32)
    w4 = np.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy,
                   wx * wy], axis=-1)
    ids = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    w4 = torch.from_numpy(w4).to(cuda)
    g = _rounded(_rand((v, n, c), c, 1.0, cuda))
    n0 = scatter.dfeat_scatter_bf16_cuda.launches
    got = scatter.dfeat_scatter_bf16_cuda(ids, g, w4, hw, 1, wf)
    again = scatter.dfeat_scatter_bf16_cuda(ids, g, w4, hw, 1, wf,
                                            ids_in_map=True)
    assert scatter.dfeat_scatter_bf16_cuda.launches == n0 + 2
    want = scatter.dfeat_scatter_cuda(ids, g.float(), w4, hw, 1, wf)
    assert torch.equal(got, want.to(BF16))
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [-1, HF * WF - WF - 1])
def test_dfeat_scatter_bf16_refuses_ids_outside_the_map(cuda, bad):
    """The bf16 form's check: a base id below 0, or one whose last tap
    reaches hw, is an IndexError, and the map's kernel is not launched."""
    ids, g, w4 = _scatter_inputs("uniform", 2, 100, 8, cuda)
    ids[1, 37] = bad
    n0 = scatter.dfeat_scatter_bf16_cuda.launches
    with pytest.raises(IndexError, match="must lie in"):
        scatter.dfeat_scatter_bf16_cuda(ids, _rounded(g), w4, HF * WF, 1, WF)
    assert scatter.dfeat_scatter_bf16_cuda.launches == n0


@pytest.mark.cuda
def test_bf16_backward_never_waits_for_the_card(cuda):
    """The bf16 route of the sampling backward (sample_feature_map's d_feat
    on a bf16 map: _sample_taps' clamped taps, K3's bf16 form with
    ids_in_map) under set_sync_debug_mode("error"), and behind a kernel
    that keeps the card busy: the backward returns while that kernel still
    runs.  Its d_feat is the float32 form's cast."""
    from transhuman_tpu_torch.kernels import build
    from transhuman_tpu_torch.ops.sampling import sample_feature_map

    build.library()
    rng = np.random.default_rng(21)
    feat = _rounded(_rand((3, 64, 80, 192), 22, 1.0, cuda)).requires_grad_()
    uv = torch.from_numpy(_sampling_uv(rng, 4096, 64, 80)).to(cuda)
    g = _rounded(_rand((3, 4096, 192), 23, 1.0, cuda))
    out = sample_feature_map(feat, uv, SF_IMAGE)
    # once to warm the library and the allocator (a first cudaMalloc may
    # wait for the card)
    torch.autograd.grad(out, feat, g, retain_graph=True)
    torch.cuda.synchronize()
    n0 = scatter.dfeat_scatter_bf16_cuda.launches
    busy = torch.cuda.Event()
    torch.cuda._sleep(2_000_000_000)  # about a second of the card's clock
    busy.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (d_feat,) = torch.autograd.grad(out, feat, g)
        still_busy = not busy.query()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert still_busy
    assert scatter.dfeat_scatter_bf16_cuda.launches == n0 + 1
    from transhuman_tpu_torch.kernels.gather import _bilinear_w4, _sample_taps

    _, _, base, wx, wy, dx, dy = _sample_taps(feat.shape, uv, SF_IMAGE)
    want = scatter.dfeat_scatter_cuda(base.to(torch.int32).contiguous(),
                                      g.float(), _bilinear_w4(wx, wy), 64 * 80,
                                      dx, dy)
    assert torch.equal(d_feat, want.reshape(feat.shape).to(BF16))


def _clumped_inputs(device, n, c, d):
    """Points at the origin and C centres of which every 16th lies within
    1 cm of it and the rest 1-2 m away: one selection lane's share holds
    more near centres than the bf16 kernel lists a point's candidates."""
    rng = np.random.default_rng(c)
    centers = rng.uniform(1, 2, (c, 3)) * rng.choice([-1, 1], (c, 3))
    centers[::16] = rng.uniform(-0.01, 0.01, (len(centers[::16]), 3))
    pts = rng.uniform(-1e-3, 1e-3, (n, 3))
    rot = np.stack([np.linalg.qr(m)[0] for m in
                    rng.standard_normal((c, 3, 3))])
    tokens = rng.standard_normal((3, c, d))
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in (pts, centers, rot, tokens)]


# (n, c, k, d, inputs): one point, a tile of 16 points and one either side,
# about a serve chunk's cull survivors and a whole chunk; C == k, C not a
# multiple of 32 and C above 32 K; every k; D of one 8-channel word, not a
# multiple of 8 (the scalar path), the render width and the model axis's
# 384 and 768; tokens 4 bytes off 16 (the scalar path); exact ties; more
# candidates than a point's list holds
DPARF_BF16_CASES = [
    *[(32768, 300, kk, 192, "random") for kk in (7, 4, 1)],
    (26321, 300, 7, 192, "random"), (4900, 300, 7, 192, "random"),
    (1, 300, 7, 192, "random"), (15, 300, 8, 192, "random"),
    (16, 300, 7, 192, "random"), (17, 300, 3, 192, "random"),
    (1000, 8, 8, 192, "random"), (1001, 33, 5, 8, "random"),
    (517, 1000, 8, 384, "random"), (300, 300, 7, 768, "random"),
    (1000, 300, 7, 20, "random"), (2051, 300, 7, 20, "random"),
    *[(259, 300, kk, 192, "random") for kk in (2, 3, 5, 6, 8)],
    (300, 300, 7, 192, "misaligned"), (500, 70, 7, 192, "ties"),
    (33, 1000, 8, 192, "clumped"), (40, 1000, 7, 20, "clumped"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n, c, k, d, inputs", DPARF_BF16_CASES)
def test_dparf_bf16_is_the_f32_form_cast(cuda, n, c, k, d, inputs):
    """K2 with bf16 tokens: tok is the float32 form's on the widened tokens
    cast once, and pe, dist, idx and w are its outputs, bit for bit."""
    if inputs == "ties":
        pts, centers, rot, tokens = _exact_tie_inputs(cuda, n, d)
    elif inputs == "clumped":
        pts, centers, rot, tokens = _clumped_inputs(cuda, n, c, d)
    else:
        pts, centers, rot, tokens = _dparf_inputs(n, c, 3, d, cuda,
                                                  seed=n + c + k + d)
    tokens = _rounded(tokens)
    if inputs == "misaligned":  # contiguous, 4 bytes off 16
        buf = torch.empty(tokens.numel() + 2, dtype=BF16, device=cuda)
        shifted = buf[2:].view(tokens.shape)
        shifted.copy_(tokens)
        tokens = shifted
    n0 = dparf.dparf_bf16_cuda.launches
    got = dparf.dparf(pts, centers, rot, tokens, k=k)
    assert dparf.dparf_bf16_cuda.launches == n0 + 1
    want = dparf.dparf_cuda(pts, centers, rot, tokens.float(), k=k)
    assert got[0].dtype == BF16
    assert torch.equal(got[0], want[0].to(BF16))
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    if inputs == "ties":
        assert got[3][0, :4].tolist() == [5, 6, 37, 38]
    if inputs == "clumped":  # the k nearest: centres 0, 16, 32, ...
        assert bool((got[3] % 16 == 0).all())


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


# ---------------------------------------------------------------- int8 form
def _int8_map(shape, seed, device):
    """A per-channel quantised map (ops/sampling.py's quantizer) of a
    seeded float32 map whose channels differ in range, and its scale."""
    from transhuman_tpu_torch.ops.sampling import quantize_feature_map

    rng = np.random.default_rng(seed)
    f = rng.standard_normal(shape) * rng.uniform(0.01, 4.0, shape[-1])
    return quantize_feature_map(torch.from_numpy(f.astype(np.float32)).to(
        device))


def test_int8_form_refuses_cpu_tensors():
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        gather.feature_sample_int8_cuda(
            torch.zeros(1, 8, 8, 8, dtype=torch.int8), torch.zeros(1, 4, 2),
            (16, 16), torch.ones(8))
    assert kernels.launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("c, n", [(384, 32768), (192, 6890)])
def test_feature_sample_int8_is_its_twin_bit_for_bit(cuda, c, n):
    """K4's int8 form at the serve pixel shape (C = 384, a 32,768-point
    chunk of 3 512x512 maps) and a 192-channel map: the plain twin's bf16
    rows, scaled and unscaled (a null scale), bit for bit, in one launch
    each counted under its own name."""
    q, scale = _int8_map((3, 512, 512, c), c, cuda)
    rng = np.random.default_rng(c + 1)
    uv = np.stack([rng.uniform(-8, 520, (3, n)),
                   rng.uniform(-8, 520, (3, n))], axis=-1)
    uv = torch.from_numpy(uv.astype(np.float32)).to(cuda)
    n0 = gather.feature_sample_int8_cuda.launches
    got = gather.feature_sample(q, uv, (512, 512), scale)
    assert gather.feature_sample_int8_cuda.launches == n0 + 1
    assert got.dtype == BF16 and got.shape == (3, n, c)
    assert torch.equal(got, gather.feature_sample_int8_plain(
        q, uv, (512, 512), scale))
    unscaled = gather.feature_sample_int8_cuda(q, uv, (512, 512))
    assert torch.equal(unscaled, gather.feature_sample_int8_plain(
        q, uv, (512, 512)))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [6, 8, 20, 384])
def test_feature_sample_int8_scalar_and_odd_widths(cuda, c):
    """Widths that are not a multiple of the 8-channel word (6, 20) take
    the scalar path; maps one texel wide or tall, uv on and past every
    border and far outside."""
    for hf, wf in ((64, 80), (64, 1), (1, 80)):
        q, scale = _int8_map((3, hf, wf, c), hf + wf + c, cuda)
        rng = np.random.default_rng(hf + wf + c)
        uv = torch.from_numpy(_sampling_uv(rng, N_SCATTER, hf, wf)).to(cuda)
        got = gather.feature_sample_int8_cuda(q, uv, SF_IMAGE, scale)
        want = gather.feature_sample_int8_plain(q, uv, SF_IMAGE, scale)
        assert torch.equal(got, want), (hf, wf)


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("c", [8, 16, 24, 40, 192, 384, 768, 6, 20])
def test_feature_sample_int8_words_and_edges(cuda, c, scaled):
    """K4's int8 form at every word its body takes: 16 channels (C = 16,
    192, 384, 768: eight, four, two rows a warp and a row in two chunks), 8
    channels (C = 8, 24, 40, and a map whose rows are 8- but not 16-byte
    aligned) and one channel a thread (C = 6, 20), with and without a
    scale, uv on the last texel row and column exactly and past them: its
    twin's bits."""
    hf, wf = 64, 80
    q, scale = _int8_map((3, hf, wf, c), 31 + c, cuda)
    rng = np.random.default_rng(c)
    uv = _sampling_uv(rng, 1500, hf, wf)
    uv[:, 100:116] = (SF_IMAGE[1] * (wf - 1) / wf, SF_IMAGE[0] * (hf - 1) / hf)
    uv = torch.from_numpy(uv).to(cuda)
    s = scale if scaled else None
    got = gather.feature_sample_int8_cuda(q, uv, SF_IMAGE, s)
    assert torch.equal(got, gather.feature_sample_int8_plain(q, uv, SF_IMAGE,
                                                             s))
    if c % 16 == 0:  # rows 8-byte aligned only: the 8-channel words
        shifted = torch.empty(q.numel() + 8, dtype=torch.int8, device=cuda)
        q8 = shifted[8:].view(q.shape)
        q8.copy_(q)
        assert torch.equal(gather.feature_sample_int8_cuda(q8, uv, SF_IMAGE,
                                                           s), got)


@pytest.mark.cuda
def test_int8_sampling_is_one_launch_without_a_sync(cuda):
    """sample_feature_map of an int8 map with its scale is one launch of
    the int8 form and never waits for the card; with the scale's gradient
    asked for, the kernel gives the unscaled rows and autograd the
    product, the same values."""
    from transhuman_tpu_torch.kernels import build
    from transhuman_tpu_torch.ops.sampling import sample_feature_map

    build.library()
    q, scale = _int8_map((3, 64, 80, 384), 17, cuda)
    rng = np.random.default_rng(18)
    uv = torch.from_numpy(_sampling_uv(rng, 4096, 64, 80)).to(cuda)
    want = gather.feature_sample_int8_plain(q, uv, SF_IMAGE, scale)
    for grad in (False, True):
        s = scale.clone().requires_grad_(grad)
        torch.cuda.synchronize()
        n0 = gather.feature_sample_int8_cuda.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = sample_feature_map(q, uv, SF_IMAGE, s)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert gather.feature_sample_int8_cuda.launches == n0 + 1
        assert out.requires_grad == grad
        assert torch.equal(out.detach(), want)


@pytest.mark.cuda
def test_int8_form_refuses_other_dtypes(cuda):
    """A float32 map, or a scale of another width or dtype, is an error,
    not a launch."""
    before = kernels.launch_counts()
    q, scale = _int8_map((2, 16, 16, 8), 19, cuda)
    uv = torch.zeros((2, 4, 2), device=cuda)
    with pytest.raises(TypeError, match="int8"):
        gather.feature_sample_int8_cuda(q.float(), uv, (16, 16), scale)
    with pytest.raises(TypeError, match="float32"):
        gather.feature_sample_int8_cuda(q, uv, (16, 16), scale.to(BF16))
    with pytest.raises(ValueError, match="scale"):
        gather.feature_sample_int8_cuda(q, uv, (16, 16), scale[:4])
    with pytest.raises(ValueError, match="int8 map"):
        gather.feature_sample(q.float(), uv, (16, 16), scale)
    assert kernels.launch_counts() == before
