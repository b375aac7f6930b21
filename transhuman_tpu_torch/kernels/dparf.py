"""K2 wrapper: DPaRF binding (kNN softmax, local sin/cos code, token sum).

``dparf_cuda`` launches ``csrc/dparf.cu``, which replaces both
``transhuman_tpu/experiments/dparf.py::dparf_fused`` and
``transhuman_tpu/experiments/dparf2.py::dparf_fused2``.  ``dparf_plain`` is
its plain PyTorch twin: the composition of
``transhuman_tpu/models/heads.py::dparf_representation``.  ``dparf`` is the
differentiable binding: an autograd Function whose forward launches the
kernel on a CUDA tensor and runs the plain twin (without a graph) on a CPU
tensor, and whose backward gives the gradient of the token sum.

All return (tok (V, N, D), pe (N, 3 + 6 n_freqs), dist (N, k), idx (N, k)
int, w (N, k)): idx and w are the neighbours and normalised weights that
the token sum used, tok[v, n] = sum_j w[n, j] tokens[v, idx[n, j]].

Tokens may be bfloat16 (the bf16 network's): ``dparf_bf16_cuda`` (its own
launch count) sums them in float32 and returns tok in bf16, narrowed once,
with pe, dist, idx and w float32 as ever; the plain twin sums the widened
tokens and narrows tok the same way.  That is the rounding the JAX
package's bf16 path applies to its float32 token sum where ``fc_0`` casts
its input.  The token gradient sums the cotangent in float32 and returns
d tokens in the tokens' dtype.
"""

from __future__ import annotations

import torch

from ..models.embedder import embed_dparf
from ..ops import knn
from . import build

KERNEL_N_FREQS = 10  # csrc/dparf.cu is compiled for this band count
KERNEL_MAX_K = 8


def dparf_plain(pts, centers, rot, tokens, k: int = 7, alpha: float = 0.5,
                n_freqs: int = 10):
    """pts (N,3), centers (C,3), rot (C,3,3) or (C,9), tokens (V,C,D)."""
    n, c = pts.shape[0], centers.shape[0]
    aux = torch.cat([centers, rot.reshape(c, 9)], dim=1)  # (C, 12)
    d2 = knn.pairwise_dist2(pts, centers)
    w_dense, dist, aux_k, w, idx = knn.dparf_dense_weights(d2, k, alpha,
                                                           aux=aux)
    centers_k = aux_k[..., :3]
    rot_k = aux_k[..., 3:].reshape(n, k, 3, 3)
    local = torch.einsum("nki,nkij->nkj", pts[:, None, :] - centers_k, rot_k)
    pe = torch.einsum("nk,nkd->nd", w, embed_dparf(local, n_freqs))
    tok = torch.einsum("nc,vcd->vnd", w_dense, tokens.float())
    return tok.to(tokens.dtype), pe, dist, idx, w


def _dparf_launch(name, entry, tok_dtype, pts, centers, rot, tokens, k,
                  alpha, n_freqs):
    """Check the tensors (tokens of ``tok_dtype``), allocate the outputs (tok
    in tokens' dtype) and launch the K2 entry; also returns whether it
    launched."""
    c = centers.shape[0]
    rot9 = rot.reshape(c, 9)
    build.check_tensors(name, {"tokens": tok_dtype}, pts=pts,
                        centers=centers, rot=rot9, tokens=tokens)
    n = pts.shape[0]
    if tokens.dim() != 3 or tokens.shape[1] != c:
        raise ValueError(
            f"{name}: tokens {tuple(tokens.shape)} must be (V, {c}, D)")
    v, _, d = tokens.shape
    if pts.shape != (n, 3) or centers.shape != (c, 3):
        raise ValueError(
            f"{name}: pts {tuple(pts.shape)}, centers "
            f"{tuple(centers.shape)}; want (N,3), (C,3)")
    if n_freqs != KERNEL_N_FREQS:
        raise ValueError(
            f"{name}: the kernel is built for n_freqs={KERNEL_N_FREQS}, "
            f"got {n_freqs}")
    if not 1 <= k <= min(KERNEL_MAX_K, c):
        raise ValueError(
            f"{name}: k={k} outside 1..min({KERNEL_MAX_K}, C={c})")
    if n >= 2**31 // 64 or c >= 2**31 // 12:
        raise ValueError(f"{name}: extent too large for int32")
    pe_dim = 3 + 6 * n_freqs
    dev = pts.device
    tok = torch.empty((v, n, d), dtype=tok_dtype, device=dev)
    pe = torch.empty((n, pe_dim), dtype=torch.float32, device=dev)
    dist = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    w = torch.empty((n, k), dtype=torch.float32, device=dev)
    if n == 0:
        return (tok, pe, dist, idx, w), False
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(
            pts.data_ptr(), centers.data_ptr(), rot9.data_ptr(),
            tokens.data_ptr(), tok.data_ptr(), pe.data_ptr(), dist.data_ptr(),
            idx.data_ptr(), w.data_ptr(), n, c, v, d, k, n_freqs,
            float(alpha), stream,
        )
    build.check(code, name)
    return (tok, pe, dist, idx, w), True


def dparf_cuda(pts, centers, rot, tokens, k: int = 7, alpha: float = 0.5,
               n_freqs: int = 10):
    """K2 on float32 CUDA tensors; same contract as dparf_plain (idx is
    int32)."""
    out, launched = _dparf_launch("dparf_cuda", "thp_dparf", torch.float32,
                                  pts, centers, rot, tokens, k, alpha,
                                  n_freqs)
    build.count_launches(dparf_cuda, launched)
    return out


dparf_cuda.launches = 0


def dparf_bf16_cuda(pts, centers, rot, tokens, k: int = 7,
                    alpha: float = 0.5, n_freqs: int = 10):
    """K2 with bfloat16 tokens (pts, centers, rot float32): tok bf16, equal
    bit for bit to ``dparf_cuda(..., tokens.float())``'s tok cast to bf16,
    and that call's pe, dist, idx and w."""
    out, launched = _dparf_launch("dparf_bf16_cuda", "thp_dparf_bf16",
                                  torch.bfloat16, pts, centers, rot, tokens,
                                  k, alpha, n_freqs)
    build.count_launches(dparf_bf16_cuda, launched)
    return out


dparf_bf16_cuda.launches = 0


def token_grad(idx, w, g_tok, n_centers: int, dtype=torch.float32):
    """d tokens (V, C, D) in ``dtype`` of tok[v, n] = sum_j w[n, j]
    tokens[v, idx[n, j]] for the cotangent g_tok (V, N, D): the dense (N, C)
    weight matrix's transpose times g_tok, as XLA transposes the JAX
    package's einsum("nc,vcd->vnd"), in float32 (the JAX package promotes
    bf16 tokens to float32 there) and cast once."""
    dense = torch.zeros((idx.shape[0], n_centers), dtype=torch.float32,
                        device=g_tok.device)
    dense.scatter_add_(1, idx.long(), w.float())
    return torch.matmul(dense.t(), g_tok.float()).to(dtype)


class _DPaRF(torch.autograd.Function):
    """Gradients flow to the tokens only: the points come from the rays and
    the centres and rotations from the SMPL fit, none of them trainable."""

    @staticmethod
    def forward(ctx, pts, centers, rot, tokens, k, alpha, n_freqs):
        if any(ctx.needs_input_grad[:3]):
            raise NotImplementedError(
                "dparf: gradients flow to the tokens only, not to the "
                "points, centres or rotations")
        if pts.is_cuda:
            fn = (dparf_bf16_cuda if tokens.dtype == torch.bfloat16
                  else dparf_cuda)
            out = fn(pts, centers, rot, tokens, k, alpha, n_freqs)
        elif pts.device.type == "cpu":
            out = dparf_plain(pts, centers, rot, tokens, k, alpha, n_freqs)
        else:
            raise ValueError(f"dparf: no kernel for device {pts.device}")
        tok, pe, dist, idx, w = out
        ctx.mark_non_differentiable(pe, dist, idx, w)
        ctx.save_for_backward(idx, w)
        ctx.n_centers, ctx.tok_dtype = centers.shape[0], tokens.dtype
        return out

    @staticmethod
    def backward(ctx, g_tok, *_):
        d_tokens = None
        if ctx.needs_input_grad[3]:
            idx, w = ctx.saved_tensors
            d_tokens = token_grad(idx, w, g_tok, ctx.n_centers,
                                  ctx.tok_dtype)
        return None, None, None, d_tokens, None, None, None


def dparf(pts, centers, rot, tokens, k: int = 7, alpha: float = 0.5,
          n_freqs: int = 10):
    """The differentiable binding: K2 for a CUDA tensor, the plain
    composition for a CPU tensor; the backward gives d tokens."""
    return _DPaRF.apply(pts, centers, rot, tokens, k, alpha, n_freqs)
