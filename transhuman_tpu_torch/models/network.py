"""Top-level TransHuman network (counterpart of transhuman_tpu/models/network.py).

    encode_views(images)                     -> (holder_map, pixel_map)
    refine_tokens(tokens, pe)                -> tokens'
    query(pts, centers, rot, tokens, pixel_feat, viewdir, pts_mask)
                                             -> raw (N, 4)
    decode(human_rep, pixel_feat, viewdir, mask)                -> raw (N, 4)

With ``compute_dtype`` bfloat16 the network computes as the JAX package's
does with Flax ``dtype=bfloat16``: every Dense/Conv casts its input, weight
and bias to bfloat16, norms take float32 statistics and return bfloat16, and
the activations between them are bfloat16; the parameters stay float32.

Its state dict is the reference layout (``encoder.model.*``, ``ViT.*``,
``fc_0`` ...) without the reference's dead weights (its unused SparseConvNet,
ResNet stages 3-4, ``cls_token``, BatchNorm running statistics and PE
buffers); ``weights.load_reference_state_dict`` drops those and loads the
rest strictly.
"""

from __future__ import annotations

import torch

from ..registry import NETWORKS
from .encoder import SpatialEncoder
from .heads import NeRFHeads, dparf_representation
from .vit import VARIANTS, TransHE

# config.compute_dtype -> the dtype every Dense/Conv, norm output and
# activation takes (the JAX package's Flax ``dtype``); parameters stay float32
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TransHumanNet(NeRFHeads):
    def __init__(self, embed_dim: int = 192, vit_depth: int = 12,
                 vit_heads: int = 3, knn_k: int = 7,
                 knn_dist_alpha: float = 0.5, knn_freqs: int = 10,
                 view_freqs: int = 4, use_truncation: bool = False,
                 knn_sigma: float = 0.25,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(rep_dim=embed_dim + 3 + 6 * knn_freqs,
                         view_dim=3 + 6 * view_freqs,
                         compute_dtype=compute_dtype)
        self.embed_dim = embed_dim
        self.vit_depth = vit_depth
        self.knn_k = knn_k
        self.knn_dist_alpha = knn_dist_alpha
        self.knn_freqs = knn_freqs
        self.view_freqs = view_freqs
        self.use_truncation = use_truncation
        self.knn_sigma = knn_sigma
        self.encoder = SpatialEncoder(embed_dim, compute_dtype)
        self.ViT = TransHE(embed_dim, vit_depth, vit_heads,
                           compute_dtype=compute_dtype)

    @classmethod
    def from_config(cls, cfg):
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype={cfg.compute_dtype!r}: the PyTorch port runs "
                f"{' or '.join(COMPUTE_DTYPES)}")
        embed_dim, heads = VARIANTS[cfg.vit_variant]
        return cls(embed_dim=embed_dim, vit_depth=cfg.vit_depth,
                   vit_heads=heads, knn_k=cfg.KNN,
                   knn_dist_alpha=cfg.KNN_DIST_ALPHA, knn_freqs=cfg.KNN_FREQ,
                   view_freqs=cfg.view_res, use_truncation=cfg.use_truncation,
                   knn_sigma=cfg.KNN_SIGMA,
                   compute_dtype=COMPUTE_DTYPES[cfg.compute_dtype])

    def encode_views(self, images):
        """images (V,H,W,3) -> holder_map (V,H,W,D), pixel_map (V,H,W,384)."""
        return self.encoder(images)

    def refine_tokens(self, tokens, pe):
        """tokens (V,C,D); pe the stored (C,D) or (V,C,D) PE table."""
        if pe.dim() == 2:
            pe = pe[None].expand(tokens.shape[0], *pe.shape)
        return self.ViT(tokens, pe)

    def query(self, pts_smpl, cluster_centers, cluster_rot, tokens,
              pixel_feat, viewdir_embed, pts_mask=None):
        """raw (N, 4) for points in SMPL coordinates (see heads.py); points
        with pts_mask False, and with use_truncation those whose nearest
        cluster is knn_sigma or farther, decode to 0."""
        rep, keep = dparf_representation(
            pts_smpl, cluster_centers, cluster_rot, tokens, k=self.knn_k,
            dist_alpha=self.knn_dist_alpha, n_freqs=self.knn_freqs,
            knn_sigma=self.knn_sigma if self.use_truncation else None,
        )
        if keep is not None:
            pts_mask = keep if pts_mask is None else pts_mask & keep
        return self.decode(rep, pixel_feat, viewdir_embed, pts_mask)


NETWORKS.register("transhuman")(TransHumanNet.from_config)
