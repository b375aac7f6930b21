"""PyTorch port of transhuman_tpu for one NVIDIA H100 (serving path).

The JAX package ``transhuman_tpu`` stays the reference; this package mirrors
its module paths and public names and never imports JAX.  Layout:

    config      serving configuration (reference key names and defaults)
    geometry/   SMPL body model, k-means clusters, rays (host numpy)
    ops/        nearest neighbours and bilinear feature sampling (plain torch)
    kernels/    hand-written CUDA kernels K1 (cull) and K2 (DPaRF), their
                nvcc build and plain twins; csrc/ holds the CUDA sources
    models/     encoder, TransHE, DPaRF binding, NeRF heads, the network
    render/     the frame render with dynamic compaction, compositing
    data/       evaluation rays
    cli/        the frame renderer and runtime construction
    serve       the HTTP render server (python -m transhuman_tpu_torch.serve)
    weights     reference-layout checkpoints and the TransHE PE table
    testing     the seeded synthetic scene
"""
