"""PyTorch port of transhuman_tpu for one NVIDIA H100 (serving, training,
evaluation and mesh reconstruction paths).

The JAX package ``transhuman_tpu`` stays the reference; this package mirrors
its module paths and public names and never imports JAX.  Layout:

    config      serve and train configuration (reference key names and
                defaults)
    geometry/   SMPL body model, k-means clusters, rays (host numpy)
    ops/        nearest neighbours; bilinear feature sampling and its backward
    kernels/    hand-written CUDA kernels K1 (cull), K2 (DPaRF) and K3 (the
                feature-fetch backward), their nvcc build and plain twins;
                csrc/ holds the CUDA sources
    models/     encoder, TransHE, DPaRF binding, NeRF heads, the network
    render/     the frame render with dynamic compaction, the density over a
                grid, the train render, compositing
    mesh_ops/   mesh reconstruction, numpy marching tetrahedra, PLY files
    train/      losses, schedule, optimizers, the train step, checkpoints
    data/       evaluation rays, synthetic train samples
    cli/        the frame renderer, runtime construction, the train and run
                entry points
    serve       the HTTP render server (python -m transhuman_tpu_torch.serve)
    tools/      checkpoint mappings, the mesh voxelizer, the kernel A/B
    weights     reference-layout checkpoints and the TransHE PE table
    testing     the seeded synthetic scene
"""
