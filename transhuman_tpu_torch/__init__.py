"""PyTorch port of transhuman_tpu for one NVIDIA H100 (serving, training,
evaluation and mesh reconstruction paths).

The JAX package ``transhuman_tpu`` stays the reference; this package mirrors
its module paths and public names and never imports JAX.  Layout:

    config      every key of the JAX package's Config, its YAML files
                (utils/yaml_subset.py, no PyYAML) and merge rules
    geometry/   SMPL body model, k-means clusters, rays (host numpy)
    ops/        nearest neighbours; bilinear feature sampling and its backward
    kernels/    hand-written CUDA kernels K1 (cull), K2 (DPaRF) and K3 (the
                feature-fetch backward), their nvcc build and plain twins;
                csrc/ holds the CUDA sources
    models/     encoder, TransHE, DPaRF binding, NeRF heads, the network;
                LPIPS (VGG16)
    render/     the frame render with dynamic compaction, the density over a
                grid, the train render, compositing
    mesh_ops/   mesh reconstruction, numpy marching tetrahedra, PLY files
    train/      losses, schedule, optimizers, the train step, checkpoints
                (the JAX package's .ckpt read without JAX)
    data/       evaluation rays, synthetic train samples
    cli/        the frame renderer, runtime construction, the train and run
                entry points
    serve       the HTTP render server (python -m transhuman_tpu_torch.serve)
    tools/      checkpoint mappings, the mesh voxelizer, the kernel A/B,
                the LPIPS and ResNet-18 weight converters
    utils/      PNG files, the YAML reader, the Recorder and its event files
    weights     reference-layout checkpoints and the TransHE PE table
    testing     the seeded synthetic scene
"""
