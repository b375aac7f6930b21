#!/bin/sh
# Training launcher of the PyTorch port: the counterpart of
# scripts/train.sh, with the same config and overrides, run data-parallel
# by torchrun over the local cards (the reference's config of record ran
# 8 data-parallel ranks: its scripts/train.sh, torch.distributed.launch
# over 8 GPUs).  mesh_axis_data 0 (the config's default) takes every rank;
# a step takes NPROC x train.batch_size samples (the global batch).
#
# NPROC ranks (default: every visible card, one rank a card over NCCL);
# extra arguments after the experiment name go to the entry point as they
# are (flags such as --dist_backend gloo first, then key value overrides).
#
# Usage: sh ./scripts/torch/train.sh [EXP_NAME] [ARGS ...]
#        NPROC=2 sh ./scripts/torch/train.sh my_run --steps 100
set -e

EXP_NAME="${1:-default_8chip}"
[ $# -gt 0 ] && shift
NPROC="${NPROC:-$(python -c 'import torch; print(torch.cuda.device_count())')}"

exec python -m torch.distributed.run --standalone --nproc_per_node "${NPROC}" \
    -m transhuman_tpu_torch.cli.train --cfg_file configs/train_or_eval.yaml \
    "$@" \
    run_mode train \
    exp_name "${EXP_NAME}" \
    resume True \
    jitter True
