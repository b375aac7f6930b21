#!/bin/sh
# Mesh-reconstruction launcher of the PyTorch port: the counterpart of
# scripts/mesh.sh (the reference's scripts/mesh.sh), with the same config,
# overrides and result layout.  Positional contract matches: $1 the CUDA
# card (CUDA_VISIBLE_DEVICES), $2 checkpoint epoch, $3 experiment name.
#
# Usage: sh ./scripts/torch/mesh.sh 0 2100 official
set -e

CARD=${1:-0}
export CUDA_VISIBLE_DEVICES="${CARD}"
EPOCH=${2:-2100}
EXP_NAME="${3:-official}"

test_input_view="0,7,15"
test_target_view="3,"            # dummy target view, not used
test_mode='model_x_motion_x'     # [model_o_motion_o | model_o_motion_x | model_x_motion_x]

LOG_DIR="./data/result/transhuman/${EXP_NAME}"
mkdir -p "${LOG_DIR}"
# unique per invocation: a fixed path raced concurrent runs of the same
# EXP_NAME (one run reading the other's status) and a stale file could
# report success after a SIGKILL
EXIT_FILE="${LOG_DIR}/.exit_code.$$"
rm -f "${EXIT_FILE}"

( set +e; python -m transhuman_tpu_torch.cli.run --type reconstruction --cfg_file configs/reconstruction.yaml \
    run_mode test \
    test.input_view "${test_input_view}" \
    test.target_view "${test_target_view}" \
    test.mode "${test_mode}" \
    exp_name "${EXP_NAME}" \
    test.epoch "${EPOCH}" \
    test.exp_folder_name "${test_mode}" \
    test.full_eval True \
    2>&1; echo $? > "${EXIT_FILE}" ) \
    | tee "${LOG_DIR}/log_E${EPOCH}_${test_mode}.txt"
# a plain pipeline returns tee's status, defeating set -e on a python
# failure; the subshell writes the real exit code, propagated here
RC="$(cat "${EXIT_FILE}" 2>/dev/null || echo 1)"
rm -f "${EXIT_FILE}"
exit "${RC}"
