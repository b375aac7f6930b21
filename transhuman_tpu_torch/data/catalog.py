"""ZJU-MoCap split catalog + test-frame decimation (a copy of
transhuman_tpu/data/catalog.py, which the port may not import).

Parity with the reference's hard-coded tables
(`lib/datasets/get_human_info.py:7-51`) and `FrameSampler`
(`lib/datasets/samplers.py:150-155`): test mode keeps every 30th frame
unless full_eval.
"""

from __future__ import annotations

import numpy as np

TRAIN = {
    "CoreView_313": {"begin_i": 0, "i_intv": 1, "ni": 60},
    "CoreView_315": {"begin_i": 0, "i_intv": 6, "ni": 400},
    "CoreView_377": {"begin_i": 0, "i_intv": 30, "ni": 300},
    "CoreView_386": {"begin_i": 0, "i_intv": 6, "ni": 300},
    "CoreView_390": {"begin_i": 700, "i_intv": 6, "ni": 300},
    "CoreView_392": {"begin_i": 0, "i_intv": 6, "ni": 300},
    "CoreView_396": {"begin_i": 810, "i_intv": 5, "ni": 270},
}

# seen models, seen motion (fitting)
TEST_MODEL_O_MOTION_O = {
    "CoreView_313": {"begin_i": 0, "i_intv": 1, "ni": 60},
    "CoreView_315": {"begin_i": 0, "i_intv": 1, "ni": 400},
    "CoreView_377": {"begin_i": 0, "i_intv": 1, "ni": 300},
    "CoreView_386": {"begin_i": 0, "i_intv": 1, "ni": 300},
    "CoreView_390": {"begin_i": 700, "i_intv": 1, "ni": 300},
    "CoreView_392": {"begin_i": 0, "i_intv": 1, "ni": 300},
    "CoreView_396": {"begin_i": 810, "i_intv": 1, "ni": 270},
}

# seen models, unseen motion (pose generalization)
TEST_MODEL_O_MOTION_X = {
    "CoreView_313": {"begin_i": 60, "i_intv": 1, "ni": 1000},
    "CoreView_315": {"begin_i": 400, "i_intv": 1, "ni": 1000},
    "CoreView_377": {"begin_i": 300, "i_intv": 1, "ni": 317},
    "CoreView_386": {"begin_i": 300, "i_intv": 1, "ni": 346},
    "CoreView_390": {"begin_i": 0, "i_intv": 1, "ni": 700},
    "CoreView_392": {"begin_i": 300, "i_intv": 1, "ni": 256},
    "CoreView_396": {"begin_i": 1080, "i_intv": 1, "ni": 270},
}

# unseen identities (identity generalization)
TEST_MODEL_X_MOTION_X = {
    "CoreView_387": {"begin_i": 0, "i_intv": 1, "ni": 654},
    "CoreView_393": {"begin_i": 0, "i_intv": 1, "ni": 658},
    "CoreView_394": {"begin_i": 0, "i_intv": 1, "ni": 859},
}

_TEST_MODES = {
    "model_o_motion_o": TEST_MODEL_O_MOTION_O,
    "model_o_motion_x": TEST_MODEL_O_MOTION_X,
    "model_x_motion_x": TEST_MODEL_X_MOTION_X,
}


def get_human_info(split: str, test_mode: str = "model_x_motion_x") -> dict:
    if split == "train":
        return dict(TRAIN)
    return dict(_TEST_MODES[test_mode])


def frame_sampler_indices(
    frame_cam_shape, full_eval: bool = False, interval: int = 30
) -> np.ndarray:
    """Flat dataset indices keeping one camera pass every `interval` frames.

    frame_cam_shape: per-human (n_frames, n_cams) as in the reference's
    human2Nframe_Ncam; indices are produced per human in catalog order and
    offset into the concatenated index space (samplers.py:136-164 semantics:
    decimate frames, keep all target cameras of kept frames).
    """
    out = []
    offset = 0
    for n_frames, n_cams in frame_cam_shape:
        idx = np.arange(n_frames * n_cams).reshape(n_frames, n_cams)
        keep = idx if full_eval else idx[::interval]
        out.append(keep.ravel() + offset)
        offset += n_frames * n_cams
    return np.concatenate(out) if out else np.array([], dtype=np.int64)
