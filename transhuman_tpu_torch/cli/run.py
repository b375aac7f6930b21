"""Frame rendering behind the serving path (counterpart of
transhuman_tpu/cli/run.py::FrameRenderer).

``dispatch`` moves a frame and its rays to the pipeline's device and queues
the render; ``fetch`` brings the maps back to the host.  PyTorch queues CUDA
work asynchronously, so the caller can do host work between the two.
"""

from __future__ import annotations

import numpy as np


class FrameRenderer:
    def __init__(self, cfg, pipe):
        self._cfg, self._pipe = cfg, pipe

    def dispatch(self, frame, eval_rays):
        dev = self._pipe.device
        return self._pipe.render_frame(frame.to(dev), eval_rays.rays.to(dev))

    def fetch(self, dispatched) -> dict:
        return {k: v.cpu().numpy().astype(np.float32)
                for k, v in dispatched.items()}
