"""One rank of tests/test_torch_multicard.py's test of ``chip_smoke.py``'s
rank-job runner (``--dist-worker``) on the CPU: a gloo group over a
``file://`` rendezvous beside the jobs file, then the runner's loop, with
its card helpers pointed at the CPU and phase l2's TransHE cut to a tiny
size.  Imports neither JAX nor the JAX package.

    python tests/_torch_multicard_worker.py JOBS.json RANK WORLD
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from transhuman_tpu_torch.parallel import init_distributed  # noqa: E402

TINY_PP = {"tokens": 8, "dim": 16, "heads": 2, "depth": 4}


def main():
    spec, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(2)
    cs._card = lambda: torch.device("cpu")
    cs.worker_device = lambda backend: torch.device("cpu")
    torch.cuda.synchronize = lambda *args, **kwargs: None
    cs.L_PP = dict(cs.L_PP, **TINY_PP)
    cs.L_PP_ITERS = 2
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    init_distributed("gloo", "file://" + os.path.join(
        os.path.dirname(spec), "rdzv"))
    cs.dist_worker(spec)


if __name__ == "__main__":
    main()
