"""Random byte mutations of tests/test_torch_formats.py's GIF cases, each
read by the port and by ``cv2.imread``; where they differ, the file is
read again by cv2 in two fresh processes to tell a deterministic reading
(a fault of the port) from one that is not.

    python -m tests._torch_gif_mutations [--count N] [--seed S]

from the repository root prints the count of files read alike, the
differing ones by kind (cv2 reads an image the port refuses, or the
reverse), and how many of those cv2 read alike in both fresh processes.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

import cv2
import numpy as np

if __name__ == "__main__":  # run as a script: import from the repo root
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from tests.test_torch_formats import CASES, cv2_imread  # noqa: E402
from transhuman_tpu_torch.data import image_io  # noqa: E402

# one fresh process: cv2's reading of each path, as a digest
_READ = ("import sys, json, hashlib, cv2\n"
         "out = {}\n"
         "for p in sys.argv[1:]:\n"
         "    r = cv2.imread(p)\n"
         "    out[p] = None if r is None else "
         "hashlib.sha256(r.tobytes()).hexdigest()\n"
         "print(json.dumps(out))\n")


def mutations(count: int, seed: int):
    """(case, bytes) of ``count`` mutations: 1-3 random bytes of a GIF
    case replaced by random values, the cases in turn."""
    names = sorted(k for k in CASES if k.startswith("gif"))
    base = {k: CASES[k]() for k in names}
    rng = np.random.default_rng(seed)
    for i in range(count):
        name = names[i % len(names)]
        data = bytearray(base[name])
        for _ in range(int(rng.integers(1, 4))):
            data[int(rng.integers(len(data)))] = int(rng.integers(256))
        yield name, bytes(data)


def fresh_reads(paths):
    out = subprocess.run([sys.executable, "-c", _READ, *paths],
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, OPENCV_LOG_LEVEL="SILENT"))
    return json.loads(out.stdout)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--count", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args(argv)
    tmp = tempfile.mkdtemp(prefix="gif_mutations_")
    differ = []
    for i, (name, data) in enumerate(mutations(args.count, args.seed)):
        p = os.path.join(tmp, f"{i}_{name}.gif")
        with open(p, "wb") as f:
            f.write(data)
        want = cv2_imread(p)
        try:
            got = image_io.imread_rgb(p)
        except (ValueError, FileNotFoundError):
            got = None
        same = (want is None) == (got is None) and (
            want is None or (want.shape == got.shape
                             and bool((want == got).all())))
        if same:
            os.remove(p)
        else:
            differ.append((p, "cv2 only" if got is None else "port only"
                           if want is None else "both, differently"))
    first = fresh_reads([p for p, _ in differ])
    second = fresh_reads([p for p, _ in differ][::-1])
    for p, _ in differ:
        os.remove(p)
    os.rmdir(tmp)
    report = {"count": args.count, "seed": args.seed,
              "alike": args.count - len(differ), "differ": len(differ),
              "kinds": {k: sum(1 for _, kk in differ if kk == k)
                        for k in sorted({k for _, k in differ})},
              "cv2_deterministic": sum(1 for p, _ in differ
                                       if first[p] == second[p])}
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
    main()
