"""One-command parity runbook on the official assets (counterpart of
transhuman_tpu/tools/validate_official.py).

Given the licensed external assets (ZJU-MoCap, the official TransHuman
checkpoint, the reference README's epoch-2100 ``.pth``, the SMPL pickle,
the official k-means dict, and optionally the torchvision VGG16
``features`` weights with the LPIPS lin heads, and the ResNet-18 weights),
this tool:

1. converts what the port reads in its own formats: the VGG16 and lin
   heads into an LPIPS npz (tools/convert_lpips.py), ResNet-18 into the
   encoder npz (tools/convert_resnet.py, train-time init only).  The
   official ``.pth`` needs no conversion: the run entry point reads the
   reference layout as it is (``--weights``), with the TransHE PE table
   the reference computes (weights.py::reference_pe_table);
2. runs the reference's evaluation protocol for every ``test.mode``
   (scripts/test.sh and get_human_info.py): input views [0,7,15], target
   views [3,5,10,12,18,20], FrameSampler decimation (test.full_eval
   False), ``configs/train_or_eval.yaml`` as the config of record, each
   protocol through the port's ``cli.run --type evaluate`` on the card
   (``--device``);
3. writes a parity report (PSNR / SSIM / LPIPS / MSE per protocol) to
   ``<workdir>/parity_report.{json,txt}``, with PASS/FAIL deltas when an
   ``--expected`` JSON of reference numbers is given
   (configs/expected_official.template.json is its template).

Usage, the day the assets are at hand::

    python -m transhuman_tpu_torch.tools.validate_official \\
        --zju_root data/zju_mocap --rasterize_root data/zju_rasterization \\
        --official_ckpt latest.pth --smpl_dir data/smplx/smpl \\
        --kmeans data/kmeans_dict/kmeans_dict_300.npy \\
        --vgg16 vgg16_features.pth \\
        --lpips_lins third_parties/lpips/weights/v0.1/vgg.pth \\
        --workdir /tmp/parity

Exit code 1 when an ``--expected`` number is missed.
"""

from __future__ import annotations

import argparse
import json
import os

# (label, test.mode, test.input_view): scripts/test.sh
PROTOCOLS = (
    ("fitting", "model_o_motion_o", "0,7,15"),
    ("pose_generalization", "model_o_motion_x", "0,7,15"),
    ("identity_generalization", "model_x_motion_x", "0,7,15"),
    ("one_shot", "model_x_motion_x", "0,"),
)
# |delta| tolerated against --expected before a FAIL verdict
DEFAULT_TOL = {"psnr": 0.05, "ssim": 0.002, "lpips": 0.002, "mse": 1e-4}


def build_argv(args, label, mode, input_view, lpips_npz):
    """The ``cli.run --type evaluate`` argument vector of one protocol: the
    reference's test.sh invocation, on the official ``.pth`` and the
    converted assets, then ``--opts``."""
    argv = [
        "--type", "evaluate",
        "--device", args.device,
        "--weights", args.official_ckpt,
        "--cfg_file", args.cfg_file,
        "data_root", args.zju_root,
        "run_mode", "test",
        "test.input_view", input_view,
        "test.target_view", "3,5,10,12,18,20",
        "test.mode", mode,
        "test.full_eval", "False",
        "test.epoch", "-1",
        "task", args.task,
        "exp_name", "official",
        "test.exp_folder_name", f"zjumocap_{label}",
        "result_dir", os.path.join(args.workdir, "result"),
        "smpl_dir", args.smpl_dir,
        "kmeans_dir", os.path.dirname(os.path.abspath(args.kmeans)),
    ]
    if args.rasterize_root:
        argv += ["rasterize_root", args.rasterize_root]
    if lpips_npz:
        argv += ["lpips_weights", lpips_npz]
    return argv + list(args.opts or [])


def convert_assets(args) -> str:
    """VGG16 + lin heads -> the LPIPS npz, ResNet-18 -> its npz; returns
    the LPIPS npz path ('' when LPIPS cannot run)."""
    km = os.path.basename(args.kmeans)
    if not km.startswith("kmeans_dict_"):
        raise SystemExit(
            f"--kmeans must be the reference kmeans_dict_<C>.npy (got {km}): "
            "the entry point reads <kmeans_dir>/kmeans_dict_<num_class>.npy")
    lpips_npz = ""
    if args.lpips_lins and args.vgg16:
        from .convert_lpips import main as convert_lpips

        lpips_npz = os.path.join(args.workdir, "lpips_vgg.npz")
        convert_lpips(["--lins", args.lpips_lins, "--vgg", args.vgg16,
                       lpips_npz])
    elif args.lpips_lins or args.vgg16:
        print("WARNING: LPIPS needs BOTH --lpips_lins and --vgg16; "
              "evaluating without LPIPS.")
    else:
        print("NOTE: no LPIPS weights supplied; PSNR/SSIM only.")
    if args.resnet18:
        # the official checkpoint holds the trained encoder; this npz is a
        # fine-tune's init (encoder_weights <this file>), one flag away
        from .convert_resnet import main as convert_resnet

        rn = os.path.join(args.workdir, "resnet18.npz")
        convert_resnet([args.resnet18, rn])
        print(f"converted ResNet18 (train-time init only): {rn}")
    return lpips_npz


def compare(summaries, expected, tol):
    """Per-protocol deltas against the expected numbers: (report rows, ok).
    An expected protocol that no run matched FAILs; keys starting with
    '_' are documentation and are skipped."""
    rows, ok = [], True
    for label in expected or {}:
        if label.startswith("_"):
            continue
        if label not in summaries:
            rows.append({"protocol": label, "verdict": "FAIL",
                         "error": "expected protocol was not run "
                                  f"(ran: {sorted(summaries)})"})
            ok = False
    for label, s in summaries.items():
        row = {"protocol": label, **{k: s.get(k) for k in
                                     ("psnr", "ssim", "lpips", "mse")}}
        exp = (expected or {}).get(label)
        if exp:
            row["expected"] = exp
            row["delta"] = {}
            verdict = "PASS"
            for k, want in exp.items():
                got = s.get(k)
                if got is None:
                    verdict = "FAIL"
                    row["delta"][k] = None
                    continue
                d = float(got) - float(want)
                row["delta"][k] = round(d, 6)
                if abs(d) > tol.get(k, 0.0):
                    verdict = "FAIL"
            row["verdict"] = verdict
            ok &= verdict == "PASS"
        rows.append(row)
    return rows, ok


def main(argv=None, dataset_factory=None) -> int:
    """dataset_factory(run_argv) -> dataset replaces the entry point's own
    (a test hook); None builds it from the config."""
    p = argparse.ArgumentParser(
        prog="python -m transhuman_tpu_torch.tools.validate_official",
        description=__doc__.split("\n", 1)[0])
    p.add_argument("--zju_root", required=True, help="ZJU-MoCap root")
    p.add_argument("--rasterize_root", default="",
                   help="zju_rasterization root (vizmaps); omit for "
                   "all-visible")
    p.add_argument("--official_ckpt", required=True,
                   help="the official TransHuman .pth")
    p.add_argument("--smpl_dir", required=True)
    p.add_argument("--kmeans", required=True,
                   help="the official kmeans_dict_300.npy")
    p.add_argument("--vgg16", default="",
                   help="torchvision VGG16 `features` state dict (.pth)")
    p.add_argument("--lpips_lins", default="",
                   help="LPIPS v0.1 vgg lin heads (.pth)")
    p.add_argument("--resnet18", default="",
                   help="torchvision ResNet18 ImageNet weights (optional; "
                   "train-time init only)")
    p.add_argument("--workdir", required=True)
    p.add_argument("--cfg_file", default="configs/train_or_eval.yaml")
    p.add_argument("--task", default="transhuman")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; fails without a card) or cpu")
    p.add_argument("--protocols", nargs="*",
                   default=[r[0] for r in PROTOCOLS[:3]],
                   choices=[r[0] for r in PROTOCOLS],
                   help="default: the three multi-view modes; add one_shot "
                   "for the single-input-view row")
    p.add_argument("--expected", default="",
                   help="JSON of reference numbers {protocol: {psnr: ...}};"
                   " enables PASS/FAIL verdicts")
    p.add_argument("--opts", nargs=argparse.REMAINDER, default=[],
                   help="extra config overrides appended to every run")
    args = p.parse_args(argv)

    os.makedirs(args.workdir, exist_ok=True)
    lpips_npz = convert_assets(args)
    expected = None
    if args.expected:
        with open(args.expected) as f:
            expected = json.load(f)

    from ..cli import run as run_cli

    summaries = {}
    for label, mode, input_view in PROTOCOLS:
        if label not in args.protocols:
            continue
        run_argv = build_argv(args, label, mode, input_view, lpips_npz)
        print(f"=== {label} (test.mode {mode}, input views {input_view}) ===",
              flush=True)
        ds = dataset_factory(run_argv) if dataset_factory else None
        summaries[label] = run_cli.main(run_argv, dataset=ds)

    rows, ok = compare(summaries, expected, DEFAULT_TOL)
    report = {
        "protocol_of_record": "scripts/test.sh + get_human_info.py "
        "(input [0,7,15], targets [3,5,10,12,18,20], FrameSampler "
        "decimation, ratio 0.5)",
        "device": args.device,
        "lpips": bool(lpips_npz),
        "results": rows,
    }
    jpath = os.path.join(args.workdir, "parity_report.json")
    with open(jpath, "w") as f:
        json.dump(report, f, indent=2)
    with open(os.path.join(args.workdir, "parity_report.txt"), "w") as f:
        for r in rows:
            f.write(f"{r['protocol']}: " + "  ".join(
                f"{k}={r[k]:.4f}" for k in ("psnr", "ssim", "lpips", "mse")
                if r.get(k) is not None))
            if "verdict" in r:
                f.write(f"  [{r['verdict']}]")
            f.write("\n")
    print(f"wrote {jpath}")
    if expected is not None and not ok:
        print("PARITY: FAIL (see parity_report.json deltas)")
        return 1
    print("PARITY: " + ("PASS" if expected is not None else
                        "report written (no --expected numbers supplied)"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
