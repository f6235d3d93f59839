"""End-to-end training driver example (the PyTorch/CUDA port of
`examples/train_lm.py`): train a small LM for a few hundred steps with
checkpoint/restart (deliverable (b) end-to-end driver). It runs on the CUDA
card; `--device cpu` runs on the host:

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --ckpt-dir DIR

The checkpoints go to `--ckpt-dir` (default: `repro_torch_train_example` in
the temporary directory, `/tmp` unless TMPDIR names another), and a rerun
resumes from the latest. A directory that already holds step `--steps` has
nothing left to train: the example then exits with a message that names it.
"""
import argparse
import sys
import tempfile
from pathlib import Path

from repro_torch.checkpoint.ckpt import latest_step
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--ckpt-dir", default=str(Path(tempfile.gettempdir())
                                              / "repro_torch_train_example"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # without a card, raise before reading the directory
    last = latest_step(args.ckpt_dir)
    if last is not None and last >= args.steps:
        sys.exit(f"{args.ckpt_dir} already holds step {last} of {args.steps}: nothing left "
                 f"to train (pass another --ckpt-dir, or remove this one)")
    device = [] if args.device is None else ["--device", args.device]
    losses = train.main([
        "--preset", args.preset,
        "--steps", str(args.steps),
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "100",
        "--resume",
    ] + device)
    drop = losses[0] - sum(losses[-10:]) / 10
    print(f"loss drop over run: {drop:.3f} (must be > 0)")
    assert drop > 0
    return losses


if __name__ == "__main__":
    main()
