"""Batched-serving example (the PyTorch/CUDA port of `examples/serve_lm.py`):
prefill + greedy decode on an assigned arch (reduced config) — exercises
KV caches, GQA decode (each decode step's self-attention launches the
`decode_attention` kernel on the card), the serve_step path. It runs on the
CUDA card; `--device cpu` runs the plain versions:

  PYTHONPATH=src python examples/serve_lm_torch.py --arch qwen3_4b
  PYTHONPATH=src python examples/serve_lm_torch.py --arch qwen3_4b --device cpu
"""
import argparse

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    device = [] if args.device is None else ["--device", args.device]
    return serve.main(["--arch", args.arch, "--tokens", str(args.tokens), "--batch", "4"]
                      + device)


if __name__ == "__main__":
    main()
