"""Batched serving on the PyTorch/CUDA port (the twin of
``examples/serve_batched.py``): prefill a batch of prompts, decode with
KV caches, optionally retrieval-augmented (NDSearch soft prompts) — the
serving side of the two-stage pipeline.

  PYTHONPATH=src python examples/torch/serve_batched.py              # card
  PYTHONPATH=src python examples/torch/serve_batched.py --rag
  PYTHONPATH=src python examples/torch/serve_batched.py --device cpu
"""
import argparse
import sys

from repro_torch.launch.serve import main as serve_main


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--rag", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    argv = ["--arch", args.arch, "--reduced", "--batch", str(args.batch),
            "--prompt-len", "48", "--gen", str(args.gen),
            "--device", args.device]
    if args.rag:
        argv.append("--rag")
    return serve_main(argv)


if __name__ == "__main__":
    sys.exit(main())
