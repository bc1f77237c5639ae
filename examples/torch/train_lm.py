"""End-to-end training on the PyTorch/CUDA port (the twin of
``examples/train_lm.py``): a ~100M-param LM for a few hundred steps with
checkpoint/restart fault tolerance and the deterministic pipeline.

Defaults to a ~10M reduced model so the example finishes quickly;
--preset 100m selects the full ~100M configuration (same code path).

  PYTHONPATH=src python examples/torch/train_lm.py --steps 120       # card
  PYTHONPATH=src python examples/torch/train_lm.py --preset 100m --steps 300
  PYTHONPATH=src python examples/torch/train_lm.py --device cpu
"""
import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_config, reduced
from repro_torch.launch.train import main as train_main
from repro_torch.models.params import count_params
from repro_torch.models.transformer import model_spec


def preset_cfg(preset: str):
    if preset == "100m":
        # ~105M params: llama-family at d=640
        return dataclasses.replace(
            get_config("yi-34b"), name="lm-100m", num_layers=10,
            d_model=640, num_heads=10, num_kv_heads=5, head_dim=64,
            d_ff=2560, vocab_size=32000)
    return reduced(get_config("gemma3-1b"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small", choices=["small", "100m"])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()

    cfg = preset_cfg(args.preset)
    n = count_params(model_spec(cfg))
    print(f"model: {cfg.name}  params={n/1e6:.1f}M")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        # registry-level injection so launch.train sees our preset
        import repro_torch.configs.registry as reg
        reg._REGISTRY[cfg.name] = cfg        # noqa: SLF001 (example glue)
        rc = train_main([
            "--arch", cfg.name, "--steps", str(args.steps),
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--lr", "3e-3", "--warmup", "20",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "50",
            "--loss-chunk", "128", "--device", args.device,
        ])
    raise SystemExit(rc)


if __name__ == "__main__":
    main()
