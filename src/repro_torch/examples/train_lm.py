"""End-to-end LM training example: trains a reduced qwen2.5-family model
for a few hundred steps with the full substrate (prefetching data
pipeline, the train step, the straggler monitor) and verifies that the
loss drops.

  PYTHONPATH=src python -m repro_torch.examples.train_lm                # on the card
  PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu [--steps 300]
"""

import argparse

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    losses = train_main([
        "--arch", args.arch, "--smoke",
        "--steps", str(args.steps),
        "--seq-len", "64", "--batch", "8",
        "--lr", "3e-3", "--warmup", "20",
        "--device", args.device,
    ])
    drop = losses[0] - losses[-1]
    print(f"loss drop over {args.steps} steps: {drop:.3f}")
    assert drop > 0.5, "expected visible learning on the synthetic stream"
    print("OK")
    return losses


if __name__ == "__main__":
    main()
