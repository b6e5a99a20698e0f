"""Batched serving example: continuous batching over a reduced
gemma-family model — requests arrive, fill decode slots, retire.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm              # on the card
  PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
"""

import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    finished = serve_main([
        "--arch", "gemma-2b", "--requests", "12", "--slots", "4",
        "--prompt-len", "8", "--max-new", "24", "--device", args.device,
    ])
    assert len(finished) == 12
    assert all(len(r.out) == 24 for r in finished)
    print("OK: all 12 requests served to completion")


if __name__ == "__main__":
    main()
