"""Train an LM end to end with the port's driver (checkpoint/resume).

The PyTorch counterpart of ``examples/train_lm.py``, forwarding to
:mod:`repro_torch.launch.train` with its defaults: the reduced
xLSTM-350M, or with ``--full-350m`` all 24 layers at full width.  It
runs on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/train_lm_torch.py --steps 60 --device cpu
"""

import argparse

from repro_torch.launch.train import main as train_main


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--full-350m", action="store_true")
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--out", default="runs/train_lm_torch")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no silent CPU fallback")
    args = ap.parse_args()
    argv = ["--arch", args.arch, "--steps", str(args.steps),
            "--out", args.out, "--ckpt-every", "25"]
    if args.device is not None:
        argv += ["--device", args.device]
    if not args.full_350m:
        argv.append("--reduced")
    train_main(argv)
