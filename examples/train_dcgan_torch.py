"""End-to-end GAN training with the SD deconvolution path, on the card.

The PyTorch counterpart of ``examples/train_dcgan.py``: the paper's
DCGAN (or with ``--small`` a 4x4 -> 16x16 one) trains against synthetic
smooth images with the non-saturating GAN loss, its generator's deconvs
through Split Deconvolution on the hand-written kernels (``sd_kernel``:
K1 forward, K2 and K3 in the backward), checkpointed by the port's
``CheckpointManager`` into ``OUT/ckpt`` every 100 steps and at the end.
It forwards to :mod:`repro_torch.launch.train_gen` and runs on the card
unless ``--device cpu`` is given (there the kernels' plain versions).

  PYTHONPATH=src python examples/train_dcgan_torch.py --steps 200
  PYTHONPATH=src python examples/train_dcgan_torch.py --steps 10 --small \\
      --device cpu
"""

import argparse

from repro_torch.launch.train_gen import main as train_gen_main
from repro_torch.launch.train_gen import train_choices


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--deconv-impl", "--deconv", dest="deconv",
                    default="sd_kernel", choices=train_choices())
    ap.add_argument("--grad-check", action="store_true",
                    help="before training, check the generator's grads "
                    "through --deconv-impl against the native reference")
    ap.add_argument("--out", default="runs/dcgan")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no silent CPU fallback")
    args = ap.parse_args(argv)
    argv = ["--steps", str(args.steps), "--batch", str(args.batch),
            "--deconv-impl", args.deconv, "--out", args.out]
    if args.small:
        argv.append("--small")
    if args.grad_check:
        argv.append("--grad-check")
    if args.device is not None:
        argv += ["--device", args.device]
    return train_gen_main(argv)


if __name__ == "__main__":
    main()
