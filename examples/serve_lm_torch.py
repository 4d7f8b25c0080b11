"""Serve a small LM with batched requests through the PyTorch port.

Pure forwarder: :mod:`repro_torch.launch.serve` is the port's LM serving
entry point; this example only supplies the small-demo defaults of
``examples/serve_lm.py`` (reduced xLSTM-350M), so the two stay alike.
It runs on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
  PYTHONPATH=src python examples/serve_lm_torch.py --requests 4   # the card
"""

import sys

from repro_torch.launch.serve import main

DEMO_ARGS = ["--arch", "xlstm-350m", "--reduced", "--requests", "8",
             "--max-new", "12", "--slots", "4"]

if __name__ == "__main__":
    # CLI args append after the defaults, so argparse's last-wins rule
    # lets callers override any value knob (--arch, --device, ...).
    # --reduced is a store_true default and cannot be unset here: for a
    # full-size run use `python -m repro_torch.launch.serve` directly.
    main(DEMO_ARGS + sys.argv[1:])
