"""Quickstart for the PyTorch port: Split Deconvolution in five minutes.

1. take a transposed-conv layer (DCGAN's 5x5 stride-2),
2. split its filter offline into s^2 = 4 small convolution filters,
3. run it as ONE standard convolution + pixel-shuffle,
4. check it against the native deconv and the naive zero-padding (NZP)
   lowering the paper replaces, and count the MACs each needs,
5. run the DCGAN generator on ``sd`` against ``native``.

It runs on the card unless asked for the CPU:

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse

import torch

from repro_torch.core.accounting import LayerSpec
from repro_torch.core.deconv import (native_deconv, nzp_deconv, sd_deconv,
                                     same_deconv_pads, split_filters)
from repro_torch.device import describe_device, resolve_device
from repro_torch.models.generative import build


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    print(f"device: {describe_device(dev)}")
    gen = torch.Generator().manual_seed(0)

    # --- a single DCGAN deconv layer ------------------------------------
    x = torch.randn(1, 8, 8, 256, generator=gen).to(dev)      # feature map
    w = (torch.randn(5, 5, 256, 128, generator=gen) * 0.02).to(dev)
    pads = same_deconv_pads(5, 2)
    with torch.no_grad():
        ref = native_deconv(x, w, 2, pads)
        out = sd_deconv(x, w, 2, pads)
        nzp = nzp_deconv(x, w, 2, pads)
    d_sd = (ref - out).abs().max().item()
    d_nzp = (ref - nzp).abs().max().item()
    print(f"native deconv:     {tuple(x.shape)} -> {tuple(ref.shape)}")
    print(f"split deconv:      max |diff| = {d_sd:.2e}")
    print(f"zero-padding:      max |diff| = {d_nzp:.2e}")

    ws = split_filters(w, 2)
    print(f"offline split:     {tuple(w.shape)} -> {tuple(ws.shape)} "
          f"(4 sub-filters stacked on C_out; zeros from the K%s!=0 "
          f"expansion: {int((ws == 0).sum())})")

    layer = LayerSpec("deconv", 256, 128, k=5, s=2, in_hw=(8, 8))
    print(f"MACs  original={layer.macs() / 1e6:.1f}M   "
          f"NZP={layer.nzp_macs() / 1e6:.1f}M "
          f"({layer.nzp_macs() / layer.macs():.1f}x waste)   "
          f"SD={layer.sd_macs() / 1e6:.1f}M")

    # --- whole DCGAN generator, implementation switch -------------------
    gen_sd = build("dcgan", "sd", device=dev)
    gen_ref = build("dcgan", "native", device=dev)
    params = gen_ref.init(torch.Generator().manual_seed(0))
    z = torch.randn(gen_ref.input_shape(4),
                    generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.no_grad():
        img_sd = gen_sd.apply(params, z)
        img_ref = gen_ref.apply(params, z)
    d_gen = (img_sd - img_ref).abs().max().item()
    print(f"DCGAN 64x64 generator: SD output == native: "
          f"{bool(torch.allclose(img_sd, img_ref, atol=1e-5))} "
          f"(max |diff| {d_gen:.2e})")
    print("done.")
    return {"sd": d_sd, "nzp": d_nzp, "generator": d_gen}


if __name__ == "__main__":
    main()
