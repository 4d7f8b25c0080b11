"""Training the paper's generators on one device, through split deconv.

Two entry points:

* :func:`make_train_step` — the one-device case of the reference's
  ``make_sharded_train_step``: an SGD step on the global-mean L2 loss to
  a target.  The mesh, parameter placement and shard scope wait for the
  port's scale-out slice.
* :func:`main` — the GAN loop of the reference's
  ``examples/train_dcgan.py``: DCGAN (or a small twin) against
  :class:`~repro_torch.models.DCGANDiscriminator` on synthetic smooth
  images, non-saturating BCE, AdamW (lr 2e-4, b1 0.5, no weight decay).

With ``--deconv-impl sd_kernel`` on the card the generator's deconvs run
the differentiable ``sd.conv_transpose`` on the fused backend: K1 in the
forward, K2 (input grad) and K3 (filter grad) in the backward.  The
discriminator step samples the generator without autograd, through the
engine's bound plans (K1 only); the AdamW step updates both nets in
place, and the engine splits its filters again on the next sample.

    python -m repro_torch.launch.train_gen --steps 5            # the card
    python -m repro_torch.launch.train_gen --small --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.core.accounting import LayerSpec, NetworkSpec
from repro_torch.data import GANLatentPipeline
from repro_torch.device import resolve_device
from repro_torch.models.generative import (DCGANDiscriminator,
                                           GenerativeModel, build)
from repro_torch.optim import OptState, adamw_init, adamw_update

Params = Dict[str, Dict[str, torch.Tensor]]

LR, B1 = 2e-4, 0.5          # the GAN loop's AdamW (weight decay 0)


def flatten(params: Params) -> List[torch.Tensor]:
    """The leaves of ``{layer: {name: tensor}}`` in sorted key order."""
    return [t for k in sorted(params) for _, t in sorted(params[k].items())]


def unflatten(params: Params, leaves) -> Params:
    """``leaves`` (in :func:`flatten`'s order) in ``params``' layout."""
    it = iter(leaves)
    return {k: {n: next(it) for n, _ in sorted(params[k].items())}
            for k in sorted(params)}


def trainable(params: Params) -> Params:
    """Mark every leaf as an autograd leaf that requires grad (in place;
    returns ``params``)."""
    for t in flatten(params):
        t.requires_grad_(True)
    return params


def make_train_step(model: GenerativeModel, lr: float = 1e-2) -> Callable:
    """``step(params, z, target) -> (new_params, loss)``: one SGD step on
    ``mean((model(params, z) - target)**2)``.  ``params`` are left as
    they are; the new params are fresh tensors."""
    def step(params: Params, z: torch.Tensor, target: torch.Tensor
             ) -> Tuple[Params, torch.Tensor]:
        ps = unflatten(params, [t.detach().requires_grad_(True)
                                for t in flatten(params)])
        with torch.enable_grad():
            loss = torch.mean((model.apply(ps, z) - target) ** 2)
            grads = torch.autograd.grad(loss, flatten(ps))
        new = [(p - lr * g).detach() for p, g in zip(flatten(ps), grads)]
        return unflatten(params, new), loss.detach()

    return step


# ---------------------------------------------------------------------------
# The GAN loop
# ---------------------------------------------------------------------------

def bce(logits: torch.Tensor, target_ones: bool) -> torch.Tensor:
    """Mean sigmoid cross-entropy of ``logits`` against all-ones or
    all-zeros labels (the reference's stable form)."""
    t = 1.0 if target_ones else 0.0
    return torch.mean(torch.relu(logits) - logits * t
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def discriminator_grads(gen: GenerativeModel, disc: DCGANDiscriminator,
                        gp: Params, dp: Params, z: torch.Tensor,
                        real: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """Loss and grads of the discriminator: real images as ones, the
    generator's samples (drawn without autograd) as zeros."""
    with torch.no_grad():
        fake = gen.apply(gp, z)
    with torch.enable_grad():
        loss = (bce(disc.apply(dp, real), True)
                + bce(disc.apply(dp, fake), False))
        grads = torch.autograd.grad(loss, flatten(dp))
    return loss.detach(), unflatten(dp, grads)


def generator_grads(gen: GenerativeModel, disc: DCGANDiscriminator,
                    gp: Params, dp: Params, z: torch.Tensor
                    ) -> Tuple[torch.Tensor, Params]:
    """Loss and grads of the generator (non-saturating: its samples
    labelled ones).  ``gp``'s leaves must require grad."""
    with torch.enable_grad():
        loss = bce(disc.apply(dp, gen.apply(gp, z)), True)
        grads = torch.autograd.grad(loss, flatten(gp))
    return loss.detach(), unflatten(gp, grads)


def double(params: Params) -> Params:
    """A detached float64 copy of ``params``."""
    return {k: {n: t.detach().double() for n, t in v.items()}
            for k, v in params.items()}


def fake_cotangent(ref: GenerativeModel, disc: DCGANDiscriminator,
                   gp: Params, dp: Params, z: torch.Tensor) -> torch.Tensor:
    """``c``, the generator loss's cotangent on the generator's samples,
    in float64 through ``ref`` and the discriminator."""
    with torch.enable_grad():
        fake = ref.apply(double(gp), z.double()).detach().requires_grad_(True)
        cot, = torch.autograd.grad(bce(disc.apply(double(dp), fake), True),
                                   fake)
    return cot


def generator_vjp(model: GenerativeModel, params: Params, z: torch.Tensor,
                  cot: torch.Tensor) -> Params:
    """``J_G^T c``: the grads of the generator's params for the fixed
    sample cotangent ``cot``, in ``params``' dtype.  ``params``' leaves
    must require grad."""
    leaves = flatten(params)
    with torch.enable_grad():
        out = model.apply(params, z.to(leaves[0].dtype))
        grads = torch.autograd.grad(out, leaves,
                                    grad_outputs=cot.to(out.dtype))
    return unflatten(params, grads)


def rel_errs(grads: Params, ref: Params) -> Dict[str, float]:
    """``max|grads - ref| / max|ref|`` per leaf, keyed ``layer/name``."""
    return {f"{k}/{n}": ((grads[k][n].double() - ref[k][n]).abs().max()
                         / ref[k][n].abs().max().clamp_min(1e-30)).item()
            for k in sorted(ref) for n in sorted(ref[k])}


def grad_check(gen: GenerativeModel, ref: GenerativeModel,
               disc: DCGANDiscriminator, gp: Params, dp: Params,
               z: torch.Tensor) -> Dict[str, float]:
    """Per-leaf :func:`rel_errs` of ``gen``'s generator grads ``J_G^T
    c`` (in ``gp``'s dtype) against ``ref``'s in float64, with ``c``
    fixed from the reference (:func:`fake_cotangent`).

    The full step's grads are not compared.  They also cross the
    discriminator's LeakyReLU kinks, and a pre-activation within f32
    rounding of 0 takes the other slope in one of the two runs: that
    moves the generator's grads by 1e-3 of their size and more with no
    fault in either (``tests/test_torch_train.py::
    test_full_step_grads_cross_a_kink`` shows one; :func:`kink_flips`
    counts them).  The generator's own ReLU kinks remain in ``J_G^T c``:
    where one flips, the check fails with no fault too (at the small
    size, seeds 398 and 511 among others; not seed 0)."""
    cot = fake_cotangent(ref, disc, gp, dp, z)
    return rel_errs(generator_vjp(gen, gp, z, cot),
                    generator_vjp(ref, trainable(double(gp)), z, cot))


def kink_flips(disc: DCGANDiscriminator, dp: Params, fake: torch.Tensor,
               fake64: torch.Tensor) -> List[Tuple[int, float, float]]:
    """Per discriminator conv, for samples ``fake`` (in ``dp``'s dtype)
    and ``fake64`` (float64): the number of pre-activations whose sign
    differs between the two, the largest ``|a64|`` among them, and
    ``max|a - a64|``, the rounding of that layer."""
    with torch.no_grad():
        a32 = disc.pre_activations(dp, fake)
        a64 = disc.pre_activations(double(dp), fake64)
    out = []
    for a, b in zip(a32, a64):
        flip = (a > 0) != (b > 0)
        out.append((int(flip.sum()),
                    b[flip].abs().max().item() if flip.any() else 0.0,
                    (a.double() - b).abs().max().item()))
    return out


def d_step(gen, disc, gp, dp, d_opt: OptState, z, real) -> torch.Tensor:
    """One discriminator step; updates ``dp`` and ``d_opt`` in place."""
    loss, grads = discriminator_grads(gen, disc, gp, dp, z, real)
    adamw_update(dp, grads, d_opt, lr=LR, b1=B1, weight_decay=0.0)
    return loss


def g_step(gen, disc, gp, dp, g_opt: OptState, z) -> torch.Tensor:
    """One generator step; updates ``gp`` and ``g_opt`` in place."""
    loss, grads = generator_grads(gen, disc, gp, dp, z)
    adamw_update(gp, grads, g_opt, lr=LR, b1=B1, weight_decay=0.0)
    return loss


def small_spec() -> NetworkSpec:
    """The reference's small DCGAN (``examples/train_dcgan.py``)."""
    return NetworkSpec("DCGAN-small", [
        LayerSpec("fc", 32, 4 * 4 * 64, name="project"),
        LayerSpec("deconv", 64, 32, k=5, s=2, in_hw=(4, 4), name="d1"),
        LayerSpec("deconv", 32, 3, k=5, s=2, in_hw=(8, 8), name="d2"),
    ])


def make_gan(small: bool, deconv_impl: str, device):
    """Generator and discriminator of the GAN loop: full DCGAN against
    channels (3, 64, 128, 256) at 64x64, or the small twin against (3,
    16, 32, 64) at 16x16."""
    if small:
        gen = GenerativeModel(small_spec(), deconv_impl=deconv_impl,
                              device=device)
        return gen, DCGANDiscriminator((16, 16), (3, 16, 32, 64), device)
    return (build("dcgan", deconv_impl, device=device),
            DCGANDiscriminator((64, 64), device=device))


def main(argv=None) -> Tuple[List[float], List[float]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--small", action="store_true",
                    help="the small DCGAN (4x4 -> 16x16) and discriminator")
    ap.add_argument("--deconv-impl", "--deconv", dest="deconv",
                    default="sd", choices=("native", "sd", "sd_kernel"))
    ap.add_argument("--grad-check", action="store_true",
                    help="before training, check the generator's grads "
                    "J_G^T c through --deconv-impl against the native "
                    "reference in float64, each leaf to 1e-4 of its "
                    "max|ref| (see grad_check)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    gen, disc = make_gan(args.small, args.deconv, dev)
    gp = trainable(gen.init(torch.Generator().manual_seed(0)))
    dp = trainable(disc.init(torch.Generator().manual_seed(1)))
    g_opt, d_opt = adamw_init(gp), adamw_init(dp)
    pipe = GANLatentPipeline(z_dim=gen.spec.layers[0].cin,
                             global_batch=args.batch)

    if args.grad_check:
        ref = GenerativeModel(gen.spec, deconv_impl="native", device=dev)
        errs = grad_check(gen, ref, disc, gp, dp, pipe.batch(0).to(dev))
        leaf = max(errs, key=errs.get)
        if errs[leaf] > 1e-4:
            raise SystemExit(f"grad check: {args.deconv} grads differ from "
                             f"native at {leaf}: {errs[leaf]:.3e} of max|ref|")
        print(f"grad check: {args.deconv} grads J_G^T c match native f64, "
              f"worst leaf {leaf} {errs[leaf]:.3e} of max|ref| (gate 1e-4)")

    d_hist, g_hist = [], []
    for step in range(args.steps):
        t0 = time.perf_counter()
        z = pipe.batch(step).to(dev)
        real = pipe.images(step, disc.img_hw).to(dev)
        dl = d_step(gen, disc, gp, dp, d_opt, z, real)
        gl = g_step(gen, disc, gp, dp, g_opt, z)
        d_hist.append(float(dl))
        g_hist.append(float(gl))
        if (step + 1) % 25 == 0 or step == 0:
            print(f"step {step + 1:4d} d_loss {d_hist[-1]:.3f} "
                  f"g_loss {g_hist[-1]:.3f} "
                  f"({(time.perf_counter() - t0) * 1e3:.0f} ms host clock, "
                  f"{dev})")
    if d_hist:
        print(f"done. d_loss {d_hist[0]:.3f}->{d_hist[-1]:.3f}, "
              f"g_loss {g_hist[0]:.3f}->{g_hist[-1]:.3f}")
    return d_hist, g_hist


if __name__ == "__main__":
    main()
