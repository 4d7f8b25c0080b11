"""Split-deconvolution plans, the differentiable transposed conv, the
presplit execution and the plain-executor adapter."""

from repro_torch.sd.compat import (clear_plan_cache, functional_deconv,
                                   plan_for)
from repro_torch.sd.functional import (conv_transpose, execute,
                                       execute_spmd, split_weights)
from repro_torch.sd.plan import (BACKENDS, DeconvPlan, plan,
                                 resolve_backend, to_ocmajor,
                                 to_shardblocked)

__all__ = ["BACKENDS", "DeconvPlan", "clear_plan_cache", "conv_transpose",
           "execute", "execute_spmd", "functional_deconv", "plan",
           "plan_for", "resolve_backend", "selfcheck", "split_weights",
           "to_ocmajor", "to_shardblocked"]


def selfcheck(device=None, verbose: bool = False) -> None:
    """Fast consistency gate of the split-deconvolution core on ``device``
    (``None``: the card, raising without one), after the reference's
    ``repro.sd.selfcheck``.

    On a small asymmetric-padding deconv, with plans on the backend
    ``"auto"`` resolves to for ``device`` (the kernels on a card):
    forward parity with bias against ``native_deconv``; ``dx``, ``dw``
    and ``db`` of a squared-sum loss against native's autograd; a bound
    plan (scale and bias folded at bind) through ``execute``;
    ``unsplit_filters`` inverting ``split_filters`` exactly; and ranks 1
    and 3 with ``output_padding``, forward and ``dw``.  Gate: 1e-4
    relative and absolute, as in the reference.  The reference also
    checks that a plan crosses ``jax.jit`` as a pytree argument and
    survives ``tree_flatten``; those have no torch meaning and are left
    out."""
    import numpy as np
    import torch

    from repro_torch.core.deconv import (native_deconv, split_filters,
                                         unsplit_filters)
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.RandomState(0)

    def t(*shape):
        return torch.as_tensor(rng.randn(*shape), dtype=torch.float32,
                               device=dev)

    def close(got, want, what):
        np.testing.assert_allclose(got.detach().cpu().numpy(),
                                   want.detach().cpu().numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=what)

    def grads(fn, *leaves):
        leaves = [v.detach().clone().requires_grad_() for v in leaves]
        return torch.autograd.grad((fn(*leaves) ** 2).sum(), leaves)

    x, w, b = t(2, 5, 6, 3), t(4, 4, 3, 2), t(2)
    stride, padding = 2, ((1, 0), (0, 1))
    p = plan(w.shape, stride, padding, device=dev)

    close(conv_transpose(p, x, w, b),
          native_deconv(x, w, stride, padding) + b, "forward")
    got = grads(lambda xx, ww, bb: conv_transpose(p, xx, ww, bb), x, w, b)
    want = grads(lambda xx, ww, bb: native_deconv(xx, ww, stride, padding)
                 + bb, x, w, b)
    for g, r, name in zip(got, want, ("dx", "dw", "db")):
        close(g, r, name)

    bound = p.bind(w, scale=torch.full((2,), 0.5, device=dev), bias=b)
    close(execute(bound, x), native_deconv(x, w, stride, padding) * 0.5 + b,
          "bound plan through execute")

    back = unsplit_filters(split_filters(w, stride), (4, 4), stride)
    if not torch.equal(back, w):
        raise AssertionError("unsplit_filters does not invert "
                             "split_filters")

    # rank generality: output_padding expresses the odd output size
    # (9 -> 19 at s=2)
    for shape_x, shape_w in (((2, 9, 3), (5, 3, 2)),
                             ((1, 3, 4, 5, 2), (3, 3, 3, 2, 2))):
        xn, wn = t(*shape_x), t(*shape_w)
        pn = plan(wn.shape, 2, 1, output_padding=1, device=dev)
        rank = len(shape_w) - 2
        close(conv_transpose(pn, xn, wn),
              native_deconv(xn, wn, 2, 1, output_padding=1),
              f"rank {rank} forward")
        (g,) = grads(lambda ww: conv_transpose(pn, xn, ww), wn)
        (r,) = grads(lambda ww: native_deconv(xn, ww, 2, 1,
                                              output_padding=1), wn)
        close(g, r, f"rank {rank} dw")

    if verbose:
        print(f"repro_torch.sd selfcheck on {dev} ({p.backend} backend): "
              f"conv_transpose/grad/execute/unsplit/N-D OK")
