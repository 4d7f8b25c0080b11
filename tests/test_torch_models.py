"""The port's generative models end to end against the JAX reference.

Weights come from ``repro.models.generative.build(name).init(PRNGKey(0))``
and cross over through ``repro_torch.convert.params_from_numpy``; the
same seeded numpy latents go through both.  f32 gate ``rtol=atol=1e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.generative import build as jbuild
from repro_torch.convert import params_from_numpy
from repro_torch.models import build

TOL = dict(rtol=1e-5, atol=1e-5)


def _carry(net):
    jm = jbuild(net, "sd_kernel", engine_backend="xla")
    jp = jm.init(jax.random.PRNGKey(0))
    x = np.random.RandomState(1).randn(*jm.input_shape(2)).astype(
        np.float32)
    ref = np.asarray(jm.apply(jp, jnp.asarray(x)))
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    return np_params, x, ref


@pytest.mark.parametrize("net", ["dcgan", "sngan"])
@pytest.mark.parametrize("impl,backend", [("sd_kernel", "fused"),
                                          ("sd_kernel", "torch"),
                                          ("native", "auto"),
                                          ("sd", "auto")])
def test_end_to_end_matches_reference(net, impl, backend):
    np_params, x, ref = _carry(net)
    m = build(net, impl, engine_backend=backend, device="cpu")
    params = params_from_numpy(np_params, "cpu", spec=m.spec)
    out = m(params, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **TOL)
    if impl == "sd_kernel":
        assert m.engine.backend == backend
        assert m.engine.bound_to(params)


def test_params_from_numpy_checks_shapes():
    np_params, _, _ = _carry("sngan")
    spec = build("sngan", device="cpu").spec
    bad = {k: dict(v) for k, v in np_params.items()}
    bad["d1"]["w"] = bad["d1"]["w"][..., :-1]
    with pytest.raises(ValueError, match="d1"):
        params_from_numpy(bad, "cpu", spec=spec)
    with pytest.raises(ValueError, match="layers"):
        params_from_numpy({"project": np_params["project"]}, "cpu",
                          spec=spec)
    bad = {k: dict(v) for k, v in np_params.items()}
    bad["d2"]["b"] = bad["d2"]["b"][:3]
    with pytest.raises(ValueError, match="d2 b|'d2' b"):
        params_from_numpy(bad, "cpu")


def test_init_is_seeded_and_engine_binds_once():
    m = build("dcgan", "sd_kernel", device="cpu")
    p1 = m.init(torch.Generator().manual_seed(3))
    p2 = m.init(torch.Generator().manual_seed(3))
    for name in p1:
        for k in p1[name]:
            assert torch.equal(p1[name][k], p2[name][k])
    assert m.engine.bound_to(p2) and not m.engine.bound_to(p1)
    z = torch.randn(2, 100)
    y = m(p2, z)
    assert y.shape == (2, 64, 64, 3) and torch.isfinite(y).all()
    assert float(y.abs().max()) <= 1.0          # final tanh


def test_device_defaults_to_cuda():
    from repro_torch.device import default_device, resolve_device
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            default_device()
        with pytest.raises(RuntimeError):
            build("dcgan")
    with pytest.raises(ValueError, match="unknown workload"):
        build("nope", device="cpu")
    # build() looks nets up in WORKLOADS; rank 1 on fused binds K1's
    # oc-major filters (tests/test_torch_rank1.py holds its numbers).
    assert build("voxgan", device="cpu").spec.name == "VoxGAN"
    m = build("wavegan", "sd_kernel", engine_backend="fused", device="cpu")
    m.init(torch.Generator().manual_seed(0))
    assert {(p.rank, p.layout) for p in m.engine.plans().values()} == \
        {(1, "ocmajor")}
