"""The port's Cout-sharded plans and mesh bookkeeping, in one process,
against the JAX package.

The pure pieces of the scale-out (``tests/test_shard.py``'s single-device
half): the shard-blocked permutation bit for bit against the
reference's ``to_shardblocked``; each rank's block of a bound plan
against the reference's shard-blocked filters (``with_shards(n).bind``,
sliced) on every backend and int8; ``with_shards`` and ``bind(mesh=)``
validation; ``gen_param_specs`` against the reference's
``PartitionSpec``s; the per-device ``layer_geom`` keys; ``cell_key``;
``GANLatentPipeline``'s ``n_procs``/``proc_index`` batches; and the
refusals: a sharded plan outside a mesh, a mesh or server without a
process group of the right size.  The collectives run in
``tests/test_torch_shard_spmd.py``.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.sd as jsd
from repro.core.accounting import WORKLOADS as J_WORKLOADS
from repro.data.pipeline import GANLatentPipeline as JPipe
from repro.distributed.sharding import (MeshContext as JMeshContext,
                                        gen_param_specs as j_gen_param_specs)
from repro.engine import SDEngine as JEngine

from repro_torch import sd
from repro_torch.core.accounting import WORKLOADS
from repro_torch.data import GANLatentPipeline
from repro_torch.distributed import (Mesh, MeshContext, gen_param_specs,
                                     local_block, spmd)
from repro_torch.engine.planner import SDEngine
from repro_torch.kernels.autotune import DeconvGeom
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.launch.serve_gen import GenServer, reduced_specs

CPU = torch.device("cpu")


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                      else t)


@pytest.mark.parametrize("rank", [1, 2, 3])
@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("shards", [2, 4])
def test_to_shardblocked_equals_reference(rank, s, shards):
    rng = np.random.RandomState(rank * 10 + s + shards)
    phases = s ** rank
    ws = rng.randn(*(2,) * rank, 3, phases * shards * 3).astype(np.float32)
    got = sd.to_shardblocked(torch.from_numpy(ws), s, shards)
    want = jsd.to_shardblocked(jnp.asarray(ws), s, shards)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    # shard k's block is n-major over its own Cout block
    cout, coutl = 3 * shards, 3
    for k in range(shards):
        blk = _np(got)[..., k * phases * coutl:(k + 1) * phases * coutl]
        for p in range(phases):
            np.testing.assert_array_equal(
                blk[..., p * coutl:(p + 1) * coutl],
                ws[..., p * cout + k * coutl:p * cout + (k + 1) * coutl])


BIND_CASES = [  # (w shape, stride, port backend, reference backend, dtype)
    ((4, 4, 3, 8), 2, "torch", "xla", "native"),
    ((4, 4, 3, 8), 2, "fused", "fused", "native"),
    ((4, 4, 3, 8), 2, "winograd", "winograd", "native"),
    ((5, 5, 3, 6), 3, "torch", "xla", "native"),
    ((4, 4, 8), 2, "fused", "fused", "native"),
    ((4, 4, 4, 2, 4), 2, "fused", "fused", "native"),
    ((4, 4, 4, 2, 4), 2, "torch", "xla", "native"),
    ((4, 4, 3, 8), 2, "torch", "xla", "int8"),
    ((4, 4, 3, 8), 2, "fused", "fused", "int8"),
    ((4, 4, 4, 2, 4), 2, "fused", "fused", "int8"),
]


@pytest.mark.parametrize("case", range(len(BIND_CASES)))
def test_bound_block_equals_reference_slice(case):
    """Rank r of ``bind(mesh=)`` holds the r-th contiguous block of the
    reference's shard-blocked ``ws``, ``bias`` and ``wscale`` (BN scale
    folded first, int8 scales per split channel of the whole filter)."""
    wshape, s, be, jbe, dt = BIND_CASES[case]
    rng = np.random.RandomState(case)
    w = rng.randn(*wshape).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(wshape[-1])).astype(np.float32)
    b = rng.randn(wshape[-1]).astype(np.float32)
    ref = jsd.plan(wshape, s, 1, backend=jbe, dtype=dt).with_shards(
        2, "model").bind(jnp.asarray(w), jnp.asarray(scale), jnp.asarray(b))
    p = sd.plan(wshape, s, 1, backend=be, dtype=dt, device=CPU)
    for r in range(2):
        bp = p.bind(torch.from_numpy(w), torch.from_numpy(scale),
                    torch.from_numpy(b), mesh=Mesh(1, 2, rank=r))
        assert bp.shards == 2 and bp.shard_axis == "model"
        assert bp.layout == ref.layout
        n = np.asarray(ref.ws).shape[-1] // 2
        want = np.asarray(ref.ws)[..., r * n:(r + 1) * n]
        if dt == "int8":
            np.testing.assert_array_equal(_np(bp.ws), want)
            m = np.asarray(ref.wscale).shape[0] // 2
            np.testing.assert_allclose(
                _np(bp.wscale), np.asarray(ref.wscale)[r * m:(r + 1) * m],
                rtol=1e-6)
        else:
            np.testing.assert_allclose(_np(bp.ws), want, rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_array_equal(
            _np(bp.bias), b[r * wshape[-1] // 2:(r + 1) * wshape[-1] // 2])
        assert bp.cout_local == wshape[-1] // 2


def test_with_shards_validation():
    """Reference ``test_with_shards_validation``."""
    p = sd.plan((4, 4, 3, 8), 2, 1, device=CPU)
    assert p.with_shards(1).shards == 1
    p2 = p.with_shards(2, "model")
    assert p2.shards == 2 and p2.cout_local == 4
    with pytest.raises(ValueError, match="divisible"):
        p.with_shards(3)
    with pytest.raises(ValueError, match="shards"):
        p.with_shards(0)


def test_bind_mesh_axis_validation():
    """Reference ``test_bind_mesh_axis_validation``, and a cout the
    model axis does not divide."""
    p = sd.plan((4, 4, 3, 7), 2, 1, device=CPU)
    w = torch.zeros(4, 4, 3, 7)
    with pytest.raises(ValueError, match="axis"):
        p.bind(w, mesh=Mesh(1, 1), axis="tensor")
    assert p.bind(w, mesh=Mesh(1, 1)).shards == 1     # replicated
    with pytest.raises(ValueError, match="not divisible"):
        p.bind(w, mesh=Mesh(1, 2))


def test_shard_specs_and_put():
    """Reference ``test_shard_specs_tree``: every leaf replicated
    unsharded; ``ws`` on its last axis and ``bias`` on its only one over
    the shard axis; ``shard_put`` keeps the rank's block."""
    w, b = torch.randn(4, 4, 3, 8), torch.randn(8)
    p = sd.plan(w.shape, 2, 1, device=CPU).bind(w, bias=b)
    assert all(not any(spec) for spec in p.shard_specs().values())
    ps = p.with_shards(2, "model")
    sp = ps.shard_specs()
    assert sp["ws"] == (None, None, None, "model") and sp["bias"] == ("model",)
    put = sd.plan(w.shape, 2, 1, device=CPU).with_shards(2).bind(
        w, bias=b).shard_put(Mesh(1, 2, rank=1))
    assert torch.equal(put.bias, b[4:])
    with pytest.raises(ValueError, match="every channel"):
        put.shard_put(Mesh(1, 2, rank=0))


@pytest.mark.parametrize("net", ["dcgan", "voxgan", "wavegan", "segnet",
                                 "fst"])
@pytest.mark.parametrize("mp", [2, 4])
def test_gen_param_specs_equal_reference(net, mp):
    jmesh = types.SimpleNamespace(axis_names=("data", "model"),
                                  devices=np.empty((1, mp)))
    want = j_gen_param_specs(J_WORKLOADS[net](), JMeshContext(jmesh))
    got = gen_param_specs(WORKLOADS[net](), MeshContext(Mesh(1, mp)))
    assert set(got) == set(want)
    for layer in want:
        assert set(got[layer]) == set(want[layer])
        for leaf, spec in want[layer].items():
            assert got[layer][leaf] == tuple(spec), (layer, leaf)
    sharded = [l for l in got if got[l]["w"]]
    assert sharded == [l.name for l in WORKLOADS[net]().layers
                       if l.kind == "deconv" and l.cout % mp == 0]


def test_local_block():
    t = torch.arange(24.0).reshape(2, 3, 4)
    m = Mesh(2, 2, rank=3)                  # data 1, model 1
    assert torch.equal(local_block(t, (None, None, "model"), m), t[..., 2:])
    assert torch.equal(local_block(t, ("data", None, None), m), t[1:])
    assert torch.equal(local_block(t, (), m), t)
    with pytest.raises(ValueError, match="split"):
        local_block(t, (None, "model", None), m)


@pytest.mark.parametrize("net", ["dcgan-dryrun", "segnet-dryrun"])
@pytest.mark.parametrize("dp,mp", [(2, 2), (1, 2), (2, 1), (4, 2)])
@pytest.mark.parametrize("batch", [1, 4, 16])
def test_engine_per_device_geometry(net, dp, mp, batch):
    """Reference ``test_engine_per_device_geometry``: what one rank
    launches (batch ceil-divided by dp, cout by the layer's shards, the
    ``_mp`` suffix), key for key against the reference's engine."""
    from repro.launch.serve_gen import reduced_specs as j_reduced_specs
    jeng = JEngine(j_reduced_specs()[net], backend="xla")
    eng = SDEngine(reduced_specs()[net], backend="torch", device=CPU)
    jeng.dp, jeng.mp = eng.dp, eng.mp = dp, mp
    for jl, l in zip(jeng.spec.deconv_layers(), eng.spec.deconv_layers()):
        g, jg = eng.layer_geom(l, batch=batch), jeng.layer_geom(jl,
                                                                batch=batch)
        assert g.key() == jg.key()
        assert g.b == max(1, -(-batch // dp))
        shards = mp if l.cout % mp == 0 else 1
        assert eng._layer_shards(l) == jeng._layer_shards(jl) == shards
        assert g.cout == l.cout // shards
        assert ("_mp" in g.key()) == (shards > 1)


def test_convgeom_mp_key_distinct():
    """Reference ``test_convgeom_mp_key_distinct``."""
    from dataclasses import replace
    g = DeconvGeom.from_deconv(2, 8, 8, 4, 8, 4, 2, padding=((1, 1),) * 2)
    g2 = replace(g, shards=2)
    assert "_mp2" in g2.key() and g.key() != g2.key()


def test_mesh_engine_binds_blocks_and_describes():
    """A mesh engine binds d1 (cout 16) to this rank's half and
    replicates d2 (cout 3); ``describe`` names the mesh and the
    shards."""
    spec = reduced_specs()["dcgan-dryrun"]
    from repro_torch.models.generative import GenerativeModel
    m = GenerativeModel(spec, "sd_kernel", engine_backend="fused",
                        device=CPU, engine_mesh=Mesh(2, 2, rank=1))
    m.init(torch.Generator().manual_seed(0))
    plans = m.engine.plans()
    assert plans["d1"].shards == 2 and plans["d1"].bias.shape == (8,)
    assert plans["d1"].ws.shape[-1] == 8 * 4
    assert plans["d2"].shards == 1 and plans["d2"].bias.shape == (3,)
    text = m.engine.describe()
    assert "mesh=dp2xmp2" in text and "shards=2@model" in text
    with pytest.raises(ValueError, match="engine impl"):
        GenerativeModel(spec, "sd", device=CPU, engine_mesh=Mesh(1, 2))


def test_cell_key_and_bucket_formats():
    """Reference ``test_cell_key_formats``, and the bucket rounded up to
    a multiple of dp."""
    srv = GenServer(nets=["g"], specs={"g": reduced_specs()["dcgan-dryrun"]},
                    device=CPU)
    assert srv.cell_key("g", 4) == ("g", 4, "float32")
    srv._mesh = object()                     # what a live mesh sets
    srv.dp, srv.mp = 2, 2
    assert srv.cell_key("g", 4) == ("g", 4, "float32", "dp2xmp2")
    assert [srv.bucket(n) for n in (1, 2, 3, 5, 16)] == [2, 2, 4, 8, 16]
    srv.dp = 3
    assert srv.buckets() == [3, 6, 9, 18]


@pytest.mark.parametrize("n_procs", [1, 2, 4])
def test_pipeline_procs_equal_reference(n_procs):
    """Each process's latents, bit for bit with the reference's seed
    arithmetic, and its share of the images."""
    for idx in range(n_procs):
        j = JPipe(100, 8, seed=3, n_procs=n_procs, proc_index=idx)
        t = GANLatentPipeline(100, 8, seed=3, n_procs=n_procs,
                              proc_index=idx)
        for step in (0, 7):
            np.testing.assert_array_equal(t.batch(step).numpy(),
                                          np.asarray(j.batch(step)))
        np.testing.assert_allclose(t.images(1, (16, 16)).numpy(),
                                   np.asarray(j.images(1, (16, 16))),
                                   rtol=1e-5, atol=1e-5)
        assert t.local_batch == 8 // n_procs


def test_sharded_plan_outside_a_mesh_raises():
    """The reference's ``ValueError`` (``_gather_cout``): a sharded plan
    run with no mesh, or on a mesh whose model axis has another size."""
    w, x = torch.randn(4, 4, 3, 8), torch.randn(2, 5, 6, 3)
    p = sd.plan(w.shape, 2, 1, backend="torch", device=CPU)
    bp = p.bind(w, mesh=Mesh(1, 2, rank=0))
    with pytest.raises(ValueError, match="not bound here"):
        sd.execute(bp, x)
    with pytest.raises(ValueError, match="not bound here"):
        sd.conv_transpose(p.with_shards(2), x, w[..., :4])
    with spmd(Mesh(1, 4)), pytest.raises(ValueError, match="not bound here"):
        sd.execute(bp, x)
    with spmd(Mesh(1, 2)), pytest.raises(ValueError, match="output channels"):
        sd.conv_transpose(p.with_shards(2), x, w)


def test_mesh_and_server_need_a_process_group():
    """Outside a process group of ``dp * mp`` ranks the mesh (and the
    server) raise the launcher error; a backend must be named; a
    collective on a mesh without groups raises."""
    with pytest.raises(ValueError, match="process group"):
        make_dev_mesh(1, 2, backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        make_dev_mesh(1, 2, backend=None, device="cpu")
    with pytest.raises(ValueError, match="process group"):
        GenServer(nets=["g"], specs={"g": reduced_specs()["dcgan-dryrun"]},
                  device=CPU, dp=2, dist_backend="gloo")
    with pytest.raises(ValueError, match="no process group"):
        Mesh(1, 2).all_gather(torch.zeros(2), "model", 0)
    assert Mesh(1, 1).all_reduce(torch.ones(2), "model").sum() == 2
