"""The port's LM sharding rules against the JAX package's, on the CPU.

``param_specs``, ``cache_specs`` and ``batch_specs`` of the port
(``repro_torch.distributed.sharding``) equal the reference's
``param_specs`` / ``cache_shardings`` / ``batch_shardings`` (each
``PartitionSpec`` read as a tuple) leaf for leaf: for the ten reduced
configs on a 1 x 1 and a 2 x 2 mesh, under strategy ``'tp'`` with and
without FSDP and under ``'fsdp'``, caches of a batch the data axis
splits and of one it does not, the batches of every ``SHAPES`` cell.
The reference's 2 x 2 side runs in one subprocess on 4 forced host
devices (the recipe of ``tests/conftest.py``'s ``multi_device_run``).
Also: the logical-axis maps, the shape-aware ``constrain``, the
reference's 16-way divisibility check on the ten full configs built on
the meta device (``abstract_params``), ``input_specs`` and
``abstract_*`` against the reference's ``jax.eval_shape``, blocks under
tuple entries, and the meta device refused where the port runs.
"""

import json
import os
import subprocess
import sys

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as J_ARCHS, SHAPES as J_SHAPES, get as jget
from repro.distributed.sharding import MeshContext as JMeshContext
from repro.distributed.sharding import param_specs as j_param_specs
from repro.launch.mesh import make_dev_mesh
from repro.launch.steps import (abstract_cache as j_abstract_cache,
                                abstract_opt_state as j_abstract_opt_state,
                                abstract_params as j_abstract_params,
                                input_specs as j_input_specs)

from repro_torch.configs import ARCHS, SHAPES, get
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import Mesh, MeshContext
from repro_torch.launch.steps import (abstract_cache, abstract_opt_state,
                                      abstract_params, input_specs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((1, 1), (2, 2))
CTXS = (("tp", True), ("tp", False), ("fsdp", True))
CACHES = ((4, 24), (3, 13))          # (batch, max_len): split, not split
CONSTRAIN = [((4, 8, 16), ("batch", None, "tensor")),
             ((1, 8, 16), ("batch", None, "tensor")),
             ((3, 40, 16), ("batch", "tensor", None)),
             ((8, 6, 16), (("batch", "tensor"), None, None)),
             ((2, 3), ("batch", "tensor"))]

REF_SPECS = """
import json
import jax
from jax.sharding import PartitionSpec as P
import repro.distributed.sharding as RS
from repro.configs import ARCHS, SHAPES, get
from repro.launch.mesh import make_dev_mesh
from repro.launch.steps import abstract_params, input_specs


def path_of(kp):
    out = []
    for k in kp:
        out.append(str(getattr(k, "key", getattr(k, "idx",
                                                  getattr(k, "name", k)))))
    return "/".join(out)


def enc(s):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(s)]


def specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {{path_of(kp): enc(s) for kp, s in flat}}


built = {{}}
for name in ARCHS:
    cfg = get(name).reduced()
    lm, ap = abstract_params(cfg)
    built[name] = (cfg, lm, ap, {{
        f"{{b}}x{{n}}": jax.eval_shape(lambda: lm.init_cache(b, n))
        for b, n in {caches!r}}})
captured = []
RS.jax.lax.with_sharding_constraint = (
    lambda x, s: (captured.append(enc(s.spec)), x)[1])
out = {{}}
for dp, mp in {meshes!r}:
    mesh = make_dev_mesh(dp, mp)
    for strategy, fsdp in {ctxs!r}:
        mc = RS.MeshContext(mesh, strategy=strategy, fsdp=fsdp)
        key = f"{{dp}}x{{mp}}/{{strategy}}/{{fsdp}}"
        out[key + "/logical"] = {{k: list(v) if isinstance(v, tuple) else v
                                 for k, v in mc.logical.items()}}
        for name, (cfg, lm, ap, caches) in built.items():
            out[f"{{key}}/{{name}}/params"] = specs(
                RS.param_specs(ap, mc, fsdp=fsdp))
            for ck, c in caches.items():
                out[f"{{key}}/{{name}}/cache{{ck}}"] = specs(jax.tree.map(
                    lambda s: s.spec, RS.cache_shardings(c, mc)))
            for cell in SHAPES:
                out[f"{{key}}/{{name}}/batch/{{cell}}"] = specs(jax.tree.map(
                    lambda s: s.spec, RS.batch_shardings(
                        input_specs(cfg, SHAPES[cell]), mc)))
    with RS.mesh_context(mesh):
        for shape, axes in {constrain!r}:
            del captured[:]
            RS.constrain(jax.ShapeDtypeStruct(shape, "float32"), *axes)
            out[f"{{dp}}x{{mp}}/constrain/{{shape}}/{{axes}}"] = captured[0]
print("SPECS" + json.dumps(out))
"""


def _dec(s):
    return tuple(tuple(e) if isinstance(e, list) else e for e in s)


@pytest.fixture(scope="module")
def ref():
    """The reference's specs on both meshes, from one subprocess on 4
    forced host devices."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = REF_SPECS.format(meshes=MESHES, ctxs=CTXS, caches=CACHES,
                            constrain=CONSTRAIN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=480)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("SPECS")][0]
    return json.loads(line[len("SPECS"):])


def _spec_paths(tree, prefix=""):
    """``{path: spec}`` of a port spec tree (a spec is a plain tuple)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_paths(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list) or hasattr(tree, "_fields"):
        out = {}
        for i, v in enumerate(tree):
            k = tree._fields[i] if hasattr(tree, "_fields") else i
            out.update(_spec_paths(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _want(d):
    return {k: _dec(v) for k, v in d.items()}


_META = {}


def _meta(name):
    """The reduced config's LM and params on the meta device, and its
    caches there (no mesh context)."""
    if name not in _META:
        cfg = get(name).reduced()
        lm, ap = abstract_params(cfg)
        _META[name] = (cfg, lm, ap, {f"{b}x{n}": lm.init_cache(b, n)
                                     for b, n in CACHES})
    return _META[name]


def _mc(dp, mp, strategy, fsdp):
    return MeshContext(Mesh(dp, mp), strategy=strategy, fsdp=fsdp)


IDS = [f"dp{d}xmp{m}-{s}-{'fsdp' if f else 'nofsdp'}"
       for d, m in MESHES for s, f in CTXS]
GRID = [(d, m, s, f) for d, m in MESHES for s, f in CTXS]


@pytest.mark.parametrize("name", sorted(ARCHS))
@pytest.mark.parametrize("dp, mp, strategy, fsdp", GRID, ids=IDS)
def test_param_specs_equal_the_reference(ref, dp, mp, strategy, fsdp, name):
    _, _, ap, _ = _meta(name)
    got = _spec_paths(SH.param_specs(ap, _mc(dp, mp, strategy, fsdp),
                                     fsdp=fsdp))
    assert got == _want(ref[f"{dp}x{mp}/{strategy}/{fsdp}/{name}/params"])


@pytest.mark.parametrize("name", sorted(ARCHS))
@pytest.mark.parametrize("dp, mp, strategy, fsdp", GRID, ids=IDS)
def test_cache_and_batch_specs_equal_the_reference(ref, dp, mp, strategy,
                                                   fsdp, name):
    cfg, _, _, caches = _meta(name)
    mc = _mc(dp, mp, strategy, fsdp)
    key = f"{dp}x{mp}/{strategy}/{fsdp}/{name}"
    for ck, cache in caches.items():
        got = _spec_paths(SH.cache_specs(cache, mc))
        assert got == _want(ref[f"{key}/cache{ck}"]), ck
    for cell in SHAPES:
        got = SH.batch_specs(input_specs(cfg, SHAPES[cell]), mc)
        assert got == _want(ref[f"{key}/batch/{cell}"]), cell


@pytest.mark.parametrize("dp, mp, strategy, fsdp", GRID, ids=IDS)
def test_logical_axes_and_constrain_equal_the_reference(ref, dp, mp,
                                                        strategy, fsdp):
    mc = _mc(dp, mp, strategy, fsdp)
    want = ref[f"{dp}x{mp}/{strategy}/{fsdp}/logical"]
    assert {k: list(v) if isinstance(v, tuple) else v
            for k, v in mc.logical.items()} == want
    if (strategy, fsdp) == ("tp", True):     # the reference's mesh_context
        for shape, axes in CONSTRAIN:
            got = SH.constrain(shape, *axes, mc=mc)
            assert got == _dec(ref[f"{dp}x{mp}/constrain/{shape}/{axes}"]), \
                (shape, axes, got)


def test_constrain_without_a_context_is_replicated():
    assert SH.constrain((4, 8), "batch", "tensor") == ()


FULL = sorted(J_ARCHS)


@pytest.mark.parametrize("name", FULL)
def test_full_configs_divide_a_16_way_model_axis(name):
    """The reference's ``test_divisibility_on_production_mesh_dims`` on
    the port: every param dim the rules put on the model axis divides
    16, from the full config built on the meta device; and the specs
    are the reference's."""
    cfg = get(name)
    _, ap = abstract_params(cfg)
    assert all(t.device.type == "meta" for _, t in SH._tree_paths(ap))
    specs = SH.param_specs(ap, MeshContext(Mesh(1, 1)))
    shapes = dict(SH._tree_paths(ap))
    for path, s in _spec_paths(specs).items():
        for i, ax in enumerate(s):
            if ax == "model":
                assert shapes[path].shape[i] % 16 == 0, (path, s)
    _, jap = j_abstract_params(jget(name))
    jspecs = j_param_specs(jap, JMeshContext(make_dev_mesh(1, 1)))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, P))
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): tuple(s) for kp, s in flat}
    assert _spec_paths(specs) == want
    # the meta tree's shapes and dtypes are the reference's eval_shape
    jflat = dict((("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in kp)), v) for kp, v in
                 jax.tree_util.tree_flatten_with_path(jap)[0])
    assert sorted(jflat) == sorted(shapes)
    for path, t in shapes.items():
        assert tuple(t.shape) == tuple(jflat[path].shape), path
        assert str(t.dtype).replace("torch.", "") == str(jflat[path].dtype)


@pytest.mark.parametrize("cell", sorted(SHAPES))
@pytest.mark.parametrize("name", FULL)
def test_input_specs_equal_the_reference(name, cell):
    got = input_specs(get(name), SHAPES[cell])
    want = j_input_specs(jget(name), J_SHAPES[cell])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert str(got[k].dtype).replace("torch.", "") == str(v.dtype), k
    small = input_specs(get(name), SHAPES[cell], batch_override=8)
    assert all(v.shape[0] == 8 for v in small.values())


@pytest.mark.parametrize("name", ["dbrx-132b", "stablelm-12b",
                                  "jamba-1.5-large-398b"])
def test_abstract_opt_state_and_cache_equal_the_reference(name):
    """AdamW's state (bf16 moments where the config asks) and the cache
    of a decode cell, on the meta device, against the reference's
    ``jax.eval_shape``."""
    cfg, jcfg = get(name), jget(name)
    lm, ap = abstract_params(cfg)
    jlm, jap = j_abstract_params(jcfg)
    opt = abstract_opt_state(ap, cfg.opt_state_dtype)
    jopt = j_abstract_opt_state(jap, jcfg.opt_state_dtype)
    for got, want in ((opt.mu, jopt.mu), (opt.nu, jopt.nu),
                      (opt.master, jopt.master)):
        if want is None:
            assert got is None
            continue
        g = {p: t for p, t in SH._tree_paths(got)}
        w = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in kp): v
             for kp, v in jax.tree_util.tree_flatten_with_path(want)[0]}
        assert sorted(g) == sorted(w)
        for p, t in g.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(w[p].shape), p
            assert str(t.dtype).replace("torch.", "") == str(w[p].dtype), p
    cell = SHAPES["decode_32k"]
    cache = abstract_cache(lm, cfg, cell)
    jcache = j_abstract_cache(jlm, jcfg, J_SHAPES["decode_32k"])
    g = {p: t for p, t in SH._tree_paths(cache) if p != "pos"}
    w = {"/".join(str(getattr(k, "key", getattr(k, "idx",
                                                 getattr(k, "name", k))))
                  for k in kp): v
         for kp, v in jax.tree_util.tree_flatten_with_path(jcache)[0]}
    w.pop("pos")
    assert sorted(g) == sorted(w)
    for p, t in g.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(w[p].shape), p


@pytest.mark.parametrize("rank", range(4))
def test_blocks_under_tuple_entries(rank):
    """A dim split over ('data', 'model') (strategy 'fsdp') is cut
    row-major, data outermost; local_shape agrees; a dim that does not
    divide is named."""
    mesh = Mesh(2, 2, rank=rank)
    t = torch.arange(8 * 3).reshape(8, 3)
    got = SH.local_block(t, (("data", "model"), None), mesh)
    assert torch.equal(got, t[2 * rank:2 * rank + 2])
    assert SH.local_shape((8, 3), (("data", "model"), None), mesh) == (2, 3)
    got = SH.local_block(t, ("model", None), mesh)
    assert torch.equal(got, t[4 * (rank % 2):4 * (rank % 2) + 4])
    with pytest.raises(ValueError, match="dim 1 of size 3"):
        SH.local_shape((8, 3), (None, "model"), mesh)


def test_place_copies_every_block():
    mesh = Mesh(1, 2, rank=1)
    tree = {"a": torch.ones(4, 2), "b": [torch.zeros(3)], "pos": 5}
    got = SH.place(tree, {"a": ("model", None), "b": [(None,)], "pos": ()},
                   mesh)
    assert got["pos"] == 5 and got["a"].shape == (2, 2)
    got["b"][0].add_(1)
    assert not tree["b"][0].any()


def test_meta_is_refused_where_the_port_runs():
    with pytest.raises(ValueError, match="meta"):
        resolve_device("meta")
    assert resolve_device("meta", shapes_only=True).type == "meta"
    from repro_torch.launch.serve import main
    with pytest.raises(ValueError, match="meta"):
        main(["--arch", "stablelm-12b", "--reduced", "--device", "meta"])


def test_a_layout_mesh_is_not_live_and_a_live_one_needs_its_groups():
    assert not Mesh(2, 2).live and not Mesh(1, 1).live
    assert Mesh(1, 2, groups={"model": object()}).live
    assert not Mesh(2, 2, groups={"model": object()}).live
    with SH.mesh_context(Mesh(2, 2)) as mc:
        assert SH.current() is mc and SH.live_mesh() is None
    assert SH.current() is None
