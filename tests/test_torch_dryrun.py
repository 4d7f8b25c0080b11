"""The port's dry-run (``launch/dryrun.py``, ``launch/hlo_analysis.py``,
``launch/mesh.py``'s production mesh) against the JAX package's and
against live gloo ranks, on the CPU.

Against the reference (one subprocess, ``REF_CODE``, on the 512 forced
host devices the reference's dry-run module sets up as it is imported):
``cell_is_skipped`` for all 40 (arch, shape) pairs; the production
meshes' shapes and axes; ``_param_counts_abstract`` and
``model_flops_global`` for all 40 cells, from the abstract trees (the
port's on the meta device, the reference's by ``jax.eval_shape``); the
ring accounting of the port's collective tally against
``collective_stats`` on synthetic HLO lines, for each op, group size
and dtype; ``roofline_terms`` with the reference's constants passed in.
The record's keys are the reference's (read from its source).

On the port alone: at the reduced StableLM and small cells (a train
step, a 2,064-token prefill that reaches K5, a decode step), the
dry-run's trace of rank 0's step predicts exactly the collectives (calls
and wire bytes per ``op/axis``), the tensor-core FLOPs and the K5 calls
that live gloo ranks record (``tests/_torch_lm_shard.py``
``dryrun_rank_main``), on dp2 x mp2, on dp1 x mp4 (kv heads the model
axis does not divide) and on the (2, 1, 2) pod mesh; at microbatch 1
the depth-1 / depth-2 extrapolation equals the full-depth trace; a
long prefill's trace reaches K5's operator once a layer and counts its
formula, never the plain scan; ``main`` writes a record per cell.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import _torch_lm_shard as H

from repro_torch.configs import ARCHS, SHAPES, get
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import Mesh, ring_wire_bytes
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch.mesh import make_production_mesh, spawn
from repro_torch.launch.steps import abstract_params, effective_seq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_S = 300
OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")
GROUPS = (2, 4, 16)
DTYPES = {"f32": 4, "bf16": 2, "s8": 1, "f64": 8, "s32": 4}
SHAPE = (4, 1024)
# (flops, bytes accessed, [(op, wire bytes)], model flops per device)
ROOFS = ((1e12, 3e9, [("all-reduce", 1e6)], 5e11),
         (2e9, 8e11, [("all-gather", 4e8), ("all-reduce", 1e7)], 1e9),
         (3e10, 1e8, [("all-gather", 5e12)], 0.0))

REF_CODE = r"""
import json, sys
import numpy as np
import repro.launch.dryrun as RD
import jax
from repro.configs import ARCHS, SHAPES, get
from repro.launch.hlo_analysis import (CollectiveStats, ICI_BW,
                                       collective_stats, roofline_terms)
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import abstract_params, effective_seq

args = json.loads(sys.argv[1])
out = {"skip": {}, "mesh": {}, "params": {}, "model_flops": {},
       "wire": {}, "roof": []}
for mp in (False, True):
    m = make_production_mesh(multi_pod=mp)
    out["mesh"][str(mp)] = [list(m.devices.shape), list(m.axis_names)]
for arch in sorted(ARCHS):
    cfg = get(arch)
    lm, ap = abstract_params(cfg)
    tot, act = RD._param_counts_abstract(lm, ap, cfg)
    out["params"][arch] = [int(tot), int(act)]
    for shape, cell in SHAPES.items():
        out["skip"][f"{arch}/{shape}"] = RD.cell_is_skipped(arch, shape)
        seq = effective_seq(cfg, cell)
        toks = cell.global_batch * (seq if cell.step != "decode" else 1)
        mult = 6.0 if cell.step == "train" else 2.0
        out["model_flops"][f"{arch}/{shape}"] = mult * act * toks
for key, line in args["lines"].items():
    out["wire"][key] = collective_stats(line).op_bytes
for flops, byts, wire, mf in args["roofs"]:
    coll = CollectiveStats({}, dict(wire), sum(b for _, b in wire), [])
    out["roof"].append(roofline_terms(
        {"flops": flops, "bytes accessed": byts}, coll, link_bw=ICI_BW,
        model_flops_per_device=mf).table_row())
out["consts"] = [RD.ICI_BW, RD.DCI_BW,
                 __import__("repro.launch.hlo_analysis",
                            fromlist=["x"]).PEAK_FLOPS,
                 __import__("repro.launch.hlo_analysis",
                            fromlist=["x"]).HBM_BW]
print("REF_JSON" + json.dumps(out))
"""


def _hlo_line(op: str, g: int, dt: str) -> str:
    """A partitioned-HLO line of ``op`` on a (4, 1024) ``dt`` result
    over one group of ``g`` devices, as XLA prints one."""
    shape = f"{dt}[{SHAPE[0]},{SHAPE[1]}]{{1,0}}"
    groups = "{" + ",".join(str(i) for i in range(g)) + "}"
    return (f"  %x = {shape} {op}({shape} %y), "
            f"replica_groups={{{groups}}}, to_apply=%sum")


@pytest.fixture(scope="module")
def ref():
    lines = {f"{op}/{g}/{dt}": _hlo_line(op, g, dt)
             for op in OPS for g in GROUPS for dt in DTYPES}
    arg = json.dumps({"lines": lines,
                      "roofs": [list(r[:2]) + [r[2], r[3]] for r in ROOFS]})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", REF_CODE, arg], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=SPAWN_S)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [x for x in res.stdout.splitlines() if x.startswith("REF_JSON")]
    return json.loads(line[0][len("REF_JSON"):])


@pytest.fixture(scope="module")
def live():
    """Each mesh's live gloo ranks (rank 0's per-cell records)."""
    return {m: spawn(H.dryrun_rank_main, m[0] * m[1] * m[2],
                     backend="gloo", args=m, timeout_s=SPAWN_S)[0]
            for m in H.DRY_MESHES}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cell_is_skipped_equals_the_reference(ref, arch):
    for shape in SHAPES:
        assert D.cell_is_skipped(arch, shape) == \
            ref["skip"][f"{arch}/{shape}"], (arch, shape)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_equals_the_reference(ref, multi_pod):
    m = make_production_mesh(multi_pod=multi_pod, rank=5)
    shape, axes = ref["mesh"][str(multi_pod)]
    assert list(m.axis_names) == axes
    assert [m.axis_size(a) for a in m.axis_names] == shape
    assert m.rank == 5 and not m.live and m.size == int(np.prod(shape))
    # row-major, jax.make_mesh's order: the last axis fastest
    last = make_production_mesh(multi_pod=multi_pod, rank=m.size - 1)
    assert [last.axis_index(a) for a in last.axis_names] == \
        [n - 1 for n in shape]
    assert m.model_index == 5 and m.data_index == 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_and_model_flops_equal_the_reference(ref, arch):
    cfg = get(arch)
    lm, ap = abstract_params(cfg)
    tot, act = D._param_counts_abstract(lm, ap, cfg)
    assert [tot, act] == ref["params"][arch]
    for shape, cell in SHAPES.items():
        assert D.model_flops(cfg, cell, act) == \
            ref["model_flops"][f"{arch}/{shape}"], (arch, shape)


@pytest.mark.parametrize("op", OPS)
def test_ring_wire_bytes_equal_collective_stats(ref, op):
    for g in GROUPS:
        for dt, size in DTYPES.items():
            want = ref["wire"][f"{op}/{g}/{dt}"][op]
            got = ring_wire_bytes(op.replace("-", "_"),
                                  SHAPE[0] * SHAPE[1] * size, g)
            assert got == want, (op, g, dt, got, want)


def test_mesh_tally_uses_the_ring_accounting():
    """An abstract mesh's tally: each call's result bytes, its group
    and its ring wire bytes, per op/axis."""
    import torch
    mesh = Mesh(2, 4, pod=2, abstract=True)
    t = torch.empty(3, 5, device="meta")
    mesh.all_gather(t, "model", 1)
    mesh.all_reduce(t, "data")
    mesh.all_reduce(t, "data")
    mesh.all_gather(t, "pod", 0)
    assert mesh.counts == {"all_gather/model": 1, "all_reduce/data": 2,
                           "all_gather/pod": 1}
    assert mesh.traffic["all_gather/model"] == {
        "bytes": 240, "group": 4, "wire": 240 * 3 / 4}
    assert mesh.traffic["all_reduce/data"] == {
        "bytes": 120, "group": 2, "wire": 2 * (2 * 60 * 1 / 2)}
    stats = HA.collective_stats(mesh.traffic, mesh.counts)
    assert stats.total_bytes == 180 + 120 + 60
    assert stats.op_counts["all_reduce/data"] == 2


@pytest.mark.parametrize("i", range(len(ROOFS)))
def test_roofline_terms_equal_the_reference_on_its_constants(ref, i):
    ici, _, peak, hbm = ref["consts"]
    flops, byts, wire, mf = ROOFS[i]
    coll = HA.CollectiveStats({}, dict(wire), sum(b for _, b in wire), [])
    got = HA.roofline_terms({"flops": flops, "bytes accessed": byts}, coll,
                            link_bw=ici, model_flops_per_device=mf,
                            peak_flops=peak, hbm_bw=hbm).table_row()
    assert got == ref["roof"][i]


def test_links_by_group():
    """Every production axis spans more than one 8-GPU node (InfiniBand);
    a group of consecutive ranks inside one node gets NVLink."""
    for mp in (False, True):
        m = make_production_mesh(multi_pod=mp)
        assert {HA.axis_link(m, a) for a in m.axis_names} == {"ib"}
    m = Mesh(2, 4)
    assert HA.axis_link(m, "model") == "nvlink"
    assert HA.axis_link(m, "data") == "nvlink"
    assert HA.axis_link(Mesh(1, 16), "model") == "ib"
    assert HA.link_bandwidths(Mesh(2, 4)) == {"data": HA.NVLINK_BW,
                                              "model": HA.NVLINK_BW}


def _ref_record_keys():
    src = open(os.path.join(REPO, "src/repro/launch/dryrun.py")).read()
    keys = set(re.findall(r'rec\["(\w+)"\]\s*=', src))
    head = src[src.index("rec: Dict[str, Any] = {"):]
    head = head[:head.index("}")]
    keys |= set(re.findall(r'"(\w+)":', head))
    mem = src[src.index('rec["memory"] = {'):]
    mem = set(re.findall(r'"(\w+)":', mem[:mem.index("}")]))
    return keys, mem


def test_record_keys_equal_the_references(tmp_path):
    keys, mem = _ref_record_keys()
    cfg = get("stablelm-12b").reduced()
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "name"}
    rec = D.run_cell("stablelm-12b", "decode_32k", False, overrides=over)
    assert rec["status"] == "ok"
    assert set(rec) == keys - {"reason"}, set(rec) ^ keys
    assert set(rec["memory"]) == mem
    assert {"counts", "bytes", "total_bytes"} <= set(rec["collectives"])
    fast = D.run_cell("stablelm-12b", "decode_32k", False, overrides=over,
                      fast=True)
    assert set(fast) == set(rec) - {"compile_s", "memory", "cost_body_once"}
    skip = D.run_cell("whisper-small", "long_500k", True)
    assert skip["status"] == "skipped" and "reason" in skip


@pytest.mark.parametrize("mesh", H.DRY_MESHES,
                         ids=[f"pod{p}xdp{d}xmp{m}" for p, d, m
                              in H.DRY_MESHES])
@pytest.mark.parametrize("cell", [c[0] for c in H.DRY_CELLS])
def test_trace_predicts_the_live_ranks(live, mesh, cell):
    pod, dp, mp = mesh
    cfg = get("stablelm-12b").reduced()
    got = D.trace_step(cfg, H.dry_cell(cell), Mesh(dp, mp, pod=pod))
    want = live[mesh][cell]
    assert dict(got["mesh"].counts) == want["counts"]
    assert {k: dict(v) for k, v in got["mesh"].traffic.items()} == \
        want["traffic"]
    assert got["trace"].flops == want["flops"]
    assert got["trace"].k5 == want["k5"]
    assert [list(map(list, s)) for s in got["trace"].k5_shapes] == \
        [list(map(list, s)) for s in want["k5_shapes"]]
    if cell == "prefill":
        assert want["k5"] == cfg.n_layers


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_depth_extrapolation_equals_the_full_trace(shape):
    """At microbatch 1 the eager full-depth trace and the reference's
    a + R·b correction from the depth-1 and depth-2 traces agree
    exactly in FLOPs, collectives and K5 calls (the reduced StableLM at
    4 layers on the 16 x 16 mesh).  The bytes accessed of a train step
    hold a term in R²: the backward of each repeat's slice of a stacked
    leaf (``select_backward``) writes the whole stack, and the grads of
    the R slices are then added; at these widths it is 26 KB of 1.6 TB
    (a 1e-6 gate)."""
    cfg = get("stablelm-12b").reduced()
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "name"}
    # the full config's 1,024-key blocks: the train step's scan over
    # 4,096 keys then takes 4 blocks a layer, not the reduced 256
    over.update(n_layers=4, microbatch=1, attn_block=1024)
    rec = D.run_cell("stablelm-12b", shape, False, overrides=over)
    full = D.trace_step(dataclasses.replace(cfg, **over), SHAPES[shape],
                        make_production_mesh())
    assert rec["cost"]["flops"] == full["trace"].flops
    if shape == "train_4k":
        assert abs(rec["cost"]["bytes_accessed"] - full["trace"].bytes) \
            <= 1e-6 * full["trace"].bytes
    else:
        assert rec["cost"]["bytes_accessed"] == full["trace"].bytes
    assert rec["cost"]["k5_launches"] == full["trace"].k5
    stats = HA.collective_stats(full["mesh"].traffic, full["mesh"].counts)
    assert rec["collectives"]["counts"] == stats.op_counts
    assert rec["collectives"]["bytes"] == stats.op_bytes
    assert rec["collectives"]["total_bytes"] == stats.total_bytes


def test_long_prefill_traces_k5_not_the_scan():
    """A 32k prefill of the reduced StableLM on 16 x 16: one K5 call a
    layer on each rank's 1 q head and its kv head (the model axis does
    not divide the 2 kv heads), its formula in the FLOPs, and no
    blockwise scan (whose einsums would add 4·B·H·D·S² more)."""
    from repro_torch.kernels.flash_attn import k5_flops
    cfg = dataclasses.replace(get("stablelm-12b").reduced(), n_heads=16,
                              n_kv_heads=2)
    r = D.trace_step(cfg, SHAPES["prefill_32k"], make_production_mesh())
    tr = r["trace"]
    assert tr.k5 == cfg.n_layers
    assert tr.k5_shapes == [((2, 1, 32768, 16), (2, 1, 32768, 16))] * 2
    k5 = cfg.n_layers * k5_flops((2, 1, 32768, 16), (2, 1, 32768, 16), True)
    dense = tr.flops - k5
    assert 0 < dense < 4 * 2 * 16 * 32768 ** 2


def test_main_writes_a_record_per_cell(tmp_path):
    out = str(tmp_path / "dry")
    D.main(["--arch", "whisper-small", "--shape", "long_500k",
            "--multi-pod", "both", "--out", out])
    names = sorted(os.listdir(out))
    assert names == ["whisper-small__long_500k__mp.json",
                     "whisper-small__long_500k__sp.json"]
    with open(os.path.join(out, names[0])) as f:
        assert json.load(f)["status"] == "skipped"


def test_an_abstract_mesh_counts_as_live_and_moves_nothing():
    import torch
    m = Mesh(2, 2, abstract=True)
    assert m.live and SH.live_mesh(SH.MeshContext(m)) is m
    t = torch.ones(2, 3)
    assert m.all_gather(t, "model", 0).shape == (4, 3)
    assert m.world_max(3.0) == 3.0
    m.check_same("x", [1])
    m.barrier()
