"""The sequence-parallel residual stream (``act_shard="seq"``, every
config's default) of the port's LM training on a (data, model) mesh, on
the CPU.

Reduced StableLM-2-12B (dense), Mixtral-8x7B (MoE, ``moe_tp``),
Jamba-1.5-Large (Mamba and attention slots, an MoE attention slot) and
InternVL2-76B (8 patches ahead of 16 text tokens) train in spawned gloo
ranks on dp1 x mp2 and dp2 x mp2 (one spawn of 4 ranks,
``tests/_torch_lm_shard.py`` ``seq_rank_main``), each under
``act_shard="seq"`` and ``"batch"``: the loss and its grads, one AdamW
step.  ``"seq"`` is held against
``"batch"`` on the same ranks and against the one-process port (under
the mesh's layout, whose data axis the MoE's dispatch groups follow) at
the gates of ``tests/test_torch_lm_sharded_recurrent.py``: loss 1e-5
and gnorm 1e-4 of ``max(1, |ref|)``, grads 1e-4 of each leaf's max,
params after the step 1e-5 of ``max(1, max|ref|)`` where the step is
determined (grads above 1e-4 of the leaf's max; the rest, at most 1% of
the elements outside the vocabulary's leaves, moves by at most 2 lr);
against one process each gate is at least four times the case's own
spread (the one-process run's move when every param moves by one f32
ulp).  The reference (the JAX package at its default ``"seq"``) is held
against the port's ``"seq"`` path by ``tests/test_torch_lm_sharded*.py``.

The tally: the forward's attention slots end in reduce-scatters where
``"batch"`` sums (``all_reduce``) over ``'model'``; the dense and MoE
steps issue the collectives counted below; a 15-token batch, which the
model axis of 2 does not divide, keeps the residual whole and issues
``"batch"``'s exact tally.  The dry-run's trace of a rank's Jamba train
step equals the live ranks' collectives and FLOPs.  The
trace's peak under ``"seq"`` is below ``"batch"``'s by the residuals
that remat saves, ``repeats * rows * S * d * itemsize * (1 - 1/mp)``,
within one residual block ``rows * S * d * itemsize`` (what else is
live at the peak differs by at most one gathered or scattered block),
where a repeat ends in an attention slot; MoE's partial combine saves
more (no sum of its expert buffers).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import _torch_lm_shard as H
from _torch_hybrid import one_torch_thread  # noqa: F401 (autouse)

from repro_torch.configs import ShapeCell, get
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import spawn

FWD_TOL = 1e-5          # loss: of max(1, max|ref|)
GRAD_TOL = 1e-4         # grads: of each leaf's max|ref|; gnorm
PARAM_TOL = 1e-5        # params after the step, where determined
MESHES = H.SEQ_MESHES
MESH_IDS = [f"dp{dp}xmp{mp}" for dp, mp in MESHES]
SPAWN_S = 240


@pytest.fixture(scope="module")
def runs():
    """Each mesh's ranks (its rank 0's results, every rank's tallies),
    the one-process port's results of every case under each mesh's
    layout, and each case's spread."""
    with ThreadPoolExecutor(1) as pool:     # the ranks run meanwhile
        job = pool.submit(spawn, H.seq_rank_main, 4, backend="gloo",
                          timeout_s=SPAWN_S)
        cases = {c: (c, H.TRAIN_SEQ) for c in H.SEQ_CASES}
        cases["odd"] = H.SEQ_ODD
        one = {m: {name: H.flat(H.train_case(c, "seq", Mesh(*m), n))
                   for name, (c, n) in cases.items()} for m in MESHES}
        spread = {}
        for name, (c, n) in cases.items():
            moved = H.flat(H.train_case(c, "seq", Mesh(*MESHES[0]), n,
                                        ulp=True))
            spread[name] = _errors(moved, one[MESHES[0]][name])
        ranks = job.result()
    # dp1 x mp2 ran on ranks 0 and 1
    port = {m: [r[m] for r in ranks if m in r] for m in MESHES}
    return {"port": port, "one": one, "spread": spread}


def _free(g) -> np.ndarray:
    """Elements whose gradient sits at the sums' rounding level:
    nonzero, at most GRAD_TOL of the leaf's max (the AdamW rule)."""
    g = np.abs(np.asarray(g))
    return (g > 0) & (g <= GRAD_TOL * g.max())


def _err(k: str, a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = float(np.abs(a - b).max(initial=0.0))
    if k.startswith("grads/"):
        return d / max(float(np.abs(b).max()), 1e-30)
    return d / max(1.0, float(np.abs(b).max(initial=0.0)))


def _errors(got: dict, want: dict) -> dict:
    """The largest error of each kind (loss, gnorm, grads, new_params
    where the AdamW rule holds them), as the gates measure it."""
    out = {}
    for k, b in want.items():
        kind, a = k.split("/")[0], got[k]
        if kind == "new_params":
            kept = ~_free(want["grads/" + k[len("new_params/"):]])
            a, b = np.asarray(a)[kept], np.asarray(b)[kept]
        out[kind] = max(out.get(kind, 0.0), _err(k, a, b))
    return out


def _case(results: dict, case: str, act: str) -> dict:
    pre = f"{case}/{act}/"
    return {k[len(pre):]: v for k, v in results.items()
            if k.startswith(pre) and not k.endswith("/collectives")}


def _assert_close(got: dict, want: dict, what: str, spread=None):
    """Every quantity of a case within its gate (module doc), each gate
    at least four times ``spread``'s where one is given."""
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want)))
    tight = {"loss": FWD_TOL, "gnorm": GRAD_TOL, "grads": GRAD_TOL,
             "new_params": PARAM_TOL}
    gate = {k: max(v, 4 * (spread or {}).get(k, 0.0))
            for k, v in tight.items()}
    loose = total = 0
    for k in sorted(want):
        a, b = np.asarray(got[k]), np.asarray(want[k])
        kind = k.split("/")[0]
        assert a.shape == b.shape, (what, k, a.shape, b.shape)
        if kind == "new_params":
            free = _free(want["grads/" + k[len("new_params/"):]])
            d = np.abs(a.astype(np.float64) - b)
            tol = max(PARAM_TOL * max(1.0, float(np.abs(b).max())),
                      gate[kind])
            assert d[~free].max(initial=0.0) <= tol, (what, k)
            assert d[free].max(initial=0.0) <= 2 * H.LR, (what, k)
            if k.rsplit("/", 1)[-1] not in ("embed", "head"):
                loose += int(free.sum())
                total += free.size
        else:
            assert _err(k, a, b) <= gate[kind], (what, k, _err(k, a, b))
    assert loose <= 0.01 * total, (what, loose, total)


@pytest.mark.parametrize("case", H.SEQ_CASES)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_seq_equals_batch_and_one_process(runs, mesh, case):
    """Loss, grads, gnorm and params after one AdamW step: ``"seq"``
    against ``"batch"`` on the same ranks and against one process."""
    r = runs["port"][mesh][0]
    seq = _case(r, case, "seq")
    _assert_close(seq, _case(r, case, "batch"), f"{case} seq vs batch")
    _assert_close(seq, runs["one"][mesh][case], f"{case} seq vs one",
                  runs["spread"][case])


def _model(counts: dict) -> dict:
    return {k.split("/")[0]: n for k, n in counts.items()
            if k.endswith("/model")}


@pytest.mark.parametrize("case", ["stablelm", "mixtral"])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_tally_of_the_loss_grads(runs, mesh, case):
    """The loss's grads of the one-slot decoders (R = 2 repeats,
    ``remat="block"``), per rank.  ``"batch"``: per repeat 2 sums in
    the forward, 1 in the recompute (the checkpoint's early stop skips
    the FFN's exit, whose output nothing saves; the MoE's combine saves
    it, 2), 2 in the backward; then 5 outside the blocks (the
    embedding, the loss's 3, the logits' entry).  ``"seq"``: repeat 0
    (entered whole) 2 reduce-scatters and 1 all-gather forward, 1 and 1
    recomputed, in the backward 3 gathers, 1 reduce-scatter and 2 sums
    (``_into``, ``ln2``'s scale); each later repeat 2 and 2 forward, 2
    and 1 recomputed, 2 and 2 backward and 2 sums (the norms' scales);
    the final gather; the MoE's router adds 1 sum a repeat.  Every rank
    alike."""
    r_ = 2
    moe = case == "mixtral"
    want = {"seq": {"all_gather": 6 * r_, "reduce_scatter": 5 * r_ - 1,
                    "all_reduce": 2 * r_ + 5 + moe * r_},
            "batch": {"all_reduce": (5 + moe) * r_ + 5}}
    for rank in runs["port"][mesh]:
        for act in H.SEQ_ACTS:
            got = _model(rank[f"{case}/{act}/collectives"])
            assert got == want[act], (case, act, got)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_attention_exits_reduce_scatter(runs, mesh):
    """Against ``"batch"``, every case's ``"seq"`` tally trades sums
    over ``'model'`` for reduce-scatters and gathers: fewer
    ``all_reduce/model`` (the exits of the attention slots and their
    FFNs, forward and recomputed, and ``_into``'s adjoints), and
    reduce-scatters where ``"batch"`` issues none."""
    for rank in runs["port"][mesh]:
        for case in H.SEQ_CASES:
            seq = _model(rank[f"{case}/seq/collectives"])
            batch = _model(rank[f"{case}/batch/collectives"])
            assert "reduce_scatter" not in batch, (case, batch)
            assert seq["reduce_scatter"] > 0, (case, seq)
            assert seq["all_reduce"] < batch["all_reduce"], (case, seq,
                                                             batch)
            assert seq["all_gather"] > batch.get("all_gather", 0), case


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_a_sequence_the_model_axis_does_not_divide_stays_whole(runs, mesh):
    """15 tokens on a model axis of 2: ``"seq"`` keeps the residual
    whole, with ``"batch"``'s exact tally and results."""
    for rank in runs["port"][mesh]:
        assert rank["odd/seq/collectives"] == rank["odd/batch/collectives"]
        assert "reduce_scatter/model" not in rank["odd/seq/collectives"]
    r = runs["port"][mesh][0]
    seq, batch = _case(r, "odd", "seq"), _case(r, "odd", "batch")
    assert sorted(seq) == sorted(batch)
    for k in seq:
        assert np.array_equal(seq[k], batch[k]), k
    _assert_close(seq, runs["one"][mesh]["odd"], "odd seq vs one",
                  runs["spread"]["odd"])


@pytest.mark.parametrize("name", [c[0] for c in H.SEQ_DRY])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_trace_predicts_the_live_seq_step(runs, mesh, name):
    """The dry-run's trace of rank 0's train step on the meta device
    (``dryrun.trace_step`` on an abstract ``Mesh(dp, mp)``) equals the
    live ranks' collectives, their wire bytes and FLOPs."""
    _, case, step, seq, rows = next(c for c in H.SEQ_DRY if c[0] == name)
    cfg = H.dry_config(case, get)
    got = D.trace_step(cfg, ShapeCell(name, step, seq, rows), Mesh(*mesh))
    want = runs["port"][mesh][0][f"dry/{name}"]
    assert "reduce_scatter/model" in want["counts"]
    assert dict(got["mesh"].counts) == want["counts"]
    assert {k: dict(v) for k, v in got["mesh"].traffic.items()} == \
        want["traffic"]
    assert got["trace"].flops == want["flops"]


@pytest.mark.parametrize("case", ["stablelm-12b", "mixtral-8x7b"])
def test_seq_saves_the_residual_slices(case):
    """A train step of 4 x 256 tokens traced on dp1 x mp2, 8 layers:
    ``"seq"``'s peak is below ``"batch"``'s by the remat-saved
    residuals' other half, within one residual block (the MoE saves at
    least that; module doc)."""
    # one attention block over the keys: few ops to trace
    base = dataclasses.replace(get(case).reduced(), n_layers=8,
                               microbatch=1, attn_block=256)
    peak = {act: D.trace_step(dataclasses.replace(base, act_shard=act),
                              ShapeCell("t", "train", 256, 4), Mesh(1, 2)
                              )["memory"]["peak_hbm_bytes"]
            for act in H.SEQ_ACTS}
    block = 4 * 256 * base.d_model * 4          # f32 residual, 4 rows
    saved = base.n_layers * block // 2
    drop = peak["batch"] - peak["seq"]
    assert drop >= saved - block, (case, peak, saved)
    if base.n_experts == 0:
        assert abs(drop - saved) <= block, (case, peak, saved)
