"""LM training entry point with fault tolerance: the port of the JAX
package's ``launch/train.py``.

  * config-driven arch selection (``--arch`` from the pool, reduced or
    full: every config of the repo; the batches of ``internvl2-76b``
    carry ``patch_embeds`` (n_patches, frontend_dim) and those of
    ``whisper-small`` ``frame_embeds`` (enc_positions, d_model), drawn
    with the tokens as the reference's pipeline draws them)
  * deterministic restart-safe data (batch = f(seed, step))
  * periodic async checkpointing with atomic commit and retention
    (:mod:`repro_torch.checkpoint`, the reference's on-disk format)
  * ``--resume auto``: restart discovery picks the newest committed
    checkpoint, so a crashed or preempted job relaunches with the same
    command line and goes on from there
  * straggler posture: synchronous steps with a per-step deadline
    (``--deadline-ms``), logged
  * ``--compress-pods``: int8 + error-feedback gradient compression is
    a no-op on one process, as in the reference (no pod axis)

The weights come from ``--seed`` through a CPU ``torch.Generator`` (the
same model on every device) and move to ``--device``.  The LM's mesh
sharding, the MoE's expert-parallel dispatch with it, is not ported
(ROADMAP.md item 16.5): when a
``torch.distributed`` process group exists, the trainer takes the
one-rank mesh ``make_dev_mesh(1, 1)`` on it (which refuses a group of
more ranks); otherwise it runs with no mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-12b \\
      --reduced --steps 4 --ckpt-every 2 --device cpu --out runs/train_demo

Without ``--device`` it runs on the card and raises where there is none.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.checkpoint import CheckpointManager, restore_latest
from repro_torch.configs import get
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.device import describe_device, resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import build_lm, embedding_inputs
from repro_torch.optim import adamw_init


def _mesh(dev):
    """The one-rank mesh ``make_dev_mesh(1, 1)`` where a process group
    exists, else None."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from repro_torch.launch.mesh import make_dev_mesh
    return make_dev_mesh(1, 1, backend=dist.get_backend(), device=dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--out", default="runs/train")
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compress-pods", action="store_true")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-step straggler deadline (0 = off)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    lm = build_lm(cfg, device=dev)
    os.makedirs(args.out, exist_ok=True)
    mesh = _mesh(dev)

    pipe = SyntheticTokenPipeline(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq, global_batch=args.batch,
                                  seed=args.seed,
                                  extra=embedding_inputs(cfg) or None)
    params = lm.init(torch.Generator().manual_seed(args.seed))
    opt = adamw_init(params)
    ckpt_dir = os.path.join(args.out, "ckpt")
    mgr = CheckpointManager(ckpt_dir, keep=3)

    start_step = 0
    if args.resume == "auto":
        step0, restored = restore_latest(ckpt_dir,
                                         {"params": params, "opt": opt})
        if restored is not None:
            params, opt = restored["params"], restored["opt"]
            start_step = step0
            print(f"[resume] restored step {step0}")

    step_fn = make_train_step(lm, base_lr=args.lr,
                              warmup=min(20, args.steps // 5 + 1),
                              total=args.steps)
    where = describe_device(dev) + ("" if mesh is None else f", {mesh!r}")
    history = []
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = {k: v.to(dev) for k, v in pipe.batch(step).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        # --compress-pods: the reference compresses inside the grad path
        # when a pod axis exists; on one process there is none (a no-op)
        loss = float(metrics["loss"])
        dt = (time.perf_counter() - t0) * 1e3
        history.append({"step": step + 1, "loss": loss,
                        "gnorm": float(metrics["gnorm"]),
                        "ms": round(dt, 1)})
        if args.deadline_ms and dt > args.deadline_ms:
            print(f"[straggler] step {step + 1} took {dt:.0f}ms "
                  f"(deadline {args.deadline_ms:.0f}ms) — on a pod "
                  "this triggers the backup-worker controller")
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            mgr.save(step + 1, {"params": params, "opt": opt})
        if (step + 1) % 10 == 0 or step == start_step:
            print(f"step {step + 1:5d} loss {loss:.4f} {dt:7.1f}ms host "
                  f"clock ({where})")
    mgr.wait()
    with open(os.path.join(args.out, "history.json"), "w") as f:
        json.dump(history, f)
    if history:
        print(f"final loss {history[-1]['loss']:.4f} "
              f"(start {history[0]['loss']:.4f})")
    return {"history": history, "params": params}


if __name__ == "__main__":
    main()
