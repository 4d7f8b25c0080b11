"""Batched LM serving: prefill + greedy decode with a request queue.

The port of the JAX package's ``launch/serve.py``.  Requests are grouped
into fixed decode slots by *prompt length* (``launch/batching.take_group``),
so no prompt is truncated to a group minimum; each group's batch is
padded to a power-of-two bucket (row 0 repeated, results discarded),
prefilled on its full prompt, then decoded greedily one token per step
for the whole slot batch.  Every LM that ``build_lm`` builds serves:
attention decoders, dense or MoE, xLSTM-350M (mLSTM and sLSTM blocks,
their recurrent states in the cache) and Jamba (Mamba, attention and
MoE).  Prompts longer than 2,048 tokens attend through K5
(``kernels/csrc/flash_attn.cu``) on the card, unless the config has a
sliding window (Mixtral's) or no attention (xLSTM).  In an MoE config
the padding
rows take expert capacity as real ones do, as in the reference, and a
prefill routes at another capacity than a decode step (``cap`` follows
the token count).

``serve`` feeds token prompts only, as the reference's does, so it
refuses a config whose prefill also needs embeddings (InternVL2's
``patch_embeds``, Whisper's ``frame_embeds``) before any work; the
reference's fails inside its prefill with a ``KeyError``.  Serve those
through :func:`~repro_torch.launch.steps.make_prefill_step` and
:func:`~repro_torch.launch.steps.make_decode_step` with a batch that
carries the embeddings.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-12b \\
      --reduced --requests 8 --max-new 16 --device cpu

Without ``--device`` it runs on the card and raises where there is none.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.batching import pow2_bucket, pow2_floor, take_group
from repro_torch.distributed import sharding as SH
from repro_torch.launch.steps import (greedy, make_decode_step,
                                      make_prefill_step)
from repro_torch.models.lm import build_lm, embedding_inputs


def serve(cfg, prompts: List[List[int]], max_new: int = 16,
          slots: int = 4, max_len: int = 128, *, params=None,
          device: DeviceLike = None):
    """Serve ``prompts`` greedily; returns ({request index: tokens},
    stats).  ``params``: the LM's parameters (default: ``init`` at seed 0
    on ``device``), cast once to the compute dtype for the whole call.
    stats: ``wall_s``, ``decode_steps``, and the host clock of each
    group's prefill and of each decode step in ms (each ends in reading
    the tokens back, which waits for the device).  Raises ``ValueError``
    for a config whose prefill needs ``patch_embeds`` or
    ``frame_embeds``.  Under a live mesh context the LM serves
    sharded: ``params`` are the rank's blocks (drawn and placed
    here when not given), every rank serves every prompt, and the
    tokens come from the sharded greedy search
    (:func:`~repro_torch.launch.steps.greedy`)."""
    need = sorted(embedding_inputs(cfg))
    if need:
        raise ValueError(
            f"serve: {cfg.name}'s prefill needs {need} beside the token "
            "prompts, which serve does not take; serve it through "
            "launch.steps.make_prefill_step / make_decode_step with a "
            "batch that carries them")
    # slots is both the group-size cap and the bucket cap; pow2_bucket
    # clamps caps to a power of two, so clamp the group size with it or
    # a 5-slot group would overflow its 4-wide bucket.
    slots = pow2_floor(max(1, slots))
    lm = build_lm(cfg, device=device)
    if params is None:
        params = lm.init()
        mc = SH.current()
        if SH.live_mesh(mc) is not None:
            params = SH.place(params, SH.param_specs(params, mc), mc.mesh)
    params = lm._cast(params)
    prefill = make_prefill_step(lm)
    decode = make_decode_step(lm)

    results = {}
    queue = list(enumerate(prompts))
    prefill_ms: List[float] = []
    decode_ms: List[float] = []
    t0 = time.perf_counter()
    n_steps = 0
    with torch.no_grad():
        while queue:
            # group only same-length prompts: no token is ever dropped
            group, queue = take_group(queue, lambda r: len(r[1]), slots)
            n = len(group)
            # pad the BATCH dim (repeat row 0, results discarded) to a
            # pow2 bucket, so the launch shapes form a small closed set
            bucket = pow2_bucket(n, slots)
            rows = [p for _, p in group] + [group[0][1]] * (bucket - n)
            batch = torch.tensor(rows, dtype=torch.int32, device=lm.device)
            cache = lm.init_cache(batch.shape[0], max_len)
            t = time.perf_counter()
            logits, cache = prefill(params, {"inputs": batch}, cache)
            toks = greedy(logits, batch.shape[0])
            outs = [[tok] for tok in toks[:n, 0].tolist()]
            prefill_ms.append((time.perf_counter() - t) * 1e3)
            for _ in range(max_new - 1):
                t = time.perf_counter()
                toks, logits, cache = decode(params, {"inputs": toks}, cache)
                for o, tok in zip(outs, toks[:n, 0].tolist()):
                    o.append(tok)
                decode_ms.append((time.perf_counter() - t) * 1e3)
                n_steps += 1
            for (rid, _), o in zip(group, outs):
                results[rid] = o
    dt = time.perf_counter() - t0
    return results, {"wall_s": dt, "decode_steps": n_steps,
                     "prefill_ms": prefill_ms, "decode_ms": decode_ms}


def random_prompts(vocab_size: int, n: int, length: int,
                   seed: int = 1) -> List[List[int]]:
    """``n`` prompts of ``length`` tokens uniform over the vocabulary,
    drawn from a numpy seed."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab_size, size=(n, length)).tolist()


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no silent CPU fallback")
    args = ap.parse_args(argv)

    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    prompts = random_prompts(cfg.vocab_size, args.requests, args.prompt_len)
    results, stats = serve(cfg, prompts, max_new=args.max_new,
                           slots=args.slots, device=dev)
    print(f"served {len(results)} requests in {stats['wall_s']:.2f}s "
          f"({stats['decode_steps']} decode steps) on {dev}")
    for rid in sorted(results)[:4]:
        print(f"  req{rid}: {results[rid][:10]}...")
    return results


if __name__ == "__main__":
    main()
