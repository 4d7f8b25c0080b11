"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``repro_torch`` only (never JAX, never the JAX package ``repro``):

1. builds the port's seven kernel sources with nvcc for sm_90a, one nvcc
   per source, all at once (``src/repro_torch/kernels/csrc/``: K1
   ``sd_fused.cu``, the fused split deconv; K2 ``sd_conv.cu``, the
   stride-1 conv of the SD backward's input grad and of the 3-D
   lowering; K3 ``sd_filter_grad.cu``, its filter grad; K4
   ``sd_wino.cu``, the Winograd split deconv; K1's int8 branch
   ``sd_fused_int8.cu``; K2's int8 pair ``sd_conv_int8.cu``; K5
   ``flash_attn.cu``, flash attention) and prints their registers and
   shared memory, and counts the TF32 ``HMMA`` instructions in the SASS
   of K1's float branch and K2, which share the 3xTF32 implicit-GEMM
   mainloop ``sd_igemm.cuh``, and of K3 and K4, which take its 3xTF32
   arithmetic (fails if any has none), and the IMMA (s8 tensor-core)
   and IDP.4A (dp4a) instructions of K1's and K2's int8 branches, the
   same mainloop on int8 (fails unless IMMA > 0 and IDP.4A = 0);
2. holds K1 against its plain PyTorch version ``sd_fused_ref`` on the 22
   deconv layers of the paper's six networks (batch 4, f32, TF32 off,
   ``max|d| <= 1e-4 * max(1, max|y_ref|)``), on an ``output_padding >
   pad_hi`` geometry and on forced GEMM plans (ragged tiles, split-K
   with an uneven last split, Cin 7 and 70), then on DCGAN's three
   layers and two forced plans in bf16 (``<= 1e-2 * max|y_ref|``); runs
   K1 twice on DCGAN d1 at batch 16 with split-K, bit-identical; times
   K1, the plain version and ``F.conv_transpose2d`` (cuDNN, a yardstick
   the port never calls) per DCGAN layer at the serving bucket 16, in
   device time (the profiler, and CUDA events over calls queued behind
   ``torch.cuda._sleep``) and in CUDA events over back-to-back calls,
   prints each layer's GEMM plan, the useful-work FFMA bound and the
   3xTF32 tensor-core bound, and fails if K1 takes more than
   ``K1_D1_MS_LIMIT`` ms of device time on d1;
3. serves 48 full-width DCGAN requests through ``GenServer`` on the card
   with the async scheduler, and checks that every batch ran K1 once per
   deconv layer, that every output is finite, and that it matches the
   same model on the plain ``torch`` backend (and, for two requests, the
   ``native`` model on the CPU);
4. runs each of the six paper networks once at batch 1 through K1
   against the plain backend;
5. trains: holds K2 and K3 against their plain versions (``sd_conv_ref``,
   ``sd_filter_grad_ref``) on the backward of the 22 paper layers at
   batch 4 and on odd geometries (``op > pad_hi``, asymmetric pads,
   forced ragged tiles and split-K plans, each run twice bit-identical),
   same f32 gate; times K2, K3, their plain versions and cuDNN's
   ``convolution_backward`` per DCGAN layer at batch 16 in device time
   and CUDA events, with each one's GEMM plan and tensor-core bound (K2
   and K3 run twice on d1 with split-K, bit-identical; both against the
   f64 product on d1 beside cuDNN f32), and fails if K2 takes more than
   ``K2_D1_MS_LIMIT`` ms of device time on d1's dx or K3 more than
   ``K3_D1_MS_LIMIT`` ms on d1's dw; then takes full-width DCGAN GAN steps (batch 16, discriminator
   3/64/128/256, AdamW) through ``repro_torch.launch.train_gen`` with
   the generator on the fused backend, and checks K1/K2/K3 launches of
   3/3/3 per generator step and 3/0/0 per discriminator step, finite
   losses, the first generator step's grads against the ``torch``
   backend (``1e-4`` relative), and the trained generator's output;
6. winograd: holds K4 against its plain version ``sd_wino_ref`` on the 22
   paper layers (batch 4, f32, the K1 gates) and on the reference's odd
   geometries (k5/s3, k6/s3, k7/s4, k5/s4, k2/s2, ``op > pad_hi``,
   asymmetric pads, forced ragged tiles), then on DCGAN's layers in
   bf16, and against K1 on the same split filters at the reference's
   ``tolerance(K_T) * max(1, max|y_K1|)``; times K4, its plain version,
   K1 and ``F.conv_transpose2d`` per DCGAN layer at batch 16 in device
   time and CUDA events, with K4's plan and grid, holds K4, K1 and cuDNN
   f32 against the f64 product on d1, and fails if K4 takes more than
   ``K4_D1_MS_LIMIT`` ms of device time on d1; serves 48
   full-width DCGAN requests through ``GenServer(backend="winograd")``
   and checks 3 K4 and 0 K1 launches per batch, finite outputs, and, on
   the same weights, the winograd model on the CPU (``sd_wino_ref``, the
   K1 f32 gate), the ``torch`` backend and the fused server's model
   within ``tolerance((3, 3)) * max|ref|``.  K4's ``bound_ms`` counts the
   work its algorithm needs (transform-domain products and transforms) on
   the CUDA cores, ``tc_bound_ms`` its products' 3xTF32 work on the
   tensor cores beside its transforms on the CUDA cores;
   ``useful_bound_ms`` is the direct deconv's, K1's bound;
7. int8: holds K1's int8 branch (``sd_fused_int8.cu``, the implicit
   GEMM on the s8 tensor cores) against its plain version
   (``sd_fused_ref`` on the int8 pair, exact sums) on the 22 paper
   layers and odd geometries (Cin not a multiple of 4, ``op > pad_hi``,
   asymmetric pads, forced GEMM plans with ragged N, Cin tails and
   several splits) at batch 4 and on DCGAN's layers at batch 16, at two
   gates: bit-identical at unit scale, zero bias and linear act; ``1e-6
   * max(1, max|y_ref|)`` with per-sample activation scales, folded-BN
   filter scales, bias and relu/tanh; holds every code at +-127 on
   DCGAN d1 (sums at 127^2 x 2,304) exactly to an int64 restatement, on
   the default plan and a 4-way split; serves 48 full-width DCGAN
   requests through
   ``GenServer(dtype="int8")`` and checks 3 K1-int8 and 0 float-K1
   launches per batch, finite outputs, the int8 ``torch`` backend on the
   card within ``1e-3 * max(1, max|ref|)`` and the float fused server's
   model within 0.05 of max|ref| with SSIM >= 0.99; times a batch of 16
   on the int8 and the float server in turns;
8. 3-D: holds K2's int8 pair (``sd_conv_int8.cu``, the implicit GEMM
   on the s8 tensor cores) against its plain version (``sd_conv_ref`` on
   the int8 pair, exact int32 sums) at VoxGAN's three tap-conv shapes at
   batch 16, at codes of +-127 and on odd geometries (Cin 3, 5, 70; Co
   5, 20, 33; ragged windows; forced GEMM plans; a batch-1 depth-tap
   band; a base off 16-byte alignment): bit-identical; holds the 3-D
   lowering (one K2 or K2-int8 launch per depth tap, then the torch
   interleave) against the ``torch`` backend on each full-width VoxGAN
   layer at batch 16, f32 within ``1e-5 * max(1, max|ref|)`` (TF32 off)
   and int8 exactly; times each tap conv in device time, in turns (K2
   int8 with its plan and grid, K2 f32, plain, ``F.conv2d`` f32 and
   ``torch._int_mm`` on the tap's own GEMM operands as yardsticks;
   ``bound_ms`` at the int8 tensor cores' peak or the memory rate),
   fails if K2 int8 takes more than ``K2_INT8_UP2_MS_LIMIT`` ms of
   device time on up2's tap, and times each whole layer (fused f32, fused int8, ``torch``,
   ``F.conv_transpose3d``); serves 48 full-width VoxGAN requests through
   ``GenServer`` in f32 and in int8 and checks 2 K2 (or K2-int8)
   launches per deconv layer per batch and nothing else, finite outputs,
   the same model on the card's ``torch`` backend (f32 ``1e-4``, int8
   ``1e-6``, relative to ``max(1, max|ref|)``) and int8 within 0.05 of
   max|ref| of the f32 server; times a batch of 16 in f32 and int8 in
   turns;
9. the calibrated int8 chain: holds K1's int8 branch with a static (1,
   NC) scale row, int8 output on DCGAN d1/d2 (relu) and f32 output on d3
   at batch 16, and on an odd geometry, on scales that saturate codes at
   +-127, bit-identical to its plain version (and prints how many codes
   saturated), and its int8-out epilogue against an exact numpy
   restatement (int64 sums, one f32 cast, ``* comb``, interleave, ``+
   bias``, relu, round half to even, clamp); serves 48 full-width DCGAN
   requests through ``GenServer(dtype="int8", calib=64)`` (calibration
   cache in a temporary file) and checks 3 K1-int8 launches per batch and
   nothing else, the chained codes and the output against the card's
   int8 ``torch`` backend with the same scales (codes exact, output
   ``1e-3 * max(1, max|ref|)``) and the float server (SSIM >= 0.99,
   max|d| <= 0.05 max|ref|); profiles one calibrated batch (3 K1-int8
   launches, 0 ``quantize_act`` calls, int8 leaving d1 and d2); times
   per DCGAN layer, in turns and in device time, the static-row launch,
   the dynamic one, float K1, ``F.conv_transpose2d`` f32, the plain
   version and ``torch._int_mm`` on the GEMM's own operands (a
   yardstick of cuBLASLt's int8 GEMM rate, checked to give the GEMM's
   exact sums; not the same function), and the static launch with f32
   out beside int8 out (``bound_ms`` at the int8 tensor cores' peak);
   fails if K1 int8 takes more than
   ``K1_INT8_D1_MS_LIMIT`` ms of device time on d1, static or dynamic;
   times a batch calibrated / dynamic / f32 in turns; serves 48
   calibrated VoxGAN requests, held exactly to the ``torch`` backend, and
   times a VoxGAN batch calibrated / dynamic / f32 in turns, with each
   one's device busy time;
10. K5 and dense LM serving: counts the HGMMA (tensor-core) and UTMALDG
   (TMA load) instructions in the SASS of K5's bf16 kernel and the TF32
   HMMA instructions in that of its f32 kernel, and fails if any is 0;
   holds K5 (``flash_attn.cu``: bf16 on wgmma + TMA, f32 on mma.sync in
   3xTF32) against its plain version ``flash_attention_ref`` at the serving
   shape (4 x 32 q / 8 kv heads x 4,080 x 160, bf16 and f32), on D in
   (16, 40, 64, 128, 160, 256) x S in (1, 63, 65, 127, 128, 129, 255,
   257, 2049) x causal and full x f32 and bf16 with grouped heads, and on
   the serving grouping at S 300 (f32 within ``2e-5 * max(1,
   max|ref|)``, bf16 within ``1e-2 * max|ref|`` and element by element
   within ``2^-7 |ref| + 1e-4 max|ref|``); times K5 bf16, K5 f32 on the
   same inputs, its plain version and ``F.scaled_dot_product_attention``
   in bf16 and f32 (a yardstick the port never calls) in turns at the
   serving shape,
   device time from the profiler (``bound_ms`` at the useful work on the
   bf16 tensor cores, ``bound_split_ms`` at the 1.5x of the split P,
   ``bound_f32_ms`` at the CUDA cores, ``bound_f32_tc_ms`` at its 3xTF32
   work on the TF32 tensor cores), and fails if K5 bf16 takes more than
   5.2 ms or K5 f32 more than 25.6 ms there; runs StableLM-2-12B widths
   at depth 2 in f32 through ``prefill`` on 4 prompts of 4,080 tokens
   (the serving shape's K5 launches) on K5 and on the plain scan (logits
   within ``1e-4 * max(1, max|ref|)``, 8 greedy tokens each) and profiles
   one f32 prefill (device busy, K5 f32's share); serves 8 prompts of 4,080
   tokens through ``repro_torch.launch.serve.serve`` on StableLM-2-12B
   at all 40 layers (random weights from seed 0, drawn in f32 and
   rounded to bf16 leaf by leaf; bf16 compute, 4 slots, ``max_len``
   4,096, 16 new tokens) and checks 40 K5 launches per prefill group
   and none in decode, finite logits and the first group's prefill
   logits against the plain scan within ``5e-2 * max|ref|``; prints
   prefill ms per group, decode ms per step, the device-busy share of
   one prefill with K5's part, and peak memory;
11. rank 1, full-width WaveGAN (fc 100 -> 16 x 64, k25/s4 deconvs 64 ->
   32 -> 16 -> 1 over 16 -> 64 -> 256 -> 1,024 samples), each 1-D layer
   an H=1 launch of a 2-D kernel: holds K1 f32 against its plain version
   on the three layers at batch 16 (default and forced ``GemmPlan``s:
   bn 16 / 32 / 64, split-K with an uneven last split), on 1-D ``op >
   pad_hi``, asymmetric-pad and Cin-70 geometries (the f32 gate), and
   up1 twice with split-K, bit-identical; K1 int8 (dynamic rows and a
   static row, f32 out; int8 out on up1/up2) bit-identical to its plain
   version, and every code at +-127 on up1 exact against int64; K4
   (alphas (1, 6)) on ``wavegan-dryrun``'s k9/s2 layers and on k17/s4
   at WaveGAN's widths against ``sd_wino_ref`` (the f32 gate) and K1
   (``tolerance((1, 5))``); K2 and K3 on each layer's backward against
   their plain versions, and full WaveGAN's ``J_G^T c`` on fused
   against the ``torch`` backend at 1e-4 with 3/3/3 K1/K2/K3 launches;
   serves 48 full-width WaveGAN requests in f32, dynamic and calibrated
   (``calib=64``) int8 and checks 3 K1 (or K1-int8) launches per batch
   and nothing else, finite outputs, the card's ``torch`` backend (f32
   ``1e-4``, int8 ``1e-6``, chained codes exact) and int8 within 0.05
   of max|ref| of the f32 server; serves ``serve_gen --dryrun --backend
   winograd`` (``wavegan-dryrun`` on K4: 5 K4 launches); times each
   layer in turns (K1 f32, K1 int8 static, the plain version,
   ``F.conv_transpose1d`` f32) with its bounds, K4 / K2 / K3 per layer,
   and a batch of 16 f32 / dynamic / calibrated in turns (host ms,
   device busy, idle share);
12. measured tiles and the per-layer algorithm (the whole script runs
   on a fresh, empty ``$REPRO_TORCH_SD_PLAN_CACHE``, so phases 1-11
   launch the call-time tiles): pretunes a full-width f32 DCGAN
   ``GenServer`` (backend fused, buckets 1-16: K1's and K4's candidate
   tiles per layer and bucket, 30 geometries, device time by
   ``kernels.timing.ahead_ms``), prints per layer at bucket 16 the
   winning ``GemmPlan`` and ``WinoPlan`` beside the heuristic plans by
   the same timer and the backend the layer bound to (chosen at batch
   1, as the reference chooses); serves 48 requests through it and
   checks K1 / K4 launches per batch against those backends and the
   outputs against the ``torch`` backend (1e-4 where every layer stayed
   on K1) or the unpretuned fused server and ``torch`` (``WINO_TOL[3]``
   where a layer switched); checks that ``estimate_ms`` is set for every
   bucket and at 16 at most 1.1x the batch's device busy time; that a
   second server on the same cache pretunes with no measurement; that a
   calibrated int8 server (``calib=64``) pretunes K1 int8 alone
   (``_int8`` / ``_q8out`` keys) and serves outputs bit-identical to an
   unpretuned one's; times a batch of the pretuned and the unpretuned
   server in turns (host ms, busy ms); then drives the switch on a copy
   of the cache whose batch-1 entries are the bucket-16 readings: at
   least one layer must bind to K4, as those readings say, each
   bucket's tile must be the measured winner of the bound algorithm, 48
   served requests must launch K1 / K4 per batch as bound and agree with
   the ``torch`` backend and the all-K1 fused model to ``WINO_TOL[3]``,
   and that model's ``J_G^T c`` must run every layer's backward on K2
   and K3 within 1e-4 of the ``torch`` backend in f64; a batch of the
   switched server is timed in turns with the pretuned one;
13. the executor registry (``repro_torch.core.registry``): runs
   ``registry.selfcheck`` and ``sd.selfcheck`` on the card (every impl
   at every declared rank against ``native``, gradients, bf16, the int8
   claim) and fails unless ``fused``, ``sd_fn`` and ``sd_kernel`` launch
   K1, ``sd_fn``'s gradient K2 and K3, ``winograd`` K4 at ranks 1 and 2
   and the int8 claim K1 int8; runs full-width DCGAN (batch 16) and FST
   (256 x 256, batch 4) through ``build(net, impl)`` for every
   registered impl on one seeded ``native`` model's weights (exact impls
   within ``1e-4 * max(1, max|ref|)``, ``winograd`` within ``WINO_TOL`` of
   its taps; 3 / 2 K1 launches per forward on ``fused``, ``sd_fn`` and
   ``sd_kernel``, as many K4 on ``winograd``, none elsewhere); prints
   Table 4's SSIM of ``sd``, ``shi`` and ``chang`` against ``native``
   beside the paper's values (random weights here) and fails unless SD
   >= 0.9999 > Shi, Chang on both nets; holds ``J_G^T c`` of DCGAN on
   ``sd_fn`` to ``native`` in f64 within 1e-4 with 3 K2 and 3 K3
   launches; and times each DCGAN layer at batch 16 on ``native``,
   ``nzp``, ``sd``, ``sd_paper``, ``fused`` and a presplit ``sd_kernel``
   plan in turns (device ms by ``kernels.timing.ahead_ms``);
14. scale-out (``repro_torch.launch.mesh``, ``repro_torch.distributed``):
   spawns gloo ranks that share the card (one process per rank, a
   deadline on each spawn and a timeout on every collective; a failed or
   late rank fails the script), the kernels built once above.  Two ranks
   as dp1 x mp2: (a) ``sd.execute_spmd`` of the reference's Cout-shard
   parity cases (2-D at stride 2 and 3, 1-D, 3-D, int8; ``torch``,
   ``fused`` and ``winograd``) and full-width DCGAN d1/d2 at batch 16 on
   K1, K1 int8 and K4, against the unsharded plan on the same card (f32
   within ``1e-5 * max(1, max|ref|)``, int8 bit-identical), each with its
   launches per rank (one per shard; one K2 or K2-int8 launch per depth
   tap at rank 3), and K1's device ms on d1 whole and on one Cout block
   beside the host ms of the gather of d1's output; (b) 48 full-width
   DCGAN requests through ``GenServer(mp=2)`` in f32 on ``fused``
   (pretuned on the mesh at bucket 16, so ``estimate_ms`` is set), in
   calibrated int8 and on ``winograd``, against the one-process server
   (f32 ``1e-4``, int8 bit for bit), 3 launches per batch per rank, the
   cell key's ``dp1xmp2``, no new cell after ``swap_checkpoint``; (c) one
   sharded SGD step of full-width DCGAN at mp 2 and at dp 2 against
   ``make_train_step`` (loss ``1e-5`` relative, params ``1e-4``; 3 K1, 3
   K2, 3 K3 per rank) and the gradients, read as ``(p - new)/lr`` from a
   step at lr ``1e6``, each rank's block of every leaf within ``1e-4`` of
   the leaf's largest reference gradient.  Four ranks as dp2 x mp2 run (b)'s f32 and
   calibrated int8 servers.  Every time printed there is gloo's host copy
   on one card, not a scale-out time.
15. checkpoints and dense-LM training (``repro_torch.checkpoint``,
   ``launch/train.py``, ``launch/steps.make_train_step``): (a)
   ``train_gen.main --steps 6 --batch 16 --deconv-impl sd_kernel`` on
   full-width DCGAN, K1 / K2 / K3 launches 3 / 3 / 3 per generator step
   and 3 / 0 / 0 per discriminator step; its blocking step-6 checkpoint
   restored into a fresh template equal to the trained ``{g, d}`` bit for
   bit; a ``GenServer`` swapped onto the restored generator
   (``swap_checkpoint``) serves 16 latents bit-identical to one holding
   the trained generator; (b) ``launch.train.main`` on the reduced
   StableLM-2-12B on the card, 6 steps straight (checkpoints at 3 and 6)
   and a fresh call with ``--resume auto`` from the step-3 checkpoint
   alone: params bit for bit; (c) ``make_train_step`` there, 3 steps on
   the card against the same steps on the CPU (TF32 off): losses within
   ``1e-5`` relative, params within ``1e-5 * max(1, max|ref|)`` where the
   gradient is determined (AdamW's elements whose gradient sits at the
   sums' rounding level within their ``2 * lr * steps`` bound, at most 1%
   of them); the loss's grads at seq 4,096 within ``1e-4`` of each leaf's
   max, with 0 K5 launches over them and a train step there; (d)
   full-width StableLM-2-12B cut to 2 of its 40 layers, batch 8 x 128, 3
   ``make_train_step`` steps: finite loss and gnorm, every leaf changed
   after step 1, host ms per step, the busy share of a profiled step and
   peak memory;
16. MoE decoders (``layers.moe``, ``mixtral-8x7b``, ``dbrx-132b``): (a)
   one full-width DBRX MoE layer (16 experts, top-4) in f32, TF32 off,
   on 320 tokens at capacity factor 1.25 against the port on the CPU:
   the same top-k experts and kept entries, outputs within ``1e-4 *
   max|ref|``; (b) K5 bf16 at DBRX's prefill shape (4 x 48 q / 8 kv
   heads x 4,080 x 128) against its plain version, one sample at a
   time, and its device time beside SDPA's; (c) DBRX-132B at full
   width, 4 of its 40 layers, bf16, serving 8 prompts of 4,080 tokens
   through ``serve`` (4 slots, ``max_len`` 4,096, 16 new tokens): 4 K5
   launches a prefill group and none in decode, finite logits, the
   first group's last-token logits against the plain scan within
   ``5e-2 * max|ref|``, the entries dropped per layer and the tokens
   routed differently after K5 than after the scan, host ms per group
   and step, one profiled prefill, and one MoE layer and its expert
   GEMMs timed at the prefill's shape; (d) Mixtral-8x7B at 2 of 32
   layers, bf16, serving 4 prompts of 4,080 tokens with 32 new tokens
   past its 4,096-token window (the ring cache wraps; 0 K5 launches,
   finite logits), then at 1 layer with f32 params and AdamW, 3
   ``make_train_step`` steps at batch 8 x 128: every expert with a
   gradient, every expert leaf updated, finite loss and gnorm, host ms,
   busy share, peak memory; (e) the reduced Mixtral and DBRX with 8
   experts in f32 on the card against the CPU: loss within 1e-6
   relative, grads within 1e-4 of each leaf's max and bit-identical in
   a second card run, served tokens equal.
17. Recurrent mixers (``models/ssm.py``: Mamba, mLSTM, sLSTM;
   ``xlstm-350m``, ``jamba-1.5-large-398b``): (a) one full-width block
   of each kind in f32, TF32 off, on 256 tokens from a nonzero state
   (Jamba's Mamba, d 8,192, d_inner 16,384; xLSTM's mLSTM and sLSTM, d
   1,024) against the port on the CPU, outputs and states within
   ``1e-4 * max|ref|``, and on the card the chunked forms against
   ``mamba_step`` / ``mlstm_recurrent`` token by token (the sLSTM
   against itself resumed half way) at the same gate; (b) xLSTM-350M at
   all 24 layers, bf16, serving 8 prompts of 2,048 tokens (4 slots, 16
   new tokens): 0 K5 launches, one group's prefill last-token logits
   and first decode step against ``forward_train`` at the same
   positions within ``5e-2 * max|ref|``, and in f32 at 8 of the 24
   layers within ``1e-4 * max|ref|``, each or four times
   ``forward_train``'s own spread at half the ``mlstm_chunk``, where
   larger (rounding amplified through the mLSTM layers), host ms per
   group and step, one profiled prefill and decode step, peak memory;
   (c) xLSTM-350M
   training at full size, f32 params and AdamW, batch 8 x 512, 2
   ``make_train_step`` steps: finite losses, host ms, busy share, peak
   memory; (d) Jamba-1.5-Large at full width, its first 4 of 72 layers
   (3 Mamba, 1 attention, MoE at slots 1 and 3), bf16, serving 8
   prompts of 4,080 tokens: K5 once a prefill group and never in
   decode, the first group's logits against the plain scan within
   ``5e-2 * max|ref|``, entries dropped per MoE layer, one profiled
   prefill, one Mamba layer timed at the prefill's shape, peak memory;
   then K5 bf16 at Jamba's prefill shape (4 x 64 q / 8 kv heads x 4,080
   x 128) against its plain version and timed beside SDPA; (e) the
   reduced xLSTM and Jamba in f32 on the card against the CPU: loss
   within 1e-6 relative, grads within 1e-4 of each leaf's max (xLSTM:
   or four times the CPU's own spread when only ``mlstm_chunk``
   changes) and bit-identical in a second card run, greedy tokens equal.
18. LM frontends (``internvl2-76b``'s patch projector,
   ``whisper-small``'s encoder-decoder) and the three other dense
   decoders: (a) InternVL2-76B at full width, its first 8 of 80 layers,
   bf16, serving 8 requests of 256 patch embeddings + 3,824 tokens
   through ``make_prefill_step`` / ``make_decode_step`` (4 slots, 16 new
   tokens; ``serve`` takes tokens only): K5 once per layer per prefill
   group and never in decode, the first group's last-token logits
   against the plain scan within ``5e-2 * max|ref|``, host ms per group
   and step, one profiled prefill, peak memory; (b) Whisper-small at
   full size (12 + 12 layers), bf16, serving 8 requests of 1,500 frame
   embeddings + 64 tokens through the step API, 32 new tokens: 0 K5
   launches, one group's prefill and first decode step against
   ``forward_train`` within ``5e-2 * max|ref|``, and in f32 within
   ``1e-4 * max|ref|``; then ``launch.train.main`` at batch 8 x 448, 3
   steps, f32 params and AdamW: finite losses and gnorms, host ms, the
   busy share of a profiled step; (c) the reduced InternVL2 and Whisper
   in f32 on the card against the CPU: loss within 1e-6 relative, grads
   within 1e-4 of each leaf's max and bit-identical in a second card
   run (Whisper's unused encoder leaves zero), greedy tokens equal; (d)
   K5 bf16 at InternVL2's prefill shape (4 x 64 q / 8 kv heads x 4,080
   x 128) against its plain version, timed beside SDPA (profiler or
   events, and ``kernels.timing.ahead_ms`` in turns); (e) Qwen1.5-32B,
   InternLM2-20B and Yi-34B at full width, each cut to 2 layers, bf16,
   serving 4 prompts of 4,080 tokens through ``serve``: K5 once per
   layer per prefill group, logits against the plain scan within ``5e-2
   * max|ref|``; K5 at Qwen's (40 / 40 heads) and Yi's (56 / 8) prefill
   shapes against its plain version and SDPA, as in (d).

19. the LM half of sharding (``repro_torch.distributed.sharding``'s
   ``param_specs`` / ``cache_specs`` / ``batch_specs``, the sharded
   ``models/lm.py``): gloo ranks sharing the card (``launch.mesh.spawn``,
   as phase 14; every collective time there is a host copy, not
   scale-out speed), each rank's weights drawn from the one-process seed
   as its blocks, the ranks in turn.  (a) StableLM-2-12B at 2 of 40
   layers, bf16, on dp1 x mp2 and on dp2 x mp2:
   one prefill group of 4 x 4,080 tokens and 8 decode steps fed the
   one-process run's tokens,
   every step's logits within ``5e-2 * max|ref|`` of that run's, the
   greedy tokens that agree counted, on every rank one K5 launch per
   layer (on its H/mp q and Hkv/mp kv heads), param and cache bytes
   equal to the blocks of ``param_specs`` / ``cache_specs``; (b)
   DBRX-132B at 1 of 40 layers, f32, ``moe_ep`` with ``fsdp_serve``, on
   dp2 x mp2, as (a) with 2 decode steps (``fsdp_serve`` gathers every
   data-split leaf each step, about 7 GB through gloo's host copies)
   at ``1e-4 * max(1, max|ref|)``, and the entries each
   dispatch group drops per layer equal to the one-process run's under
   a layout-only ``mesh_context(Mesh(2, 2))`` (two groups); (c)
   Mixtral-8x7B at 1 layer, f32, its capacity factor lowered until
   entries drop, a dp2 x mp1 prefill within ``1e-4`` of the one-process
   run with two groups and not of the run with one, the drops equal;
   (d) one train step of StableLM at 2 layers, f32, ``fsdp_train``, on
   dp2 x mp2, against the one-process step: loss within 1e-6 relative,
   grads within 1e-4 of each leaf's max, params by phase 15's AdamW
   rule, its 1% share of loosely held elements taken over the leaves
   other than the vocabulary's (the head's columns for tokens a batch
   does not target carry softmax-sized gradients); (e) K5 bf16 at the
   per-rank shapes of StableLM (4 x 16 / 4 x 4,080 x 160) and DBRX (4 x
   24 / 4 x 4,080 x 128) against its plain version and timed in turns
   with SDPA.  Prints each rank's peak
   memory and the collectives it issues per prefill group, decode step
   and train step.
20. the sharded recurrent slots and frontends (``models/ssm.py``'s
   Mamba / mLSTM / sLSTM on a model rank, the patch projector and the
   encoder-decoder on a mesh), as phase 19 on gloo ranks sharing the
   card, every one-process reference run first and freed: (a)
   Jamba-1.5-Large's first 4 of 72 layers (3 Mamba, attention, two
   ``moe_ep`` FFNs), bf16, on dp1 x mp2: a prefill group of 4 x 4,080
   tokens (one K5 launch per rank, on its 32 q / 4 kv heads) and 8
   decode steps fed the one-process tokens and MoE routes within
   ``5e-2 * max|ref|``, the greedy tokens that agree and the entries the
   ranks' own routers would route otherwise (bf16 near ties) counted;
   (c) InternVL2-76B at 2 of 80 layers, bf16, on dp1 x mp2, 4 x (256
   patches + 3,824 tokens) through the step API, 2 K5 launches per
   rank, the same gate; (b) xLSTM-350M
   at all 24 layers, f32, on dp2 x mp2, 4 x 256 tokens and 8 decode
   steps within ``max(1e-4 * max(1, max|ref|), 4 x`` the one-process
   prefill's spread under ``mlstm_chunk`` 64); (b2) the same at full
   width cut to one mLSTM and one sLSTM layer, where that spread is
   small, and its train step (bt) (at 8 layers a one-ulp move of every
   f32 param moves a grad leaf by 0.28 of its max): loss and grads
   against the one-process step at 4 x its spread (the larger under
   ``mlstm_chunk`` 64 and under a one-ulp move of every param) where
   above 1e-6 / 1e-4; (d) Whisper-small whole, on dp2 x mp2, 4 x
   (1,500 frames + 64 tokens) and 8 decode steps at the bf16 gate, and
   one f32 train step held as phase 19 (d)'s; (e) K5 bf16 at Jamba's
   per-rank shape (4 x 32 / 4 x 4,080 x 128) against its plain version,
   timed in turns with SDPA.  Prints each rank's param and cache bytes
   beside the specs' blocks, peak memory and collectives per prefill
   group, decode step and train step;
21. the dry-run (``launch/dryrun.py``) and the heads a model axis does
   not divide, which run replicated over it: (e) K5 bf16 at
   StableLM-2-12B's per-rank shape on 16 ranks (4 x 2 q / 1 kv x 4,080
   x 160) against its plain version, timed in turns with SDPA; (a)
   StableLM-2-12B at 2 of 40 layers on dp1 x mp16 gloo ranks sharing
   the card (each rank 2 q heads and 1 kv head), a prefill of 4 x 4,080
   tokens through K5; (b) Whisper-small (12 heads, 1,500 encoder
   positions) and xLSTM-350M (4 mLSTM heads) whole on dp1 x mp8, a
   prefill and a decode step each and an xLSTM train step; every step
   run once under ``dryrun.run_step``'s trace on inputs one seed draws
   on every rank; (c) for each, the dry-run's trace of rank 0's step on
   the meta device predicts the ranks' collectives (calls and wire bytes
   per ``op/axis``), tensor-core FLOPs and K5 calls exactly, its
   ``peak_hbm_bytes`` printed beside the live ``max_memory_allocated``
   with their ratio (gated at ``DRY_MEM_RATIO``), the gathered logits of
   StableLM and Whisper against the one-process run on the card at the
   bf16 gate; (d) ``python -m repro_torch.launch.dryrun`` on
   StableLM-2-12B ``prefill_32k`` (16 x 16) and Yi-34B ``decode_32k``
   (2 x 16 x 16), each ending ``ok``; (f) on (a)'s 16 ranks, a train
   step of StableLM-2-12B at 2 layers on 2 x 4,096 tokens with the
   sequence-parallel residual stream (``act_shard="seq"``: each rank
   holds 256 positions between attention blocks; reduce-scatters at the
   blocks' exits), held by (c) against its trace, and the loss and
   grads of its first microbatch under ``"seq"`` against ``"batch"`` on
   every rank within the bf16 gate, printing which transport gloo took
   for the reduce-scatters; (g) one Mamba layer at Jamba-1.5-Large's
   width on phase 17 (d)'s prefill shape through Mamba's chunk-scan
   operator (``repro_torch::mamba_chunk_scan``) against the plain
   checkpointed loop, output and state bit-identical, and one chunk's
   backward operator against autograd through the plain body,
   bit-identical.

Every printed number carries the card's name and power limit.  The line
before the last is ``{"kernels": [...]}``; the last is ``{"ok": true,
"device": {...}}``.  Exits non-zero, with no result, when CUDA is absent
or the repository's ``src/repro_torch`` is not beside this file.

    python3 chip_smoke.py [--json report.json]
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TIME_LIMIT_S = 1200
F32_GATE = 1e-4          # relative to max(1, max|y_ref|)
BF16_GATE = 1e-2         # relative to max|y_ref|
PEAK_F32_FLOPS = 67e12   # H100 SXM, CUDA cores, dense (data sheet)
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
SERVE_REQUESTS = 48
BUCKET = 16
SEED = 0
GAN_STEPS = 6
SOURCES = ("sd_fused", "sd_conv", "sd_filter_grad", "sd_wino",
           "sd_fused_int8", "sd_conv_int8", "flash_attn")
# The int8 kernels.  bound_ms: the H100 SXM's dense int8 tensor-core peak
# (NVIDIA data sheet, 1,979 TOP/s).
PEAK_INT8_OPS = 1979e12
INT8_EXACT_GATE = 1e-6   # K1 int8 vs its plain version, rel. max(1, max|ref|)
INT8_SERVE_GATE = 1e-3   # served vs the int8 torch backend (tests/test_quant.py:116)
INT8_VS_F32 = 0.05       # max|d|/max|ref| vs the float server (:134)
SSIM_GATE = 0.99         # vs the float server (benchmarks/quant_bench.py)
ND_F32_GATE = 1e-5       # the 3-D lowering vs the torch backend (TF32 off)
# K1's float branch and K2 in f32 run on the TF32 tensor cores in 3xTF32
# (three products per multiply-add; bf16 one): their tensor-core bound is
# that work at the H100 SXM's dense TF32 peak (NVIDIA data sheet).
PEAK_TF32_FLOPS = 495e12
K1_D1_MS_LIMIT = 0.13    # K1 f32 on DCGAN d1 at batch 16, device ms
K2_D1_MS_LIMIT = 0.20    # K2 (dx) on DCGAN d1 at batch 16, device ms
K3_D1_MS_LIMIT = 0.15    # K3 (dw) on DCGAN d1 at batch 16, device ms
K4_D1_MS_LIMIT = 0.12    # K4 f32 on DCGAN d1 at batch 16, device ms
K1_INT8_D1_MS_LIMIT = 0.065  # K1 int8 (static and dynamic) there, device ms
K2_INT8_UP2_MS_LIMIT = 0.018  # K2 int8 on VoxGAN up2's tap at batch 16
# Phase 10: K5 and dense LM serving.  StableLM-2-12B
# (src/repro_torch/configs/stablelm_12b.py) at all 40 of its layers: the
# weights are drawn leaf by leaf in f32 and rounded to bf16 at once (24.2
# GB, what serve's one cast of an f32 tree gives), beside a 3.4 GB cache.
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores (data sheet)
K5_F32_GATE = 2e-5        # tests/test_flash_attn.py:30, rel. max(1, max|ref|)
# K5 in bf16, element by element: the kernel sums in f32 and rounds its
# output once (at most 2^-8 |ref|), so |d| <= 2^-7 |ref| + 1e-4 max|ref|
K5_BF16_REL, K5_BF16_FLOOR = 2.0 ** -7, 1e-4
K5_SWEEP_D = (16, 40, 64, 128, 160, 256)
# around both kernels' tiles: f32 (128 or 64, 32), bf16 (128, 64)
K5_SWEEP_S = (1, 63, 65, 127, 128, 129, 255, 257, 2049)
K5_BF16_MS_LIMIT = 5.2    # ms at LM_K5_SHAPE: 10x below the FFMA kernel's
K5_F32_MS_LIMIT = 25.6    # ms at LM_K5_SHAPE: half the FFMA kernel's 51.3
LM_BF16_GATE = 5e-2       # served logits vs the plain scan, rel. max|ref|
                          # (bf16, tests/test_flash_attn.py:39)
LM_ARCH = "stablelm-12b"
LM_K5_SHAPE = (4, 32, 8, 4080, 160)   # B, H, Hkv, S, D of a prefill group
LM_SERVE_LAYERS = 40       # all of StableLM-2-12B's layers
LM_REQUESTS = 8
LM_PROMPT_LEN = 4080
LM_SLOTS = 4
LM_MAX_NEW = 16
LM_MAX_LEN = 4096         # StableLM-2's context length
LM_GATE_LEN = 4080        # past 2,048: the prefill takes the blockwise branch
LM_GATE_PROMPTS = 4       # with LM_GATE_LEN, LM_K5_SHAPE's B and S
LM_GATE_DECODE = 8


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _time_ms(fns: dict, reps: int = 7, iters: int = 20) -> dict:
    """Device time of each ``fns[name]()`` in ms: CUDA events around
    ``iters`` warm launches, repeated ``reps`` times in turns (the order
    reversed every other round) so that a slow spell of the card hits
    every function alike.  Returns ``{name: (median, min, max)}``."""
    import torch
    names = list(fns)
    for name in names:
        for _ in range(3):
            fns[name]()
    runs = {name: [] for name in names}
    for r in range(reps):
        for name in (names if r % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(iters):
                fns[name]()
            end.record()
            torch.cuda.synchronize()
            runs[name].append(start.elapsed_time(end) / iters)
    return {name: (sorted(v)[len(v) // 2], min(v), max(v))
            for name, v in runs.items()}


def _ahead_ms(fn, calls: int = 20) -> float:
    """:func:`repro_torch.kernels.timing.ahead_ms`: device ms per call of
    ``fn``, the host's time per call hidden behind ``torch.cuda._sleep``
    (imported at call time: the package is found only once ``main`` has
    put ``src`` on the path)."""
    from repro_torch.kernels.timing import ahead_ms
    return ahead_ms(fn, calls)


def _device_ms(fn) -> tuple:
    """(profiler ms, ahead ms) of one call of ``fn``: the device busy time
    of a profiled call (every kernel it launches summed, the median of
    3; None when the profiler reports no device time) and
    :func:`_ahead_ms`."""
    prof = [b[0] for b in (_device_breakdown(fn) for _ in range(3))
            if b is not None]
    return (sorted(prof)[len(prof) // 2] if prof else None, _ahead_ms(fn))


def _ms_txt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def _clocks() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def _device_breakdown(fn, top: int = 6, cuda_only: bool = False):
    """One synchronised call of ``fn`` under ``torch.profiler``: (device
    busy ms, wall ms, [(kernel, ms, calls)] the ``top`` by device time),
    or None when the profiler saw no device time.  ``cuda_only`` records
    the device's activity alone (no host op events): for calls that
    launch hundreds of thousands of kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA]
    if not cuda_only:
        acts.insert(0, ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue                      # host ops: their kernels count
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), wall, rows[:top]


def _gate_err(out, ref, rel: float, floor_one: bool) -> tuple:
    d = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = rel * (max(1.0, scale) if floor_one else scale)
    return d, tol


def _train_phase(dev, tag: str, randn) -> dict:
    """Phase 5: K2 and K3 against their plain versions on the backward of
    every paper layer and the odd geometries; K2, K3, their plain
    versions and cuDNN's backward timed per DCGAN layer at batch 16;
    then full-width DCGAN GAN steps on the card through train_gen.
    Returns the two kernels' records and the training report."""
    import torch
    import torch.nn.functional as F
    import repro_torch.kernels.sd_conv as K
    from repro_torch import sd
    from repro_torch.core.accounting import BENCHMARKS, LayerSpec
    from repro_torch.core.deconv import (conv_valid, conv_valid_filter_grad,
                                         same_deconv_pads)
    from repro_torch.data import GANLatentPipeline
    from repro_torch.kernels.autotune import (ConvGeom, FilterGradGeom,
                                              GemmPlan, filter_grad_plan,
                                              gemm_grid, gemm_plan,
                                              gemm_smem_bytes)
    from repro_torch.launch import train_gen
    from repro_torch.models.generative import GenerativeModel
    from repro_torch.optim import adamw_init
    from repro_torch.sd.grad import split_cotangent

    def case(layer, batch, pad, op=0):
        p = sd.plan((layer.k, layer.k, layer.cin, layer.cout), layer.s,
                    pad, backend="fused", output_padding=op, device=dev)
        x = randn(batch, *layer.in_hw, layer.cin)
        w = randn(layer.k, layer.k, layer.cin, layer.cout,
                  scale=1.0 / (layer.k * layer.k * layer.cin) ** 0.5)
        dy = randn(batch, *p.out_shape(layer.in_hw), layer.cout)
        ws = sd.split_weights(p, w)
        k2 = dict(x=split_cotangent(p, dy),
                  w=ws.flip(0, 1).transpose(-1, -2).contiguous(),
                  pad=tuple((k - 1, k - 1) for k in p.kt),
                  out_start=p.pi, out_size=tuple(layer.in_hw))
        k3 = dict(x=x, dy1=k2["x"], kt=p.kt,
                  pad=tuple((q, q) for q in p.pi))
        return p, x, dy, k2, k3

    def k2_call(a, plan=None):
        return K.sd_conv(a["x"], a["w"], pad=a["pad"],
                         out_start=a["out_start"], out_size=a["out_size"],
                         plan=plan)

    def k2_ref(a):
        return K.sd_conv_ref(a["x"], a["w"], a["pad"], a["out_start"],
                             a["out_size"])

    def k3_call(a, plan=None):
        return K.sd_filter_grad(a["x"], a["dy1"], a["kt"], pad=a["pad"],
                                plan=plan)

    def k3_ref(a):
        return K.sd_filter_grad_ref(a["x"], a["dy1"], a["kt"], a["pad"])

    err = {"sd_conv": 0.0, "sd_filter_grad": 0.0}
    failures = []

    def gate(name, label, out, ref):
        torch.cuda.synchronize()
        d, tol = _gate_err(out, ref, F32_GATE, True)
        err[name] = max(err[name], d)
        ok = d <= tol and tuple(out.shape) == tuple(ref.shape)
        print(f"  {label} {name} {tuple(out.shape)} max|d| {d:.3e} tol "
              f"{tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{label} {name}")

    print(f"check: K2 vs sd_conv_ref and K3 vs sd_filter_grad_ref on each "
          f"layer's backward (dx, dw), f32, batch 4, gate "
          f"{F32_GATE}*max(1,max|ref|) {tag}")
    for net, fn in BENCHMARKS.items():
        for l in fn().deconv_layers():
            _, _, _, a2, a3 = case(l, 4, same_deconv_pads(l.k, l.s))
            gate("sd_conv", f"{net}/{l.name}", k2_call(a2), k2_ref(a2))
            gate("sd_filter_grad", f"{net}/{l.name}", k3_call(a3),
                 k3_ref(a3))
    # op > pad_hi, per-dim op, asymmetric pads, then forced tiles (K2:
    # GEMM tiles ragged in M, N and K, split-K with an uneven last split,
    # a contraction of 5 * 4 phase channels (4-byte copies) and Co 70;
    # K3: Cin 40 and 70 in ragged 64-channel row tiles, 20 cotangent
    # channels (4-byte copies), many splits and one).
    odd = [(LayerSpec("deconv", 3, 2, k=4, s=2, in_hw=(5, 6)), 2, 0, 1,
            None, None),
           (LayerSpec("deconv", 3, 2, k=4, s=2, in_hw=(5, 6)), 2, 1, (1, 0),
            None, None),
           (LayerSpec("deconv", 3, 2, k=5, s=2, in_hw=(6, 7)), 1,
            ((1, 3), (0, 2)), 0, None, None),
           (LayerSpec("deconv", 40, 24, k=5, s=2, in_hw=(13, 11)), 3, 2, 1,
            GemmPlan(16, 3), GemmPlan(32, 9)),
           (LayerSpec("deconv", 70, 5, k=5, s=2, in_hw=(9, 10)), 2, 1, 1,
            GemmPlan(32, 7), GemmPlan(16, 1))]
    for l, batch, padv, op, t2, t3 in odd:
        _, _, _, a2, a3 = case(l, batch, padv, op)
        label = f"odd {l.in_hw} cin{l.cin} k{l.k} p{padv} op{op}"
        gate("sd_conv", label, k2_call(a2, t2), k2_ref(a2))
        gate("sd_filter_grad", label, k3_call(a3, t3), k3_ref(a3))
        if t3 is not None:
            same = torch.equal(k3_call(a3, t3), k3_call(a3, t3))
            print(f"  {label} sd_filter_grad run twice: "
                  f"{'bit-identical' if same else 'DIFFERS'}")
            if not same:
                failures.append(f"{label} K3 not deterministic")
        if t2 is not None:
            same = torch.equal(k2_call(a2, t2), k2_call(a2, t2))
            print(f"  {label} sd_conv run twice with {t2}: "
                  f"{'bit-identical' if same else 'DIFFERS'}")
            if not same:
                failures.append(f"{label} K2 not deterministic")
    if failures:
        raise SystemExit(f"chip_smoke: backward kernels disagree with their "
                         f"plain versions on {failures}")

    print(f"time: DCGAN backward at batch {BUCKET}, f32, CUDA events: median "
          f"[min, max] of 7 rounds of 20 warm launches, kernel / plain / "
          f"cuDNN convolution_backward (one gradient requested) in turns; "
          f"for K2 and K3 also device ms of one call (ahead: CUDA events "
          f"over 20 calls queued behind torch.cuda._sleep; profiler: its "
          f"kernels summed, median of 3) and the tc bound (its GEMM's 3xTF32 "
          f"work at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s) {tag}")
    per_layer, precision = [], {}
    for l in BENCHMARKS["dcgan"]().deconv_layers():
        p, x, dy, a2, a3 = case(l, BUCKET, same_deconv_pads(l.k, l.s))
        gate("sd_conv", f"dcgan/{l.name} b{BUCKET}", k2_call(a2), k2_ref(a2))
        gate("sd_filter_grad", f"dcgan/{l.name} b{BUCKET}", k3_call(a3),
             k3_ref(a3))
        geom = ConvGeom(h=a2["x"].shape[1], w=a2["x"].shape[2],
                        cin=a2["x"].shape[3], co=l.cin, kth=p.kt[0],
                        ktw=p.kt[1], out_h=l.in_hw[0],
                        out_w=l.in_hw[1]).as_gemm(BUCKET)
        plan = gemm_plan(geom)
        fgeom = FilterGradGeom(b=BUCKET, h=l.in_hw[0], w=l.in_hw[1],
                               cin=l.cin, nco=a3["dy1"].shape[-1],
                               kth=p.kt[0], ktw=p.kt[1],
                               o1h=a3["dy1"].shape[1], o1w=a3["dy1"].shape[2])
        fplan = filter_grad_plan(fgeom)
        if not per_layer:
            # Split-K sums its partials in a fixed order: two runs agree.
            for name, call, a_, pl in (("sd_conv", k2_call, a2, plan),
                                       ("sd_filter_grad", k3_call, a3,
                                        fplan)):
                split = pl if pl.splits > 1 else GemmPlan(64, 3)
                same = torch.equal(call(a_, split), call(a_, split))
                print(f"  dcgan/{l.name} {name} run twice with {split}: "
                      f"{'bit-identical' if same else 'DIFFERS'}")
                if not same:
                    failures.append(f"dcgan/{l.name} {name} not "
                                    f"deterministic")
            (plo_h, phi_h), (plo_w, phi_w) = a2["pad"]
            (oh, ow), (sh, sw) = a2["out_size"], a2["out_start"]
            ref64 = conv_valid(F.pad(a2["x"].double(), (
                0, 0, plo_w, phi_w, plo_h, phi_h)), a2["w"].double())[
                    :, sh:sh + oh, sw:sw + ow]
            scale = max(1.0, ref64.abs().max().item())
            prec = {n: (y_.double() - ref64).abs().max().item() / scale
                    for n, y_ in (("k2", k2_call(a2)), ("plain", k2_ref(a2)))}
            print(f"  precision: dcgan/{l.name} dx at batch {BUCKET} against "
                  f"the f64 product: max|d| / max(1, max|ref|) K2 "
                  f"{prec['k2']:.3e}, plain (cuDNN f32, TF32 off) "
                  f"{prec['plain']:.3e} {tag}")
            precision["k2"] = prec
            (plo_h, phi_h), (plo_w, phi_w) = a3["pad"]
            ref64 = conv_valid_filter_grad(
                F.pad(a3["x"].double(), (0, 0, plo_w, phi_w, plo_h, phi_h)),
                a3["dy1"].double())
            scale = max(1.0, ref64.abs().max().item())
            prec = {n: (y_.double() - ref64).abs().max().item() / scale
                    for n, y_ in (("k3", k3_call(a3)), ("plain", k3_ref(a3)))}
            print(f"  precision: dcgan/{l.name} dw at batch {BUCKET} against "
                  f"the f64 product: max|d| / max(1, max|ref|) K3 "
                  f"{prec['k3']:.3e}, plain (cuDNN f32, TF32 off) "
                  f"{prec['plain']:.3e} {tag}")
            precision["k3"] = prec
        # Library yardstick: cuDNN's backward of the same-size
        # transposed conv (NCHW, crop 2 + output_padding 1 -> in*s),
        # asked for dx only or dw only.
        g_cf = dy.permute(0, 3, 1, 2).contiguous()
        x_cf = x.permute(0, 3, 1, 2).contiguous()
        w_cf = torch.randn(l.cin, l.cout, l.k, l.k, device=dev)
        geo = ([l.s, l.s], [2, 2], [1, 1], True, [1, 1], 1)

        def lib(mask, g_cf=g_cf, x_cf=x_cf, w_cf=w_cf, geo=geo):
            return torch.ops.aten.convolution_backward(
                g_cf, x_cf, w_cf, None, *geo, mask)

        assert lib([True, False, False])[0].shape == x_cf.shape
        t = _time_ms({
            "k2": lambda a2=a2: k2_call(a2),
            "k2_plain": lambda a2=a2: k2_ref(a2),
            "lib_dx": lambda: lib([True, False, False]),
            "k3": lambda a3=a3: k3_call(a3),
            "k3_plain": lambda a3=a3: k3_ref(a3),
            "lib_dw": lambda: lib([False, True, False])})
        dv = {"k2": _device_ms(lambda a2=a2: k2_call(a2)),
              "k2_plain": _device_ms(lambda a2=a2: k2_ref(a2)),
              "lib_dx": _device_ms(lambda: lib([True, False, False])),
              "k3": _device_ms(lambda a3=a3: k3_call(a3)),
              "k3_plain": _device_ms(lambda a3=a3: k3_ref(a3)),
              "lib_dw": _device_ms(lambda: lib([False, True, False]))}
        useful = 2.0 * BUCKET * l.macs()
        o1h, o1w = a2["x"].shape[1:3]
        kt2 = p.kt[0] * p.kt[1]
        nco = a2["x"].shape[-1]
        kernel_ops = {"sd_conv": 2.0 * geom.m * geom.n * geom.k,
                      "sd_filter_grad": 2.0 * BUCKET * o1h * o1w * kt2
                      * nco * l.cin}
        moved = {"sd_conv": [a2["x"], a2["w"], x],
                 "sd_filter_grad": [x, a3["dy1"], a2["w"]]}
        # K3 stages A as 32 positions x (64 + 8) channels and no row table.
        for label, gg, pl, smem in (
                ("K2", geom, plan, gemm_smem_bytes(geom, plan)),
                ("K3", fgeom.as_gemm(), fplan,
                 3 * 32 * (64 + 8 + fplan.bn + 8) * 4)):
            grid = gemm_grid(gg, pl)
            print(f"  dcgan/{l.name} {label} launch: {pl}, GEMM M {gg.m} x "
                  f"N {gg.n} x K {gg.k}, grid {grid[0]} x {grid[1]} x "
                  f"{grid[2]} blocks of 128 threads"
                  f"{', then the ordered split sum' if grid[2] > 1 else ''}"
                  f", {smem} B dynamic shared memory per block")
        for name, tk, tp, tl in (("sd_conv", "k2", "k2_plain", "lib_dx"),
                                 ("sd_filter_grad", "k3", "k3_plain",
                                  "lib_dw")):
            nbytes = sum(u.numel() * u.element_size() for u in moved[name])
            t_ops = useful / PEAK_F32_FLOPS * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            ms, lo, hi = t[tk]
            rec = {"kernel": name, "layer": f"dcgan/{l.name}", "ms": ms,
                   "ms_min": lo, "ms_max": hi, "plain_ms": t[tp][0],
                   "library_ms": t[tl][0],
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "flops": useful, "kernel_flops": kernel_ops[name],
                   "bytes": nbytes}
            # The record in device time; events kept beside it.
            rec.update(
                ms=dv[tk][1], profiler_ms=dv[tk][0], events_ms=ms,
                events_ms_min=lo, events_ms_max=hi,
                plain_ms=dv[tp][1], plain_events_ms=t[tp][0],
                library_ms=dv[tl][1], library_profiler_ms=dv[tl][0],
                library_events_ms=t[tl][0],
                plan=str(plan if name == "sd_conv" else fplan),
                tc_bound_ms=max(3 * kernel_ops[name] / PEAK_TF32_FLOPS
                                * 1e3, t_bytes))
            extra = (f"; device {rec['ms']:.4f} ms (profiler "
                     f"{_ms_txt(dv[tk][0])}), plain "
                     f"{rec['plain_ms']:.4f}, cuDNN "
                     f"{rec['library_ms']:.4f} (profiler "
                     f"{_ms_txt(dv[tl][0])}); tc bound "
                     f"{rec['tc_bound_ms']:.4f} ms")
            per_layer.append(rec)
            print(f"  dcgan/{l.name} {'K2 dx' if name == 'sd_conv' else 'K3 dw'}"
                  f": {ms:.4f} ms [{lo:.4f}, {hi:.4f}], plain "
                  f"{t[tp][0]:.4f} ms, cuDNN {t[tl][0]:.4f} "
                  f"ms (events){extra}, bound {rec['bound_ms']:.4f} ms "
                  f"({rec['bound_by']}, "
                  f"useful {useful / 1e9:.3f} GFLOP; the kernel does "
                  f"{kernel_ops[name] / 1e9:.3f}), "
                  f"{useful / rec['ms'] / 1e9:.1f} useful TFLOP/s; sm clock, "
                  f"power, temperature {_clocks()} {tag}")
    if failures:
        raise SystemExit(f"chip_smoke: backward kernels disagree at batch "
                         f"{BUCKET} on {failures}")
    for name, label, limit in (("sd_conv", "K2 dx", K2_D1_MS_LIMIT),
                               ("sd_filter_grad", "K3 dw", K3_D1_MS_LIMIT)):
        d1 = next(r for r in per_layer if r["kernel"] == name)
        gate_ms = (d1["profiler_ms"] if d1["profiler_ms"] is not None
                   else d1["ms"])
        how = "profiler" if d1["profiler_ms"] is not None else "ahead events"
        ok = gate_ms <= limit
        print(f"gate: {label} on dcgan/d1 at batch {BUCKET}: {gate_ms:.4f} "
              f"ms of device time ({how}), limit {limit} ms "
              f"{'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"chip_smoke: {label} on DCGAN d1 is over its "
                             f"time limit")

    # ---- full-width DCGAN GAN steps through train_gen --------------------
    gen, disc = train_gen.make_gan(False, "sd_kernel", dev)
    ref_gen = GenerativeModel(gen.spec, "sd_kernel", engine_backend="torch",
                              device=dev)
    assert gen.engine.backend == "fused"
    gp = train_gen.trainable(gen.init(torch.Generator().manual_seed(SEED)))
    dp = train_gen.trainable(disc.init(torch.Generator().manual_seed(SEED + 1)))
    g_opt, d_opt = adamw_init(gp), adamw_init(dp)
    pipe = GANLatentPipeline(z_dim=gen.spec.layers[0].cin,
                             global_batch=BUCKET, seed=SEED)
    z0 = pipe.batch(0).to(dev)
    # The gate holds the generator's grads J_G^T c, with c the
    # discriminator's cotangent on the samples fixed from the torch
    # backend in float64 (train_gen.grad_check).  The full step's grads
    # also cross the discriminator's LeakyReLU kinks, where a
    # pre-activation within f32 rounding of 0 may take the other slope
    # than in f64 and move every generator grad with no fault anywhere
    # (tests/test_torch_train.py::test_full_step_grads_cross_a_kink).
    # They are printed beside the gate, with native F.conv_transpose2d's
    # full step and the discriminator's sign flips as the witness.
    native = GenerativeModel(gen.spec, "native", device=dev)
    errs = {"fused": train_gen.grad_check(gen, ref_gen, disc, gp, dp, z0),
            "torch": train_gen.grad_check(ref_gen, ref_gen, disc, gp, dp,
                                          z0)}
    g64 = train_gen.generator_grads(
        ref_gen, disc, train_gen.trainable(train_gen.double(gp)),
        train_gen.double(dp), z0.double())[1]
    for name, model in (("fused", gen), ("torch", ref_gen),
                        ("native", native)):
        errs[f"{name}, full step"] = train_gen.rel_errs(
            train_gen.generator_grads(model, disc, gp, dp, z0)[1], g64)
    for leaf in errs["fused"]:
        print(f"  grad {leaf}: max|d|/max|ref| "
              + ", ".join(f"{k} {v[leaf]:.2e}" for k, v in errs.items()))
    worst = {k: max(v.values()) for k, v in errs.items()}
    with torch.no_grad():
        kinks = train_gen.kink_flips(
            disc, dp, native.apply(gp, z0),
            native.apply(train_gen.double(gp), z0.double()))
    ok = worst["fused"] <= F32_GATE
    print(f"train: first generator step's grads J_G^T c, f32 vs the torch "
          f"backend in f64 on the card: worst leaf max|d|/max|ref| fused "
          f"(K1/K2/K3) {worst['fused']:.3e} (gate {F32_GATE}), torch "
          f"backend {worst['torch']:.3e}; the full step against its f64 "
          f"twin: fused {worst['fused, full step']:.3e}, torch "
          f"{worst['torch, full step']:.3e}, native F.conv_transpose2d "
          f"{worst['native, full step']:.3e}; discriminator pre-activations "
          f"whose sign differs between native's f32 and f64 samples, per "
          f"conv (count, max|a64| among them, max|a32 - a64|): {kinks} "
          f"{'ok' if ok else 'FAIL'} {tag}")
    worst = worst["fused"]
    if not ok:
        raise SystemExit("chip_smoke: training grads through the kernels "
                         "disagree with the torch backend")

    names = ("K1", "K2", "K3")

    def counts():
        return (K.SD_FUSED_LAUNCHES, K.SD_CONV_LAUNCHES,
                K.SD_FILTER_GRAD_LAUNCHES)

    def zero():
        K.SD_FUSED_LAUNCHES = K.SD_CONV_LAUNCHES = \
            K.SD_FILTER_GRAD_LAUNCHES = 0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero()
    step_ms, d_hist, g_hist = [], [], []
    for step in range(GAN_STEPS):
        z = pipe.batch(step).to(dev)
        real = pipe.images(step, disc.img_hw).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c0 = counts()
        dl = train_gen.d_step(gen, disc, gp, dp, d_opt, z, real)
        c1 = counts()
        gl = train_gen.g_step(gen, disc, gp, dp, g_opt, z)
        c2 = counts()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        d_hist.append(dl.item())
        g_hist.append(gl.item())
        per_d = tuple(b - a for a, b in zip(c0, c1))
        per_g = tuple(b - a for a, b in zip(c1, c2))
        print(f"  GAN step {step}: d_loss {d_hist[-1]:.4f} g_loss "
              f"{g_hist[-1]:.4f}, {step_ms[-1]:.3f} ms host clock; launches "
              f"D step {dict(zip(names, per_d))}, G step "
              f"{dict(zip(names, per_g))}")
        if per_d != (3, 0, 0) or per_g != (3, 3, 3):
            raise SystemExit("chip_smoke: a GAN step did not run K1 3 (D), "
                             "K1/K2/K3 3/3/3 (G)")
    launches = dict(zip(("sd_fused", "sd_conv", "sd_filter_grad"), counts()))
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    if not all(map(math.isfinite, d_hist + g_hist)):
        raise SystemExit("chip_smoke: a GAN loss is not finite")
    with torch.no_grad():
        zf = pipe.batch(GAN_STEPS).to(dev)
        out, ref = gen.apply(gp, zf), ref_gen.apply(gp, zf)
    d, tol = _gate_err(out, ref, F32_GATE, True)
    ok = (d <= tol and bool(torch.isfinite(out).all())
          and tuple(out.shape) == (BUCKET, 64, 64, 3))
    print(f"  trained generator out {tuple(out.shape)} finite, vs torch "
          f"backend max|d| {d:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: the trained generator's output is "
                         "wrong")
    med = sorted(step_ms)[len(step_ms) // 2]
    z = pipe.batch(0).to(dev)
    real = pipe.images(0, disc.img_hw).to(dev)
    breakdown = _device_breakdown(lambda: (
        train_gen.d_step(gen, disc, gp, dp, d_opt, z, real),
        train_gen.g_step(gen, disc, gp, dp, g_opt, z)))
    print(f"train: {GAN_STEPS} full-width DCGAN GAN steps (batch {BUCKET}, "
          f"D {disc.channels}, f32, AdamW): median {med:.3f} ms per step "
          f"[{min(step_ms):.3f}, {max(step_ms):.3f}] host clock, "
          f"synchronised; peak memory {peak_mib:.1f} MiB; launches in the "
          f"run {launches} {tag}")
    if breakdown is None:
        print("  device time per kernel: not measured (the profiler "
              "reported no device time)")
    else:
        busy, wall, top = breakdown
        print(f"  profiler, one GAN step: device busy {busy:.3f} ms of "
              f"{wall:.3f} ms wall {tag}")
        for name, ms_k, calls in top:
            print(f"    {ms_k:.4f} ms in {calls} call(s): {name[:90]}")
    kernels = []
    for name, src, line in (("sd_conv", "sd_conv.cu", 186),
                            ("sd_filter_grad", "sd_filter_grad.cu", 524)):
        recs = [r for r in per_layer if r["kernel"] == name]
        tot = {k: sum(r[k] for r in recs)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "flops", "bytes")}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/sd_conv.py:{line}",
            "launches": launches[name], "max_abs_err": err[name],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": ("operations" if tot["flops"] / PEAK_F32_FLOPS
                         >= tot["bytes"] / PEAK_BYTES else "bytes"),
            "library_ms": tot["library_ms"]})
        kernels[-1].update({k: sum(r[k] for r in recs)
                            for k in ("events_ms", "tc_bound_ms")})
    return {"kernels": kernels, "per_layer": per_layer,
            "precision_d1": precision,
            "k1_launches": launches["sd_fused"],
            "train": {"step_ms": step_ms, "median_step_ms": med,
                      "d_loss": d_hist, "g_loss": g_hist,
                      "peak_mib": peak_mib, "grad_rel_err": worst,
                      "kink_flips": kinks,
                      "device": breakdown}}


def _wino_phase(dev, tag, randn) -> dict:
    """Phase 6: K4 against its plain version and against K1 on every
    paper layer and the odd geometries, f32 and bf16; K4, plain, K1 and
    cuDNN timed per DCGAN layer at batch 16; then full-width DCGAN served
    through ``GenServer(backend="winograd")``.  Returns K4's record, the
    per-layer times and the serving report."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    import repro_torch.kernels.sd_conv as K
    from repro_torch import sd
    from repro_torch.core.accounting import BENCHMARKS
    from repro_torch.core.deconv import same_deconv_pads
    from repro_torch.kernels import ops
    from repro_torch.core.deconv import conv_valid
    from repro_torch.kernels import winograd as W
    from repro_torch.kernels.autotune import (WinoPlan, wino_grid,
                                              wino_smem_bytes)
    from repro_torch.launch.serve_gen import GenServer, serve_async
    from repro_torch.models.generative import GenerativeModel

    def plans(wshape, s, pad, act, op=0, tile=None, dtype=torch.float32,
              scale_on=True):
        w = randn(*wshape, scale=1.0 / (wshape[0] * wshape[1]
                                        * wshape[2]) ** 0.5)
        scale = randn(wshape[-1], scale=0.1) + 1.0 if scale_on else None
        bias = randn(wshape[-1], scale=0.1)
        args = (w.to(dtype), None if scale is None else scale.to(dtype),
                bias)
        pw = sd.plan(w.shape, s, pad, backend="winograd", act=act,
                     output_padding=op, tile=tile).bind(*args)
        pf = sd.plan(w.shape, s, pad, backend="fused", act=act,
                     output_padding=op).bind(*args)
        return pw, pf

    def geo(p, x):
        return dict(bias=p.bias, act=p.act,
                    pad=((p.pi[0],) * 2, (p.pi[1],) * 2),
                    crop=(p.pk[0] + p.padding[0][0],
                          p.pk[1] + p.padding[1][0]),
                    out_space=p.out_shape(x.shape[1:3]))

    def k4(x, p):
        return ops.sd_deconv_presplit_wino(
            x, p.ws, p.kernel, p.stride, p.padding,
            output_padding=p.output_padding, bias=p.bias, act=p.act,
            plan=p.tile)

    err = {"plain": 0.0, "k1": 0.0}
    failures = []

    def check(label, x, pw, pf, bf16=False):
        out = k4(x, pw)
        ref = W.sd_wino_ref(x, pw.ws, pw.kt, pw.stride, **geo(pw, x))
        torch.cuda.synchronize()
        d, tol = _gate_err(out, ref, BF16_GATE if bf16 else F32_GATE,
                           not bf16)
        ok = (d <= tol and tuple(out.shape) == tuple(ref.shape)
              and out.dtype == x.dtype)
        line = f"  {label} {tuple(out.shape)} max|d| {d:.3e} tol {tol:.3e}"
        if not bf16:
            err["plain"] = max(err["plain"], d)
            y1 = sd.execute(pf, x)
            torch.cuda.synchronize()
            d1, tol1 = _gate_err(out, y1, W.tolerance(pw.kt), True)
            err["k1"] = max(err["k1"], d1 / max(1.0, y1.abs().max().item()))
            ok = ok and d1 <= tol1
            line += f"; vs K1 max|d| {d1:.3e} tol {tol1:.3e}"
        print(f"{line} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)

    print(f"check: K4 vs sd_wino_ref (gate {F32_GATE}*max(1,max|ref|)) and "
          f"vs K1 on the same split filters (gate tolerance(K_T)*max(1,"
          f"max|y_K1|)), f32, batch 4 {tag}")
    for net, fn in BENCHMARKS.items():
        layers = fn().layers
        for i, l in enumerate(layers):
            if l.kind != "deconv":
                continue
            act = "linear" if i == len(layers) - 1 else "relu"
            pw, pf = plans((l.k, l.k, l.cin, l.cout), l.s,
                           same_deconv_pads(l.k, l.s), act)
            check(f"{net}/{l.name} F(2,{pw.kt[0]})",
                  randn(4, *l.in_hw, l.cin), pw, pf)
    # The reference's odd geometries (tests/test_winograd.py), op >
    # pad_hi, asymmetric pads, a mixed F(2,3) x F(1,1) kernel, and forced
    # ragged plans (bands past the tiles, samples past the batch, a
    # residual crop row, Cin 40 and 70 in 16-channel chunks, 4-byte
    # copies, F(2,5) on three points per warp).
    odd = [((2, 7, 6, 4), (5, 5, 4, 3), 3, 2, 0, None),
           ((2, 7, 6, 4), (6, 6, 4, 3), 3, "same", 0, None),
           ((2, 7, 6, 4), (7, 7, 4, 3), 4, 3, 0, None),
           ((2, 7, 6, 4), (5, 5, 4, 3), 4, "same", 0, None),
           ((2, 7, 6, 4), (2, 2, 4, 3), 2, 0, 0, None),
           ((2, 5, 6, 3), (4, 4, 3, 2), 2, 0, 1, None),
           ((1, 6, 7, 3), (5, 5, 3, 2), 2, ((1, 3), (0, 2)), 0, None),
           ((1, 5, 6, 3), (5, 2, 3, 2), 2, ((2, 2), (0, 1)), 0, None),
           ((3, 13, 11, 40), (5, 5, 40, 24), 2, 2, 1,
            WinoPlan(nth=3, ntw=2, nb=2, tc=16)),
           ((2, 9, 10, 70), (3, 3, 70, 5), 2, 1, 1,
            WinoPlan(nth=2, ntw=3, nb=2, tc=32)),
           ((2, 9, 7, 12), (5, 5, 12, 6), 1, 2, 0,
            WinoPlan(nth=3, ntw=1, nb=2, tc=16)),
           ((3, 8, 8, 7), (5, 5, 7, 5), 2, "same", 0, None)]
    for sx, sw_, st, padv, op, tile in odd:
        pad = same_deconv_pads(sw_[0], st) if padv == "same" else padv
        pw, pf = plans(sw_, st, pad, "tanh", op, tile, scale_on=False)
        check(f"odd {sx} k{sw_[:2]} s{st} p{padv} op{op} tile {tile}",
              randn(*sx), pw, pf)
    dcgan = [(i, l) for i, l in enumerate(BENCHMARKS["dcgan"]().layers)
             if l.kind == "deconv"]
    print(f"check: K4 vs sd_wino_ref, bf16 in/out (bf16 transformed "
          f"filters), f32 accumulation, batch 4, gate "
          f"{BF16_GATE}*max|ref| {tag}")
    for i, l in dcgan:
        pw, pf = plans((l.k, l.k, l.cin, l.cout), l.s,
                       same_deconv_pads(l.k, l.s),
                       "linear" if i == 3 else "relu", dtype=torch.bfloat16)
        check(f"dcgan/{l.name} bf16", randn(4, *l.in_hw, l.cin).bfloat16(),
              pw, pf, bf16=True)
    if failures:
        raise SystemExit(f"chip_smoke: K4 disagrees on {failures}")

    print(f"time: DCGAN layers at batch {BUCKET}, f32, K4 / K1 / "
          f"conv_transpose2d: device ms of one call (ahead: CUDA events over "
          f"20 calls queued behind torch.cuda._sleep; profiler: its kernels "
          f"summed, median of 3) and, with the plain version, CUDA events "
          f"(median [min, max] of 7 rounds of 20 warm launches in turns); "
          f"bound: K4's own work "
          f"(transform-domain products and transforms) at the "
          f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s CUDA cores, tc bound: its "
          f"products' 3xTF32 work at the {PEAK_TF32_FLOPS / 1e12:.0f} "
          f"TFLOP/s TF32 tensor cores beside its transforms on the CUDA "
          f"cores {tag}")
    per_layer, precision = [], {}
    for i, l in dcgan:
        pw, pf = plans((l.k, l.k, l.cin, l.cout), l.s,
                       same_deconv_pads(l.k, l.s),
                       "linear" if i == 3 else "relu")
        x = randn(BUCKET, *l.in_hw, l.cin)
        g = geo(pw, x)
        x_cf = x.permute(0, 3, 1, 2).contiguous()
        w_t = torch.randn(l.cin, l.cout, l.k, l.k, device=dev)
        lib = lambda: F.conv_transpose2d(                 # noqa: E731
            x_cf, w_t, pw.bias, stride=l.s, padding=2, output_padding=1)
        assert lib().shape[2:] == k4(x, pw).shape[1:3]
        fns = {"k4": lambda: k4(x, pw),
               "plain": lambda: W.sd_wino_ref(x, pw.ws, pw.kt, pw.stride,
                                              **g),
               "k1": lambda: sd.execute(pf, x),
               "lib": lib}
        t = _time_ms(fns)
        # The plain version copies the Toom-Cook matrices from pageable
        # host memory per call: it cannot run ahead of the host, so it is
        # timed by events alone.
        dv = {n: _device_ms(f) for n, f in fns.items() if n != "plain"}
        y = k4(x, pw)
        ref = W.sd_wino_ref(x, pw.ws, pw.kt, pw.stride, **g)
        torch.cuda.synchronize()
        d, tol = _gate_err(y, ref, F32_GATE, True)
        err["plain"] = max(err["plain"], d)
        print(f"  dcgan/{l.name} batch {BUCKET} vs sd_wino_ref max|d| "
              f"{d:.3e} tol {tol:.3e} {'ok' if d <= tol else 'FAIL'}")
        if not (d <= tol and y.shape == ref.shape):
            raise SystemExit(f"chip_smoke: K4 disagrees with sd_wino_ref "
                             f"on dcgan/{l.name} at batch {BUCKET}")
        if not per_layer:
            # K4, K1 (3xTF32) and the plain direct conv (cuDNN f32, TF32
            # off) against the f64 product of the same split filters.
            (plo_h, phi_h), (plo_w, phi_w) = g["pad"]
            ref64 = K.shuffle_epilogue(
                conv_valid(F.pad(x.double(), (0, 0, plo_w, phi_w, plo_h,
                                              phi_h)), pf.ws.double()),
                pf.stride, pf.bias.double(), pf.act, g["crop"],
                g["out_space"], torch.float64)
            scale = max(1.0, ref64.abs().max().item())
            fk = dict(bias=pf.bias, act=pf.act, **{
                k_: g[k_] for k_ in ("pad", "crop", "out_space")})
            prec = {n: (y_.double() - ref64).abs().max().item() / scale
                    for n, y_ in (("k4", y), ("k1", sd.execute(pf, x)),
                                  ("plain", K.sd_fused_ref(
                                      x, pf.ws, pf.stride, **fk)))}
            print(f"  precision: dcgan/{l.name} at batch {BUCKET} against "
                  f"the f64 direct product: max|d| / max(1, max|ref|) K4 "
                  f"{prec['k4']:.3e}, K1 {prec['k1']:.3e}, plain direct "
                  f"conv (cuDNN f32, TF32 off) {prec['plain']:.3e} {tag}")
            precision = prec
        lg = W.wino_launch(tuple(x.shape), tuple(pw.ws.shape), pw.kt,
                           pw.stride, g["pad"], g["crop"], g["out_space"])
        flops = 2.0 * BUCKET * l.macs()
        grid = wino_grid(lg.geom, lg.plan)
        tiles = grid[1] * grid[2] * lg.plan.nb * lg.plan.nth * lg.plan.ntw
        # What K4's algorithm must do for this output: F(m, K_T) tiles of
        # m x m conv rows; per tile, alpha_h*alpha_w products per input
        # and phase channel, the input transform B^T d B per input channel
        # and the output transform A^T M A per phase channel (their
        # nonzero matrix entries).
        (at_h, _, bt_h), (at_w, _, bt_w) = (
            W.winograd_matrices(W.output_tile(t), t) for t in pw.kt)
        ah, aw = bt_h.shape[0], bt_w.shape[0]
        n_tiles = (BUCKET * -(-y.shape[1] // (l.s * lg.geom.mh))
                   * -(-y.shape[2] // (l.s * lg.geom.mw)))
        nc = pw.ws.shape[-1]
        wino_macs = n_tiles * ah * aw * l.cin * nc
        transform_macs = n_tiles * (
            l.cin * (np.count_nonzero(bt_h) * aw
                     + ah * np.count_nonzero(bt_w))
            + nc * (np.count_nonzero(at_h) * aw
                    + lg.geom.mh * np.count_nonzero(at_w)))
        nbytes = sum(a.numel() * a.element_size()
                     for a in (x, pw.ws, pw.bias, y))
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = 2.0 * (wino_macs + transform_macs) / PEAK_F32_FLOPS * 1e3
        t_useful = flops / PEAK_F32_FLOPS * 1e3
        t_tc = max(3 * 2.0 * wino_macs / PEAK_TF32_FLOPS * 1e3,
                   2.0 * transform_macs / PEAK_F32_FLOPS * 1e3, t_bytes)
        ev, lo, hi = t["k4"]
        ms = dv["k4"][1]
        rec = {"layer": f"dcgan/{l.name}", "ms": ms,
               "profiler_ms": dv["k4"][0], "events_ms": ev,
               "events_ms_min": lo, "events_ms_max": hi,
               "plain_ms": t["plain"][0],
               "k1_ms": dv["k1"][1], "k1_events_ms": t["k1"][0],
               "library_ms": dv["lib"][1],
               "library_profiler_ms": dv["lib"][0],
               "library_events_ms": t["lib"][0],
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "tc_bound_ms": t_tc,
               "useful_bound_ms": max(t_useful, t_bytes),
               "flops": flops, "wino_macs": wino_macs,
               "transform_macs": int(transform_macs),
               "max_abs_err": d, "launched_tiles": tiles, "bytes": nbytes,
               "plan": str(lg.plan), "launches_per_batch": 1}
        per_layer.append(rec)
        print(f"  dcgan/{l.name} K4 launch: {lg.plan}, grid {grid[0]} x "
              f"{grid[1]} x {grid[2]} blocks of 512 threads, {tiles} tile "
              f"slots, {wino_smem_bytes(lg.geom, lg.plan)} B dynamic shared "
              f"memory per block")
        print(f"  dcgan/{l.name} {tuple(x.shape)}->{tuple(y.shape)}: K4 "
              f"device {ms:.4f} ms (profiler {_ms_txt(dv['k4'][0])}), events "
              f"{ev:.4f} [{lo:.4f}, {hi:.4f}]; plain events "
              f"{rec['plain_ms']:.4f}; K1 device {rec['k1_ms']:.4f} "
              f"(profiler {_ms_txt(dv['k1'][0])}); conv_transpose2d device "
              f"{rec['library_ms']:.4f} (profiler {_ms_txt(dv['lib'][0])}); "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; K4's "
              f"{wino_macs / 1e9:.3f} G transform-domain products + "
              f"{transform_macs / 1e9:.3f} G transform MACs, "
              f"{2 * wino_macs / ms / 1e9:.1f} TFLOP/s of products), tc "
              f"bound {t_tc:.4f} ms, useful-work bound "
              f"{rec['useful_bound_ms']:.4f} ms ({flops / 2e9:.3f} G direct "
              f"MACs); sm clock, power, temperature {_clocks()} {tag}")
    d1 = per_layer[0]
    gate_ms = d1["profiler_ms"] if d1["profiler_ms"] is not None else d1["ms"]
    how = "profiler" if d1["profiler_ms"] is not None else "ahead events"
    ok = gate_ms <= K4_D1_MS_LIMIT
    print(f"gate: K4 f32 on dcgan/d1 at batch {BUCKET}: {gate_ms:.4f} ms of "
          f"device time ({how}), limit {K4_D1_MS_LIMIT} ms "
          f"{'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit("chip_smoke: K4 on DCGAN d1 is over its time limit")

    # ---- serve full-width DCGAN on the winograd backend ----------------
    server = GenServer(nets=("dcgan",), device=dev, max_batch=BUCKET,
                       seed=SEED, backend="winograd")
    built_cells = server.warmup()
    reqs = server.random_requests("dcgan", SERVE_REQUESTS, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    W.SD_WINO_LAUNCHES = 0
    K.SD_FUSED_LAUNCHES = 0
    results, stats = serve_async(server, reqs)
    torch.cuda.synchronize()
    launches, k1_launches = W.SD_WINO_LAUNCHES, K.SD_FUSED_LAUNCHES
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    lat = stats["latency_ms"]
    print(f"serve winograd: {stats['served']} DCGAN requests (full width, "
          f"f32) in {stats['wall_s']:.4f} s host clock: "
          f"{stats['req_per_s']:.1f} req/s, p50 {lat['p50']} ms, p95 "
          f"{lat['p95']} ms, {stats['launches']} launches, "
          f"{stats['compiles']} cells ({built_cells} built in warmup), peak "
          f"memory {peak_mib:.1f} MiB {tag}")
    print(f"  K4 launches in the serving run: {launches} (3 deconv layers x "
          f"{stats['launches']} batches); K1 launches: {k1_launches}")
    if launches != 3 * stats["launches"] or launches == 0 or k1_launches:
        raise SystemExit("chip_smoke: the winograd server did not run K4 "
                         "(and only K4) once per deconv layer per batch")
    if stats["served"] != SERVE_REQUESTS or stats["shed"]:
        raise SystemExit(f"chip_smoke: served {stats['served']} of "
                         f"{SERVE_REQUESTS}, shed {stats['shed']}")
    model, params = server.model("dcgan")
    fused = GenerativeModel(model.spec, "sd_kernel", engine_backend="fused",
                            device=dev)
    z = torch.stack([r.latent for r in reqs])
    out = torch.stack([results[r.rid] for r in reqs])
    with torch.no_grad():
        ref = fused.apply(params, z)
        ref_t = GenerativeModel(model.spec, "sd_kernel",
                                engine_backend="torch",
                                device=dev).apply(params, z)
        # K4's plain version end to end: the same model on the CPU,
        # where every winograd layer runs sd_wino_ref.
        cpu_params = {k: {n: t.cpu() for n, t in v.items()}
                      for k, v in params.items()}
        ref_p = GenerativeModel(model.spec, "sd_kernel",
                                engine_backend="winograd",
                                device="cpu").apply(cpu_params, z.cpu())
    finite = bool(torch.isfinite(out).all())
    ok = finite and tuple(out.shape) == (SERVE_REQUESTS, 64, 64, 3)
    print(f"  outputs {tuple(out.shape)} finite={finite}; on the same "
          f"weights {tag}:")
    for label, r, rel, floor_one, gate in (
            ("winograd model on the CPU (sd_wino_ref)", ref_p.to(dev),
             F32_GATE, True, f"{F32_GATE}*max(1,max|ref|)"),
            ("torch backend on the card (direct conv)", ref_t,
             W.tolerance((3, 3)), False, "tolerance((3, 3))*max|ref|"),
            ("fused server's model (K1)", ref, W.tolerance((3, 3)), False,
             "tolerance((3, 3))*max|ref|")):
        d, tol = _gate_err(out, r, rel, floor_one)
        ok = ok and d <= tol
        print(f"    vs {label} max|d| {d:.3e} tol {tol:.3e} ({gate}) "
              f"{'ok' if d <= tol else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: winograd-served outputs are wrong")
    full = [r.latent for r in reqs[:BUCKET]]
    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.run_group("dcgan", full)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = sorted(host)[len(host) // 2]
    breakdown = _device_breakdown(lambda: server.run_group("dcgan", full))
    print(f"batch winograd: one DCGAN batch of {BUCKET} through run_group: "
          f"{host_ms:.3f} ms host clock (median of 10, synchronised) {tag}")
    if breakdown is None:
        print("  device time per kernel: not measured (the profiler "
              "reported no device time)")
    else:
        busy, wall, top = breakdown
        print(f"  profiler: device busy {busy:.3f} ms of {wall:.3f} ms wall "
              f"(idle share {1 - busy / wall:.3f}) {tag}")
        for name, ms_k, calls in top:
            print(f"    {ms_k:.4f} ms in {calls} call(s): {name[:90]}")

    tot = {k: sum(r[k] for r in per_layer)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                     "useful_bound_ms", "tc_bound_ms", "events_ms",
                     "wino_macs", "transform_macs", "bytes")}
    kernel = {
        "name": "sd_wino", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sd_wino.cu",
        "replaces": "src/repro/kernels/winograd.py:268",
        "launches": launches, "max_abs_err": err["plain"],
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": ("operations" if 2.0 * (tot["wino_macs"]
                                            + tot["transform_macs"])
                     / PEAK_F32_FLOPS >= tot["bytes"] / PEAK_BYTES
                     else "bytes"),
        "useful_bound_ms": tot["useful_bound_ms"],
        "tc_bound_ms": tot["tc_bound_ms"], "events_ms": tot["events_ms"],
        "library_ms": tot["library_ms"], "wino_macs": tot["wino_macs"],
        "transform_macs": tot["transform_macs"],
        "max_rel_err_vs_k1": err["k1"]}
    return {"kernel": kernel, "per_layer": per_layer,
            "precision_d1": precision,
            "serve": {k: stats[k] for k in ("served", "launches",
                                            "req_per_s", "wall_s",
                                            "latency_ms")},
            "peak_mib": peak_mib, "batch_host_ms": host_ms,
            "batch_device": breakdown}


def _total(vals):
    """Sum of per-layer readings, None when any is missing."""
    vals = list(vals)
    return None if any(v is None for v in vals) else sum(vals)


def _saturating_d1(dev, tag) -> dict:
    """K1 int8 with every code at +-127 on DCGAN d1 at batch 16 (K =
    3*3*256 = 2,304): interior sums reach 127^2 * 2,304 in magnitude.
    Unit scale, zero bias, linear act, on the default plan and a forced
    4-way split: held to an int64 numpy restatement rounded to f32 once
    (:func:`_np_chain_epilogue`), 0 elements different."""
    import numpy as np
    import torch
    import repro_torch.kernels.sd_conv as K
    from repro_torch import sd
    from repro_torch.kernels.autotune import GemmPlan
    g = torch.Generator().manual_seed(SEED)
    sample = torch.where(torch.rand(BUCKET, 1, 1, 1, generator=g) < 0.5,
                         127, -127)
    column = torch.where(torch.rand(512, generator=g) < 0.5, 127, -127)
    xq = sample.expand(BUCKET, 8, 8, 256).to(torch.int8).contiguous()
    ws = column.expand(3, 3, 256, 512).to(torch.int8).contiguous()
    p = sd.plan((5, 5, 256, 128), 2, 2, backend="fused", output_padding=1,
                dtype="int8", device=dev)
    geo = dict(pad=((p.pi[0],) * 2, (p.pi[1],) * 2),
               crop=(p.pk[0] + p.padding[0][0], p.pk[1] + p.padding[1][0]),
               out_space=p.out_shape((8, 8)))
    ones = np.ones((1, 512), np.float32)
    want = _np_chain_epilogue(xq.numpy(), ws.numpy(), 2, geo["pad"],
                              geo["crop"], geo["out_space"], ones,
                              np.zeros(128, np.float32), "linear", False)
    peak = 127 * 127 * 2304
    out_rec = {}
    for plan in (None, GemmPlan(64, 4)):
        out = K.sd_fused(xq.to(dev), ws.to(dev), 2,
                         scale=torch.ones(1, 512, device=dev), plan=plan,
                         **geo).cpu().numpy()
        n_diff = int((out != want).sum())
        top = float(np.abs(out).max())
        ok = n_diff == 0 and top == float(peak)
        print(f"check: K1 int8 saturating, every code +-127 on dcgan/d1 at "
              f"batch {BUCKET} (K 2304), plan {plan or 'default'}: {n_diff} "
              f"of {out.size} elements differ from the int64 restatement, "
              f"max|y| {top:.0f} (127^2 x 2304 = {peak}) "
              f"{'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit("chip_smoke: K1 int8 is not exact at the int32 "
                             "range of d1")
        out_rec[str(plan or "default")] = n_diff
    return {"elements_differ": out_rec, "max_abs": peak}


def _int8_phase(dev, tag, randn) -> dict:
    """Phase 7: K1's int8 branch against its plain version (exact sums)
    at two gates on the 22 paper layers and the odd geometries at batch
    4, every code at +-127 on DCGAN d1 (:func:`_saturating_d1`), and
    DCGAN's layers at batch 16 (phase 9 times them); then full-width
    DCGAN served through ``GenServer(dtype="int8")``.  Returns K1 int8's
    record and the serving report."""
    import torch
    import repro_torch.kernels.sd_conv as K
    from repro_torch import sd
    from repro_torch.core.accounting import BENCHMARKS
    from repro_torch.core.deconv import same_deconv_pads
    from repro_torch.core.quant import quantize_act
    from repro_torch.core.ssim import ssim
    from repro_torch.kernels import ops
    from repro_torch.kernels.autotune import GemmPlan
    from repro_torch.launch.serve_gen import GenServer, serve_async
    from repro_torch.models.generative import GenerativeModel

    def case(sx, wshape, s, pad, act, op=0, tile=None):
        """f32 input and weights, the int8 plan (BN scale folded, bias),
        the per-sample quantized input and the combined (B, NC) scale."""
        x = randn(*sx)
        w = randn(*wshape, scale=1.0 / (wshape[0] * wshape[1]
                                        * wshape[2]) ** 0.5)
        gamma = randn(wshape[-1], scale=0.1) + 1.0
        bias = randn(wshape[-1], scale=0.1)
        p = sd.plan(w.shape, s, pad, backend="fused", act=act,
                    output_padding=op, tile=tile, dtype="int8",
                    device=dev).bind(w, gamma, bias)
        xq, sxs = quantize_act(x)
        comb = (sxs[:, None] * p.wscale[None, :]).contiguous()
        return x, w, gamma, bias, p, xq, comb

    def geo(p, xq):
        return dict(pad=((p.pi[0],) * 2, (p.pi[1],) * 2),
                    crop=(p.pk[0] + p.padding[0][0],
                          p.pk[1] + p.padding[1][0]),
                    out_space=p.out_shape(xq.shape[1:3]))

    def k1q(xq, p, comb, bias, act):
        return ops.sd_deconv_presplit_fused(
            xq, p.ws, p.kernel, p.stride, p.padding,
            output_padding=p.output_padding, bias=bias, act=act,
            scale=comb, plan=p.tile)

    def plain(xq, p, comb, bias, act):
        return K.sd_fused_ref(xq, p.ws, p.stride, bias=bias, act=act,
                              scale=comb, **geo(p, xq))

    err = {"unit": 0.0, "scaled": 0.0}
    failures = []

    def check(label, xq, p, comb, acts):
        """(a) unit scale, zero bias, linear: bit-identical; (b) the real
        scales, the plan's bias, each act in ``acts``: within
        INT8_EXACT_GATE * max(1, max|ref|)."""
        ones, zero = torch.ones_like(comb), torch.zeros_like(p.bias)
        out, ref = k1q(xq, p, ones, zero, "linear"), \
            plain(xq, p, ones, zero, "linear")
        torch.cuda.synchronize()
        n_diff = int((out != ref).sum())
        d = (out - ref).abs().max().item()
        err["unit"] = max(err["unit"], d)
        ok = n_diff == 0 and out.shape == ref.shape \
            and out.dtype == torch.float32
        line = (f"  {label} {tuple(xq.shape)}->{tuple(out.shape)} unit "
                f"scale: {n_diff} elements differ (max|d| {d:.3e})")
        for act in acts:
            out, ref = k1q(xq, p, comb, p.bias, act), \
                plain(xq, p, comb, p.bias, act)
            torch.cuda.synchronize()
            d, tol = _gate_err(out, ref, INT8_EXACT_GATE, True)
            err["scaled"] = max(err["scaled"], d)
            ok = ok and d <= tol
            line += f"; {act} max|d| {d:.3e} tol {tol:.3e}"
        print(f"{line} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)

    print(f"check: K1 int8 vs sd_fused_ref on the int8 pair (exact sums), "
          f"batch 4: (a) unit scale, zero bias, linear: bit-identical; (b) "
          f"per-sample scales, folded-BN wscale, bias, relu and tanh: gate "
          f"{INT8_EXACT_GATE}*max(1,max|ref|) {tag}")
    for net, fn in BENCHMARKS.items():
        for l in fn().deconv_layers():
            _, _, _, _, p, xq, comb = case(
                (4, *l.in_hw, l.cin), (l.k, l.k, l.cin, l.cout), l.s,
                same_deconv_pads(l.k, l.s), "relu")
            check(f"{net}/{l.name}", xq, p, comb, ("relu", "tanh"))
    # Cin not a multiple of 4 (byte copies), op > pad_hi, asymmetric pads,
    # forced GEMM plans: Cin 40 (4-byte copies) and a ragged N over bn 64
    # with an empty last split, Cin 70 and N 20 over bn 16 in 3 splits,
    # stride 1 with Cin 6 and N 6 (byte copies of A and B) in 2 splits.
    odd = [((2, 5, 6, 7), (4, 4, 7, 2), 2, 0, 1, None),
           ((2, 5, 6, 3), (4, 4, 3, 2), 2, 1, (1, 0), None),
           ((1, 6, 7, 5), (5, 5, 5, 2), 2, ((1, 3), (0, 2)), 0, None),
           ((3, 13, 11, 40), (5, 5, 40, 24), 2, 2, 1, GemmPlan(64, 4)),
           ((2, 9, 10, 70), (3, 3, 70, 5), 2, 1, 1, GemmPlan(16, 3)),
           ((2, 9, 7, 6), (5, 5, 6, 6), 1, 2, 0, GemmPlan(16, 2))]
    for sx, sw_, st, padv, op, tile in odd:
        _, _, _, _, p, xq, comb = case(sx, sw_, st, padv, "relu", op, tile)
        check(f"odd k{sw_[:2]} s{st} p{padv} op{op} tile {tile}", xq, p,
              comb, ("relu", "tanh"))
    if failures:
        raise SystemExit(f"chip_smoke: K1 int8 disagrees with its plain "
                         f"version on {failures}")

    sat = _saturating_d1(dev, tag)
    # DCGAN's layers at the serving bucket; phase 9 times them
    for i, l in enumerate(BENCHMARKS["dcgan"]().layers):
        if l.kind != "deconv":
            continue
        act = "linear" if i == 3 else "relu"
        *_, p, xq, comb = case((BUCKET, *l.in_hw, l.cin),
                               (l.k, l.k, l.cin, l.cout), l.s,
                               same_deconv_pads(l.k, l.s), act)
        check(f"dcgan/{l.name} batch {BUCKET}", xq, p, comb,
              (act, "tanh") if act == "relu" else ("relu", "tanh"))
    if failures:
        raise SystemExit(f"chip_smoke: K1 int8 disagrees with its plain "
                         f"version on {failures}")

    # ---- serve full-width DCGAN through the int8 server ----------------
    server = GenServer(nets=("dcgan",), device=dev, max_batch=BUCKET,
                       seed=SEED, dtype="int8")
    built_cells = server.warmup()
    reqs = server.random_requests("dcgan", SERVE_REQUESTS, seed=1)
    torch.cuda.synchronize()
    K.SD_FUSED_INT8_LAUNCHES = 0
    K.SD_FUSED_LAUNCHES = 0
    results, stats = serve_async(server, reqs)
    torch.cuda.synchronize()
    launches, k1_launches = K.SD_FUSED_INT8_LAUNCHES, K.SD_FUSED_LAUNCHES
    lat = stats["latency_ms"]
    print(f"serve int8: {stats['served']} DCGAN requests (full width, "
          f"int8 execution, f32 IO) in {stats['wall_s']:.4f} s host clock: "
          f"{stats['req_per_s']:.1f} req/s, p50 {lat['p50']} ms, p95 "
          f"{lat['p95']} ms, {stats['launches']} launches, "
          f"{stats['compiles']} cells ({built_cells} built in warmup) {tag}")
    print(f"  K1 int8 launches in the serving run: {launches} (3 deconv "
          f"layers x {stats['launches']} batches); K1 f32 launches: "
          f"{k1_launches}")
    if launches != 3 * stats["launches"] or launches == 0 or k1_launches:
        raise SystemExit("chip_smoke: the int8 server did not run K1's int8 "
                         "branch (and only it) once per deconv layer per "
                         "batch")
    if stats["served"] != SERVE_REQUESTS or stats["shed"]:
        raise SystemExit(f"chip_smoke: served {stats['served']} of "
                         f"{SERVE_REQUESTS}, shed {stats['shed']}")
    model, params = server.model("dcgan")
    z = torch.stack([r.latent for r in reqs])
    out = torch.stack([results[r.rid] for r in reqs])
    with torch.no_grad():
        ref_t = GenerativeModel(model.spec, "sd_kernel",
                                engine_backend="torch", device=dev,
                                engine_dtype="int8").apply(params, z)
        ref_f = GenerativeModel(model.spec, "sd_kernel",
                                engine_backend="fused",
                                device=dev).apply(params, z)
    finite = bool(torch.isfinite(out).all())
    ok = finite and tuple(out.shape) == (SERVE_REQUESTS, 64, 64, 3)
    d, tol = _gate_err(out, ref_t, INT8_SERVE_GATE, True)
    n_over = int(((out - ref_t).abs() > 1e-5).sum())
    ok = ok and d <= tol
    rel = ((out - ref_f).abs().max() / ref_f.abs().max()).item()
    s_val = ssim(out, ref_f, data_range=2.0).item()
    ok = ok and rel < INT8_VS_F32 and s_val >= SSIM_GATE
    print(f"  outputs {tuple(out.shape)} finite={finite}; on the same "
          f"weights {tag}:")
    print(f"    vs the int8 torch backend on the card (exact sums) max|d| "
          f"{d:.3e} tol {tol:.3e} ({INT8_SERVE_GATE}*max(1,max|ref|)); "
          f"{n_over} of {out.numel()} elements differ by more than 1e-5 "
          f"{'ok' if d <= tol else 'FAIL'}")
    print(f"    vs the float fused server's model: max|d|/max|ref| "
          f"{rel:.4e} (gate < {INT8_VS_F32}), SSIM {s_val:.6f} (gate >= "
          f"{SSIM_GATE}, data_range 2.0) "
          f"{'ok' if rel < INT8_VS_F32 and s_val >= SSIM_GATE else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: int8-served outputs are wrong")

    # ---- one batch of 16: int8 vs float fused, in turns ----------------
    f32 = GenServer(nets=("dcgan",), device=dev, max_batch=BUCKET,
                    seed=SEED)
    f32.warmup()
    full = [r.latent for r in reqs[:BUCKET]]
    host = {"int8": [], "f32": []}
    for r in range(10):
        for name in (("int8", "f32") if r % 2 == 0 else ("f32", "int8")):
            srv = server if name == "int8" else f32
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.run_group("dcgan", full)
            torch.cuda.synchronize()
            host[name].append((time.perf_counter() - t0) * 1e3)
    host_ms = {k: sorted(v)[len(v) // 2] for k, v in host.items()}
    breakdown = {k: _device_breakdown(lambda s=s: s.run_group("dcgan", full))
                 for k, s in (("int8", server), ("f32", f32))}
    print(f"batch int8: one DCGAN batch of {BUCKET} through run_group: int8 "
          f"{host_ms['int8']:.3f} ms, f32 fused {host_ms['f32']:.3f} ms host "
          f"clock (median of 10, synchronised, in turns) {tag}")
    for name, bd in breakdown.items():
        if bd is None:
            print(f"  {name}: device time per kernel: not measured (the "
                  "profiler reported no device time)")
            continue
        busy, wall, top = bd
        print(f"  {name} profiler: device busy {busy:.3f} ms of {wall:.3f} "
              f"ms wall (idle share {1 - busy / wall:.3f}) {tag}")
        for kname, ms_k, calls in top:
            print(f"    {ms_k:.4f} ms in {calls} call(s): {kname[:90]}")

    kernel = {
        "name": "sd_fused_int8", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sd_fused_int8.cu",
        "replaces": "src/repro/kernels/sd_conv.py:352",
        "launches": launches, "max_abs_err": err["scaled"],
        "max_abs_err_unit_scale": err["unit"]}
    return {"kernel": kernel, "saturating": sat,
            "serve": {k: stats[k] for k in ("served", "launches",
                                            "req_per_s", "wall_s",
                                            "latency_ms")},
            "vs_torch_max_abs": d, "vs_f32_rel": rel, "ssim": s_val,
            "batch_host_ms": host_ms, "batch_device": breakdown}


def _nd_phase(dev, tag, randn) -> dict:
    """Phase 8: the 3-D serving path.  (a) K2's int8 pair against its
    plain version at VoxGAN's three tap-conv shapes at batch 16, at codes
    of +-127 and at odd geometries: bit-identical; (b) the 3-D lowering
    (one K2 launch per depth tap) against the ``torch`` backend on each
    VoxGAN layer at batch 16, f32 within ``1e-5 * max(1, max|ref|)``
    (TF32 off), int8 exact; (c) each tap conv timed as K2 int8 / K2 f32 /
    plain / ``F.conv2d`` f32 / ``torch._int_mm`` on its GEMM operands,
    K2 int8 gated on up2's tap, and each whole layer against
    ``F.conv_transpose3d``; (d) 48 full-width VoxGAN requests served in
    f32 and in int8 and held against the same model on the ``torch``
    backend.  Returns K2-int8's record, K2's 3-D serving launches and the
    reports."""
    import torch
    import torch.nn.functional as F
    import repro_torch.kernels.sd_conv as K
    from repro_torch import sd
    from repro_torch.core.accounting import WORKLOADS
    from repro_torch.core.deconv import same_deconv_pads
    from repro_torch.kernels.autotune import (ConvGeom, GemmGeom, GemmPlan,
                                              gemm_grid, gemm_plan,
                                              gemm_smem_bytes)
    from repro_torch.launch.serve_gen import GenServer, serve_async
    from repro_torch.models.generative import GenerativeModel

    gen = torch.Generator().manual_seed(SEED + 8)
    layers = WORKLOADS["voxgan"]().deconv_layers()
    pads = same_deconv_pads((4,) * 3, (2,) * 3)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int8).to(dev)

    def tap_shapes(l, batch):
        """(x, w) shapes of one depth tap's K2 launch of layer ``l``: the
        depth-padded input's ``D_out`` slices folded into the batch."""
        p = sd.plan((4, 4, 4, l.cin, l.cout), 2, pads, backend="fused",
                    device=dev)
        od = l.in_hw[0] + 2 * p.pi[0] - p.kt[0] + 1
        return ((batch * od, *l.in_hw[1:], l.cin),
                (*p.kt[1:], l.cin, p.phases * l.cout),
                ((p.pi[1],) * 2, (p.pi[2],) * 2))

    # ---- (a) K2 int8 bit-identical to its plain version ----------------
    print(f"check: K2 int8 vs sd_conv_ref on the int8 pair (exact int32 "
          f"sums), gate 0 elements different {tag}")
    cases = []
    for l in layers:
        sx, sw_, pad = tap_shapes(l, BUCKET)
        cases.append((f"voxgan/{l.name} tap conv, batch {BUCKET} x D_out",
                      codes(*sx), codes(*sw_), pad, (0, 0), None, None))
    sx, sw_, pad = tap_shapes(layers[0], 2)
    full = torch.full(sx, 127, dtype=torch.int8, device=dev)
    full[..., 1::2] = -127
    cases.append(("voxgan/up1 tap conv, codes at +-127", full,
                  torch.full(sw_, -127, dtype=torch.int8, device=dev), pad,
                  (0, 0), None, None))
    odd = [((2, 5, 6, 3), (3, 3, 3, 5), ((2, 1), (0, 2)), (0, 0), None,
            GemmPlan(16, 3)),
           ((2, 7, 6, 5), (2, 3, 5, 20), ((1, 1), (1, 1)), (1, 2), (5, 3),
            GemmPlan(32, 2)),
           ((3, 11, 13, 5), (2, 2, 5, 8), ((1, 1), (1, 1)), (0, 0), None,
            None),
           ((1, 9, 10, 70), (3, 3, 70, 33), ((1, 1), (1, 1)), (0, 0), None,
            GemmPlan(64, 3))]
    for sx, sw_, pad, start, size, tile in odd:
        cases.append((f"odd Cin {sx[-1]} pad {pad} window {start}+{size} "
                      f"plan {tile}", codes(*sx), codes(*sw_), pad, start,
                      size, tile))
    # a batch-1 depth-tap band as the 3-D lowering hands it to K2 (a view
    # td*H*W*Cin bytes into its storage), odd Cin; and a Cin-64 input 4
    # bytes past a 16-byte boundary: the copy width follows the pointer
    xp = codes(1, 6, 7, 9, 5)
    band = xp[:, 1:6].reshape(5, 7, 9, 5)
    cases.append((f"batch-1 depth-tap band, Cin 5, base +"
                  f"{band.data_ptr() - xp.data_ptr()} B", band,
                  codes(2, 2, 5, 8), ((1, 1), (1, 1)), (0, 0), None, None))
    buf = codes(3 * 6 * 6 * 64 + 4)
    cases.append(("Cin 64 at a base 4 bytes past 16-byte alignment",
                  buf[4:].view(3, 6, 6, 64), codes(2, 2, 64, 32),
                  ((1, 1), (1, 1)), (0, 0), None, GemmPlan(32, 2)))
    failures, max_err = [], 0.0
    for label, xq, wq, pad, start, size, tile in cases:
        out = K.sd_conv(xq, wq, pad=pad, out_start=start, out_size=size,
                        plan=tile)
        ref = K.sd_conv_ref(xq, wq, pad, start, size)
        torch.cuda.synchronize()
        n_diff = int((out != ref).sum()) if out.shape == ref.shape else -1
        if n_diff >= 0:
            max_err = max(max_err, (out - ref).abs().max().item())
        ok = n_diff == 0 and out.dtype == torch.int32
        print(f"  {label} {tuple(xq.shape)} x {tuple(wq.shape)} -> "
              f"{tuple(out.shape)} int32: {n_diff} elements differ "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
    if failures:
        raise SystemExit(f"chip_smoke: K2 int8 disagrees with its plain "
                         f"version on {failures}")

    # ---- (b) the 3-D lowering against the torch backend ----------------
    print(f"check: the 3-D lowering (one K2 launch per depth tap) vs the "
          f"torch backend at batch {BUCKET}: f32 gate "
          f"{ND_F32_GATE}*max(1,max|ref|) (TF32 off), int8 exact {tag}")
    bound = {}
    for i, l in enumerate(layers):
        act = "linear" if i == len(layers) - 1 else "relu"
        x = randn(BUCKET, *l.in_hw, l.cin)
        w = randn(4, 4, 4, l.cin, l.cout, scale=1.0 / (64 * l.cin) ** 0.5)
        gamma = randn(l.cout, scale=0.1) + 1.0
        bias = randn(l.cout, scale=0.1)
        for dtype, counter in (("native", "SD_CONV_LAUNCHES"),
                               ("int8", "SD_CONV_INT8_LAUNCHES")):
            pf, pt = (sd.plan(w.shape, 2, pads, backend=b, act=act,
                              dtype=dtype, device=dev).bind(w, gamma, bias)
                      for b in ("fused", "torch"))
            before = getattr(K, counter)
            out = sd.execute(pf, x)
            n = getattr(K, counter) - before
            ref = sd.execute(pt, x)
            torch.cuda.synchronize()
            if dtype == "int8":
                d = (out - ref).abs().max().item()
                ok = bool(torch.equal(out, ref))
                gate = "exact"
            else:
                d, tol = _gate_err(out, ref, ND_F32_GATE, True)
                ok = d <= tol
                gate = f"tol {tol:.3e}"
            ok = ok and n == pf.kt[0] and out.shape == ref.shape
            print(f"  voxgan/{l.name} {dtype} {tuple(x.shape)}->"
                  f"{tuple(out.shape)}: {n} {'K2 int8' if dtype == 'int8' else 'K2'} "
                  f"launches, max|d| {d:.3e} {gate} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"voxgan/{l.name} {dtype}")
            bound[(l.name, dtype)] = (x, pf, pt, w, bias)
    if failures:
        raise SystemExit(f"chip_smoke: the 3-D lowering disagrees with the "
                         f"torch backend on {failures}")

    # ---- (c) timing -----------------------------------------------------
    print(f"time: VoxGAN tap convs (each layer makes 2 such launches) at "
          f"batch {BUCKET}, in turns: K2 int8 / K2 f32 / plain (exact f64 "
          f"tap GEMMs) / F.conv2d f32 (TF32 off; a float yardstick) / "
          f"torch._int_mm on the tap's own GEMM operands (im2col left out, "
          f"N padded to a multiple of 8: a yardstick of cuBLASLt's int8 "
          f"GEMM rate, checked to give the GEMM's exact sums); device ms of "
          f"one call (ahead events; the profiler's median of 3 beside) and "
          f"CUDA events over 20 back-to-back calls (median [min, max] of 7 "
          f"rounds); bound at the dense int8 tensor-core peak "
          f"{PEAK_INT8_OPS / 1e12:.0f} TOP/s or {PEAK_BYTES / 1e12:.2f} TB/s, "
          f"whichever is larger {tag}")
    per_tap = []
    for l, (label, xq, wq, pad, _, _, _) in zip(layers, cases):
        xf, wf = xq.float(), wq.float()
        x_cf = xf.permute(0, 3, 1, 2).contiguous()
        w_cf = wf.permute(3, 2, 0, 1).contiguous()
        y = K.sd_conv(xq, wq, pad=pad)
        geom = ConvGeom(h=xq.shape[1], w=xq.shape[2], cin=xq.shape[3],
                        co=wq.shape[3], kth=wq.shape[0], ktw=wq.shape[1],
                        out_h=y.shape[1], out_w=y.shape[2], dtype="int8")
        gq = geom.as_gemm(xq.shape[0])
        plan = gemm_plan(gq)
        grid = gemm_grid(gq, plan)
        f32_plan = gemm_plan(GemmGeom(gq.m, gq.n, gq.k))
        a_mat, b_mat = _int_mm_operands(xq, wq, -pad[0][0], -pad[1][0],
                                        y.shape[1], y.shape[2])
        fns = {"k2q": lambda: K.sd_conv(xq, wq, pad=pad),
               "k2": lambda: K.sd_conv(xf, wf, pad=pad),
               "plain": lambda: K.sd_conv_ref(xq, wq, pad),
               "lib": lambda: F.conv2d(x_cf, w_cf, padding=1),
               "int_mm": lambda: torch._int_mm(a_mat, b_mat)}
        assert fns["lib"]().shape[2:] == y.shape[1:3]
        prod = fns["int_mm"]()[:, :gq.n]
        im_ok = torch.equal(prod.double(), a_mat.double()
                            @ b_mat[:, :gq.n].double()) and torch.equal(
            prod.reshape(y.shape), y)
        t = _time_ms(fns)
        dv = {n: _device_ms(f) for n, f in fns.items()}
        macs = y.numel() * wq.shape[0] * wq.shape[1] * wq.shape[2]
        nbytes = xq.numel() + wq.numel() + 4 * y.numel()
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = 2.0 * macs / PEAK_INT8_OPS * 1e3
        rec = {"layer": f"voxgan/{l.name} tap", "x": list(xq.shape),
               "w": list(wq.shape), "ms": dv["k2q"][1],
               "profiler_ms": dv["k2q"][0], "events_ms": t["k2q"][0],
               "events_ms_min": t["k2q"][1], "events_ms_max": t["k2q"][2],
               "k2_f32_ms": dv["k2"][1], "k2_f32_profiler_ms": dv["k2"][0],
               "k2_f32_events_ms": t["k2"][0],
               "plain_ms": dv["plain"][1], "plain_events_ms": t["plain"][0],
               "library_ms": None, "f32_library_ms": dv["lib"][1],
               "f32_library_profiler_ms": dv["lib"][0],
               "int_mm_ms": dv["int_mm"][1],
               "int_mm_profiler_ms": dv["int_mm"][0],
               "int_mm_shape": [*a_mat.shape, b_mat.shape[1]],
               "int_mm_exact": im_ok,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "macs": macs, "bytes": nbytes, "plan": str(plan),
               "grid": list(grid), "smem_bytes": gemm_smem_bytes(gq, plan),
               "k2_f32_plan": str(f32_plan), "launches_per_batch": 2}
        per_tap.append(rec)
        print(f"  voxgan/{l.name} tap {tuple(xq.shape)}x{tuple(wq.shape)}->"
              f"{tuple(y.shape)} GEMM {gq.m} x {gq.n} x {gq.k}, {plan}, grid "
              f"{grid[0]} x {grid[1]} x {grid[2]}, {rec['smem_bytes']} B "
              f"dynamic shared memory: K2 int8 device {rec['ms']:.4f} ms "
              f"(profiler {_ms_txt(rec['profiler_ms'])}; events "
              f"{rec['events_ms']:.4f} [{rec['events_ms_min']:.4f}, "
              f"{rec['events_ms_max']:.4f}]; {2 * macs / rec['ms'] / 1e9:.1f} "
              f"TOP/s), K2 f32 ({f32_plan}) {rec['k2_f32_ms']:.4f} (profiler "
              f"{_ms_txt(rec['k2_f32_profiler_ms'])}), plain "
              f"{rec['plain_ms']:.4f}, F.conv2d f32 "
              f"{rec['f32_library_ms']:.4f} (profiler "
              f"{_ms_txt(rec['f32_library_profiler_ms'])}), torch._int_mm "
              f"{' x '.join(map(str, rec['int_mm_shape']))} "
              f"{rec['int_mm_ms']:.4f} (profiler "
              f"{_ms_txt(rec['int_mm_profiler_ms'])}; its sums "
              f"{'equal' if im_ok else 'DIFFER FROM'} the f64 product and "
              f"K2 int8); bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
              f"{nbytes} bytes, {macs} MACs); sm clock, power, temperature "
              f"{_clocks()} {tag}")
        if not im_ok:
            raise SystemExit("chip_smoke: the torch._int_mm yardstick's "
                             "operands are not K2 int8's GEMM")
    up2 = per_tap[1]
    gate_ms = (up2["profiler_ms"] if up2["profiler_ms"] is not None
               else up2["ms"])
    ok = gate_ms <= K2_INT8_UP2_MS_LIMIT
    print(f"gate: K2 int8 on the voxgan/up2 tap at batch {BUCKET}: "
          f"{gate_ms:.4f} ms of device time ("
          f"{'profiler' if up2['profiler_ms'] is not None else 'ahead events'}"
          f"), limit {K2_INT8_UP2_MS_LIMIT} ms {'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit("chip_smoke: K2 int8 on the VoxGAN up2 tap is over "
                         "its time limit")
    print(f"time: whole VoxGAN layers at batch {BUCKET} (bound plans: BN "
          f"scale, bias, act; int8 includes the per-sample quantization), "
          f"CUDA events, median of 7 rounds in turns: fused f32 (2 K2 "
          f"launches) / fused int8 (2 K2-int8 launches) / torch backend f32 "
          f"/ F.conv_transpose3d f32 (cuDNN, TF32 off, a yardstick) {tag}")
    per_layer = []
    for l in layers:
        x, pf, pt, w, bias = bound[(l.name, "native")]
        pq = bound[(l.name, "int8")][1]
        x_cf = x.permute(0, 4, 1, 2, 3).contiguous()
        w_cf = w.permute(3, 4, 0, 1, 2).contiguous()
        lib = lambda: F.conv_transpose3d(                  # noqa: E731
            x_cf, w_cf, bias, stride=2, padding=1)
        assert lib().shape[2:] == sd.execute(pf, x).shape[1:4]
        t = _time_ms({"f32": lambda: sd.execute(pf, x),
                      "int8": lambda: sd.execute(pq, x),
                      "torch": lambda: sd.execute(pt, x), "lib": lib})
        rec = {"layer": f"voxgan/{l.name}", "x": list(x.shape),
               "fused_f32_ms": t["f32"][0], "fused_int8_ms": t["int8"][0],
               "torch_ms": t["torch"][0], "library_ms": t["lib"][0]}
        per_layer.append(rec)
        print(f"  voxgan/{l.name} {tuple(x.shape)}: fused f32 "
              f"{rec['fused_f32_ms']:.4f} ms, fused int8 "
              f"{rec['fused_int8_ms']:.4f} ms, torch {rec['torch_ms']:.4f} "
              f"ms, conv_transpose3d {rec['library_ms']:.4f} ms {tag}")

    # ---- (d) serve full-width VoxGAN in f32 and int8 --------------------
    names = ("SD_FUSED_LAUNCHES", "SD_FUSED_INT8_LAUNCHES",
             "SD_CONV_LAUNCHES", "SD_CONV_INT8_LAUNCHES",
             "SD_FILTER_GRAD_LAUNCHES")
    from repro_torch.kernels import winograd as W
    serve, servers = {}, {}
    for dtype, counter in (("f32", "SD_CONV_LAUNCHES"),
                           ("int8", "SD_CONV_INT8_LAUNCHES")):
        server = GenServer(nets=("voxgan",), device=dev, max_batch=BUCKET,
                           seed=SEED, backend="fused",
                           dtype="int8" if dtype == "int8" else torch.float32)
        built_cells = server.warmup()
        reqs = server.random_requests("voxgan", SERVE_REQUESTS, seed=1)
        torch.cuda.synchronize()
        for n in names:
            setattr(K, n, 0)
        W.SD_WINO_LAUNCHES = 0
        results, stats = serve_async(server, reqs)
        torch.cuda.synchronize()
        counts = {n: getattr(K, n) for n in names}
        counts["SD_WINO_LAUNCHES"] = W.SD_WINO_LAUNCHES
        lat = stats["latency_ms"]
        print(f"serve voxgan {dtype}: {stats['served']} VoxGAN requests "
              f"(full width, 64->32->16->1 channels, 4^3 -> 32^3 voxels, "
              f"{'int8 execution, ' if dtype == 'int8' else ''}f32 IO) in "
              f"{stats['wall_s']:.4f} s host clock: "
              f"{stats['req_per_s']:.1f} req/s, p50 {lat['p50']} ms, p95 "
              f"{lat['p95']} ms, {stats['launches']} launches, "
              f"{stats['compiles']} cells ({built_cells} built in warmup) "
              f"{tag}")
        want = 3 * 2 * stats["launches"]
        print(f"  launches in the serving run: {counts} (want {counter} = 3 "
              f"layers x 2 depth taps x {stats['launches']} batches, every "
              f"other 0)")
        if counts[counter] != want or want == 0 or any(
                v for n, v in counts.items() if n != counter):
            raise SystemExit(f"chip_smoke: the {dtype} VoxGAN server did "
                             f"not run {counter} (and only it) twice per "
                             "deconv layer per batch")
        if stats["served"] != SERVE_REQUESTS or stats["shed"]:
            raise SystemExit(f"chip_smoke: served {stats['served']} of "
                             f"{SERVE_REQUESTS}, shed {stats['shed']}")
        model, params = server.model("voxgan")
        z = torch.stack([r.latent for r in reqs])
        out = torch.stack([results[r.rid] for r in reqs])
        ref_m = GenerativeModel(model.spec, "sd_kernel",
                                engine_backend="torch", device=dev,
                                engine_dtype="int8" if dtype == "int8"
                                else "native")
        with torch.no_grad():       # the served batches of 16, in order
            ref = torch.cat([ref_m.apply(params, z[i:i + BUCKET])
                             for i in range(0, SERVE_REQUESTS, BUCKET)])
        finite = bool(torch.isfinite(out).all())
        rel = F32_GATE if dtype == "f32" else INT8_EXACT_GATE
        d, tol = _gate_err(out, ref, rel, True)
        n_diff = int((out != ref).sum())
        ok = finite and d <= tol and tuple(out.shape) == (
            SERVE_REQUESTS, 32, 32, 32, 1)
        print(f"  outputs {tuple(out.shape)} finite={finite}; vs the same "
              f"model on the {dtype} torch backend on the card (the served "
              f"batches of {BUCKET}): max|d| {d:.3e} tol {tol:.3e} "
              f"({rel}*max(1,max|ref|)), {n_diff} of {out.numel()} elements "
              f"differ {'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"chip_smoke: {dtype}-served VoxGAN outputs "
                             "are wrong")
        serve[dtype] = {k: stats[k] for k in ("served", "launches",
                                              "req_per_s", "wall_s",
                                              "latency_ms")}
        serve[dtype].update(launches_by_counter=counts, vs_torch_max_abs=d,
                            elements_differ=n_diff, out=out)
        servers[dtype] = (server, reqs)
    a, b = serve["int8"].pop("out"), serve["f32"].pop("out")
    int8_vs_f32 = ((a - b).abs().max() / b.abs().max()).item()
    ok = int8_vs_f32 < INT8_VS_F32
    print(f"  int8 served vs the f32 server on the same weights and "
          f"latents: max|d|/max|ref| {int8_vs_f32:.4e} (gate < "
          f"{INT8_VS_F32}) {'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit("chip_smoke: int8 VoxGAN strays from f32")

    # ---- one batch of 16: int8 vs f32, in turns -------------------------
    full = [r.latent for r in servers["f32"][1][:BUCKET]]
    host = {"f32": [], "int8": []}
    for r in range(10):
        for name in (("int8", "f32") if r % 2 == 0 else ("f32", "int8")):
            srv = servers[name][0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.run_group("voxgan", full)
            torch.cuda.synchronize()
            host[name].append((time.perf_counter() - t0) * 1e3)
    host_ms = {k: sorted(v)[len(v) // 2] for k, v in host.items()}
    breakdown = {k: _device_breakdown(
        lambda s=servers[k][0]: s.run_group("voxgan", full))
        for k in ("f32", "int8")}
    print(f"batch voxgan: one VoxGAN batch of {BUCKET} through run_group: "
          f"f32 {host_ms['f32']:.3f} ms, int8 {host_ms['int8']:.3f} ms host "
          f"clock (median of 10, synchronised, in turns) {tag}")
    for name, bd in breakdown.items():
        if bd is None:
            print(f"  {name}: device time per kernel: not measured (the "
                  "profiler reported no device time)")
            continue
        busy, wall, top = bd
        print(f"  {name} profiler: device busy {busy:.3f} ms of {wall:.3f} "
              f"ms wall (idle share {1 - busy / wall:.3f}) {tag}")
        for kname, ms_k, calls in top:
            print(f"    {ms_k:.4f} ms in {calls} call(s): {kname[:90]}")

    tot = {k: _total(r[k] for r in per_tap)
           for k in ("ms", "profiler_ms", "events_ms", "plain_ms",
                     "f32_library_ms", "bound_ms", "k2_f32_ms", "int_mm_ms",
                     "macs", "bytes")}
    kernel = {
        "name": "sd_conv_int8", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sd_conv_int8.cu",
        "replaces": "src/repro/kernels/sd_conv.py:186",
        "launches": serve["int8"]["launches_by_counter"][
            "SD_CONV_INT8_LAUNCHES"],
        "max_abs_err": max_err,
        "ms": tot["ms"], "profiler_ms": tot["profiler_ms"],
        "events_ms": tot["events_ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": ("operations" if 2.0 * tot["macs"] / PEAK_INT8_OPS
                     >= tot["bytes"] / PEAK_BYTES else "bytes"),
        "library_ms": None, "f32_library_ms": tot["f32_library_ms"],
        "k2_f32_ms": tot["k2_f32_ms"], "int_mm_ms": tot["int_mm_ms"]}
    return {"kernel": kernel,
            "k2_launches_serve_3d": serve["f32"]["launches_by_counter"][
                "SD_CONV_LAUNCHES"],
            "per_tap": per_tap, "per_layer": per_layer, "serve": serve,
            "int8_vs_f32_rel": int8_vs_f32, "batch_host_ms": host_ms,
            "batch_device": breakdown}


def _np_chain_epilogue(xq, ws_oc, s, pad, crop, out_space, comb, bias,
                       act, out_int8):
    """K1 int8 restated exactly in numpy: int64 tap sums over the
    zero-padded input, one f32 cast, ``* comb`` per oc-major phase
    channel (a (1, NC) row broadcasts), interleave, crop (zero-extended),
    ``+ bias`` in f32, act, and for int8 output ``rint`` (half to even)
    and a clamp to +-127."""
    import numpy as np
    (plo_h, phi_h), (plo_w, phi_w) = pad
    xp = np.pad(xq.astype(np.int64), ((0, 0), (plo_h, phi_h),
                                      (plo_w, phi_w), (0, 0)))
    kth, ktw, _, nc = ws_oc.shape
    oh, ow = xp.shape[1] - kth + 1, xp.shape[2] - ktw + 1
    acc = np.zeros((xq.shape[0], oh, ow, nc), np.int64)
    for a in range(kth):
        for c in range(ktw):
            acc += np.tensordot(xp[:, a:a + oh, c:c + ow],
                                ws_oc[a, c].astype(np.int64), axes=1)
    y = acc.astype(np.float32) * comb[:, None, None, :]
    b, cout = y.shape[0], nc // (s * s)
    y = y.reshape(b, oh, ow, cout, s, s).transpose(0, 1, 4, 2, 5, 3)
    y = y.reshape(b, oh * s, ow * s, cout)
    out = np.zeros((b, *out_space, cout), np.float32)
    src = y[:, crop[0]:crop[0] + out_space[0], crop[1]:crop[1] + out_space[1]]
    out[:, :src.shape[1], :src.shape[2]] = src
    out = out + bias
    if act == "relu":
        out = np.maximum(out, np.float32(0))
    if out_int8:
        return np.clip(np.rint(out), -127, 127).astype(np.int8)
    return out


def _int_mm_operands(xq, ws, r0, c0, mh, mw):
    """An int8 implicit GEMM (K1 int8's or K2 int8's) as two int8 matrices
    for ``torch._int_mm``: A (M, K) gathered from the zero-padded input,
    ``mh x mw`` positions per sample from input offset ``(r0, c0)`` at tap
    (0, 0) (im2col, made here once, outside the timing), B the filters
    read as K x N, N zero-padded to a multiple of 8 (``_int_mm`` takes no
    other)."""
    import torch
    import torch.nn.functional as F
    kth, ktw, cin, n = ws.shape
    lo_h, lo_w = max(0, -r0), max(0, -c0)
    hi_h = max(0, r0 + mh + kth - 1 - xq.shape[1])
    hi_w = max(0, c0 + mw + ktw - 1 - xq.shape[2])
    xp = F.pad(xq, (0, 0, lo_w, hi_w, lo_h, hi_h))
    r0, c0 = r0 + lo_h, c0 + lo_w
    a = torch.cat([xp[:, r0 + kh:r0 + kh + mh, c0 + kw:c0 + kw + mw]
                   for kh in range(kth) for kw in range(ktw)], dim=-1)
    b = ws.reshape(kth * ktw * cin, n)
    return (a.reshape(-1, kth * ktw * cin).contiguous(),
            F.pad(b, (0, -n % 8)).contiguous())


def _chain_phase(dev, tag, randn) -> dict:
    """Phase 9: the calibrated int8 chain.  (a) K1 int8 with a static
    (1, NC) row, int8 out on DCGAN d1/d2 (relu) and f32 out on d3, batch
    16, and on an odd geometry, on scales that saturate codes:
    bit-identical to its plain version; (b) the int8-out epilogue against
    an exact numpy restatement; (c) 48 DCGAN requests served through
    ``GenServer(dtype="int8", calib=64)`` (calibration cache in a
    temporary file) against the card's int8 torch backend with the same
    scales and against the float server; (d) one profiled calibrated
    batch: 3 K1-int8 launches, no ``quantize_act``, int8 between layers;
    (e) per layer, the static-row launch against the dynamic one, and the
    host ms of a batch calibrated / dynamic / f32, in turns; (f) 48
    VoxGAN requests served calibrated, held exactly to the torch
    backend.  Returns K1 int8's record for this path and the reports."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    import torch.nn.functional as F
    import repro_torch.kernels.sd_conv as K
    import repro_torch.sd.functional as SF
    from repro_torch import sd
    from repro_torch.core.accounting import BENCHMARKS
    from repro_torch.core.deconv import same_deconv_pads
    from repro_torch.core.quant import (quantize_act, quantize_static,
                                        scale_from_amax)
    from repro_torch.core.ssim import ssim
    from repro_torch.kernels import ops
    from repro_torch.kernels import winograd as W
    from repro_torch.kernels.autotune import GemmPlan, gemm_grid
    from repro_torch.launch.serve_gen import GenServer, serve_async
    from repro_torch.models.generative import GenerativeModel

    names = ("SD_FUSED_LAUNCHES", "SD_FUSED_INT8_LAUNCHES",
             "SD_CONV_LAUNCHES", "SD_CONV_INT8_LAUNCHES",
             "SD_FILTER_GRAD_LAUNCHES")

    def zero_counts():
        for n in names:
            setattr(K, n, 0)
        W.SD_WINO_LAUNCHES = 0

    def counts():
        out = {n: getattr(K, n) for n in names}
        out["SD_WINO_LAUNCHES"] = W.SD_WINO_LAUNCHES
        return out

    def geo(p, xq):
        return dict(pad=((p.pi[0],) * 2, (p.pi[1],) * 2),
                    crop=(p.pk[0] + p.padding[0][0],
                          p.pk[1] + p.padding[1][0]),
                    out_space=p.out_shape(xq.shape[1:3]))

    def k1q(xq, p, comb, bias, act, out_dtype):
        return ops.sd_deconv_presplit_fused(
            xq, p.ws, p.kernel, p.stride, p.padding,
            output_padding=p.output_padding, bias=bias, act=act,
            scale=comb, out_dtype=out_dtype, plan=p.tile)

    def chained_case(sx, wshape, s, pad, act, chain, op=0, tile=None):
        """An int8 plan, the static input codes, and the static row and
        bias of a calibrated launch: ``sx_in`` from the input's amax;
        chained, ``sx_out`` at half the static f32 output's amax, so the
        top codes saturate, folded into row and bias."""
        x = randn(*sx)
        w = randn(*wshape, scale=1.0 / (wshape[0] * wshape[1]
                                        * wshape[2]) ** 0.5)
        gamma = randn(wshape[-1], scale=0.1) + 1.0
        bias = randn(wshape[-1], scale=0.1)
        p = sd.plan(w.shape, s, pad, backend="fused", act=act,
                    output_padding=op, tile=tile, dtype="int8",
                    device=dev).bind(w, gamma, bias)
        sx_in = scale_from_amax(x.abs().max())
        xq = quantize_static(x, sx_in)
        row = (torch.tensor(sx_in, device=dev) * p.wscale)[None, :]
        bias_l = p.bias
        if chain:
            y = K.sd_fused_ref(xq, p.ws, p.stride, bias=p.bias, act=act,
                               scale=row, **geo(p, xq))
            sn = torch.tensor(0.5 * scale_from_amax(y.abs().max()),
                              device=dev)
            row, bias_l = row / sn, p.bias / sn
        return x, p, xq, row.contiguous(), bias_l, sx_in

    # ---- (a) K1 int8, static row, bit-identical to its plain version ----
    print(f"check: K1 int8 with a static (1, NC) row vs sd_fused_ref, "
          f"DCGAN at batch {BUCKET} (d1/d2 relu, int8 out; d3 linear, f32 "
          f"out) and an odd geometry, on scales that saturate codes: gate "
          f"0 elements different {tag}")
    dcgan = [(i, l) for i, l in enumerate(BENCHMARKS["dcgan"]().layers)
             if l.kind == "deconv"]
    cases = []
    for i, l in dcgan:
        chain = i < 3
        cases.append((f"dcgan/{l.name}", (BUCKET, *l.in_hw, l.cin),
                      (l.k, l.k, l.cin, l.cout), l.s,
                      same_deconv_pads(l.k, l.s),
                      "relu" if chain else "linear", chain, 0, None))
    cases.append(("odd k5 s2 p2 op1 GemmPlan(64, 4)",
                  (3, 13, 11, 40), (5, 5, 40, 24), 2, 2, "linear", True, 1,
                  GemmPlan(64, 4)))
    failures, checked, max_err = [], {}, 0.0
    for label, sx, wshape, s, pad, act, chain, op, tile in cases:
        x, p, xq, row, bias_l, sx_in = chained_case(
            sx, wshape, s, pad, act, chain, op, tile)
        od = torch.int8 if chain else None
        out = k1q(xq, p, row, bias_l, act, od)
        ref = K.sd_fused_ref(xq, p.ws, p.stride, bias=bias_l, act=act,
                             scale=row, out_dtype=od, **geo(p, xq))
        torch.cuda.synchronize()
        same = out.shape == ref.shape and out.dtype == ref.dtype
        n_diff = int((out != ref).sum()) if same else -1
        if same:
            max_err = max(max_err,
                          (out.float() - ref.float()).abs().max().item())
        sat = int((out.abs() == 127).sum()) if chain else 0
        ok = n_diff == 0 and (sat > 0 or not chain)
        sat_txt = (f"{sat} of {out.numel()} codes saturated at +-127"
                   if chain else "f32 values, no codes")
        print(f"  {label} {tuple(xq.shape)}->{tuple(out.shape)} "
              f"{'int8' if chain else 'f32'} out, {act}: {n_diff} elements "
              f"differ; {sat_txt} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
        checked[label] = (x, p, xq, row, bias_l, act, od, sx_in)
    if failures:
        raise SystemExit(f"chip_smoke: K1 int8 (static row, int8 out) "
                         f"disagrees with its plain version on {failures}")

    # ---- (b) the int8-out epilogue against an exact restatement ---------
    print(f"check: K1 int8's int8-out epilogue vs an exact numpy "
          f"restatement (int64 sums, one f32 cast, * comb, interleave, + "
          f"bias, relu, round half to even, clamp), first 4 samples: gate "
          f"0 elements different {tag}")
    for label in ("dcgan/d1", "dcgan/d2"):
        _, p, xq, row, bias_l, act, od, _ = checked[label]
        g = geo(p, xq)
        out = k1q(xq[:4], p, row, bias_l, act, od).cpu().numpy()
        want = _np_chain_epilogue(
            xq[:4].cpu().numpy(), p.ws.cpu().numpy(), p.stride[0], g["pad"],
            g["crop"], g["out_space"], row.cpu().numpy(),
            bias_l.cpu().numpy(), act, True)
        n_diff = int((out != want).sum())
        print(f"  {label}: {n_diff} of {out.size} codes differ, "
              f"{int((np.abs(want) == 127).sum())} saturated "
              f"{'ok' if n_diff == 0 else 'FAIL'}")
        if n_diff:
            failures.append(label)
    if failures:
        raise SystemExit(f"chip_smoke: K1 int8's int8-out epilogue "
                         f"disagrees with its exact restatement on "
                         f"{failures}")

    # ---- (c) serve calibrated, chained int8 DCGAN -----------------------
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_calib_")
    old_env = os.environ.get("REPRO_TORCH_SD_CALIB_CACHE")
    os.environ["REPRO_TORCH_SD_CALIB_CACHE"] = os.path.join(
        cache_dir, "sd_calib.json")
    try:
        server = GenServer(nets=("dcgan",), device=dev, max_batch=BUCKET,
                           seed=SEED, dtype="int8", calib=64)
        built_cells = server.warmup()
        with open(os.environ["REPRO_TORCH_SD_CALIB_CACHE"]) as f:
            saved = sorted(json.load(f)["scales"])
        reqs = server.random_requests("dcgan", SERVE_REQUESTS, seed=1)
        torch.cuda.synchronize()
        zero_counts()
        results, stats = serve_async(server, reqs)
        torch.cuda.synchronize()
        served_counts = counts()
    finally:
        if old_env is None:
            os.environ.pop("REPRO_TORCH_SD_CALIB_CACHE", None)
        else:
            os.environ["REPRO_TORCH_SD_CALIB_CACHE"] = old_env
        shutil.rmtree(cache_dir, ignore_errors=True)
    launches = served_counts["SD_FUSED_INT8_LAUNCHES"]
    lat = stats["latency_ms"]
    model, params = server.model("dcgan")
    scales = {n: p.sx_in.item() for n, p in model.engine.plans().items()}
    print(f"serve calibrated int8: {stats['served']} DCGAN requests (full "
          f"width, calibrated on 64 latents: sx {scales}; d1 -> d2 -> d3 "
          f"int8 between layers, f32 IO) in {stats['wall_s']:.4f} s host "
          f"clock: {stats['req_per_s']:.1f} req/s, p50 {lat['p50']} ms, p95 "
          f"{lat['p95']} ms, {stats['launches']} launches, "
          f"{stats['compiles']} cells ({built_cells} built in warmup); "
          f"scales saved in a temporary cache under {saved} {tag}")
    want = 3 * stats["launches"]
    print(f"  launches in the serving run: {served_counts} (want "
          f"SD_FUSED_INT8_LAUNCHES = 3 deconv layers x {stats['launches']} "
          f"batches, every other 0)")
    if launches != want or want == 0 or any(
            v for n, v in served_counts.items()
            if n != "SD_FUSED_INT8_LAUNCHES"):
        raise SystemExit("chip_smoke: the calibrated server did not run "
                         "K1's int8 branch (and only it) once per deconv "
                         "layer per batch")
    if stats["served"] != SERVE_REQUESTS or stats["shed"]:
        raise SystemExit(f"chip_smoke: served {stats['served']} of "
                         f"{SERVE_REQUESTS}, shed {stats['shed']}")
    z = torch.stack([r.latent for r in reqs])
    out = torch.stack([results[r.rid] for r in reqs])
    plans = model.engine.plans()
    ref_t = GenerativeModel(model.spec, "sd_kernel", engine_backend="torch",
                            device=dev, engine_dtype="int8")
    ref_t.engine.set_calibration(scales)
    with torch.no_grad():
        ref_t.engine.bind(params)
        tplans = ref_t.engine.plans()
        ref = ref_t.apply(params, z)
        ref_f = GenerativeModel(model.spec, "sd_kernel",
                                engine_backend="fused",
                                device=dev).apply(params, z)
        # the chained codes, layer by layer, on the served batches of 16
        h = z @ params["project"]["w"] + params["project"]["b"]
        h = torch.relu(h.reshape(SERVE_REQUESTS, *dcgan[0][1].in_hw,
                                 dcgan[0][1].cin))
        ht, code_diff = h, {}
        for _, l in dcgan[:2]:
            h = torch.cat([sd.execute(plans[l.name], h[j:j + BUCKET])
                           for j in range(0, SERVE_REQUESTS, BUCKET)])
            ht = sd.execute(tplans[l.name], ht)
            code_diff[l.name] = (str(h.dtype).replace("torch.", ""),
                                 int((h != ht).sum()), h.numel())
    finite = bool(torch.isfinite(out).all())
    d, tol = _gate_err(out, ref, INT8_SERVE_GATE, True)
    rel = ((out - ref_f).abs().max() / ref_f.abs().max()).item()
    s_val = ssim(out, ref_f, data_range=2.0).item()
    codes_ok = all(dt == "int8" and n == 0 for dt, n, _ in
                   code_diff.values())
    ok = (finite and tuple(out.shape) == (SERVE_REQUESTS, 64, 64, 3)
          and d <= tol and codes_ok and rel <= INT8_VS_F32
          and s_val >= SSIM_GATE)
    print(f"  outputs {tuple(out.shape)} finite={finite}; on the same "
          f"weights and scales {tag}:")
    print(f"    chained codes vs the card's int8 torch backend (exact sums): "
          + ", ".join(f"{k} {dt}, {n} of {m} differ"
                      for k, (dt, n, m) in code_diff.items())
          + f"; final output max|d| {d:.3e} tol {tol:.3e} "
          f"({INT8_SERVE_GATE}*max(1,max|ref|))")
    print(f"    vs the float fused server's model: max|d|/max|ref| "
          f"{rel:.4e} (gate <= {INT8_VS_F32}), SSIM {s_val:.6f} (gate >= "
          f"{SSIM_GATE}, data_range 2.0) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: calibrated int8 outputs are wrong")

    # ---- (d) one profiled calibrated batch ------------------------------
    full = [r.latent for r in reqs[:BUCKET]]
    seen, quant_calls = [], []
    real_fused, real_qa = ops.sd_fused, SF.quantize_act

    def recording_fused(x, *a, **kw):
        y = real_fused(x, *a, **kw)
        seen.append((str(x.dtype).replace("torch.", ""),
                     str(y.dtype).replace("torch.", "")))
        return y

    def counting_qa(x):
        quant_calls.append(tuple(x.shape))
        return real_qa(x)

    ops.sd_fused, SF.quantize_act = recording_fused, counting_qa
    try:
        torch.cuda.synchronize()
        zero_counts()
        bd_cal = _device_breakdown(lambda: server.run_group("dcgan", full))
        prof_counts = counts()
    finally:
        ops.sd_fused, SF.quantize_act = real_fused, real_qa
    others = {n: v for n, v in prof_counts.items()
              if n != "SD_FUSED_INT8_LAUNCHES"}
    ok = (prof_counts["SD_FUSED_INT8_LAUNCHES"] == 3 and not quant_calls
          and seen == [("int8", "int8"), ("int8", "int8"),
                       ("int8", "float32")]
          and not any(others.values()))
    print(f"profile: one calibrated DCGAN batch of {BUCKET}: "
          f"{prof_counts['SD_FUSED_INT8_LAUNCHES']} K1-int8 launches (other "
          f"counters {others}), {len(quant_calls)} quantize_act calls; K1 "
          f"launches (input -> output dtype): {seen} "
          f"{'ok' if ok else 'FAIL'} {tag}")
    if bd_cal is None:
        print("  device time per kernel: not measured (the profiler "
              "reported no device time)")
    else:
        busy, wall, top = bd_cal
        print(f"  profiler: device busy {busy:.3f} ms of {wall:.3f} ms wall "
              f"(idle share {1 - busy / wall:.3f}) {tag}")
        for kname, ms_k, calls in top:
            print(f"    {ms_k:.4f} ms in {calls} call(s): {kname[:90]}")
    if not ok:
        raise SystemExit("chip_smoke: a calibrated batch did not run 3 K1 "
                         "int8 launches with int8 between layers and no "
                         "per-sample quantization")

    # ---- (e) timing: static row vs dynamic, and a batch in turns --------
    print(f"time: DCGAN layers at batch {BUCKET}, in turns: K1 int8 with the "
          f"static row (int8 out on d1/d2) / K1 int8 with the dynamic (B, "
          f"NC) scale, f32 out / K1 f32 / conv_transpose2d f32 (TF32 off; a "
          f"float yardstick) / the plain version of the static launch / "
          f"torch._int_mm on the GEMM's M x K x N operands (im2col left out, "
          f"N padded to a multiple of 8: a yardstick of cuBLASLt's int8 "
          f"GEMM rate, not the same function): device ms of one call (ahead "
          f"events; the profiler's median of 3 beside) and CUDA events over "
          f"20 back-to-back calls (median [min, max] of 7 rounds); bound at "
          f"the dense int8 tensor-core peak {tag}")
    per_layer = []
    for i, l in dcgan:
        _, p, xq, row, bias_l, act, od, _ = checked[f"dcgan/{l.name}"]
        x_dyn = randn(*xq.shape)
        xq_d, sxs = quantize_act(x_dyn)
        comb_d = (sxs[:, None] * p.wscale[None, :]).contiguous()
        g = geo(p, xq)
        lg = K.gemm_launch(xq.shape, p.ws.shape, p.stride, g["pad"],
                           g["crop"], g["out_space"], dtype="int8")
        pf = sd.plan((l.k, l.k, l.cin, l.cout), l.s,
                     same_deconv_pads(l.k, l.s), backend="fused", act=act,
                     device=dev).bind(randn(l.k, l.k, l.cin, l.cout,
                                            scale=0.05), None, p.bias)
        x_cf = x_dyn.permute(0, 3, 1, 2).contiguous()
        w_t = randn(l.cin, l.cout, l.k, l.k, scale=0.05)
        a_mat, b_mat = _int_mm_operands(xq, p.ws, lg.q_h - lg.plo_h,
                                        lg.q_w - lg.plo_w, lg.mh, lg.mw)
        fns = {
            "static": lambda: k1q(xq, p, row, bias_l, act, od),
            "dynamic": lambda: k1q(xq_d, p, comb_d, p.bias, act, None),
            "k1_f32": lambda: sd.execute(pf, x_dyn),
            "lib": lambda: F.conv_transpose2d(
                x_cf, w_t, p.bias, stride=l.s, padding=2, output_padding=1),
            "plain": lambda: K.sd_fused_ref(xq, p.ws, p.stride, bias=bias_l,
                                            act=act, scale=row, out_dtype=od,
                                            **g),
            "int_mm": lambda: torch._int_mm(a_mat, b_mat)}
        # the int_mm operands are the kernel's GEMM: its exact sums
        prod = fns["int_mm"]()[:, :lg.geom.n].double()
        im_ok = torch.equal(prod, a_mat.double() @ b_mat[:, :lg.geom.n]
                            .double())
        t = _time_ms(fns)
        dv = {n: _device_ms(f) for n, f in fns.items()}
        # int8 out against f32 out of the same static launch: the
        # scattered single-byte stores' cost over 4-byte ones
        st_f32 = (_device_ms(lambda: k1q(xq, p, row, bias_l, act, None))
                  if od is not None else None)
        y = fns["static"]()
        macs = BUCKET * l.macs()
        nbytes = (xq.numel() + p.ws.numel() + 4 * row.numel()
                  + 4 * bias_l.numel() + y.numel() * y.element_size())
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = 2.0 * macs / PEAK_INT8_OPS * 1e3
        grid = gemm_grid(lg.geom, lg.plan)
        rec = {"layer": f"dcgan/{l.name}", "out": str(y.dtype),
               "ms": dv["static"][1], "profiler_ms": dv["static"][0],
               "events_ms": t["static"][0], "events_ms_min": t["static"][1],
               "events_ms_max": t["static"][2],
               "dynamic_ms": dv["dynamic"][1],
               "dynamic_profiler_ms": dv["dynamic"][0],
               "dynamic_events_ms": t["dynamic"][0],
               "k1_f32_ms": dv["k1_f32"][1],
               "k1_f32_profiler_ms": dv["k1_f32"][0],
               "f32_library_ms": dv["lib"][1],
               "f32_library_profiler_ms": dv["lib"][0],
               "plain_ms": dv["plain"][1], "plain_events_ms": t["plain"][0],
               "int_mm_ms": dv["int_mm"][1],
               "int_mm_profiler_ms": dv["int_mm"][0],
               "int_mm_shape": [*a_mat.shape, b_mat.shape[1]],
               "int_mm_exact": im_ok, "library_ms": None,
               "static_f32_out_ms": None if st_f32 is None else st_f32[1],
               "static_f32_out_profiler_ms":
                   None if st_f32 is None else st_f32[0],
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "macs": macs, "bytes": nbytes, "plan": str(lg.plan),
               "grid": list(grid), "launches_per_batch": 1}
        per_layer.append(rec)
        stores = ("" if st_f32 is None else
                  f"; the same static launch with f32 out: device "
                  f"{st_f32[1]:.4f} ms (profiler {_ms_txt(st_f32[0])})")
        print(f"  dcgan/{l.name} {tuple(xq.shape)}->{tuple(y.shape)} "
              f"{rec['out'].replace('torch.', '')} out, {lg.plan}, grid "
              f"{grid[0]} x {grid[1]} x {grid[2]}: static row device "
              f"{rec['ms']:.4f} ms (profiler {_ms_txt(rec['profiler_ms'])}; "
              f"events {rec['events_ms']:.4f} [{rec['events_ms_min']:.4f}, "
              f"{rec['events_ms_max']:.4f}]), dynamic device "
              f"{rec['dynamic_ms']:.4f} ms (profiler "
              f"{_ms_txt(rec['dynamic_profiler_ms'])}; events "
              f"{rec['dynamic_events_ms']:.4f}), K1 f32 "
              f"{rec['k1_f32_ms']:.4f} (profiler "
              f"{_ms_txt(rec['k1_f32_profiler_ms'])}), conv_transpose2d f32 "
              f"{rec['f32_library_ms']:.4f} (profiler "
              f"{_ms_txt(rec['f32_library_profiler_ms'])}), plain "
              f"{rec['plain_ms']:.4f}, torch._int_mm "
              f"{' x '.join(map(str, rec['int_mm_shape']))} "
              f"{rec['int_mm_ms']:.4f} (profiler "
              f"{_ms_txt(rec['int_mm_profiler_ms'])}; its sums "
              f"{'equal' if im_ok else 'DIFFER FROM'} the f64 product){stores}"
              f"; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
              f"{nbytes} bytes); sm clock, power, temperature {_clocks()} "
              f"{tag}")
        if not im_ok:
            raise SystemExit("chip_smoke: the torch._int_mm yardstick's "
                             "operands are not the kernel's GEMM")
    d1 = per_layer[0]
    for name in ("", "dynamic_"):
        prof = d1[f"{name}profiler_ms"]
        gate_ms = prof if prof is not None else d1[f"{name}ms"]
        ok = gate_ms <= K1_INT8_D1_MS_LIMIT
        what = ("dynamic (B, NC) scale, f32 out" if name
                else "static row, int8 out")
        print(f"gate: K1 int8 ({what}) on dcgan/d1 at batch {BUCKET}: {gate_ms:.4f} ms of device "
              f"time ({'profiler' if prof is not None else 'ahead events'}), "
              f"limit {K1_INT8_D1_MS_LIMIT} ms {'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit("chip_smoke: K1 int8 on DCGAN d1 is over its "
                             "time limit")

    dyn = GenServer(nets=("dcgan",), device=dev, max_batch=BUCKET,
                    seed=SEED, dtype="int8")
    f32 = GenServer(nets=("dcgan",), device=dev, max_batch=BUCKET,
                    seed=SEED)
    servers = {"calibrated": server, "dynamic": dyn, "f32": f32}
    for srv in (dyn, f32):
        srv.warmup()
    host = {k: [] for k in servers}
    order = list(servers)
    for r in range(10):
        for name in (order if r % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            servers[name].run_group("dcgan", full)
            torch.cuda.synchronize()
            host[name].append((time.perf_counter() - t0) * 1e3)
    host_ms = {k: sorted(v)[len(v) // 2] for k, v in host.items()}
    breakdown = {k: (bd_cal if k == "calibrated" else _device_breakdown(
        lambda s=s: s.run_group("dcgan", full)))
        for k, s in servers.items()}
    print(f"batch calibrated: one DCGAN batch of {BUCKET} through run_group, "
          f"host clock (median of 10, synchronised, in turns): calibrated "
          f"int8 {host_ms['calibrated']:.3f} ms, dynamic int8 "
          f"{host_ms['dynamic']:.3f} ms, f32 {host_ms['f32']:.3f} ms {tag}")
    for name, bd in breakdown.items():
        if bd is None:
            print(f"  {name}: device time: not measured")
            continue
        busy, wall, _ = bd
        print(f"  {name} profiler: device busy {busy:.3f} ms of {wall:.3f} "
              f"ms wall (idle share {1 - busy / wall:.3f}) {tag}")

    # ---- (f) serve calibrated, chained int8 VoxGAN ----------------------
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_calib_")
    os.environ["REPRO_TORCH_SD_CALIB_CACHE"] = os.path.join(
        cache_dir, "sd_calib.json")
    try:
        vox = GenServer(nets=("voxgan",), device=dev, max_batch=BUCKET,
                        seed=SEED, backend="fused", dtype="int8", calib=64)
        vox.warmup()
        vreqs = vox.random_requests("voxgan", SERVE_REQUESTS, seed=1)
        torch.cuda.synchronize()
        zero_counts()
        vres, vstats = serve_async(vox, vreqs)
        torch.cuda.synchronize()
        vcounts = counts()
    finally:
        if old_env is None:
            os.environ.pop("REPRO_TORCH_SD_CALIB_CACHE", None)
        else:
            os.environ["REPRO_TORCH_SD_CALIB_CACHE"] = old_env
        shutil.rmtree(cache_dir, ignore_errors=True)
    vmodel, vparams = vox.model("voxgan")
    vz = torch.stack([r.latent for r in vreqs])
    vout = torch.stack([vres[r.rid] for r in vreqs])
    vref_m = GenerativeModel(vmodel.spec, "sd_kernel",
                             engine_backend="torch", device=dev,
                             engine_dtype="int8")
    vref_m.engine.set_calibration(
        {n: p.sx_in.item() for n, p in vmodel.engine.plans().items()})
    with torch.no_grad():
        vref = torch.cat([vref_m.apply(vparams, vz[j:j + BUCKET])
                          for j in range(0, SERVE_REQUESTS, BUCKET)])
    vwant = 3 * 2 * vstats["launches"]
    n_diff = int((vout != vref).sum())
    chained = [n for n, p in vmodel.engine.plans().items() if p.chain_out]
    ok = (vcounts["SD_CONV_INT8_LAUNCHES"] == vwant and vwant > 0
          and not any(v for n, v in vcounts.items()
                      if n != "SD_CONV_INT8_LAUNCHES")
          and vstats["served"] == SERVE_REQUESTS and not vstats["shed"]
          and bool(torch.isfinite(vout).all()) and n_diff == 0
          and tuple(vout.shape) == (SERVE_REQUESTS, 32, 32, 32, 1))
    vlat = vstats["latency_ms"]
    print(f"serve calibrated voxgan: {vstats['served']} VoxGAN requests "
          f"(full width, int8 calibrated on 64 latents, chained layers "
          f"{chained}) in {vstats['wall_s']:.4f} s host clock: "
          f"{vstats['req_per_s']:.1f} req/s, p50 {vlat['p50']} ms, p95 "
          f"{vlat['p95']} ms; launches {vcounts} (want "
          f"SD_CONV_INT8_LAUNCHES = 3 layers x 2 taps x "
          f"{vstats['launches']} batches); vs the card's int8 torch "
          f"backend with the same scales: {n_diff} of "
          f"{vout.numel()} elements differ (gate exact) "
          f"{'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit("chip_smoke: calibrated VoxGAN serving failed")
    # one VoxGAN batch of 16 calibrated / dynamic / f32, in turns
    vfull = [r.latent for r in vreqs[:BUCKET]]
    vservers = {"calibrated": vox}
    for name, dt in (("dynamic", "int8"), ("f32", torch.float32)):
        vservers[name] = GenServer(nets=("voxgan",), device=dev,
                                   max_batch=BUCKET, seed=SEED,
                                   backend="fused", dtype=dt)
        vservers[name].warmup()
    vhost = {k: [] for k in vservers}
    for r in range(10):
        for name in (list(vservers) if r % 2 == 0 else list(vservers)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vservers[name].run_group("voxgan", vfull)
            torch.cuda.synchronize()
            vhost[name].append((time.perf_counter() - t0) * 1e3)
    vhost_ms = {k: sorted(v)[len(v) // 2] for k, v in vhost.items()}
    vbreakdown = {k: _device_breakdown(
        lambda s=s: s.run_group("voxgan", vfull)) for k, s in vservers.items()}
    print(f"batch calibrated voxgan: one VoxGAN batch of {BUCKET} through "
          f"run_group, host clock (median of 10, synchronised, in turns): "
          f"calibrated int8 {vhost_ms['calibrated']:.3f} ms, dynamic int8 "
          f"{vhost_ms['dynamic']:.3f} ms, f32 {vhost_ms['f32']:.3f} ms {tag}")
    for name, bd in vbreakdown.items():
        if bd is None:
            print(f"  {name}: device time: not measured")
            continue
        busy, wall, top = bd
        print(f"  {name} profiler: device busy {busy:.3f} ms of {wall:.3f} "
              f"ms wall (idle share {1 - busy / wall:.3f}) {tag}")
        for kname, ms_k, calls in top:
            print(f"    {ms_k:.4f} ms in {calls} call(s): {kname[:90]}")

    tot = {k: _total(r[k] for r in per_layer)
           for k in ("ms", "profiler_ms", "events_ms", "plain_ms",
                     "plain_events_ms", "bound_ms", "dynamic_ms",
                     "dynamic_profiler_ms", "k1_f32_ms", "f32_library_ms",
                     "int_mm_ms", "macs", "bytes")}
    record = {
        "launches": launches, "max_abs_err": max_err, "ms": tot["ms"],
        "profiler_ms": tot["profiler_ms"], "events_ms": tot["events_ms"],
        "plain_ms": tot["plain_ms"],
        "plain_events_ms": tot["plain_events_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": ("operations" if 2.0 * tot["macs"] / PEAK_INT8_OPS
                     >= tot["bytes"] / PEAK_BYTES else "bytes"),
        "library_ms": None, "f32_library_ms": tot["f32_library_ms"],
        "k1_f32_ms": tot["k1_f32_ms"], "int_mm_ms": tot["int_mm_ms"],
        "ms_dynamic_same_rounds": tot["dynamic_ms"],
        "profiler_ms_dynamic_same_rounds": tot["dynamic_profiler_ms"]}
    return {"record": record, "per_layer": per_layer,
            "scales": scales, "code_diff": code_diff,
            "serve": {k: stats[k] for k in ("served", "launches",
                                            "req_per_s", "wall_s",
                                            "latency_ms")},
            "serve_counts": served_counts, "profile_counts": prof_counts,
            "quantize_act_calls": len(quant_calls), "k1_io_dtypes": seen,
            "vs_torch_max_abs": d, "vs_f32_rel": rel, "ssim": s_val,
            "batch_host_ms": host_ms, "batch_device": breakdown,
            "voxgan": {"serve": {k: vstats[k] for k in (
                "served", "launches", "req_per_s", "wall_s",
                "latency_ms")}, "counts": vcounts,
                "elements_differ": n_diff, "chained": chained,
                "batch_host_ms": vhost_ms, "batch_device": vbreakdown}}


def _sass_counts(path, kernel: str) -> dict:
    """Counts of tensor-core (HGMMA: wgmma; HMMA: mma.sync, and
    HMMA_TF32 those of them on TF32 operands; IMMA: integer mma.sync),
    dp4a (IDP.4A) and TMA-load (UTMALDG) instructions in the SASS of
    every function of the library at
    ``path`` whose (mangled) name holds ``kernel``, from ``cuobjdump
    -sass``."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise SystemExit(f"chip_smoke: cuobjdump failed: {out.stderr}")
    counts = {"functions": 0, "HGMMA": 0, "UTMALDG": 0, "HMMA": 0,
              "HMMA_TF32": 0, "IMMA": 0, "IDP.4A": 0}
    inside = False
    for line in out.stdout.splitlines():
        if "Function :" in line:
            inside = kernel in line
            counts["functions"] += inside
        elif inside:
            for op in ("HGMMA", "UTMALDG", "HMMA", "IMMA", "IDP.4A"):
                counts[op] += f" {op}." in line or f" {op} " in line
            counts["HMMA_TF32"] += " HMMA." in line and ".TF32" in line
    return counts


def _k5_plain(q, k, v, causal=True):
    """K5's plain version one sample at a time (the serving shape's f32
    scores take 2.1 GB per sample)."""
    import torch
    import repro_torch.kernels.flash_attn as FA
    return torch.cat([FA.flash_attention_ref(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=causal)
        for i in range(q.shape[0])])


def _k5_gate(out, ref, dtype):
    """(ok, text, max|d|, element share) of K5's output against the plain
    version's f32 one: f32 within K5_F32_GATE * max(1, max|ref|); bf16
    within BF16_GATE * max|ref| and, element by element, within
    K5_BF16_REL * |ref| + K5_BF16_FLOOR * max|ref|."""
    import torch
    f32 = dtype == torch.float32
    dmax, tol = _gate_err(out, ref, K5_F32_GATE if f32 else BF16_GATE, f32)
    ok = dmax <= tol
    text = f"max|d| {dmax:.3e} tol {tol:.3e} ({dmax / tol:.3f} of it)"
    worst = 0.0
    if not f32:
        lim = K5_BF16_REL * ref.abs() + K5_BF16_FLOOR * ref.abs().max()
        worst = ((out.float() - ref).abs() / lim).max().item()
        ok = ok and worst <= 1.0
        text += f"; element by element {worst:.3f} of its limit"
    return ok, text, dmax, worst


@contextlib.contextmanager
def _plain_scan():
    """Hold ``blockwise_attention`` to its plain scan, the reference of
    the LM's long-prompt attention, while the block runs."""
    from repro_torch.models import layers as L
    real = L._in_k5_contract
    L._in_k5_contract = lambda *a: False
    try:
        yield
    finally:
        L._in_k5_contract = real


def _lm_phase(dev, tag: str) -> dict:
    """Phase 10: K5 and the dense LM serving path.  (a) HGMMA and UTMALDG
    in the SASS of K5's bf16 kernel, TF32 HMMA in its f32 kernel's; (b)
    K5 against its plain version ``flash_attention_ref`` (TF32 off) at
    the serving shape (bf16 and f32, grouped heads; the plain version one
    sample at a time) and on D x S x causal x dtype cases with grouped
    heads: f32 within ``2e-5 * max(1, max|ref|)``, bf16 within ``1e-2 *
    max|ref|`` of the plain version in f32 on the same bf16 inputs and,
    element by element, within ``2^-7 |ref| + 1e-4 max|ref|``; (c) at the
    serving shape, K5 bf16, K5 f32, its plain version and
    ``F.scaled_dot_product_attention`` (a yardstick the port never calls)
    in turns, device time from the profiler, K5 bf16 at most
    ``K5_BF16_MS_LIMIT`` and K5 f32 at most ``K5_F32_MS_LIMIT``; (d)
    StableLM-2-12B widths at depth 2 in f32: ``LM_GATE_PROMPTS`` prompts
    of ``LM_GATE_LEN`` tokens (K5's launches at LM_K5_SHAPE) through
    ``prefill`` with K5 and with the plain scan, last-token logits within
    ``1e-4 * max(1, max|ref|)``, then 8 greedy decode tokens from each,
    and one f32 prefill under the profiler; (e) StableLM-2-12B at all 40
    layers (bf16 weights drawn leaf by leaf, bf16 compute) serving 8
    prompts of 4,080 tokens through ``launch/serve.serve`` with 4 slots
    and ``max_len`` 4,096: 40 K5 launches per prefill group and none in
    decode, finite logits, the first group's prefill logits against the
    plain scan within ``5e-2 * max|ref|``.  Returns K5's record and the
    reports."""
    import dataclasses
    import numpy as np
    import torch
    import torch.nn.functional as F
    import repro_torch.kernels.flash_attn as FA
    from repro_torch.configs import get
    from repro_torch.launch.serve import random_prompts, serve
    from repro_torch.models.lm import build_lm

    from repro_torch.kernels.build import load

    gen = torch.Generator().manual_seed(SEED)
    lib = load("flash_attn")
    sass = _sass_counts(lib.path, "flash_attn_wgmma")
    serial = (f"{lib.ptxas.count('C7515')} ptxas warnings that it "
              f"serialized wgmma (C7515)" if lib.ptxas
              else "ptxas's report not kept (a cached build)")
    print(f"sass: K5 bf16 ({sass['functions']} instantiations of "
          f"flash_attn_wgmma_kernel in {lib.path.name}): {sass['HGMMA']} "
          f"HGMMA, {sass['UTMALDG']} UTMALDG instructions; {serial} {tag}")
    if not (sass["functions"] and sass["HGMMA"] and sass["UTMALDG"]):
        raise SystemExit("chip_smoke: K5's bf16 kernel has no HGMMA or no "
                         "UTMALDG in its SASS")
    sass_f32 = _sass_counts(lib.path, "flash_attn_kernel")
    print(f"sass: K5 f32 ({sass_f32['functions']} instantiations of "
          f"flash_attn_kernel in {lib.path.name}): {sass_f32['HMMA']} HMMA, "
          f"{sass_f32['HMMA_TF32']} of them on TF32 operands (HMMA...TF32) "
          f"{tag}")
    if not (sass_f32["functions"] and sass_f32["HMMA_TF32"]):
        raise SystemExit("chip_smoke: K5's f32 kernel has no TF32 HMMA in "
                         "its SASS")

    def qkv(b, h, hkv, s, d, dtype):
        return tuple((torch.randn(b, n, s, d, generator=gen) * 0.5)
                     .to(dev, dtype) for n in (h, hkv, hkv))

    plain, gate = _k5_plain, _k5_gate

    # ---- (b) K5 against its plain version ------------------------------
    print(f"check: K5 vs flash_attention_ref, TF32 off: f32 gate "
          f"{K5_F32_GATE}*max(1,max|ref|), bf16 gate {BF16_GATE}*max|ref| "
          f"and element by element {K5_BF16_REL}*|ref| + "
          f"{K5_BF16_FLOOR}*max|ref| (the plain version in f32 on the bf16 "
          f"inputs) {tag}")
    cases = [(*LM_K5_SHAPE, torch.bfloat16, True),
             (*LM_K5_SHAPE, torch.float32, True)]
    for d in K5_SWEEP_D:
        for s in K5_SWEEP_S:
            for causal in (True, False):
                for dtype in (torch.float32, torch.bfloat16):
                    cases.append((2, 4, 2, s, d, dtype, causal))
    for dtype in (torch.float32, torch.bfloat16):     # the serving grouping
        cases.append((1, 32, 8, 300, 160, dtype, True))
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_share = 0.0
    failures = []
    for b, h, hkv, s, d, dtype, causal in cases:
        q, k, v = qkv(b, h, hkv, s, d, dtype)
        out = FA.flash_attention(q, k, v, causal=causal)
        ref = plain(q.float(), k.float(), v.float(), causal)
        torch.cuda.synchronize()
        ok, text, dmax, share = gate(out, ref, dtype)
        err[dtype] = max(err[dtype], dmax)
        worst_share = max(worst_share, share)
        ok = ok and out.dtype == dtype and out.shape == q.shape
        if (b, h, hkv, s, d) == LM_K5_SHAPE or not ok or s == 2049:
            print(f"  ({b}, {h}/{hkv} heads, S {s}, D {d}) "
                  f"{str(dtype)[6:]} {'causal' if causal else 'full'} "
                  f"{text} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append((b, h, hkv, s, d, str(dtype), causal))
    print(f"  {len(cases)} cases: the serving shape in bf16 and f32; D in "
          f"{K5_SWEEP_D}, S in {K5_SWEEP_S}, causal and full, f32 and bf16, "
          f"4 q / 2 kv heads; 32 q / 8 kv heads at S 300, D 160; max|d| "
          f"f32 {err[torch.float32]:.3e}, bf16 {err[torch.bfloat16]:.3e}; "
          f"bf16 at most {worst_share:.3f} of the element limit")
    if failures:
        raise SystemExit(f"chip_smoke: K5 disagrees with its plain version "
                         f"on {failures}")

    # ---- (c) timing at the serving shape --------------------------------
    b, h, hkv, s, d = LM_K5_SHAPE
    q, k, v = qkv(b, h, hkv, s, d, torch.bfloat16)
    q32, k32, v32 = q.float(), k.float(), v.float()
    fns = {"k5": lambda: FA.flash_attention(q, k, v),
           "k5_f32": lambda: FA.flash_attention(q32, k32, v32),
           "plain": lambda: plain(q32, k32, v32),
           "sdpa": lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True),
           "sdpa_f32": lambda: F.scaled_dot_product_attention(
               q32, k32, v32, is_causal=True, enable_gqa=True)}
    ev = _time_ms(fns, reps=5, iters=3)
    dev_ms = {n: [] for n in fns}
    for r in range(3):
        for n in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            br = _device_breakdown(fns[n])
            if br is not None:        # a profiled call may report nothing
                dev_ms[n].append(br[0])
    dev_ms = {n: sorted(x)[(len(x) - 1) // 2] if x else float("nan")
              for n, x in dev_ms.items()}
    flops = 2.0 * b * h * d * s * (s + 1)           # causal pairs only
    nbytes = 2 * (2 * b * h * s * d + 2 * b * hkv * s * d)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    # the bf16 kernel's P.V runs twice (P = P_hi + P_lo): 1.5x the work
    t_split = 1.5 * t_ops
    # the f32 kernel: its useful work on the CUDA cores, twice the bytes;
    # and the 3xTF32 work it does at the TF32 tensor cores
    t_f32 = max(flops / PEAK_F32_FLOPS * 1e3, 2 * t_bytes)
    t_f32_tc = max(3 * flops / PEAK_TF32_FLOPS * 1e3, 2 * t_bytes)
    measured = {n: dev_ms[n] if math.isfinite(dev_ms[n]) else ev[n][0]
                for n in fns}
    src = {n: "profiler" if math.isfinite(dev_ms[n]) else "CUDA events"
           for n in fns}
    print(f"time: K5 at the serving shape ({b}, {h} q / {hkv} kv heads, S "
          f"{s}, D {d}, causal), in turns: device time from the "
          f"profiler (median of the 3 profiled calls that report any) / "
          f"CUDA events over 3 calls (median [min, max] of 5; taken as the "
          f"time where the profiler reports none): {tag}")
    for n, label in (("k5", "K5 bf16 (wgmma + TMA)"),
                     ("k5_f32", "K5 f32 (3xTF32 mma.sync), the same "
                                "inputs in f32"),
                     ("plain", "plain (per sample, f32)"),
                     ("sdpa", "F.scaled_dot_product_attention bf16"),
                     ("sdpa_f32", "F.scaled_dot_product_attention f32")):
        print(f"  {label}: {dev_ms[n]:.3f} ms device / {ev[n][0]:.3f} ms "
              f"[{ev[n][1]:.3f}, {ev[n][2]:.3f}] events; taken: {src[n]}")
    print(f"  bound {max(t_ops, t_bytes):.3f} ms at the useful work "
          f"({'operations' if t_ops >= t_bytes else 'bytes'}: {flops:.3e} "
          f"at the 989 TFLOP/s bf16 tensor cores; {nbytes / 1e6:.1f} MB), "
          f"{max(t_split, t_bytes):.3f} ms at the split's work (1.5x); f32 "
          f"bound at the 67 TFLOP/s CUDA cores {t_f32:.3f} ms; K5 bf16 at "
          f"{flops / measured['k5'] / 1e9:.1f} TFLOP/s useful, "
          f"{max(t_split, t_bytes) / measured['k5']:.3f} of the split "
          f"bound, {measured['k5'] / measured['sdpa']:.2f}x SDPA; sm clock, "
          f"power, temperature {_clocks()} {tag}")
    print(f"  K5 f32 bounds: {t_f32:.3f} ms at the useful work on the "
          f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s CUDA cores, {t_f32_tc:.3f} "
          f"ms at its 3xTF32 work (3x) on the "
          f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32 tensor cores; K5 f32 "
          f"{measured['k5_f32']:.3f} ms ({src['k5_f32']}) at "
          f"{flops / measured['k5_f32'] / 1e9:.1f} TFLOP/s useful, "
          f"{t_f32_tc / measured['k5_f32']:.3f} of the 3xTF32 bound, "
          f"{t_f32 / measured['k5_f32']:.3f} of the CUDA-core one, "
          f"{measured['k5_f32'] / measured['sdpa_f32']:.3f}x SDPA f32 "
          f"({measured['sdpa_f32']:.3f} ms, {src['sdpa_f32']}); limit "
          f"{K5_F32_MS_LIMIT} ms {tag}")
    if measured["k5"] > K5_BF16_MS_LIMIT:
        raise SystemExit(f"chip_smoke: K5 bf16 took {measured['k5']:.3f} ms "
                         f"at the serving shape, over {K5_BF16_MS_LIMIT} ms")
    if measured["k5_f32"] > K5_F32_MS_LIMIT:
        raise SystemExit(f"chip_smoke: K5 f32 took "
                         f"{measured['k5_f32']:.3f} ms at the serving shape, "
                         f"over {K5_F32_MS_LIMIT} ms")
    del q, k, v, q32, k32, v32
    torch.cuda.empty_cache()

    # ---- (d) path gate in f32 at StableLM-2-12B widths, depth 2 --------
    cfg32 = dataclasses.replace(get(LM_ARCH), n_layers=2,
                                compute_dtype="float32")
    lm = build_lm(cfg32, device=dev)
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED))
    toks = torch.tensor(random_prompts(cfg32.vocab_size, LM_GATE_PROMPTS,
                                       LM_GATE_LEN, seed=SEED),
                        dtype=torch.int32, device=dev)
    runs = {}
    with torch.no_grad():
        for name in ("k5", "scan"):
            FA.FLASH_ATTN_LAUNCHES = 0
            held = _plain_scan() if name == "scan" \
                else contextlib.nullcontext()
            with held:
                cache = lm.init_cache(LM_GATE_PROMPTS, LM_GATE_LEN + 16)
                lg, cache = lm.prefill(params, {"inputs": toks}, cache)
            n_k5 = FA.FLASH_ATTN_LAUNCHES
            out, t, logits = [], torch.argmax(lg, -1).to(torch.int32), [lg]
            for _ in range(LM_GATE_DECODE):
                out.append(t[:, 0].tolist())
                lgd, cache = lm.decode_step(params, {"inputs": t}, cache)
                logits.append(lgd)
                t = torch.argmax(lgd, -1).to(torch.int32)
            runs[name] = (lg, n_k5, out, logits)
    gate_d, tol = _gate_err(runs["k5"][0], runs["scan"][0], 1e-4, True)
    ok = (gate_d <= tol and runs["k5"][1] == 2 and runs["scan"][1] == 0
          and bool(torch.isfinite(runs["k5"][0]).all()))
    print(f"path: {LM_ARCH} widths at depth 2, f32 compute, TF32 off, "
          f"{LM_GATE_PROMPTS} prompts of {LM_GATE_LEN} tokens: prefill "
          f"through K5 ("
          f"{runs['k5'][1]} launches) vs the plain scan ({runs['scan'][1]}):"
          f" last-token logits max|d| {gate_d:.3e} tol {tol:.3e} "
          f"{'ok' if ok else 'FAIL'} {tag}")
    for name in ("k5", "scan"):
        print(f"  {LM_GATE_DECODE} greedy tokens ({name}): "
              f"{[list(r) for r in zip(*runs[name][2])]}")
    for i, (a, b_) in enumerate(zip(runs["k5"][2], runs["scan"][2])):
        for row, (ta, tb) in enumerate(zip(a, b_)):
            if ta != tb:
                top2 = torch.topk(runs["scan"][3][i][row, 0], 2).values
                margin = (top2[0] - top2[1]).item()
                print(f"  token {i} of prompt {row} differs: {ta} vs {tb}, "
                      f"the scan's top-2 margin {margin:.3e}")
    if not ok:
        raise SystemExit("chip_smoke: the LM prefill through K5 disagrees "
                         "with the plain scan")
    del runs, cache
    torch.cuda.empty_cache()
    with torch.no_grad():
        pbr = _device_breakdown(lambda: lm.prefill(
            params, {"inputs": toks},
            lm.init_cache(LM_GATE_PROMPTS, LM_GATE_LEN + 16)), top=1000)
    if pbr is None:
        pbusy = pwall = pk5 = float("nan")
        print("  one f32 prefill under the profiler: not measured (no "
              "device time reported)")
    else:
        pbusy, pwall, ptop = pbr
        pk5 = sum(ms for name, ms, _ in ptop if "flash_attn" in name)
        print(f"  one f32 prefill under the profiler: device busy "
              f"{pbusy:.3f} ms of {pwall:.3f} ms wall (busy share "
              f"{pbusy / pwall:.3f}); K5 f32 {pk5:.3f} ms ({pk5 / pbusy:.3f} "
              f"of busy, {pk5 / cfg32.n_layers:.3f} ms per launch on the "
              f"LM's (B, S, H, D) views) {tag}")
        for name, ms_k, calls in ptop[:6]:
            print(f"    {ms_k:.3f} ms in {calls} call(s): {name[:90]}")
    del lm, params
    torch.cuda.empty_cache()

    # ---- (e) serve StableLM-2-12B at all its layers --------------------
    # param_dtype bf16: init rounds each f32 draw to bf16 as it is made,
    # the values that serve's one cast of the f32 tree would give
    cfg = dataclasses.replace(get(LM_ARCH), n_layers=LM_SERVE_LAYERS,
                              param_dtype=get(LM_ARCH).compute_dtype)
    lm = build_lm(cfg, device=dev)
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = lm.param_counts(params)[0]
    prompts = random_prompts(cfg.vocab_size, LM_REQUESTS, LM_PROMPT_LEN,
                             seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    FA.FLASH_ATTN_LAUNCHES = 0
    results, stats = serve(cfg, prompts, max_new=LM_MAX_NEW, slots=LM_SLOTS,
                           max_len=LM_MAX_LEN, params=params, device=dev)
    torch.cuda.synchronize()
    launches = FA.FLASH_ATTN_LAUNCHES
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    groups = len(stats["prefill_ms"])
    dec = sorted(stats["decode_ms"])
    print(f"serve: {cfg.name} at {LM_SERVE_LAYERS} of "
          f"{get(LM_ARCH).n_layers} layers (d_model "
          f"{cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv_heads} kv heads of "
          f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
          f"{n_params / 1e9:.3f} B params drawn in f32 and rounded to "
          f"{cfg.param_dtype} leaf by leaf in {init_s:.3f} s, "
          f"{cfg.compute_dtype} compute): {len(results)} prompts of "
          f"{LM_PROMPT_LEN} "
          f"tokens, {LM_MAX_NEW} new tokens each, {LM_SLOTS} slots, max_len "
          f"{LM_MAX_LEN}, in {stats['wall_s']:.3f} s host clock; peak "
          f"memory {peak_gib:.2f} GiB {tag}")
    print(f"  prefill per group of {LM_SLOTS} (host clock, ends in reading "
          f"the tokens): {[round(x, 3) for x in stats['prefill_ms']]} ms; "
          f"decode per step: median {dec[len(dec) // 2]:.3f} ms [min "
          f"{dec[0]:.3f}, max {dec[-1]:.3f}] over {len(dec)} steps")
    print(f"  K5 launches in the serving run: {launches} ({groups} prefill "
          f"groups x {LM_SERVE_LAYERS} layers expected)")
    ok = (launches == groups * LM_SERVE_LAYERS and groups == 2
          and sorted(results) == list(range(LM_REQUESTS))
          and all(len(t) == LM_MAX_NEW and all(0 <= x < cfg.vocab_size
                                                for x in t)
                  for t in results.values()))
    if not ok:
        raise SystemExit("chip_smoke: LM serving did not run K5 once per "
                         "layer per prefill group, or its tokens are wrong")
    batch = {"inputs": torch.tensor(prompts[:LM_SLOTS], dtype=torch.int32,
                                    device=dev)}
    with torch.no_grad():
        FA.FLASH_ATTN_LAUNCHES = 0
        cache = lm.init_cache(LM_SLOTS, LM_MAX_LEN)
        lg, cache = lm.prefill(params, batch, cache)
        n_prefill = FA.FLASH_ATTN_LAUNCHES
        tok = torch.argmax(lg, -1).to(torch.int32)
        FA.FLASH_ATTN_LAUNCHES = 0
        lgd, cache = lm.decode_step(params, {"inputs": tok}, cache)
        torch.cuda.synchronize()
        n_decode = FA.FLASH_ATTN_LAUNCHES
        with _plain_scan():
            ref, _ = lm.prefill(params, batch, lm.init_cache(LM_SLOTS,
                                                          LM_MAX_LEN))
    dmax, tol = _gate_err(lg, ref, LM_BF16_GATE, False)
    finite = bool(torch.isfinite(lg).all() and torch.isfinite(lgd).all())
    same = torch.equal(torch.argmax(lg, -1), torch.argmax(ref, -1))
    print(f"  first group's prefill: {n_prefill} K5 launches, one decode "
          f"step {n_decode}; logits finite={finite}; vs the plain scan on "
          f"the same weights max|d| {dmax:.3e} tol {tol:.3e} "
          f"({LM_BF16_GATE}*max|ref|), greedy tokens equal {same} {tag}")
    for row in range(lg.shape[0]):
        ta, tb = (torch.argmax(t[row, 0]).item() for t in (lg, ref))
        if ta != tb:
            top2 = torch.topk(ref[row, 0], 2).values
            print(f"    prompt {row}: token {ta} vs the scan's {tb}, the "
                  f"scan's top-2 margin {(top2[0] - top2[1]).item():.3e}")
    if not (finite and dmax <= tol and n_prefill == LM_SERVE_LAYERS
            and n_decode == 0):
        raise SystemExit("chip_smoke: the served LM's prefill is wrong")
    tok = torch.argmax(lgd, -1).to(torch.int32)
    with torch.no_grad():
        dbr = _device_breakdown(lambda: lm.decode_step(
            params, {"inputs": tok}, cache))
    if dbr is None:
        dbusy = dwall = float("nan")
        print("  one decode step under the profiler: not measured")
    else:
        dbusy, dwall, dtop = dbr
        print(f"  one decode step under the profiler: device busy "
              f"{dbusy:.3f} ms of {dwall:.3f} ms wall (busy share "
              f"{dbusy / dwall:.3f}) {tag}")
        for name, ms_k, calls in dtop:
            print(f"    {ms_k:.3f} ms in {calls} call(s): {name[:90]}")
    del ref, cache
    torch.cuda.empty_cache()
    br = _device_breakdown(lambda: lm.prefill(
        params, batch, lm.init_cache(LM_SLOTS, LM_MAX_LEN)))
    if br is None:
        busy = wall = k5_ms = float("nan")
        print("  one prefill under the profiler: not measured (no device "
              "time reported)")
    else:
        busy, wall, top = br
        k5_ms = sum(ms for name, ms, _ in top if "flash_attn" in name)
        print(f"  one prefill under the profiler: device busy {busy:.3f} ms "
              f"of {wall:.3f} ms wall (busy share {busy / wall:.3f}); K5 "
              f"{k5_ms:.3f} ms ({k5_ms / busy:.3f} of busy, "
              f"{k5_ms / LM_SERVE_LAYERS:.3f} ms per launch on the LM's "
              f"(B, S, H, D) views) {tag}")
        for name, ms_k, calls in top:
            print(f"    {ms_k:.3f} ms in {calls} call(s): {name[:90]}")
    del params, lm
    torch.cuda.empty_cache()
    record = {"name": "flash_attn", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
              "replaces": "src/repro/kernels/flash_attn.py:81",
              "launches": launches, "max_abs_err": err[torch.float32],
              "max_abs_err_bf16": err[torch.bfloat16],
              "ms": measured["k5"], "plain_ms": measured["plain"],
              "bound_ms": max(t_ops, t_bytes),
              "bound_by": "operations" if t_ops >= t_bytes else "bytes",
              "bound_split_ms": max(t_split, t_bytes),
              "library_ms": measured["sdpa"], "ms_events": ev["k5"][0],
              "ms_f32": measured["k5_f32"], "bound_f32_ms": t_f32,
              "bound_f32_tc_ms": t_f32_tc,
              "library_f32_ms": measured["sdpa_f32"],
              "sass_bf16": sass, "sass_f32": sass_f32}
    report = {"k5_device_ms": dev_ms, "k5_events_ms": ev,
              "path_gate_max_abs": gate_d,
              "f32_prefill_device": {"busy_ms": pbusy, "wall_ms": pwall,
                                     "k5_ms": pk5},
              "serve_gate_max_abs": dmax,
              "serve": {"prefill_ms": stats["prefill_ms"],
                        "decode_ms": stats["decode_ms"],
                        "wall_s": stats["wall_s"], "peak_gib": peak_gib,
                        "k5_launches": launches, "params": n_params},
              "prefill_device": {"busy_ms": busy, "wall_ms": wall,
                                 "k5_ms": k5_ms,
                                 "k5_ms_per_launch": k5_ms / LM_SERVE_LAYERS},
              "decode_device": {"busy_ms": dbusy, "wall_ms": dwall}}
    return {"kernel": record, "report": report}


def _wavegan_phase(dev, tag, randn) -> dict:
    """Phase 11: rank 1, full-width WaveGAN through H=1 launches of the
    2-D kernels.  (a) K1 f32 against its plain version on WaveGAN's three
    layers at batch 16, 1-D odd geometries and forced ``GemmPlan``s, up1
    twice with split-K bit-identical; (b) K1 int8 (dynamic rows and a
    static row; int8 out on up1/up2, f32 out on to_audio) bit-identical
    to its plain version, and every code at +-127 on up1 exact against
    int64; (c) K4 on ``wavegan-dryrun``'s layers and on WaveGAN's widths
    at k17/s4 (5 taps) against ``sd_wino_ref`` and K1; (d) K2 and K3 on
    each layer's backward against their plain versions, and full
    WaveGAN's ``J_G^T c`` on fused against the torch backend; (e) 48
    requests served in f32, dynamic int8 and calibrated int8; (f) the
    winograd dryrun through K4; (g) per-layer device times in turns and
    a batch of 16 f32 / dynamic / calibrated in turns.  Returns the
    launches and times each kernel's record takes, and the report."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    import torch.nn.functional as F
    import repro_torch.kernels.sd_conv as K
    from repro_torch import sd
    from repro_torch.core.accounting import WORKLOADS
    from repro_torch.core.deconv import same_deconv_pads
    from repro_torch.core.quant import quantize_act
    from repro_torch.kernels import ops
    from repro_torch.kernels import winograd as W
    from repro_torch.kernels.autotune import GemmPlan, gemm_grid
    from repro_torch.launch import serve_gen
    from repro_torch.launch.serve_gen import (GenServer, reduced_specs,
                                              serve_async)
    from repro_torch.models.generative import GenerativeModel
    from repro_torch.sd.grad import split_cotangent

    names = ("SD_FUSED_LAUNCHES", "SD_FUSED_INT8_LAUNCHES",
             "SD_CONV_LAUNCHES", "SD_CONV_INT8_LAUNCHES",
             "SD_FILTER_GRAD_LAUNCHES")

    def zero_counts():
        for n in names:
            setattr(K, n, 0)
        W.SD_WINO_LAUNCHES = 0

    def counts():
        out = {n: getattr(K, n) for n in names}
        out["SD_WINO_LAUNCHES"] = W.SD_WINO_LAUNCHES
        return out

    layers = WORKLOADS["wavegan"]().deconv_layers()
    acts = ("relu", "relu", "linear")       # the engine's epilogues

    def h1_geo(p, length):
        """What ``ops.sd_deconv_presplit_fused_1d`` hands the 2-D kernel."""
        return dict(pad=((0, 0), (p.pi[0],) * 2),
                    crop=(0, p.pk[0] + p.padding[0][0]),
                    out_space=(1, p.out_shape((length,))[0]))

    def h1_gemm(p, batch, length, tile=None, dtype=""):
        """K1's GEMM launch for a rank-1 plan's H=1 launch."""
        geo = h1_geo(p, length)
        return K.gemm_launch((batch, 1, length, p.cin), (1, *p.ws.shape),
                             (1, p.stride[0]), geo["pad"], geo["crop"],
                             geo["out_space"], tile, dtype=dtype)

    def case(k, s, cin, cout, batch, length, act, pad="same", op=0,
             tile=None, dtype="native"):
        x = randn(batch, length, cin)
        w = randn(k, cin, cout, scale=1.0 / (k * cin) ** 0.5)
        gamma = randn(cout, scale=0.1) + 1.0
        bias = randn(cout, scale=0.1)
        pads = same_deconv_pads((k,), (s,)) if pad == "same" else pad
        p = sd.plan(w.shape, s, pads, backend="fused", act=act,
                    output_padding=op, tile=tile, dtype=dtype,
                    device=dev).bind(w, gamma, bias)
        return x, w, p

    def k1(x, p, scale=None, out_dtype=None, bias=None):
        return ops.sd_deconv_presplit_fused_1d(
            x, p.ws, p.kernel, p.stride, p.padding,
            output_padding=p.output_padding,
            bias=p.bias if bias is None else bias, act=p.act, scale=scale,
            out_dtype=out_dtype, plan=p.tile)

    def plain(x, p, scale=None, out_dtype=None, bias=None):
        return K.sd_fused_ref(x[:, None], p.ws[None], (1, p.stride[0]),
                              bias=p.bias if bias is None else bias,
                              act=p.act, scale=scale, out_dtype=out_dtype,
                              **h1_geo(p, x.shape[1]))[:, 0]

    report = {}
    failures = []

    # ---- (a) K1 f32 as an H=1 launch -----------------------------------
    print(f"check: WaveGAN (fc 100 -> 16x64, deconvs k25/s4 64 -> 32 -> 16 "
          f"-> 1, 16 -> 64 -> 256 -> 1024 samples): K1 f32 as an H=1 launch "
          f"((1, 7) filter, (1, 4) interleave) vs sd_fused_ref, gate "
          f"{F32_GATE}*max(1,max|ref|) {tag}")
    cases = []
    for l, act in zip(layers, acts):
        for tile in (None, GemmPlan(16, 2), GemmPlan(32, 3),
                     GemmPlan(64, 5)):
            cases.append((f"wavegan/{l.name} batch {BUCKET}", l.k, l.s,
                          l.cin, l.cout, BUCKET, l.in_hw[0], act, "same", 0,
                          tile))
    cases += [("1-D op > pad_hi, k5/s3", 5, 3, 3, 2, 2, 10, "tanh", 1, 2,
               None),
              ("1-D asymmetric pads (3, 5), k9/s2, op 1", 9, 2, 5, 3, 2, 7,
               "tanh", (3, 5), 1, GemmPlan(16, 2)),
              ("1-D Cin 70, k25/s4", 25, 4, 70, 5, 3, 13, "relu", "same", 0,
               GemmPlan(32, 4))]
    k1_err = bwd_err = 0.0
    for label, k, s, cin, cout, b, length, act, pad, op, tile in cases:
        x, _, p = case(k, s, cin, cout, b, length, act, pad, op, tile)
        before = K.SD_FUSED_LAUNCHES
        out = k1(x, p)
        n = K.SD_FUSED_LAUNCHES - before
        ref = plain(x, p)
        torch.cuda.synchronize()
        d, tol = _gate_err(out, ref, F32_GATE, True)
        k1_err = max(k1_err, d)
        g = h1_gemm(p, b, length, tile)
        ok = d <= tol and n == 1 and out.shape == ref.shape \
            and out.is_contiguous()
        print(f"  {label} {tuple(x.shape)}->{tuple(out.shape)} GEMM {g.geom.m}"
              f" x {g.geom.n} x {g.geom.k}, {g.plan}: {n} launch, max|d| "
              f"{d:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"K1 {label} {g.plan}")
    x, _, p = case(25, 4, 64, 32, BUCKET, 16, "relu", tile=GemmPlan(64, 4))
    same = torch.equal(k1(x, p), k1(x, p))
    print(f"  wavegan/up1 K1 run twice with {p.tile} (split-K): "
          f"{'bit-identical' if same else 'DIFFERS'}")
    if not same:
        failures.append("K1 split-K on up1 not deterministic")

    # ---- (b) K1 int8 as an H=1 launch ----------------------------------
    print(f"check: WaveGAN K1 int8 as an H=1 launch vs sd_fused_ref on the "
          f"int8 pair (exact sums), batch {BUCKET}: dynamic (B, NC) rows and "
          f"a static (1, NC) row, f32 out; int8 out (relu, saturating "
          f"codes) on up1/up2; gate 0 elements different {tag}")
    for l, act in zip(layers, acts):
        x, _, p = case(l.k, l.s, l.cin, l.cout, BUCKET, l.in_hw[0], act,
                       dtype="int8")
        xq, sxs = quantize_act(x)
        comb = (sxs[:, None] * p.wscale[None, :]).contiguous()
        runs = [("dynamic rows, f32 out", comb, None, None),
                ("static row, f32 out", comb[:1].contiguous(), None, None)]
        if act == "relu":
            runs.append(("static row, int8 out", (comb[:1] * 2000)
                         .contiguous(), torch.int8, p.bias * 50))
        for what, sc, od, bias in runs:
            before = K.SD_FUSED_INT8_LAUNCHES
            out = k1(xq, p, sc, od, bias)
            n = K.SD_FUSED_INT8_LAUNCHES - before
            ref = plain(xq, p, sc, od, bias)
            torch.cuda.synchronize()
            n_diff = int((out != ref).sum())
            sat = int((out.abs() == 127).sum()) if od is not None else None
            ok = (n_diff == 0 and n == 1 and out.dtype == ref.dtype
                  and (sat is None or sat > 0))
            print(f"  wavegan/{l.name} {what} {tuple(xq.shape)}->"
                  f"{tuple(out.shape)}: {n} launch, {n_diff} elements differ"
                  f"{'' if sat is None else f', {sat} codes at +-127'} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"K1 int8 wavegan/{l.name} {what}")
    l = layers[0]
    gsat = torch.Generator().manual_seed(SEED)
    sample = torch.where(torch.rand(BUCKET, 1, 1, generator=gsat) < 0.5,
                         127, -127)
    column = torch.where(torch.rand(l.cout * l.s, generator=gsat) < 0.5,
                         127, -127)
    xq = sample.expand(BUCKET, l.in_hw[0], l.cin).to(torch.int8).contiguous()
    ws = column.expand(7, l.cin, l.cout * l.s).to(torch.int8).contiguous()
    p = sd.plan((l.k, l.cin, l.cout), l.s, same_deconv_pads((l.k,), (l.s,)),
                backend="fused", dtype="int8", device=dev)
    geo = h1_geo(p, l.in_hw[0])
    xp = np.pad(xq.numpy().astype(np.int64), ((0, 0), geo["pad"][1], (0, 0)))
    lc = xp.shape[1] - 6
    acc = sum(xp[:, a:a + lc] @ ws.numpy()[a].astype(np.int64)
              for a in range(7))
    peak = 127 * 127 * 7 * l.cin
    want = K.shuffle_epilogue(torch.from_numpy(acc.astype(np.float32))[:, None],
                              (1, l.s), None, "linear", geo["crop"],
                              geo["out_space"], torch.float32)[:, 0]
    for tile in (None, GemmPlan(32, 4)):
        out = ops.sd_deconv_presplit_fused_1d(
            xq.to(dev), ws.to(dev), l.k, l.s, p.padding,
            scale=torch.ones(1, l.cout * l.s, device=dev), plan=tile).cpu()
        n_diff = int((out != want).sum())
        ok = (n_diff == 0 and int(np.abs(acc).max()) == peak
              and out.abs().max().item() == float(peak))
        print(f"check: K1 int8 saturating, every code +-127 on wavegan/up1 at "
              f"batch {BUCKET} (K {7 * l.cin}), plan {tile or 'default'}: "
              f"{n_diff} of {out.numel()} elements differ from the int64 "
              f"restatement, max|y| {out.abs().max().item():.0f} (127^2 x "
              f"{7 * l.cin} = {peak}) {'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            failures.append(f"K1 int8 saturating up1 {tile}")

    # ---- (c) K4 as an H=1 launch ---------------------------------------
    print(f"check: K4 as an H=1 launch (alphas (1, 6): F(1,1) x F(2,5)) at "
          f"batch {BUCKET} vs sd_wino_ref (gate {F32_GATE}*max(1,max|ref|)) "
          f"and vs K1 on the same split filters (tolerance((1, 5)) = "
          f"{W.tolerance((1, 5))} * max(1,max|y_K1|)) {tag}")
    spec_d = reduced_specs()["wavegan-dryrun"]
    wino_cases = [(f"wavegan-dryrun/{dl.name}", dl.k, dl.s, dl.cin, dl.cout,
                   dl.in_hw[0]) for dl in spec_d.deconv_layers()]
    wino_cases += [(f"k17/s4 at wavegan/{wl.name}'s widths", 17, 4, wl.cin,
                    wl.cout, wl.in_hw[0]) for wl in layers]
    wino_bound = {}
    for label, k, s, cin, cout, length in wino_cases:
        x = randn(BUCKET, length, cin)
        w = randn(k, cin, cout, scale=1.0 / (k * cin) ** 0.5)
        bias = randn(cout, scale=0.1)
        pw, pf = (sd.plan(w.shape, s, same_deconv_pads((k,), (s,)),
                          backend=b, act="relu", device=dev).bind(
                              w, bias=bias)
                  for b in ("winograd", "fused"))
        kt = (1, pw.kt[0])
        geo = h1_geo(pw, length)
        wl_ = W.wino_launch((BUCKET, 1, length, cin), (1, *pw.ws.shape), kt,
                            (1, s), geo["pad"], geo["crop"], geo["out_space"])
        before = W.SD_WINO_LAUNCHES
        out = ops.sd_deconv_presplit_wino_1d(x, pw.ws, k, s, pw.padding,
                                             bias=pw.bias, act="relu")
        n = W.SD_WINO_LAUNCHES - before
        ref = W.sd_wino_ref(x[:, None], pw.ws[None], kt, (1, s),
                            bias=pw.bias, act="relu", **geo)[:, 0]
        y1 = sd.execute(pf, x)
        torch.cuda.synchronize()
        d, tol = _gate_err(out, ref, F32_GATE, True)
        d1, tol1 = _gate_err(out, y1, W.tolerance(kt), True)
        ok = d <= tol and d1 <= tol1 and n == 1 and pw.kt == (5,)
        print(f"  {label} {tuple(x.shape)}->{tuple(out.shape)}, "
              f"{wl_.plan}: {n} launch, vs sd_wino_ref max|d| {d:.3e} tol "
              f"{tol:.3e}, vs K1 max|d| {d1:.3e} tol {tol1:.3e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"K4 {label}")
        wino_bound[label] = (x, pw)
    if failures:
        raise SystemExit(f"chip_smoke: a WaveGAN H=1 launch disagrees with "
                         f"its plain version on {failures}")

    # ---- (d) K2 and K3 on the 1-D backward ------------------------------
    print(f"check: WaveGAN's backward at batch {BUCKET}: K2 (dx) and K3 (dw) "
          f"as H=1 launches vs sd_conv_ref / sd_filter_grad_ref, gate "
          f"{F32_GATE}*max(1,max|ref|) {tag}")
    bwd = {}
    for l in layers:
        p = sd.plan((l.k, l.cin, l.cout), l.s,
                    same_deconv_pads((l.k,), (l.s,)), backend="fused",
                    device=dev)
        x = randn(BUCKET, l.in_hw[0], l.cin)
        w = randn(l.k, l.cin, l.cout, scale=1.0 / (l.k * l.cin) ** 0.5)
        dy = randn(BUCKET, *p.out_shape(l.in_hw), l.cout)
        dy1 = split_cotangent(p, dy)[:, None]
        (kt,), (pi,) = p.kt, p.pi
        w_t = sd.split_weights(p, w)[None].flip(0, 1).transpose(-1, -2) \
            .contiguous()
        geo2 = dict(pad=((0, 0), (kt - 1, kt - 1)), out_start=(0, pi),
                    out_size=(1, l.in_hw[0]))
        geo3 = dict(pad=((0, 0), (pi, pi)))
        x1 = x[:, None]
        before = (K.SD_CONV_LAUNCHES, K.SD_FILTER_GRAD_LAUNCHES)
        dx = K.sd_conv(dy1, w_t, **geo2)
        dws = K.sd_filter_grad(x1, dy1, (1, kt), **geo3)
        n = (K.SD_CONV_LAUNCHES - before[0],
             K.SD_FILTER_GRAD_LAUNCHES - before[1])
        for what, out, ref in (
                ("K2 dx", dx, K.sd_conv_ref(dy1, w_t, **geo2)),
                ("K3 dw", dws, K.sd_filter_grad_ref(x1, dy1, (1, kt),
                                                    **geo3))):
            torch.cuda.synchronize()
            d, tol = _gate_err(out, ref, F32_GATE, True)
            bwd_err = max(bwd_err, d)
            ok = d <= tol and n == (1, 1)
            print(f"  wavegan/{l.name} {what} {tuple(out.shape)}: max|d| "
                  f"{d:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{what} wavegan/{l.name}")
        bwd[l.name] = (dy1, w_t, geo2, x1, kt, geo3)
    # J_G^T c of full WaveGAN, the cotangent fixed, fused vs torch
    gm = {b: GenerativeModel(WORKLOADS["wavegan"](), "sd_kernel",
                             engine_backend=b, device=dev)
          for b in ("fused", "torch")}
    params0 = gm["fused"].init(torch.Generator().manual_seed(SEED))
    z = randn(BUCKET, 100)
    c = randn(BUCKET, 1024, 1)
    grads, jgc_counts = {}, None
    for b, m in gm.items():
        params = {k: {n: t.detach().clone().requires_grad_()
                      for n, t in v.items()} for k, v in params0.items()}
        torch.cuda.synchronize()
        zero_counts()
        (m.apply(params, z) * c).sum().backward()
        torch.cuda.synchronize()
        if b == "fused":
            jgc_counts = counts()
        grads[b] = {(k, n): t.grad for k, v in params.items()
                    for n, t in v.items()}
    worst = max(((grads["fused"][key] - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-30)).item()
                for key, ref in grads["torch"].items())
    want = {"SD_FUSED_LAUNCHES": 3, "SD_CONV_LAUNCHES": 3,
            "SD_FILTER_GRAD_LAUNCHES": 3}
    ok = worst <= 1e-4 and all(jgc_counts.get(k, 0) == v
                               for k, v in want.items()) and not any(
        v for k, v in jgc_counts.items() if k not in want)
    print(f"  full WaveGAN J_G^T c at batch {BUCKET} (c fixed): fused vs "
          f"torch backend, worst leaf max|d|/max|ref| {worst:.3e} (gate "
          f"1e-4); launches {jgc_counts} (want K1/K2/K3 3/3/3, every other 0) "
          f"{'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        failures.append("WaveGAN J_G^T c")
    if failures:
        raise SystemExit(f"chip_smoke: WaveGAN's backward is wrong: "
                         f"{failures}")
    report["jgc"] = {"worst_rel": worst, "launches": jgc_counts}

    # ---- (e) serve full-width WaveGAN: f32, dynamic and calibrated int8 -
    old_env = os.environ.get("REPRO_TORCH_SD_CALIB_CACHE")
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_calib_")
    os.environ["REPRO_TORCH_SD_CALIB_CACHE"] = os.path.join(
        cache_dir, "sd_calib.json")
    servers, serve, outs = {}, {}, {}
    try:
        for form, counter in (("f32", "SD_FUSED_LAUNCHES"),
                              ("dynamic", "SD_FUSED_INT8_LAUNCHES"),
                              ("calibrated", "SD_FUSED_INT8_LAUNCHES")):
            server = GenServer(nets=("wavegan",), device=dev,
                               max_batch=BUCKET, seed=SEED, backend="fused",
                               dtype=torch.float32 if form == "f32"
                               else "int8",
                               calib=64 if form == "calibrated" else 0)
            built_cells = server.warmup()
            reqs = server.random_requests("wavegan", SERVE_REQUESTS, seed=1)
            torch.cuda.synchronize()
            zero_counts()
            results, stats = serve_async(server, reqs)
            torch.cuda.synchronize()
            cnt = counts()
            lat = stats["latency_ms"]
            print(f"serve wavegan {form}: {stats['served']} WaveGAN requests "
                  f"(full width, 1,024 samples each, f32 IO) in "
                  f"{stats['wall_s']:.4f} s host clock: "
                  f"{stats['req_per_s']:.1f} req/s, p50 {lat['p50']} ms, p95 "
                  f"{lat['p95']} ms, {stats['launches']} launches, "
                  f"{stats['compiles']} cells ({built_cells} built in warmup) "
                  f"{tag}")
            want = 3 * stats["launches"]
            print(f"  launches in the serving run: {cnt} (want {counter} = 3 "
                  f"layers x {stats['launches']} batches, every other 0)")
            if cnt[counter] != want or want == 0 or any(
                    v for n, v in cnt.items() if n != counter):
                raise SystemExit(f"chip_smoke: the {form} WaveGAN server did "
                                 f"not run {counter} (and only it) once per "
                                 "deconv layer per batch")
            if stats["served"] != SERVE_REQUESTS or stats["shed"]:
                raise SystemExit(f"chip_smoke: served {stats['served']} of "
                                 f"{SERVE_REQUESTS}, shed {stats['shed']}")
            model, params = server.model("wavegan")
            zb = torch.stack([r.latent for r in reqs])
            out = torch.stack([results[r.rid] for r in reqs])
            ref_m = GenerativeModel(model.spec, "sd_kernel",
                                    engine_backend="torch", device=dev,
                                    engine_dtype="native" if form == "f32"
                                    else "int8")
            plans = model.engine.plans()
            code_txt = ""
            if form == "calibrated":
                ref_m.engine.set_calibration(
                    {n: p.sx_in.item() for n, p in plans.items()})
            with torch.no_grad():
                ref = torch.cat([ref_m.apply(params, zb[i:i + BUCKET])
                                 for i in range(0, SERVE_REQUESTS, BUCKET)])
                if form == "calibrated":
                    tplans = ref_m.engine.plans()
                    h = zb @ params["project"]["w"] + params["project"]["b"]
                    h = torch.relu(h.reshape(SERVE_REQUESTS, 16, 64))
                    ht, diffs = h, []
                    for name in ("up1", "up2"):
                        h = torch.cat([sd.execute(plans[name],
                                                  h[j:j + BUCKET])
                                       for j in range(0, SERVE_REQUESTS,
                                                      BUCKET)])
                        ht = sd.execute(tplans[name], ht)
                        diffs.append((name, str(h.dtype), int((h != ht)
                                                              .sum())))
                    code_txt = "; chained codes vs the torch backend: " + \
                        ", ".join(f"{n} {dt.replace('torch.', '')} {k} differ"
                                  for n, dt, k in diffs)
                    if any(dt != "torch.int8" or k for _, dt, k in diffs):
                        raise SystemExit("chip_smoke: WaveGAN's chained "
                                         "codes differ from the torch "
                                         "backend's")
            finite = bool(torch.isfinite(out).all())
            rel = F32_GATE if form == "f32" else INT8_EXACT_GATE
            d, tol = _gate_err(out, ref, rel, True)
            ok = finite and d <= tol and tuple(out.shape) == (
                SERVE_REQUESTS, 1024, 1)
            print(f"  outputs {tuple(out.shape)} finite={finite}; vs the same "
                  f"model on the card's torch backend (the served batches of "
                  f"{BUCKET}{', the same scales' if form == 'calibrated' else ''}"
                  f"): max|d| {d:.3e} tol {tol:.3e} ({rel}*max(1,max|ref|))"
                  f"{code_txt} {'ok' if ok else 'FAIL'} {tag}")
            if not ok:
                raise SystemExit(f"chip_smoke: {form}-served WaveGAN outputs "
                                 "are wrong")
            serve[form] = {k: stats[k] for k in ("served", "launches",
                                                 "req_per_s", "wall_s",
                                                 "latency_ms")}
            serve[form].update(launches_by_counter=cnt, vs_torch_max_abs=d)
            servers[form] = (server, reqs)
            outs[form] = out
    finally:
        if old_env is None:
            os.environ.pop("REPRO_TORCH_SD_CALIB_CACHE", None)
        else:
            os.environ["REPRO_TORCH_SD_CALIB_CACHE"] = old_env
        shutil.rmtree(cache_dir, ignore_errors=True)
    for form in ("dynamic", "calibrated"):
        a, b = outs[form], outs["f32"]
        r = ((a - b).abs().max() / b.abs().max()).item()
        ok = r < INT8_VS_F32
        print(f"  {form} int8 served vs the f32 server on the same weights "
              f"and latents: max|d|/max|ref| {r:.4e} (gate < {INT8_VS_F32}) "
              f"{'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"chip_smoke: {form} int8 WaveGAN strays from "
                             "f32")
        serve[form]["vs_f32_rel"] = r

    # ---- (f) the winograd dryrun ---------------------------------------
    torch.cuda.synchronize()
    zero_counts()
    wres, wstats = serve_gen.main(["--dryrun", "--backend", "winograd"])
    torch.cuda.synchronize()
    wcnt = counts()
    cells = wstats["compile_cache"]
    # dcgan-dryrun 2 + segnet-dryrun 1 + wavegan-dryrun 2 deconv layers,
    # one batch each
    ok = ("('wavegan-dryrun', 2, 'float32')" in cells
          and not any("voxgan" in c for c in cells)
          and wstats["launches"] == 3
          and wcnt["SD_WINO_LAUNCHES"] == 5 and not any(
              v for n, v in wcnt.items() if n != "SD_WINO_LAUNCHES")
          and all(bool(torch.isfinite(r).all()) for r in wres.values()))
    print(f"serve_gen --dryrun --backend winograd: cells {cells}; launches "
          f"{wcnt} (want 5 K4: 2 + 1 + 2 deconv layers, every other 0) "
          f"{'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit("chip_smoke: the winograd dryrun did not serve "
                         "wavegan-dryrun through K4")
    report["wino_dryrun"] = {"cells": cells, "launches": wcnt}

    # ---- (g) timing -----------------------------------------------------
    print(f"time: WaveGAN layers at batch {BUCKET}, in turns: K1 f32 / K1 "
          f"int8 with a static row (int8 out on up1/up2, f32 on to_audio) / "
          f"the plain f32 version / F.conv_transpose1d f32 (cuDNN, TF32 off, "
          f"a yardstick; padding 11 + output_padding 1 for the same length): "
          f"device ms of one call (ahead events; the profiler's median of 3 "
          f"beside) and CUDA events over 20 back-to-back calls; bound: f32 at "
          f"the {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s CUDA cores, int8 at the "
          f"{PEAK_INT8_OPS / 1e12:.0f} TOP/s int8 tensor cores, or the bytes "
          f"at {PEAK_BYTES / 1e12:.2f} TB/s, whichever is larger {tag}")
    per_layer = []
    for l, act in zip(layers, acts):
        x, w, p = case(l.k, l.s, l.cin, l.cout, BUCKET, l.in_hw[0], act)
        _, _, pq = case(l.k, l.s, l.cin, l.cout, BUCKET, l.in_hw[0], act,
                        dtype="int8")
        xq, sxs = quantize_act(x)
        od = torch.int8 if act == "relu" else None
        row = (sxs[:1, None] * pq.wscale[None, :]
               * (200.0 if od is not None else 1.0)).contiguous()
        x_cf = x.permute(0, 2, 1).contiguous()
        w_cf = w.permute(1, 2, 0).contiguous()          # (Cin, Cout, K)
        fns = {"k1": lambda: k1(x, p),
               "k1q": lambda: k1(xq, pq, row, od),
               "plain": lambda: plain(x, p),
               "lib": lambda: F.conv_transpose1d(
                   x_cf, w_cf, p.bias, stride=l.s, padding=11,
                   output_padding=1)}
        y, yq = fns["k1"](), fns["k1q"]()
        assert fns["lib"]().shape[2] == y.shape[1]
        t = _time_ms(fns)
        dv = {n: _device_ms(f) for n, f in fns.items()}
        g32 = h1_gemm(p, BUCKET, l.in_hw[0])
        g8 = h1_gemm(pq, BUCKET, l.in_hw[0], dtype="int8")
        macs = BUCKET * l.macs()
        b32 = sum(t_.numel() * t_.element_size() for t_ in (x, p.ws, p.bias,
                                                             y))
        b8 = sum(t_.numel() * t_.element_size() for t_ in (xq, pq.ws, row,
                                                           pq.bias, yq))
        bound32 = max(2.0 * macs / PEAK_F32_FLOPS, b32 / PEAK_BYTES) * 1e3
        bound8 = max(2.0 * macs / PEAK_INT8_OPS, b8 / PEAK_BYTES) * 1e3
        rec = {"layer": f"wavegan/{l.name}", "x": list(x.shape),
               "y": list(y.shape), "plan": str(g32.plan),
               "grid": list(gemm_grid(g32.geom, g32.plan)),
               "gemm": [g32.geom.m, g32.geom.n, g32.geom.k],
               "ms": dv["k1"][1], "profiler_ms": dv["k1"][0],
               "events_ms": t["k1"][0],
               "int8_plan": str(g8.plan), "int8_out": str(yq.dtype),
               "int8_ms": dv["k1q"][1], "int8_profiler_ms": dv["k1q"][0],
               "int8_events_ms": t["k1q"][0],
               "plain_ms": dv["plain"][1], "plain_events_ms": t["plain"][0],
               "library_ms": dv["lib"][1],
               "library_profiler_ms": dv["lib"][0],
               "library_events_ms": t["lib"][0],
               "bound_ms": bound32,
               "bound_by": ("operations" if 2.0 * macs / PEAK_F32_FLOPS
                            >= b32 / PEAK_BYTES else "bytes"),
               "int8_bound_ms": bound8,
               "int8_bound_by": ("operations" if 2.0 * macs / PEAK_INT8_OPS
                                 >= b8 / PEAK_BYTES else "bytes"),
               "macs": macs, "bytes": b32, "int8_bytes": b8,
               "launches_per_batch": 1}
        per_layer.append(rec)
        print(f"  wavegan/{l.name} {tuple(x.shape)}->{tuple(y.shape)} GEMM "
              f"{g32.geom.m} x {g32.geom.n} x {g32.geom.k}, f32 {g32.plan} "
              f"grid {' x '.join(map(str, rec['grid']))}, int8 {g8.plan}: K1 "
              f"f32 device {rec['ms']:.4f} ms (profiler "
              f"{_ms_txt(rec['profiler_ms'])}; events {rec['events_ms']:.4f}),"
              f" K1 int8 static {rec['int8_out'].replace('torch.', '')} out "
              f"{rec['int8_ms']:.4f} (profiler "
              f"{_ms_txt(rec['int8_profiler_ms'])}; events "
              f"{rec['int8_events_ms']:.4f}), plain {rec['plain_ms']:.4f}, "
              f"conv_transpose1d {rec['library_ms']:.4f} (profiler "
              f"{_ms_txt(rec['library_profiler_ms'])}); bound f32 "
              f"{bound32:.5f} ms ({rec['bound_by']}), int8 {bound8:.5f} ms "
              f"({rec['int8_bound_by']}); sm clock, power, temperature "
              f"{_clocks()} {tag}")
    print(f"time: WaveGAN's K4 (k17/s4 at WaveGAN's widths, 5 taps), K2 (dx) "
          f"and K3 (dw) as H=1 launches at batch {BUCKET}: device ms (ahead "
          f"events; profiler beside), their plain versions' and a library "
          f"call's on the same-size 1-D deconv (F.conv_transpose1d for K4, "
          f"cuDNN convolution_backward asked for dx only or dw only for K2 "
          f"and K3; TF32 off), in that order; bound: the useful work at the "
          f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s CUDA cores or the bytes "
          f"(inputs and output once) at {PEAK_BYTES / 1e12:.2f} TB/s, "
          f"whichever is larger {tag}")
    other = {"sd_wino": [], "sd_conv": [], "sd_filter_grad": []}
    for (label, (x, pw)), l in zip(list(wino_bound.items())[-3:], layers):
        kt = (1, pw.kt[0])
        geo = h1_geo(pw, x.shape[1])
        fk = lambda x=x, pw=pw: ops.sd_deconv_presplit_wino_1d(  # noqa
            x, pw.ws, 17, 4, pw.padding, bias=pw.bias, act="relu")
        fp = lambda x=x, pw=pw, kt=kt, geo=geo: W.sd_wino_ref(  # noqa
            x[:, None], pw.ws[None], kt, (1, 4), bias=pw.bias, act="relu",
            **geo)
        dy1, w_t, geo2, x1, ktt, geo3 = bwd[l.name]
        # Library yardsticks on random operands of the same sizes (NCL;
        # padding and output_padding give out = 4 * in, as the layers'
        # asymmetric "same" pads do): k17/s4 forward for K4, WaveGAN's
        # k25/s4 backward, one gradient at a time, for K2 and K3.
        length = l.in_hw[0]
        x_cf = torch.randn(BUCKET, l.cin, length, device=dev)
        w17 = torch.randn(l.cin, l.cout, 17, device=dev)
        w25 = torch.randn(l.cin, l.cout, l.k, device=dev)
        g_cf = torch.randn(BUCKET, l.cout, 4 * length, device=dev)
        bgeo = ([l.s], [11], [1], True, [1], 1)

        def lib_bwd(mask, g_cf=g_cf, x_cf=x_cf, w25=w25, bgeo=bgeo):
            return torch.ops.aten.convolution_backward(
                g_cf, x_cf, w25, None, *bgeo, mask)

        libs = {"sd_wino": lambda x_cf=x_cf, w17=w17: F.conv_transpose1d(
                    x_cf, w17, stride=4, padding=7, output_padding=1),
                "sd_conv": lambda: lib_bwd([True, False, False]),
                "sd_filter_grad": lambda: lib_bwd([False, True, False])}
        assert libs["sd_wino"]().shape[2] == fk().shape[1]
        assert libs["sd_conv"]()[0].shape == x_cf.shape
        for kname, f_k, f_p, args in (
                ("sd_wino", fk, fp, (x, pw.ws, pw.bias, fk())),
                ("sd_conv", lambda: K.sd_conv(dy1, w_t, **geo2),
                 lambda: K.sd_conv_ref(dy1, w_t, **geo2),
                 (dy1, w_t, x1)),
                ("sd_filter_grad",
                 lambda: K.sd_filter_grad(x1, dy1, (1, ktt), **geo3),
                 lambda: K.sd_filter_grad_ref(x1, dy1, (1, ktt), **geo3),
                 (x1, dy1, w_t))):
            dk, dp = _device_ms(f_k), _device_ms(f_p)
            dl = _device_ms(libs[kname])
            macs = BUCKET * (l.macs() if kname != "sd_wino"
                             else l.in_hw[0] * 17 * l.cin * l.cout)
            t_ops = 2.0 * macs / PEAK_F32_FLOPS * 1e3
            t_bytes = sum(t_.numel() * t_.element_size()
                          for t_ in args) / PEAK_BYTES * 1e3
            other[kname].append({"layer": label if kname == "sd_wino"
                                 else f"wavegan/{l.name}",
                                 "ms": dk[1], "profiler_ms": dk[0],
                                 "plain_ms": dp[1],
                                 "library_ms": dl[1],
                                 "library_profiler_ms": dl[0],
                                 "useful_bound_ms": t_ops,
                                 "bound_ms": max(t_ops, t_bytes),
                                 "bound_by": ("operations" if t_ops >= t_bytes
                                              else "bytes")})
            r = other[kname][-1]
            print(f"  {kname} {r['layer']}: device {dk[1]:.4f} ms (profiler "
                  f"{_ms_txt(dk[0])}), plain {dp[1]:.4f} ms, library "
                  f"{dl[1]:.4f} ms (profiler {_ms_txt(dl[0])}), useful-work "
                  f"bound {t_ops:.5f} ms, bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']})")

    full = [r.latent for r in servers["f32"][1][:BUCKET]]
    host = {k: [] for k in servers}
    order = list(servers)
    for r in range(10):
        for name in (order if r % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            servers[name][0].run_group("wavegan", full)
            torch.cuda.synchronize()
            host[name].append((time.perf_counter() - t0) * 1e3)
    host_ms = {k: sorted(v)[len(v) // 2] for k, v in host.items()}
    breakdown = {k: _device_breakdown(
        lambda s=s[0]: s.run_group("wavegan", full))
        for k, s in servers.items()}
    print(f"batch wavegan: one WaveGAN batch of {BUCKET} through run_group, "
          f"host clock (median of 10, synchronised, in turns): f32 "
          f"{host_ms['f32']:.3f} ms, dynamic int8 {host_ms['dynamic']:.3f} ms, "
          f"calibrated int8 {host_ms['calibrated']:.3f} ms {tag}")
    for name, bd in breakdown.items():
        if bd is None:
            print(f"  {name}: device time: not measured (the profiler "
                  "reported no device time)")
            continue
        busy, wall, top = bd
        print(f"  {name} profiler: device busy {busy:.3f} ms of {wall:.3f} "
              f"ms wall (idle share {1 - busy / wall:.3f}) {tag}")
        for kname, ms_k, calls in top:
            print(f"    {ms_k:.4f} ms in {calls} call(s): {kname[:90]}")

    report.update(per_layer=per_layer, other=other, serve=serve,
                  batch_host_ms=host_ms, batch_device=breakdown)
    return {
        "k1_max_abs_err": k1_err, "backward_max_abs_err": bwd_err,
        "launches": {
            "sd_fused": serve["f32"]["launches_by_counter"][
                "SD_FUSED_LAUNCHES"],
            "sd_fused_int8": serve["dynamic"]["launches_by_counter"][
                "SD_FUSED_INT8_LAUNCHES"],
            "sd_fused_int8_calibrated": serve["calibrated"][
                "launches_by_counter"]["SD_FUSED_INT8_LAUNCHES"],
            "sd_conv": jgc_counts["SD_CONV_LAUNCHES"],
            "sd_filter_grad": jgc_counts["SD_FILTER_GRAD_LAUNCHES"],
            "sd_wino": wcnt["SD_WINO_LAUNCHES"]},
        "ms": {"sd_fused": [r["ms"] for r in per_layer],
               "sd_fused_int8": [r["int8_ms"] for r in per_layer],
               **{k: [r["ms"] for r in v] for k, v in other.items()}},
        "report": report}


PLAN_CACHE_ENV = "REPRO_TORCH_SD_PLAN_CACHE"
EST_OVER_BUSY = 1.1      # estimate_ms(16) <= this x the batch's busy time


@contextlib.contextmanager
def _plan_cache(path: str):
    """Point the port's tile cache at ``path`` while the block runs (an
    engine reads it when it binds and when a cell resolves its tiles),
    and restore the variable after."""
    old = os.environ.get(PLAN_CACHE_ENV)
    os.environ[PLAN_CACHE_ENV] = path
    try:
        yield path
    finally:
        if old is None:
            os.environ.pop(PLAN_CACHE_ENV, None)
        else:
            os.environ[PLAN_CACHE_ENV] = old


@contextlib.contextmanager
def _counted_measure():
    """Count the calls of ``autotune.measure`` (what ``pretune`` times
    each candidate tile with) while the block runs."""
    from repro_torch.kernels import autotune as A
    real, n = A.measure, [0]

    def measure(*args, **kw):
        n[0] += 1
        return real(*args, **kw)

    A.measure = measure
    try:
        yield n
    finally:
        A.measure = real


def _batch_times(dev, runs: dict, rounds: int = 10) -> dict:
    """Host ms per batch of each ``runs[name]()`` (median of ``rounds``
    synchronised calls, the servers in turns) and its device busy ms
    (one profiled call; events over the batch queued behind
    ``torch.cuda._sleep`` where the profiler reports none)."""
    import torch
    host = {n: [] for n in runs}
    for r in range(rounds):
        for n in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            runs[n]()
            torch.cuda.synchronize(dev)
            host[n].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for n, fn in runs.items():
        bd = _device_breakdown(fn)
        busy, how = ((bd[0], "profiler") if bd is not None
                     else (_ahead_ms(fn, calls=5), "ahead events"))
        out[n] = {"host_ms": sorted(host[n])[rounds // 2], "busy_ms": busy,
                  "busy_from": how,
                  "idle_share": None if bd is None else 1 - bd[0] / bd[1]}
    return out


def _pretune_phase(dev, tag) -> dict:
    """Phase 12: measured tiles and the per-layer algorithm.  Pretunes a
    full-width f32 DCGAN ``GenServer`` (backend fused, buckets 1-16: K1's
    and K4's candidate tiles per (layer, bucket)), prints each layer's
    winners against the heuristic plans and the backend it bound to,
    serves 48 requests through it (launch counts per backend, outputs
    against the ``torch`` backend or the all-K1 fused server), holds
    ``estimate_ms`` to the batch's busy time, pretunes a second server on
    the same cache with no measurement, pretunes a calibrated int8 server
    (K1 int8 only) and holds its outputs bit-identical to an unpretuned
    one's, times a batch of the pretuned and the unpretuned server in
    turns, and (f) serves and trains a server whose cache binds layers to
    K4.  Every failure raises."""
    import shutil
    import tempfile
    import torch
    import repro_torch.kernels.sd_conv as K
    import repro_torch.kernels.winograd as W
    from repro_torch import sd
    from repro_torch.core.deconv import same_deconv_pads
    from repro_torch.kernels import autotune as A
    from repro_torch.launch.serve_gen import GenServer, serve_async
    from repro_torch.models.generative import GenerativeModel
    from repro_torch.sd.functional import execute

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_pretune_")
    cache = os.path.join(work, "sd_plans.json")
    empty = os.path.join(work, "empty_plans.json")
    report = {}
    try:
        # ---- (a) pretune f32 DCGAN ---------------------------------------
        with _plan_cache(cache):
            server = GenServer(nets=("dcgan",), device=dev,
                               max_batch=BUCKET, seed=SEED, backend="fused")
            model, params = server.model("dcgan")
            eng = model.engine
            with _counted_measure() as n_measure:
                t0 = time.perf_counter()
                tuned = server.pretune()
                torch.cuda.synchronize(dev)
                tune_s = time.perf_counter() - t0
        layers = model.spec.deconv_layers()
        want = len(layers) * len(server.buckets()) * 2
        print(f"pretune: full-width f32 DCGAN, backend fused, buckets "
              f"{server.buckets()}: {len(tuned)} (layer, bucket, algorithm) "
              f"geometries (want {want}), {n_measure[0]} calls of "
              f"autotune.measure (device ms by ahead events, least of 3 "
              f"readings; two passes over <= 8 candidates each) in "
              f"{tune_s:.2f} s host clock {tag}")
        if len(tuned) != want or sum(k.endswith("_wino")
                                     for k in tuned) != want // 2:
            raise SystemExit("chip_smoke: pretune did not time K1 and K4 on "
                             "every (layer, bucket)")
        bound = {n: p.backend for n, p in eng.plans().items()}
        per_layer = []
        for i, l in enumerate(layers):
            p = params[l.name]
            act = "linear" if i == len(layers) - 1 else "relu"
            pads = same_deconv_pads(l.k, l.s)
            x = torch.randn((BUCKET, *l.in_hw, l.cin), device=dev)
            rec = {"layer": f"dcgan/{l.name}", "bound": bound[l.name]}
            for algo, backend in (("", "fused"), ("wino", "winograd")):
                g = eng.layer_geom(l, BUCKET, algo=algo)
                g1 = eng.layer_geom(l, 1, algo=algo)
                plan = sd.plan(p["w"].shape, l.s, pads, backend=backend,
                               act=act, device=dev).bind(
                                   p["w"], p["scale"], p["b"])
                heur = A.default_plan(g)
                with torch.no_grad():
                    heur_ms = A.measure(
                        lambda: execute(plan.with_tile(heur), x),
                        device=dev)
                rec["k4" if algo else "k1"] = {
                    "winner": str(tuned[g.key()]),
                    "ms": A.measured_ms(g, path=cache, device=dev),
                    "heuristic": str(heur), "heuristic_ms": heur_ms,
                    "ms_batch1": A.measured_ms(g1, path=cache, device=dev)}
            per_layer.append(rec)
            k1, k4 = rec["k1"], rec["k4"]
            print(f"  dcgan/{l.name} at bucket {BUCKET}: K1 {k1['winner']} "
                  f"{k1['ms']:.4f} ms (heuristic {k1['heuristic']} "
                  f"{k1['heuristic_ms']:.4f}); K4 {k4['winner']} "
                  f"{k4['ms']:.4f} ms (heuristic {k4['heuristic']} "
                  f"{k4['heuristic_ms']:.4f}); bound to {rec['bound']} "
                  f"(chosen at batch 1: K1 {k1['ms_batch1']:.4f} / K4 "
                  f"{k4['ms_batch1']:.4f} ms; at {BUCKET} the faster is "
                  f"{'K4' if k4['ms'] < k1['ms'] else 'K1'}) {tag}")
        report["per_layer"] = per_layer
        report["tuned"] = len(tuned)
        report["tune_s"] = tune_s
        report["measure_calls"] = n_measure[0]

        # ---- (b) serve the pretuned server ---------------------------------
        n_k4 = sum(b == "winograd" for b in bound.values())
        n_k1 = len(bound) - n_k4
        with _plan_cache(cache):
            server.warmup()
            reqs = server.random_requests("dcgan", SERVE_REQUESTS, seed=1)
            torch.cuda.synchronize(dev)
            K.SD_FUSED_LAUNCHES = W.SD_WINO_LAUNCHES = 0
            results, stats = serve_async(server, reqs)
            torch.cuda.synchronize(dev)
            l1, l4 = K.SD_FUSED_LAUNCHES, W.SD_WINO_LAUNCHES
        lat = stats["latency_ms"]
        print(f"serve pretuned: {stats['served']} DCGAN requests (full "
              f"width, f32) in {stats['wall_s']:.4f} s host clock: "
              f"{stats['req_per_s']:.1f} req/s, p50 {lat['p50']} ms, p95 "
              f"{lat['p95']} ms, {stats['launches']} launches; K1 launches "
              f"{l1} (want {n_k1} x {stats['launches']} batches), K4 "
              f"launches {l4} (want {n_k4} x {stats['launches']}) {tag}")
        if (l1 != n_k1 * stats["launches"] or l4 != n_k4 * stats["launches"]
                or stats["served"] != SERVE_REQUESTS or stats["shed"]):
            raise SystemExit("chip_smoke: the pretuned server's launches do "
                             "not match its layers' backends")
        z = torch.stack([r.latent for r in reqs])
        out = torch.stack([results[r.rid] for r in reqs])
        with torch.no_grad():
            ref_t = GenerativeModel(model.spec, "sd_kernel",
                                    engine_backend="torch",
                                    device=dev).apply(params, z)
            with _plan_cache(empty):      # the all-K1 fused server's model
                ref_f = GenerativeModel(model.spec, "sd_kernel",
                                        engine_backend="fused",
                                        device=dev).apply(params, z)
        if n_k4:
            gates = (("the unpretuned fused server's model (every layer on "
                      "K1)", ref_f, W.WINO_TOL[3], False,
                      "WINO_TOL[3]*max|ref|"),
                     ("the torch backend", ref_t, W.WINO_TOL[3], False,
                      "WINO_TOL[3]*max|ref|"))
        else:
            gates = (("the torch backend", ref_t, F32_GATE, True,
                      f"{F32_GATE}*max(1,max|ref|)"),)
        ok = bool(torch.isfinite(out).all()) and tuple(out.shape) == (
            SERVE_REQUESTS, 64, 64, 3)
        for label, r, rel, floor_one, gate in gates:
            d, tol = _gate_err(out, r, rel, floor_one)
            ok = ok and d <= tol
            print(f"  vs {label} max|d| {d:.3e} tol {tol:.3e} ({gate}) "
                  f"{'ok' if d <= tol else 'FAIL'}")
        if not ok:
            raise SystemExit("chip_smoke: the pretuned server's outputs are "
                             "wrong")
        report["serve"] = {k: stats[k] for k in ("served", "launches",
                                                 "req_per_s", "wall_s",
                                                 "latency_ms")}
        report["launches"] = {"sd_fused": l1, "sd_wino": l4}

        # ---- (c) the service-time seed against the busy time ---------------
        with _plan_cache(cache):
            est = {b: server.estimate_ms("dcgan", b)
                   for b in server.buckets()}
            full = [r.latent for r in reqs[:BUCKET]]
        with _plan_cache(empty):
            base = GenServer(nets=("dcgan",), device=dev, max_batch=BUCKET,
                             seed=SEED, backend="fused")
            base.warmup()                  # every cell on call-time tiles
            base_k1 = len(base.model("dcgan")[0].engine.plans())
            times = _batch_times(dev, {
                "pretuned": lambda: server.run_group("dcgan", full),
                "unpretuned": lambda: base.run_group("dcgan", full)})
        busy = times["pretuned"]["busy_ms"]
        print(f"estimate_ms: {', '.join(f'{b}: {_ms_txt(e)}' for b, e in est.items())} "
              f"ms; at {BUCKET} {_ms_txt(est[BUCKET])} against a busy time "
              f"of {busy:.4f} ms ({times['pretuned']['busy_from']}; limit "
              f"{EST_OVER_BUSY} x busy; the fc layer and the host are not "
              f"counted) {tag}")
        if (any(e is None for e in est.values())
                or est[BUCKET] > EST_OVER_BUSY * busy):
            raise SystemExit("chip_smoke: estimate_ms is missing or above "
                             "the batch's busy time")
        for n, t in times.items():
            idle = ("" if t["idle_share"] is None
                    else f", idle share {t['idle_share']:.3f}")
            print(f"batch {n}: one DCGAN batch of {BUCKET} through "
                  f"run_group: {t['host_ms']:.4f} ms host clock (median of "
                  f"10, synchronised, the two servers in turns), device "
                  f"busy {t['busy_ms']:.4f} ms ({t['busy_from']}){idle} "
                  f"{tag}")
        print(f"  the unpretuned server runs its {base_k1} layers on K1 at "
              f"the call-time tiles; the pretuned one "
              f"{n_k1} on K1 and {n_k4} on K4 at the measured tiles")
        report["estimate_ms"] = est
        report["batch"] = times

        # ---- (d) a second server on the same cache measures nothing --------
        with _plan_cache(cache), _counted_measure() as n2:
            again = GenServer(nets=("dcgan",), device=dev, max_batch=BUCKET,
                              seed=SEED, backend="fused")
            tuned2 = again.pretune()
            bound2 = {n: p.backend for n, p in
                      again.model("dcgan")[0].engine.plans().items()}
        print(f"pretune again: a second server on the same cache: "
              f"{len(tuned2)} geometries, {n2[0]} calls of "
              f"autotune.measure (want 0), backends {bound2} {tag}")
        if n2[0] or bound2 != bound:
            raise SystemExit("chip_smoke: a pretuned cache was measured "
                             "again or bound differently")
        report["measure_calls_again"] = n2[0]

        # ---- (e) calibrated int8: direct only, bit-identical ---------------
        old_calib = os.environ.get("REPRO_TORCH_SD_CALIB_CACHE")
        os.environ["REPRO_TORCH_SD_CALIB_CACHE"] = os.path.join(
            work, "sd_calib.json")
        int8_cache = os.path.join(work, "int8_plans.json")
        try:
            outs = {}
            for name, path in (("pretuned", int8_cache),
                               ("unpretuned", empty)):
                with _plan_cache(path):
                    s8 = GenServer(nets=("dcgan",), device=dev,
                                   max_batch=BUCKET, seed=SEED,
                                   backend="fused", dtype="int8", calib=64)
                    if name == "pretuned":
                        t0 = time.perf_counter()
                        tuned8 = s8.pretune()
                        t8 = time.perf_counter() - t0
                    s8.warmup()
                    r8 = s8.random_requests("dcgan", SERVE_REQUESTS,
                                            seed=1)
                    torch.cuda.synchronize(dev)
                    K.SD_FUSED_INT8_LAUNCHES = K.SD_FUSED_LAUNCHES = 0
                    W.SD_WINO_LAUNCHES = 0
                    res8, st8 = serve_async(s8, r8)
                    torch.cuda.synchronize(dev)
                    counts8 = (K.SD_FUSED_INT8_LAUNCHES,
                               K.SD_FUSED_LAUNCHES + W.SD_WINO_LAUNCHES)
                outs[name] = torch.stack([res8[r.rid] for r in r8])
                if (counts8 != (3 * st8["launches"], 0)
                        or st8["served"] != SERVE_REQUESTS or st8["shed"]):
                    raise SystemExit(f"chip_smoke: the {name} calibrated "
                                     f"int8 server did not run K1 int8 alone "
                                     f"({counts8})")
                if name == "pretuned":
                    l8 = counts8[0]
        finally:
            if old_calib is None:
                os.environ.pop("REPRO_TORCH_SD_CALIB_CACHE", None)
            else:
                os.environ["REPRO_TORCH_SD_CALIB_CACHE"] = old_calib
        keys8 = sorted(tuned8)
        direct_only = (len(keys8) == 3 * len(server.buckets())
                       and not any(k.endswith("_wino") for k in keys8)
                       and all("_int8" in k for k in keys8)
                       and sum(k.endswith("_q8out") for k in keys8)
                       == 2 * len(server.buckets()))
        same = torch.equal(outs["pretuned"], outs["unpretuned"])
        print(f"pretune int8: calibrated int8 DCGAN (calib=64): "
              f"{len(keys8)} geometries in {t8:.2f} s, K1 int8 only "
              f"({sum(k.endswith('_q8out') for k in keys8)} of them _q8out "
              f"keys, no _wino) {'ok' if direct_only else 'FAIL'}; served "
              f"outputs vs the unpretuned calibrated server: "
              f"{'bit-identical' if same else 'DIFFER'}; {l8} K1 int8 "
              f"launches {tag}")
        if not (direct_only and same):
            raise SystemExit("chip_smoke: pretuned int8 is not direct-only "
                             "or not bit-identical to unpretuned int8")
        report["int8"] = {"tuned": len(keys8), "tune_s": t8,
                          "bit_identical": same, "launches": l8}

        # ---- (f) a cache that binds layers to K4 ---------------------------
        # (a) chooses at batch 1, where K1 has measured faster on this card,
        # so the switch is driven here on a copy of the cache whose batch-1
        # entries are the bucket-16 readings (tile and ms, both algorithms)
        switch = os.path.join(work, "switch_plans.json")
        plans = dict(A.load_cache(cache))
        want_sw = {}
        for rec, l in zip(per_layer, layers):
            for algo in ("", "wino"):
                plans[eng.layer_geom(l, 1, algo=algo).key()] = dict(
                    plans[eng.layer_geom(l, BUCKET, algo=algo).key()])
            want_sw[l.name] = ("winograd" if rec["k4"]["ms"] < rec["k1"]["ms"]
                               else "fused")
        A.save_cache(plans, switch)
        with _plan_cache(switch):
            sw = GenServer(nets=("dcgan",), device=dev, max_batch=BUCKET,
                           seed=SEED, backend="fused")
            sw_model, sw_params = sw.model("dcgan")
            sw_eng = sw_model.engine
            bound_sw = {n: p.backend for n, p in sw_eng.plans().items()}
            n4 = sum(b == "winograd" for b in bound_sw.values())
            n1 = len(bound_sw) - n4
            # each bucket's tiles: the measured winners of the bound
            # algorithm (batch 1: the copied bucket-16 tile where its
            # launch takes it, else the call-time default)
            tiles_ok, tile_txt = True, []
            for b in sw.buckets():
                pb = sw_eng.plans_for_batch(b)
                for l in layers:
                    algo = "wino" if bound_sw[l.name] == "winograd" else ""
                    g = sw_eng.layer_geom(l, b, algo=algo)
                    want_t = (A.get_plan(g, path=switch, device=dev)
                              if b == 1 else tuned[g.key()])
                    got_t = pb[l.name].tile
                    kind = A.WinoPlan if algo else A.GemmPlan
                    ok_t = got_t == want_t and (
                        got_t is None or isinstance(got_t, kind))
                    tiles_ok = tiles_ok and ok_t and (
                        b == 1 or got_t is not None)
                    if b == BUCKET:
                        tile_txt.append(f"{l.name} {got_t}")
            sw.warmup()
            rs = sw.random_requests("dcgan", SERVE_REQUESTS, seed=1)
            torch.cuda.synchronize(dev)
            K.SD_FUSED_LAUNCHES = W.SD_WINO_LAUNCHES = 0
            res_sw, st_sw = serve_async(sw, rs)
            torch.cuda.synchronize(dev)
            s1, s4 = K.SD_FUSED_LAUNCHES, W.SD_WINO_LAUNCHES
        print(f"switch: a copy of the cache with the bucket-{BUCKET} "
              f"readings under the batch-1 keys binds {bound_sw} (want "
              f"{want_sw}, at least one layer on K4); tiles at {BUCKET}: "
              f"{', '.join(tile_txt)}, every bucket's the measured winner of "
              f"its algorithm {'ok' if tiles_ok else 'FAIL'} {tag}")
        print(f"serve switched: {st_sw['served']} DCGAN requests in "
              f"{st_sw['wall_s']:.4f} s host clock, {st_sw['launches']} "
              f"launches; K1 launches {s1} (want {n1} x "
              f"{st_sw['launches']}), K4 launches {s4} (want {n4} x "
              f"{st_sw['launches']}) {tag}")
        if (bound_sw != want_sw or not n4 or not tiles_ok
                or s1 != n1 * st_sw["launches"]
                or s4 != n4 * st_sw["launches"]
                or st_sw["served"] != SERVE_REQUESTS or st_sw["shed"]):
            raise SystemExit("chip_smoke: the switched server did not bind, "
                             "tile or launch as its cache says")
        z_sw = torch.stack([r.latent for r in rs])
        out_sw = torch.stack([res_sw[r.rid] for r in rs])
        with torch.no_grad():
            ref_t = GenerativeModel(sw_model.spec, "sd_kernel",
                                    engine_backend="torch",
                                    device=dev).apply(sw_params, z_sw)
            with _plan_cache(empty):
                ref_f = GenerativeModel(sw_model.spec, "sd_kernel",
                                        engine_backend="fused",
                                        device=dev).apply(sw_params, z_sw)
        ok = bool(torch.isfinite(out_sw).all()) and tuple(out_sw.shape) == (
            SERVE_REQUESTS, 64, 64, 3)
        for label, r in (("the torch backend", ref_t),
                         ("the all-K1 fused model", ref_f)):
            d, tol = _gate_err(out_sw, r, W.WINO_TOL[3], False)
            ok = ok and d <= tol
            print(f"  vs {label} max|d| {d:.3e} tol {tol:.3e} "
                  f"(WINO_TOL[3]*max|ref|) {'ok' if d <= tol else 'FAIL'}")
        if not ok:
            raise SystemExit("chip_smoke: the switched server's outputs are "
                             "wrong")
        # one batch of each algorithm in turns: K4 is faster at 16 by
        # device time, but a batch is host-bound (PERF.md, open questions)
        full_sw = [r.latent for r in rs[:BUCKET]]
        with _plan_cache(switch):
            times_sw = _batch_times(dev, {
                "pretuned": lambda: server.run_group("dcgan", full),
                "switched": lambda: sw.run_group("dcgan", full_sw)})
        for n, t in times_sw.items():
            idle = ("" if t["idle_share"] is None
                    else f", idle share {t['idle_share']:.3f}")
            print(f"batch {n} ({n4} of {len(layers)} layers on K4 in the "
                  f"switched one): one DCGAN batch of {BUCKET} through "
                  f"run_group: {t['host_ms']:.4f} ms host clock (median of "
                  f"10, synchronised, the pretuned and the switched server "
                  f"in turns), device busy {t['busy_ms']:.4f} ms "
                  f"({t['busy_from']}){idle} {tag}")
        # its training step: the switched layers' backward on K2 and K3
        from repro_torch.launch import train_gen
        from repro_torch.models import DCGANDiscriminator, build
        with _plan_cache(switch):
            gen = build("dcgan", "sd_kernel", engine_backend="fused",
                        device=dev)
            disc = DCGANDiscriminator((64, 64), device=dev)
            fb = {l.name: gen._functional_plan(l).backend for l in layers}
            gp = train_gen.trainable(gen.init(
                torch.Generator().manual_seed(SEED)))
            dp = train_gen.trainable(disc.init(
                torch.Generator().manual_seed(SEED + 1)))
            ref_gen = GenerativeModel(gen.spec, "sd_kernel",
                                      engine_backend="torch", device=dev)
            z0 = torch.randn((BUCKET, gen.spec.layers[0].cin),
                             generator=torch.Generator().manual_seed(SEED)
                             ).to(dev)
            torch.cuda.synchronize(dev)
            K.SD_FUSED_LAUNCHES = W.SD_WINO_LAUNCHES = 0
            K.SD_CONV_LAUNCHES = K.SD_FILTER_GRAD_LAUNCHES = 0
            errs = train_gen.grad_check(gen, ref_gen, disc, gp, dp, z0)
            torch.cuda.synchronize(dev)
            g_counts = {"K1": K.SD_FUSED_LAUNCHES, "K4": W.SD_WINO_LAUNCHES,
                        "K2": K.SD_CONV_LAUNCHES,
                        "K3": K.SD_FILTER_GRAD_LAUNCHES}
        worst = max(errs.values())
        g_want = {"K1": n1, "K4": n4, "K2": len(layers), "K3": len(layers)}
        ok = fb == want_sw and g_counts == g_want and worst <= F32_GATE
        print(f"train switched: J_G^T c of full-width DCGAN at batch "
              f"{BUCKET} with the layers bound {fb}: launches {g_counts} "
              f"(want {g_want}); worst leaf max|d|/max|ref| {worst:.3e} "
              f"against the torch backend in f64 (gate {F32_GATE}) "
              f"{'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit("chip_smoke: the switched layers' training "
                             "step left the kernels or disagrees")
        report["switch"] = {"bound": bound_sw, "launches": {
            "sd_fused": s1, "sd_wino": s4}, "train_launches": g_counts,
            "train_worst": worst, "batch": times_sw}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"pretune phase: {report['phase_s']:.1f} s host clock {tag}")
    return report


# ---------------------------------------------------------------------------
# Phase 13: the executor registry
# ---------------------------------------------------------------------------

REGISTRY_NETS = (("dcgan", BUCKET), ("fst", 4))    # (net, batch)
PAPER_TABLE4 = {"dcgan": (1.0, 0.568, 0.534), "fst": (1.0, 0.939, 0.742)}
SD_SSIM_GATE = 0.9999     # SD is exact; shi and chang must fall below
REGISTRY_TIMED = ("native", "nzp", "sd", "sd_paper", "fused", "sd_kernel")
REGISTRY_ROUNDS = 5
# the kernels JSON's names -> phase 13's counters
REGISTRY_KERNELS = {"sd_fused": "K1", "sd_fused_int8": "K1 int8",
                    "sd_conv": "K2", "sd_filter_grad": "K3", "sd_wino": "K4"}


def _launch_counts() -> dict:
    """The port's deconv-kernel launch counters, by kernel."""
    import repro_torch.kernels.sd_conv as K
    import repro_torch.kernels.winograd as W
    return {"K1": K.SD_FUSED_LAUNCHES, "K1 int8": K.SD_FUSED_INT8_LAUNCHES,
            "K2": K.SD_CONV_LAUNCHES, "K2 int8": K.SD_CONV_INT8_LAUNCHES,
            "K3": K.SD_FILTER_GRAD_LAUNCHES, "K4": W.SD_WINO_LAUNCHES}


def _zero_launch_counts() -> None:
    import repro_torch.kernels.sd_conv as K
    import repro_torch.kernels.winograd as W
    K.SD_FUSED_LAUNCHES = K.SD_FUSED_INT8_LAUNCHES = 0
    K.SD_CONV_LAUNCHES = K.SD_CONV_INT8_LAUNCHES = 0
    K.SD_FILTER_GRAD_LAUNCHES = W.SD_WINO_LAUNCHES = 0


def _launch_txt(c: dict) -> str:
    return ", ".join(f"{k} {v}" for k, v in c.items() if v) or "none"


def _registry_phase(dev, tag) -> dict:
    """Phase 13: every registered deconv impl on the card.  (a) runs
    ``registry.selfcheck`` and ``sd.selfcheck`` on the card and checks
    the kernel launches of each impl's checks; (b) runs full-width DCGAN
    (batch 16) and FST (256 x 256, batch 4) through ``build(net, impl)``
    for every impl on one seeded ``native`` model's weights, exact impls
    within ``F32_GATE * max(1, max|ref|)`` of ``native`` and ``winograd``
    within ``WINO_TOL`` of its tap count, with K1 / K4 launches per
    forward; (c) the SSIM of ``sd``, ``shi`` and ``chang`` against
    ``native`` beside the paper's Table 4; (d) ``J_G^T c`` of DCGAN on
    ``sd_fn`` against ``native`` in f64; (e) device ms per DCGAN layer of
    each baseline in turns.  Every failure raises."""
    import torch
    from repro_torch import sd
    from repro_torch.core import registry
    from repro_torch.core.deconv import same_deconv_pads
    from repro_torch.core.ssim import ssim
    from repro_torch.data.pipeline import GANLatentPipeline, cubic_weights
    from repro_torch.kernels.winograd import WINO_TOL
    from repro_torch.launch import train_gen
    from repro_torch.models import DCGANDiscriminator, build

    t_phase = time.perf_counter()
    report = {}
    torch.cuda.synchronize(dev)
    _zero_launch_counts()

    # ---- (a) the self-checks on the card --------------------------------
    per, last = {}, [_launch_counts()]

    def note(name, check):
        torch.cuda.synchronize(dev)
        now = _launch_counts()
        per[(name, check)] = {k: now[k] - last[0][k] for k in now}
        last[0] = now

    t0 = time.perf_counter()
    registry.selfcheck(device=dev, report=note)
    t_reg = time.perf_counter() - t0
    by_impl = {}
    for (name, check), c in per.items():
        tot = by_impl.setdefault(name, dict.fromkeys(c, 0))
        for k, v in c.items():
            tot[k] += v
    print(f"registry: selfcheck on the card passed, {len(registry.names())} "
          f"impls at every declared rank, grads, bf16 and int8 claims, in "
          f"{t_reg:.1f} s host clock {tag}")
    for name in registry.names():
        checks = "; ".join(f"{c} {_launch_txt(v)}" for (n, c), v in
                           per.items() if n == name and any(v.values()))
        print(f"  {name:<10} launches: {_launch_txt(by_impl[name])}"
              f"{' (' + checks + ')' if checks else ''}")
    want = [(f"{n} launches K1", by_impl[n]["K1"])
            for n in ("fused", "sd_fn", "sd_kernel")]
    for r in (1, 2):
        g = per[("sd_fn", f"rank {r} grad")]
        want += [(f"sd_fn rank {r} grad launches K2", g["K2"]),
                 (f"sd_fn rank {r} grad launches K3", g["K3"]),
                 (f"winograd rank {r} launches K4",
                  per[("winograd", f"rank {r}")]["K4"])]
    want.append(("sd_kernel's int8 claim launches K1 int8",
                 per[("sd_kernel", "int8")]["K1 int8"]))
    missing = [what for what, n in want if n == 0]
    if missing:
        raise SystemExit(f"chip_smoke: registry selfcheck passed over a "
                         f"kernel: {missing}")
    before = _launch_counts()
    t0 = time.perf_counter()
    sd.selfcheck(device=dev)
    torch.cuda.synchronize(dev)
    after = _launch_counts()
    sd_counts = {k: after[k] - before[k] for k in after}
    print(f"sd: selfcheck on the card passed (forward, dx/dw/db, a bound "
          f"plan, the split's inverse, ranks 1 and 3 with output_padding) "
          f"in {time.perf_counter() - t0:.1f} s host clock; launches "
          f"{_launch_txt(sd_counts)} {tag}")
    if not (sd_counts["K1"] and sd_counts["K2"] and sd_counts["K3"]):
        raise SystemExit("chip_smoke: sd.selfcheck did not run K1, K2 and "
                         "K3")
    report["selfcheck"] = {"launches": {f"{n} / {c}": v
                                        for (n, c), v in per.items()},
                           "sd_launches": sd_counts}

    # ---- (b) full width, every impl; (c) Table 4 -------------------------
    kernel_of = {"fused": "K1", "sd_fn": "K1", "sd_kernel": "K1",
                 "winograd": "K4"}
    report["nets"] = {}
    for net, batch in REGISTRY_NETS:
        ref_m = build(net, "native", device=dev)
        params = ref_m.init(torch.Generator().manual_seed(SEED))
        gen = torch.Generator().manual_seed(SEED + 1)
        if net == "dcgan":
            x = torch.randn(ref_m.input_shape(batch), generator=gen)
        else:   # a smooth content image, as the reference's Table 4 feeds
            low = torch.randn(batch, 16, 16, 3, generator=gen)
            wc = torch.from_numpy(cubic_weights(16, 256))
            x = torch.tanh(torch.einsum("bhwc,hy,wx->byxc", low, wc, wc))
        x = x.to(dev)
        with torch.no_grad():
            ref = ref_m.apply(params, x)
        torch.cuda.synchronize(dev)
        ndc = len(ref_m.spec.deconv_layers())
        kt = max(-(-l.k // l.s) for l in ref_m.spec.deconv_layers())
        print(f"registry: full-width {net} {tuple(x.shape)} -> "
              f"{tuple(ref.shape)} through build({net!r}, impl) for every "
              f"impl, weights of one seeded native model; exact impls within "
              f"{F32_GATE}*max(1,max|ref|) of native (TF32 off), winograd "
              f"within WINO_TOL[{kt}] = {WINO_TOL[kt]}*max(1,max|ref|) "
              f"{tag}")
        outs, rows = {}, {}
        for impl in registry.names():
            info = registry.get_impl(impl)
            m = build(net, impl, device=dev)
            torch.cuda.synchronize(dev)
            c0 = _launch_counts()
            with torch.no_grad():
                y = m.apply(params, x)
            torch.cuda.synchronize(dev)
            c1 = _launch_counts()
            counts = {k: c1[k] - c0[k] for k in c1}
            d, tol = _gate_err(y, ref, WINO_TOL[kt] if info.tolerance
                               else F32_GATE, True)
            launch_ok = counts == {k: (ndc if k == kernel_of.get(impl)
                                       else 0) for k in counts}
            finite = bool(torch.isfinite(y).all())
            gated = info.exact or bool(info.tolerance)
            ok = (finite and launch_ok and y.shape == ref.shape
                  and (d <= tol or not gated))
            print(f"  {net}/{impl:<10} max|d| {d:.3e} "
                  f"{'tol ' + format(tol, '.3e') if gated else '(not exact)'}"
                  f", launches per forward {_launch_txt(counts)} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"chip_smoke: {net} on {impl} is wrong or "
                                 f"left its kernels ({counts})")
            outs[impl] = y
            rows[impl] = {"max_abs_err": d, "tol": tol if gated else None,
                          "launches": counts}
        vals = {i: ssim(ref, outs[i], data_range=2.0).item()
                for i in ("sd", "shi", "chang")}
        paper = PAPER_TABLE4[net]
        ok = (vals["sd"] >= SD_SSIM_GATE and vals["shi"] < SD_SSIM_GATE
              and vals["chang"] < SD_SSIM_GATE)
        print(f"table 4: {net} SSIM against native (data_range 2.0): SD "
              f"{vals['sd']:.6f}, Shi [30] {vals['shi']:.6f}, Chang [31] "
              f"{vals['chang']:.6f}; paper {paper[0]} / {paper[1]} / "
              f"{paper[2]} on trained weights (these are random, seed "
              f"{SEED}); gate SD >= {SD_SSIM_GATE} > Shi, Chang "
              f"{'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"chip_smoke: Table 4's ordering fails on {net}")
        report["nets"][net] = {"impls": rows, "ssim": vals}
        del outs

    # ---- (d) J_G^T c through sd_fn --------------------------------------
    gen_m = build("dcgan", "sd_fn", device=dev)
    ref_g = build("dcgan", "native", device=dev)
    disc = DCGANDiscriminator((64, 64), device=dev)
    gp = train_gen.trainable(gen_m.init(torch.Generator().manual_seed(SEED)))
    dp = train_gen.trainable(disc.init(
        torch.Generator().manual_seed(SEED + 1)))
    z0 = GANLatentPipeline(z_dim=gen_m.spec.layers[0].cin,
                           global_batch=BUCKET, seed=SEED).batch(0).to(dev)
    torch.cuda.synchronize(dev)
    c0 = _launch_counts()
    errs = train_gen.grad_check(gen_m, ref_g, disc, gp, dp, z0)
    torch.cuda.synchronize(dev)
    c1 = _launch_counts()
    g_counts = {k: c1[k] - c0[k] for k in ("K1", "K2", "K3")}
    worst = max(errs.values())
    ok = worst <= F32_GATE and g_counts == {"K1": 3, "K2": 3, "K3": 3}
    print(f"registry grads: J_G^T c of full-width DCGAN at batch {BUCKET} "
          f"through build('dcgan', 'sd_fn'), f32, against native in f64: "
          f"worst leaf max|d|/max|ref| {worst:.3e} ({max(errs, key=errs.get)}"
          f"), gate {F32_GATE}; launches {g_counts} (want 3 each) "
          f"{'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit("chip_smoke: sd_fn's gradient is wrong or left "
                         "K2/K3")
    report["grads"] = {"worst": worst, "launches": g_counts}
    torch.cuda.synchronize(dev)
    report["launches"] = _launch_counts()

    # ---- (e) the paper's comparison per DCGAN layer, in turns ----------
    from repro_torch.core.accounting import BENCHMARKS
    print(f"time: DCGAN layers at batch {BUCKET}, f32, each registered "
          f"baseline in turns (median of {REGISTRY_ROUNDS} rounds of "
          f"kernels.timing.ahead_ms, device ms of one call; fused splits "
          f"inline every call, sd_kernel is a presplit bound plan); not a "
          f"claim {tag}")
    timing = {}
    rng = torch.Generator().manual_seed(SEED + 2)
    for l in BENCHMARKS["dcgan"]().deconv_layers():
        pads = same_deconv_pads(l.k, l.s)
        x = torch.randn(BUCKET, *l.in_hw, l.cin, generator=rng).to(dev)
        w = (torch.randn(l.k, l.k, l.cin, l.cout, generator=rng)
             / (l.k * l.k * l.cin) ** 0.5).to(dev)
        bound = sd.plan(w.shape, l.s, pads, backend="fused",
                        device=dev).bind(w)
        fns = {i: (lambda f=registry.resolve(i): f(x, w, l.s, pads))
               for i in REGISTRY_TIMED if i != "sd_kernel"}
        fns["sd_kernel"] = lambda: sd.execute(bound, x)
        runs = {i: [] for i in fns}
        with torch.no_grad():
            ref = fns["native"]()
            for i, f in fns.items():
                d, tol = _gate_err(f(), ref, F32_GATE, True)
                if d > tol:
                    raise SystemExit(f"chip_smoke: {i} on dcgan/{l.name} "
                                     f"differs from native ({d:.3e})")
            for r in range(REGISTRY_ROUNDS):
                for i in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                    runs[i].append(_ahead_ms(fns[i]))
        med = {i: sorted(v)[len(v) // 2] for i, v in runs.items()}
        timing[l.name] = med
        print(f"  dcgan/{l.name} {tuple(x.shape)}: "
              + " / ".join(f"{i} {med[i]:.4f}" for i in fns)
              + f" ms; sm clock, power, temperature {_clocks()} {tag}")
    report["time_ms"] = timing
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"registry phase: {report['phase_s']:.1f} s host clock {tag}")
    return report


# ---------------------------------------------------------------------------
# Phase 14: scale-out, gloo ranks on one card
# ---------------------------------------------------------------------------

SCALE_F32_GATE = 1e-5     # sharded vs unsharded, rel. max(1, max|ref|)
SCALE_SERVE_GATE = 1e-4   # the mesh server vs the one-process server
SCALE_LOSS_RTOL = 1e-5    # sharded train step vs make_train_step
SCALE_PARAM_GATE = 1e-4   # new params, rel. max(1, max|ref|) per leaf
SCALE_GRAD_GATE = 1e-4    # grads, rel. the leaf's max|g_ref|
# One SGD step at this lr reads the gradient: the step is p - lr*g, and
# at lr*|g| far above |p| (p - new)/lr is g to f32 rounding.  At
# SCALE_LR the update (1e-7..1e-5 per element on full-width DCGAN) sits
# far under the new-params gate, which then cannot see a wrong gradient.
SCALE_GRAD_LR = 1e6
SCALE_SPAWN_S = 300       # each spawn's deadline and collective timeout
SCALE_LR = 1e-2
# The reference's Cout-shard parity cases (tests/test_shard.py:137-163)
# on the port's backends, and a rank-3 int8 one for K2's int8 pair:
# (x shape, w shape, stride, dtype, backends)
SCALE_CASES = (
    ((2, 5, 6, 3), (4, 4, 3, 8), 2, "native", ("torch", "fused", "winograd")),
    ((2, 5, 6, 3), (5, 5, 3, 6), 3, "native", ("torch", "fused")),
    ((2, 7, 4), (4, 4, 8), 2, "native", ("torch", "fused", "winograd")),
    ((1, 3, 4, 5, 2), (4, 4, 4, 2, 4), 2, "native", ("torch", "fused")),
    ((2, 5, 6, 3), (4, 4, 3, 8), 2, "int8", ("torch", "fused")),
    ((1, 3, 4, 5, 2), (4, 4, 4, 2, 4), 2, "int8", ("fused",)),
)
# the kernels JSON's names -> the launch counters
SCALE_KERNELS = {**REGISTRY_KERNELS, "sd_conv_int8": "K2 int8"}


def _want_launches(rank: int, s: int, k: int, backend: str, dtype: str
                   ) -> dict:
    """Launches per rank of one sharded layer: one per shard (one per
    depth tap for the rank-3 lowering), none on ``torch``."""
    if backend == "torch":
        return {}
    if backend == "winograd":
        return {"K4": 1}
    if rank == 3:
        return {"K2 int8" if dtype == "int8" else "K2": -(-k // s)}
    return {"K1 int8" if dtype == "int8" else "K1": 1}


def _launched(fn) -> tuple:
    """``fn()`` with the launch counters zeroed before and read after:
    (its result, the nonzero counts)."""
    _zero_launch_counts()
    out = fn()
    return out, {k: v for k, v in _launch_counts().items() if v}


def _scaleout_rank(rank: int, world: int, cfg: dict) -> dict:
    """One gloo rank of phase 14 on ``cfg["device"]`` (see
    :func:`_scaleout_phase`).  Raises on any failed gate; returns its
    lines (rank 0), launch counts and readings."""
    import tempfile
    import torch
    from repro_torch import sd
    from repro_torch.core.accounting import WORKLOADS
    from repro_torch.core.deconv import same_deconv_pads
    from repro_torch.distributed import local_block
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.serve_gen import GenServer, serve_async
    from repro_torch.launch.train_gen import (make_sharded_train_step,
                                              make_train_step, place_params)
    from repro_torch.models.generative import GenerativeModel

    dev = torch.device(cfg["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["REPRO_TORCH_SD_CALIB_CACHE"] = os.path.join(
        tempfile.mkdtemp(prefix="chip_smoke_calib_"), "sd_calib.json")
    tag, lines = cfg["tag"], []
    total = {}                    # launches summed over the sharded runs

    def say(msg):
        if rank == 0:
            lines.append(msg)

    def count(c):
        for k, v in c.items():
            total[k] = total.get(k, 0) + v

    def check(ok, what):
        if not ok:
            raise AssertionError(f"rank {rank}: {what}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    dp, mp = cfg["dp"], cfg["mp"]
    mesh = make_dev_mesh(dp, mp, backend="gloo", device=dev)
    where = f"dp{dp}xmp{mp}, {world} gloo ranks on {dev}"
    gen = torch.Generator().manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    readings = {}
    if cfg["part"] == "mp2":
        # ---- (a) parity: sharded execute_spmd vs unsharded execute ------
        say(f"scale-out (a): execute_spmd on {where} vs unsharded execute, "
            f"f32 within {SCALE_F32_GATE}*max(1,max|ref|), int8 exact {tag}")
        cases = [(f"case{i}", xs, ws, s, 1, dt, be)
                 for i, (xs, ws, s, dt, bes) in enumerate(SCALE_CASES)
                 for be in bes]
        dc = WORKLOADS["dcgan"]().layers
        for l in dc[1:3]:                       # d1, d2: cout 128, 64
            for be, dt in (("fused", "native"), ("fused", "int8"),
                           ("winograd", "native")):
                cases.append((f"dcgan/{l.name}", (BUCKET, *l.in_hw, l.cin),
                              (l.k, l.k, l.cin, l.cout), l.s,
                              same_deconv_pads(l.k, l.s), dt, be))
        for name, xs, ws, s, pad, dt, be in cases:
            x = randn(*xs)
            w = randn(*ws, scale=1.0 / (math.prod(ws[:-1])) ** 0.5)
            scale = randn(ws[-1], scale=0.1) + 1.0
            bias = randn(ws[-1], scale=0.1)
            p = sd.plan(ws, s, pad, backend=be, act="relu", dtype=dt,
                        device=dev)
            ref = sd.execute(p.bind(w, scale, bias), x)
            bp = p.bind(w, scale, bias, mesh=mesh)
            check(bp.shards == mp and bp.bias.shape[0] == ws[-1] // mp,
                  f"{name} {be} bound {bp.shards} shards")
            y, got = _launched(lambda: sd.execute_spmd(bp, x, mesh))
            sync()
            count(got)
            want = _want_launches(len(ws) - 2, s, ws[0], be, dt)
            if dt == "int8":
                d, tol = (y.float() - ref.float()).abs().max().item(), 0.0
            else:
                d, tol = _gate_err(y, ref, SCALE_F32_GATE, True)
            ok = (d <= tol and got == want
                  and tuple(y.shape) == tuple(ref.shape))
            say(f"  {name} {be} {dt} x{tuple(xs)} w{tuple(ws)} s{s}: "
                f"launches per rank {_launch_txt(got)} (want "
                f"{_launch_txt(want)}), max|d| {d:.3e} tol {tol:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, f"parity {name} {be} {dt}: max|d| {d} launches {got}")
        # per-shard K1 on d1 and the gather of its output
        l = dc[1]
        x = randn(BUCKET, *l.in_hw, l.cin)
        w = randn(l.k, l.k, l.cin, l.cout, scale=1.0 / (25 * l.cin) ** 0.5)
        p = sd.plan(w.shape, l.s, same_deconv_pads(l.k, l.s),
                    backend="fused", act="relu", device=dev)
        full, bp = p.bind(w), p.bind(w, mesh=mesh)
        block = bp.block()                              # no gather
        y_local = sd.execute(block, x)
        mesh.barrier()
        if rank == 0 and dev.type == "cuda":
            readings["k1_d1_full_ms"] = _ahead_ms(lambda: sd.execute(full, x))
            readings["k1_d1_block_ms"] = _ahead_ms(
                lambda: sd.execute(block, x))
        mesh.barrier()
        gms = []
        for _ in range(21):
            sync()
            t0 = time.perf_counter()
            mesh.all_gather(y_local, "model", y_local.ndim - 1)
            sync()
            gms.append((time.perf_counter() - t0) * 1e3)
        readings["gather_d1_ms"] = sorted(gms)[10]
        readings["gather_d1_bytes"] = y_local.numel() * 4
        say(f"  time: K1 on d1 at batch {BUCKET}, device ms (ahead events): "
            f"unsharded {_ms_txt(readings.get('k1_d1_full_ms'))}, one Cout "
            f"block of {bp.cout_local} {_ms_txt(readings.get('k1_d1_block_ms'))}"
            f"; gather of d1's output ({readings['gather_d1_bytes']} bytes per "
            f"rank) {readings['gather_d1_ms']:.4f} ms host clock, median of "
            f"21 (gloo on one card, not a scale-out time) {tag}")
    # ---- (b) serving ----------------------------------------------------
    nets = ("dcgan",)
    servers = [("f32 fused", dict(backend="fused"), SCALE_SERVE_GATE),
               ("calibrated int8", dict(backend="fused", dtype="int8",
                                        calib=64), 0.0)]
    if cfg["part"] == "mp2":
        servers.append(("f32 winograd", dict(backend="winograd"),
                        SCALE_SERVE_GATE))
    for label, kw, gate in servers:
        srv = GenServer(nets=nets, device=dev, dp=dp, mp=mp,
                        dist_backend="gloo", seed=SEED, **kw)
        model, _ = srv.model("dcgan")
        plans = model.engine.plans()
        shards = [plans[n].shards for n in ("d1", "d2", "d3")]
        check(shards == [mp, mp, 1], f"{label}: shards {shards}")
        est = None
        if label == "f32 fused":
            model.engine.pretune([BUCKET], iters=2)
            est = srv.estimate_ms("dcgan", BUCKET)
            check(est is not None, "estimate_ms after the mesh pretune")
        reqs = srv.random_requests("dcgan", SERVE_REQUESTS, seed=5)
        sync()
        (results, stats), got = _launched(lambda: serve_async(srv, reqs))
        sync()
        count(got)
        batches = stats["launches"]
        kern = ("K4" if kw["backend"] == "winograd"
                else "K1 int8" if kw.get("dtype") == "int8" else "K1")
        want = {kern: 3 * batches}
        y = torch.stack([results[r.rid] for r in reqs])
        keys = stats["compile_cache"]
        check(got == want, f"{label}: launches {got}, want {want}")
        check(stats["shed"] == 0 and bool(torch.isfinite(y).all()),
              f"{label}: shed {stats['shed']} or non-finite output")
        check(all(k.endswith(f"'dp{dp}xmp{mp}')") for k in keys),
              f"{label}: cell keys {keys}")
        n0 = srv.compile_count
        srv.swap_checkpoint("dcgan", model.init(
            torch.Generator().manual_seed(99)))
        srv.run_group("dcgan", [r.latent for r in reqs[:BUCKET]])
        check(srv.compile_count == n0, f"{label}: swap built a cell")
        d = tol = d_bucket = None
        host = {}
        if rank == 0:
            one = GenServer(nets=nets, device=dev, seed=SEED, **kw)

            def one_run(rows):
                return torch.cat([one.run_group("dcgan", [r.latent for r in
                                                          reqs[i:i + rows]])
                                  for i in range(0, len(reqs), rows)])

            ref = one_run(BUCKET)
            if gate:
                d, tol = _gate_err(y, ref, gate, True)
            else:
                # int8 codes are exact only against the same fc GEMM:
                # cuBLAS's f32 sums for the latents' fc (before d1's
                # static quantization) depend on its batch, so a data
                # rank's BUCKET/dp rows are held to the one-process
                # server run on the same blocks
                d_bucket = (y - ref).abs().max().item()
                d = (d_bucket if dp == 1 else
                     (y - one_run(BUCKET // dp)).abs().max().item())
                tol = 0.0
            check(d <= tol, f"{label}: vs the one-process server "
                  f"max|d| {d} > {tol}")
        # host ms per batch, mesh and one process in turns (rank 0's
        # one-process turns run while the other ranks wait)
        zs = [r.latent for r in reqs[:BUCKET]]
        mesh_ms, one_ms = [], []
        for _ in range(5):
            mesh.barrier()
            sync()
            t0 = time.perf_counter()
            srv.run_group("dcgan", zs)
            sync()
            mesh_ms.append((time.perf_counter() - t0) * 1e3)
            mesh.barrier()
            if rank == 0:
                sync()
                t0 = time.perf_counter()
                one.run_group("dcgan", zs)
                sync()
                one_ms.append((time.perf_counter() - t0) * 1e3)
        host[label] = (sorted(mesh_ms)[2],
                       sorted(one_ms)[2] if one_ms else None)
        readings[f"serve {label}"] = {
            "launches": got, "max_abs_err": d,
            "max_abs_err_vs_bucket": d_bucket, "estimate_ms": est,
            "host_ms_mesh": host[label][0], "host_ms_one": host[label][1],
            "cells": keys}
        if rank == 0:
            say(f"scale-out (b): serve {label} DCGAN on {where}: "
                f"{SERVE_REQUESTS} requests, {batches} batches, launches per "
                f"rank {_launch_txt(got)}, 0 shed, cells {keys}, no new cell "
                f"after swap_checkpoint"
                + f", vs the one-process server max|d| {d:.3e} tol {tol:.3e}"
                + (f" on the same {BUCKET // dp}-row blocks ({d_bucket:.3e} "
                   f"against its {BUCKET}-row batches: the fc's cuBLAS "
                   f"sums move with the batch and flip codes)"
                   if d_bucket is not None and dp > 1 else "")
                + (f", estimate_ms({BUCKET}) {est:.4f} (one rank's launches, "
                   f"device time, gathers left out)" if est is not None
                   else "")
                + f"; host ms per batch of {BUCKET}: mesh {host[label][0]:.2f}, "
                f"one process {host[label][1]:.2f} (gloo on one card, not a "
                f"scale-out time) {tag}")
    # ---- (c) training ---------------------------------------------------
    if cfg["part"] == "mp2":
        spec = WORKLOADS["dcgan"]()
        model = GenerativeModel(spec, "sd_kernel", engine_backend="fused",
                                device=dev)
        params = model.init(torch.Generator().manual_seed(SEED))
        z = randn(BUCKET, spec.layers[0].cin)
        t = randn(BUCKET, 64, 64, 3, scale=0.5)

        def grads(p, new):
            return {k: {n: (p[k][n] - new[k][n]) / SCALE_GRAD_LR
                        for n in p[k]} for k in p}

        new_ref, loss_ref = make_train_step(model, lr=SCALE_LR)(params, z, t)
        g_ref = grads(params, make_train_step(model, lr=SCALE_GRAD_LR)(
            params, z, t)[0])
        sync()
        want = {"K1": 3, "K2": 3, "K3": 3}
        for mtag, mdp, mmp in (("mp2", 1, 2), ("dp2", 2, 1)):
            m = mesh if (mdp, mmp) == (dp, mp) else make_dev_mesh(
                mdp, mmp, backend="gloo", device=dev)
            step, specs = make_sharded_train_step(model, m, lr=SCALE_LR)
            gstep, _ = make_sharded_train_step(model, m, lr=SCALE_GRAD_LR)
            placed = place_params(params, m, specs)
            (new, loss), got = _launched(lambda: step(placed, z, t))
            sync()
            count(got)
            (gnew, _), ggot = _launched(lambda: gstep(placed, z, t))
            sync()
            count(ggot)
            g = grads(placed, gnew)
            rel = abs(loss.item() - loss_ref.item()) / abs(loss_ref.item())
            worst = worst_g = 0.0
            for k in new:
                for n in new[k]:
                    r_ = local_block(new_ref[k][n], specs[k][n], m)
                    dd, tt = _gate_err(new[k][n], r_, SCALE_PARAM_GATE, True)
                    worst = max(worst, dd / tt)
                    # this rank's block of the leaf, gated on the whole
                    # leaf's largest gradient
                    gr = local_block(g_ref[k][n], specs[k][n], m)
                    tt = SCALE_GRAD_GATE * g_ref[k][n].abs().max().item()
                    dd = (g[k][n] - gr).abs().max().item()
                    worst_g = max(worst_g, dd / tt)
            ok = (rel <= SCALE_LOSS_RTOL and worst <= 1.0 and worst_g <= 1.0
                  and got == want and ggot == want)
            readings[f"train {mtag}"] = {"loss": loss.item(),
                                         "loss_ref": loss_ref.item(),
                                         "loss_rel": rel,
                                         "params_share_of_gate": worst,
                                         "grads_share_of_gate": worst_g,
                                         "launches": got}
            say(f"scale-out (c): train {mtag} (dp{mdp}xmp{mmp}) full-width "
                f"DCGAN, batch {BUCKET}, one SGD step: loss {loss.item():.6f}"
                f" vs make_train_step {loss_ref.item():.6f} (rel {rel:.2e}, "
                f"gate {SCALE_LOSS_RTOL}), new params at {worst:.3f} of "
                f"their gate ({SCALE_PARAM_GATE}*max(1,max|ref|)), grads "
                f"(p - new)/lr of a step at lr {SCALE_GRAD_LR:g} at "
                f"{worst_g:.3f} of their gate ({SCALE_GRAD_GATE}*max|g_ref| "
                f"per leaf), launches per rank per step {_launch_txt(got)} "
                f"{'ok' if ok else 'FAIL'} {tag}")
            check(ok, f"train {mtag}: loss rel {rel}, params {worst}, "
                  f"grads {worst_g}, launches {got} {ggot}")
    return {"lines": lines, "launches": total, "readings": readings}


def _scaleout_phase(dev, tag, rank_fn=None) -> dict:
    """Phase 14: scale-out on one card, the kernels built once above.
    Spawns gloo ranks on ``dev`` through ``repro_torch.launch.mesh.
    spawn`` (each with a deadline and a collective timeout; a failed or
    late rank fails the script): two ranks as dp1 x mp2 run (a) the
    reference's Cout-shard parity cases and full-width DCGAN d1/d2 on K1,
    K1 int8 and K4 against the unsharded plans, (b) the f32 (pretuned on
    the mesh, for ``estimate_ms``), calibrated int8 and winograd servers
    against the one-process servers, and (c) one sharded train step at mp
    2 and at dp 2 against ``make_train_step``, new params and gradients;
    four ranks as dp2 x mp2
    run (b)'s f32 and calibrated int8 servers.  Counts each kernel's
    launches per rank; every time printed is gloo on one card."""
    import shutil
    import tempfile
    from repro_torch.launch.mesh import spawn
    rank_fn = rank_fn or _scaleout_rank
    t0 = time.perf_counter()
    report = {"launches": {}, "readings": {}}
    work = tempfile.mkdtemp(prefix="chip_smoke_scaleout_")
    try:
        # a fresh tile cache: the mesh pretune's entries stay in it
        with _plan_cache(os.path.join(work, "sd_plans.json")):
            for part, dp, mp in (("mp2", 1, 2), ("dp2xmp2", 2, 2)):
                cfg = {"part": part, "dp": dp, "mp": mp, "device": str(dev),
                       "tag": tag}
                try:
                    out = spawn(rank_fn, dp * mp, backend="gloo",
                                args=(cfg,), timeout_s=SCALE_SPAWN_S)
                except RuntimeError as e:
                    raise SystemExit(f"chip_smoke: phase 14 ({part}) "
                                     f"failed: {e}")
                for line in out[0]["lines"]:
                    print(line)
                for k, v in out[0]["launches"].items():
                    report["launches"][k] = report["launches"].get(k, 0) + v
                report["readings"][part] = out[0]["readings"]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    report["phase_s"] = time.perf_counter() - t0
    print(f"scale-out: launches on rank 0 over phase 14's sharded runs "
          f"{_launch_txt(report['launches'])}; phase {report['phase_s']:.1f} "
          f"s host clock {tag}")
    missing = [k for k in SCALE_KERNELS.values()
               if not report["launches"].get(k)]
    if missing:
        raise SystemExit(f"chip_smoke: phase 14 launched no {missing} on a "
                         "shard")
    return report


# ---------------------------------------------------------------------------
# Phase 15: checkpoints and dense-LM training
# ---------------------------------------------------------------------------

CKPT_GAN_STEPS = 6        # (a): the blocking save at the end is step 6
LM_RESUME_STEPS = 6       # (b): straight, and resumed from step 3's save
LM_RESUME_EVERY = 3
LM_CHECK_STEPS = 3        # (c): card against the CPU, reduced StableLM
LM_CHECK_SEQ, LM_CHECK_BATCH = 32, 4
LM_CHECK_LR = 1e-3
LM_LONG_SEQ = 4096        # (c): past 2,048 tokens, the scan under grad
LM_TRAIN_LAYERS = 2       # (d): full-width StableLM-2-12B cut to 2 of 40
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 128
LM_TRAIN_STEPS = 3
LM_LOSS_RTOL = 1e-5       # card loss vs CPU, relative
LM_PARAM_GATE = 1e-5      # card params vs CPU, rel. max(1, max|ref|)
LM_GRAD_GATE = 1e-4       # card grads vs CPU, rel. the leaf's max|ref|
LM_LOOSE_SHARE = 0.01     # AdamW's undetermined elements, at most
CKPT_KERNELS = {"sd_fused": "K1", "sd_conv": "K2", "sd_filter_grad": "K3"}


def _leaf_items(tree):
    from repro_torch.checkpoint.manager import _flatten
    return {k: v for k, v in _flatten(tree).items()
            if not k.endswith("#none")}


def _adam_gate(got, want, grads, lr: float, share_exempt=()) -> dict:
    """Params after ``len(grads)`` AdamW steps against a reference run:
    ``max|d|`` over the elements whose reference gradient was determined
    at every step (above ``LM_GRAD_GATE`` of its leaf's max), gated at
    ``LM_PARAM_GATE * max(1, max|ref|)``; AdamW divides each element's
    moment by its own magnitude, so an element whose gradient sits at
    the sums' rounding level moves by an arbitrary share of its bound
    ``lr`` a step: those are held to ``2 * lr * steps`` and to
    ``LM_LOOSE_SHARE`` of the elements, those of the leaves in
    ``share_exempt`` left out of that share (each leaf's share in
    ``per_leaf``).  Returns the worst reading."""
    import torch
    g, w = _leaf_items(got), _leaf_items(want)
    gs = [_leaf_items(t) for t in grads]
    worst = {"ratio": 0.0, "leaf": None, "loose": 0, "total": 0,
             "loose_max": 0.0, "ok": sorted(g) == sorted(w), "per_leaf": {}}
    for k, ref in w.items():
        a = g[k].detach().float().cpu()
        b = ref.detach().float().cpu()
        free = torch.zeros(b.shape, dtype=torch.bool)
        for t in gs:
            r = t[k].detach().float().cpu().abs()
            free |= (r > 0) & (r <= LM_GRAD_GATE * r.max())
        d = (a - b).abs()
        tol = LM_PARAM_GATE * max(1.0, b.abs().max().item())
        fixed = d[~free].max().item() if (~free).any() else 0.0
        loose = d[free].max().item() if free.any() else 0.0
        if fixed / tol > worst["ratio"]:
            worst.update(ratio=fixed / tol, leaf=k)
        worst["loose_max"] = max(worst["loose_max"], loose)
        worst["per_leaf"][k] = (int(free.sum()), free.numel(), loose)
        if k not in share_exempt:
            worst["loose"] += int(free.sum())
            worst["total"] += free.numel()
        if fixed > tol or loose > 2 * lr * len(gs):
            worst["ok"] = False
    if worst["loose"] > LM_LOOSE_SHARE * worst["total"]:
        worst["ok"] = False
    return worst


def _ckpt_gan(dev, tag, work) -> dict:
    """Phase 15 (a): ``train_gen.main`` on full-width DCGAN through K1 /
    K2 / K3, its blocking step-6 checkpoint restored bit for bit, and a
    server swapped onto the restored generator serving bit-identically
    to one holding the trained generator."""
    import torch
    import repro_torch.kernels.sd_conv as K
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import GANLatentPipeline
    from repro_torch.launch import train_gen
    from repro_torch.launch.serve_gen import GenServer

    def counts():
        return (K.SD_FUSED_LAUNCHES, K.SD_CONV_LAUNCHES,
                K.SD_FILTER_GRAD_LAUNCHES)

    steps = {"d": [], "g": []}
    held = {}
    real_d, real_g = train_gen.d_step, train_gen.g_step

    def d_counted(*a):
        c0 = counts()
        out = real_d(*a)
        steps["d"].append(tuple(b - c for b, c in zip(counts(), c0)))
        return out

    def g_counted(gen, disc, gp, dp, g_opt, z):
        c0 = counts()
        out = real_g(gen, disc, gp, dp, g_opt, z)
        steps["g"].append(tuple(b - c for b, c in zip(counts(), c0)))
        held.update(gen=gen, disc=disc, g=gp, d=dp)
        return out

    out_dir = os.path.join(work, "dcgan")
    torch.cuda.synchronize()
    _zero_launch_counts()
    train_gen.d_step, train_gen.g_step = d_counted, g_counted
    t0 = time.perf_counter()
    try:
        d_hist, g_hist = train_gen.main([
            "--steps", str(CKPT_GAN_STEPS), "--batch", str(BUCKET),
            "--out", out_dir, "--deconv-impl", "sd_kernel",
            "--device", str(dev)])
    finally:
        train_gen.d_step, train_gen.g_step = real_d, real_g
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(CKPT_KERNELS, counts()))
    gen, disc = held["gen"], held["disc"]
    ok_launch = (all(s == (3, 0, 0) for s in steps["d"])
                 and all(s == (3, 3, 3) for s in steps["g"])
                 and len(steps["g"]) == CKPT_GAN_STEPS)
    mgr = CheckpointManager(os.path.join(out_dir, "ckpt"))
    template = {"g": gen.init(torch.Generator().manual_seed(SEED + 7)),
                "d": disc.init(torch.Generator().manual_seed(SEED + 8))}
    step, got = mgr.restore(template)
    mem = {"g": held["g"], "d": held["d"]}
    differ = [f"{net}/{k}/{n}" for net in mem for k in mem[net]
              for n in mem[net][k]
              if not torch.equal(got[net][k][n], mem[net][k][n].detach())]
    ok_restore = (step == CKPT_GAN_STEPS and mgr.steps() == [step]
                  and not differ
                  and all(map(math.isfinite, d_hist + g_hist)))
    print(f"ckpt (a): train_gen.main --steps {CKPT_GAN_STEPS} --batch "
          f"{BUCKET} --deconv-impl sd_kernel on full-width DCGAN: "
          f"{wall:.2f} s host clock, launches per D step {steps['d']}, per "
          f"G step {steps['g']} (K1, K2, K3), in the run {launches}; "
          f"d_loss {d_hist[-1]:.4f} g_loss {g_hist[-1]:.4f}; checkpoints "
          f"{mgr.steps()}, step {step} restored into a fresh template: "
          f"{len(differ)} leaves differ from the trained {{g, d}} "
          f"{'ok' if ok_launch and ok_restore else 'FAIL'} {tag}")
    if not ok_launch:
        raise SystemExit("chip_smoke: phase 15 (a)'s GAN steps did not run "
                         "K1 3 (D), K1/K2/K3 3/3/3 (G)")
    if not ok_restore:
        raise SystemExit(f"chip_smoke: phase 15 (a)'s checkpoint does not "
                         f"restore the trained nets: {differ[:4]}")

    # the restored generator, hot-swapped into a server, serves as the
    # trained one does
    z = GANLatentPipeline(z_dim=gen.spec.layers[0].cin, global_batch=BUCKET,
                          seed=SEED + 9).batch(0)
    latents = list(z.numpy())
    served = {}
    for name, g in (("trained", {k: {n: t.detach() for n, t in v.items()}
                                 for k, v in held["g"].items()}),
                    ("restored", got["g"])):
        server = GenServer(("dcgan",), device=dev, backend="fused",
                           seed=SEED)
        server.swap_checkpoint("dcgan", g)
        before = K.SD_FUSED_LAUNCHES
        served[name] = server.run_group("dcgan", latents)
        torch.cuda.synchronize()
        served[name + "_k1"] = K.SD_FUSED_LAUNCHES - before
    ok = (torch.equal(served["trained"], served["restored"])
          and served["restored_k1"] == 3
          and bool(torch.isfinite(served["restored"]).all())
          and tuple(served["restored"].shape) == (BUCKET, 64, 64, 3))
    print(f"ckpt (a): GenServer.swap_checkpoint with the restored G serves "
          f"{BUCKET} latents {tuple(served['restored'].shape)} "
          f"{'bit-identical' if ok else 'NOT identical'} to a server "
          f"holding the trained G, K1 launches {served['restored_k1']} / "
          f"{served['trained_k1']} {'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit("chip_smoke: phase 15 (a): the restored generator "
                         "serves differently")
    return {"launches": launches, "d_steps": steps["d"],
            "g_steps": steps["g"], "wall_s": wall, "d_loss": d_hist,
            "g_loss": g_hist}


def _lm_resume(dev, tag, work) -> dict:
    """Phase 15 (b): ``launch.train.main`` on the reduced StableLM on the
    card, 6 steps straight (checkpoints at 3 and 6), then a fresh call
    with ``--resume auto`` whose ``--out`` holds the step-3 checkpoint
    alone (a job preempted after it): params bit for bit."""
    import shutil
    import torch
    import repro_torch.kernels.flash_attn as FA
    from repro_torch.launch import train

    base = ["--arch", LM_ARCH, "--reduced", "--steps", str(LM_RESUME_STEPS),
            "--ckpt-every", str(LM_RESUME_EVERY), "--batch", "4", "--seq",
            "16", "--device", str(dev)]
    a, b = os.path.join(work, "lm_a"), os.path.join(work, "lm_b")
    FA.FLASH_ATTN_LAUNCHES = 0
    t0 = time.perf_counter()
    straight = train.main(base + ["--out", a])
    first = f"step_{LM_RESUME_EVERY:010d}"
    os.makedirs(os.path.join(b, "ckpt"))
    shutil.copytree(os.path.join(a, "ckpt", first),
                    os.path.join(b, "ckpt", first))
    resumed = train.main(base + ["--out", b])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sp, rp = _leaf_items(straight["params"]), _leaf_items(resumed["params"])
    differ = [k for k in sp if not torch.equal(sp[k], rp[k])]
    ran = [h["step"] for h in resumed["history"]]
    same_loss = ([h["loss"] for h in resumed["history"]]
                 == [h["loss"] for h in straight["history"][LM_RESUME_EVERY:]])
    ok = (not differ and sorted(sp) == sorted(rp) and same_loss
          and ran == list(range(LM_RESUME_EVERY + 1, LM_RESUME_STEPS + 1))
          and all(t.device.type == dev.type for t in rp.values()))
    print(f"ckpt (b): launch.train.main --arch {LM_ARCH} --reduced on the "
          f"card, {LM_RESUME_STEPS} steps straight vs resumed from the step-"
          f"{LM_RESUME_EVERY} checkpoint (steps {ran}): {len(differ)} of "
          f"{len(sp)} leaves differ, losses "
          f"{'equal' if same_loss else 'differ'}; K5 launches "
          f"{FA.FLASH_ATTN_LAUNCHES}; {wall:.2f} s host clock for both "
          f"calls {'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit(f"chip_smoke: phase 15 (b): the resumed run is not "
                         f"bit-identical to the straight one: {differ[:4]}")
    return {"differ": len(differ), "wall_s": wall,
            "loss": [h["loss"] for h in straight["history"]]}


def _lm_card_vs_cpu(dev, tag) -> dict:
    """Phase 15 (c): the port's ``make_train_step`` on the reduced
    StableLM, 3 steps on the card against the same steps on the CPU (TF32
    off); then the loss's grads at seq 4,096 on both, with K5 counted
    over them and one card step there."""
    import torch
    import repro_torch.kernels.flash_attn as FA
    from repro_torch.configs import get
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models.lm import build_lm
    from repro_torch.optim import adamw_init

    cfg = get(LM_ARCH).reduced()
    lms = {"cpu": build_lm(cfg, device="cpu"), "card": build_lm(cfg, dev)}
    p0 = lms["cpu"].init(torch.Generator().manual_seed(SEED))
    devs = {"cpu": torch.device("cpu"), "card": dev}
    params = {k: _tree_to(p0, d) for k, d in devs.items()}
    opts = {k: adamw_init(p) for k, p in params.items()}
    steps = {k: make_train_step(lm, base_lr=LM_CHECK_LR, warmup=1,
                                total=2 * LM_CHECK_STEPS)
             for k, lm in lms.items()}
    pipe = SyntheticTokenPipeline(cfg.vocab_size, LM_CHECK_SEQ,
                                  LM_CHECK_BATCH, seed=SEED)
    losses, grads = {"cpu": [], "card": []}, []
    for s in range(LM_CHECK_STEPS):
        batch = pipe.batch(s)
        grads.append(value_and_grad(lms["cpu"], params["cpu"], batch)[1])
        for k in ("cpu", "card"):
            params[k], opts[k], m = steps[k](
                params[k], opts[k], {n: t.to(devs[k]) for n, t in
                                     batch.items()})
            losses[k].append(float(m["loss"]))
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["card"], losses["cpu"]))
    gate = _adam_gate(params["card"], params["cpu"], grads, LM_CHECK_LR)
    ok = gate["ok"] and loss_rel <= LM_LOSS_RTOL
    print(f"ckpt (c): make_train_step on {cfg.name}, {LM_CHECK_STEPS} steps "
          f"(batch {LM_CHECK_BATCH} x {LM_CHECK_SEQ}) card vs CPU, TF32 off: "
          f"losses {losses['card']} vs {losses['cpu']}, worst rel "
          f"{loss_rel:.3e} (gate {LM_LOSS_RTOL}); params worst "
          f"{gate['ratio']:.3f} of the {LM_PARAM_GATE} gate at "
          f"{gate['leaf']}, {gate['loose']} of {gate['total']} elements "
          f"with a gradient at rounding level, max|d| there "
          f"{gate['loose_max']:.3e} (bound {2 * LM_CHECK_LR * LM_CHECK_STEPS}"
          f") {'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit("chip_smoke: phase 15 (c): the card's train steps "
                         "disagree with the CPU's")

    # past 2,048 tokens: grads on the plain scan, never K5
    long = SyntheticTokenPipeline(cfg.vocab_size, LM_LONG_SEQ, 1,
                                  seed=SEED + 1).batch(0)
    ref_loss, ref = value_and_grad(lms["cpu"], params["cpu"], long)
    torch.cuda.synchronize()
    FA.FLASH_ATTN_LAUNCHES = 0
    t0 = time.perf_counter()
    loss, got = value_and_grad(lms["card"], params["card"],
                               {n: t.to(dev) for n, t in long.items()})
    torch.cuda.synchronize()
    grad_ms = (time.perf_counter() - t0) * 1e3
    _, _, m = steps["card"](params["card"], opts["card"],
                            {n: t.to(dev) for n, t in long.items()})
    torch.cuda.synchronize()
    k5 = FA.FLASH_ATTN_LAUNCHES
    g, r = _leaf_items(got), _leaf_items(ref)
    errs = {k: ((g[k].float().cpu() - r[k].float()).abs().max()
                / r[k].float().abs().max().clamp_min(1e-30)).item()
            for k in r}
    leaf = max(errs, key=errs.get)
    rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    ok = (errs[leaf] <= LM_GRAD_GATE and rel <= LM_LOSS_RTOL and k5 == 0
          and math.isfinite(float(m["loss"])))
    print(f"ckpt (c): loss and grads at seq {LM_LONG_SEQ} (batch 1) card vs "
          f"CPU: loss rel {rel:.3e}, worst leaf {leaf} {errs[leaf]:.3e} of "
          f"its max (gate {LM_GRAD_GATE}); K5 launches over the grads and "
          f"one train step there {k5}; card grads {grad_ms:.1f} ms host "
          f"clock {'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit(f"chip_smoke: phase 15 (c) at seq {LM_LONG_SEQ}: "
                         "grads disagree or K5 ran under autograd")
    return {"losses": losses, "loss_rel": loss_rel, "params": gate,
            "long": {"loss_rel": rel, "worst_leaf": leaf,
                     "worst": errs[leaf], "k5_launches": k5,
                     "grad_ms": grad_ms}}


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device, copy=True)


def _lm_full_width(dev, tag) -> dict:
    """Phase 15 (d): full-width StableLM-2-12B at ``LM_TRAIN_LAYERS``
    layers, ``make_train_step`` for ``LM_TRAIN_STEPS`` steps at batch 8 x
    128 (f32 params and AdamW, bf16 compute, the config's own)."""
    import dataclasses
    import torch
    import repro_torch.kernels.flash_attn as FA
    from repro_torch.configs import get
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.lm import build_lm
    from repro_torch.optim import adamw_init

    cfg = dataclasses.replace(get(LM_ARCH), n_layers=LM_TRAIN_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = build_lm(cfg, device=dev)
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED))
    n_params = lm.param_counts(params)[0]
    opt = adamw_init(params)
    step = make_train_step(lm)
    pipe = SyntheticTokenPipeline(cfg.vocab_size, LM_TRAIN_SEQ,
                                  LM_TRAIN_BATCH, seed=SEED)
    before = {k: v.clone() for k, v in _leaf_items(params).items()}
    FA.FLASH_ATTN_LAUNCHES = 0
    ms, metrics, unchanged = [], [], None
    for s in range(LM_TRAIN_STEPS):
        batch = {k: v.to(dev) for k, v in pipe.batch(s).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append((float(m["loss"]), float(m["gnorm"]), m["lr"]))
        if s == 0:
            now = _leaf_items(params)
            unchanged = [k for k in before if torch.equal(before[k], now[k])]
            del before, now
            first_peak = torch.cuda.max_memory_allocated() / 2 ** 30
            torch.cuda.reset_peak_memory_stats()   # the copy held above
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    batch = {k: v.to(dev) for k, v in pipe.batch(LM_TRAIN_STEPS).items()}
    breakdown = _device_breakdown(lambda: step(params, opt, batch), top=8)
    finite = all(math.isfinite(x) for l, g, _ in metrics for x in (l, g))
    ok = finite and not unchanged and FA.FLASH_ATTN_LAUNCHES == 0
    print(f"ckpt (d): full-width {cfg.name} at {LM_TRAIN_LAYERS} of 40 "
          f"layers ({n_params / 1e9:.3f} G params, f32 params and AdamW, "
          f"bf16 compute), batch {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}, "
          f"{LM_TRAIN_STEPS} make_train_step steps: (loss, gnorm, lr) "
          f"{metrics}; host ms per step {[round(t, 3) for t in ms]} "
          f"(synchronised); leaves unchanged after step 1: {unchanged}; "
          f"K5 launches {FA.FLASH_ATTN_LAUNCHES}; peak memory over steps 2-"
          f"{LM_TRAIN_STEPS} {peak:.2f} GiB (step 1, with a copy of the "
          f"params to compare: {first_peak:.2f}) {'ok' if ok else 'FAIL'} "
          f"{tag}")
    busy = None
    if breakdown is None:
        print("  device time of one step: not measured (the profiler "
              "reported no device time)")
    else:
        busy, wall, top = breakdown
        print(f"  profiler, one step: device busy {busy:.3f} ms of "
              f"{wall:.3f} ms wall (busy share {busy / wall:.3f}) {tag}")
        for name, ms_k, calls in top:
            print(f"    {ms_k:.3f} ms in {calls} call(s): {name[:90]}")
    if not ok:
        raise SystemExit("chip_smoke: phase 15 (d): a loss or gnorm is not "
                         "finite, a leaf did not change, or K5 ran")
    return {"params": n_params, "step_ms": ms, "metrics": metrics,
            "peak_gib": peak, "first_peak_gib": first_peak,
            "device": breakdown, "busy_ms": busy}


def _ckpt_phase(dev, tag) -> dict:
    """Phase 15: (a) DCGAN checkpoints trained on K1 / K2 / K3 and served
    after a hot swap, (b) LM resume bit for bit, (c) the LM train step
    card vs CPU and past 2,048 tokens without K5, (d) full-width
    StableLM-2-12B at 2 layers.  Every failure raises."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        report = {"gan": _ckpt_gan(dev, tag, work),
                  "resume": _lm_resume(dev, tag, work)}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    report["card_vs_cpu"] = _lm_card_vs_cpu(dev, tag)
    report["full_width"] = _lm_full_width(dev, tag)
    report["phase_s"] = time.perf_counter() - t0
    print(f"ckpt phase: {report['phase_s']:.1f} s host clock {tag}")
    return report


# ---------------------------------------------------------------------------
# Phase 16: MoE decoders
# ---------------------------------------------------------------------------

MOE_DBRX, MOE_MIXTRAL = "dbrx-132b", "mixtral-8x7b"
MOE_LAYER_TOKENS = (2, 160)   # (a): one full-width DBRX MoE layer, f32
MOE_LAYER_GATE = 1e-4         # (a): card vs CPU, rel. max|ref|
MOE_K5_SHAPE = (4, 48, 8, 4080, 128)   # (b): DBRX's prefill group
MOE_DBRX_LAYERS = 4           # (c): 4 of DBRX's 40 layers, bf16
MOE_REQUESTS, MOE_PROMPT_LEN, MOE_SLOTS = 8, 4080, 4
MOE_MAX_LEN, MOE_MAX_NEW = 4096, 16
MOE_MIX_LAYERS = 2            # (d): 2 of Mixtral's 32 layers, bf16
MOE_MIX_PROMPTS, MOE_MIX_NEW, MOE_MIX_MAX_LEN = 4, 32, 4160
MOE_TRAIN_LAYERS = 1          # (d): 1 of 32, f32 params and AdamW
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 8, 128, 3
MOE_CHECK_LOSS_RTOL = 1e-6    # (e): reduced LMs, card vs CPU
MOE_CHECK_BATCH, MOE_CHECK_SEQ = 4, 32
K5_AHEAD_ROUNDS = 4           # _k5_at_shape: K5 and SDPA by ahead_ms in turns


@contextlib.contextmanager
def _moe_log(log: list):
    """Record every ``layers.moe`` call's routing while the block runs:
    its top-k experts and the entries its capacity dropped (the route
    recomputed on the same input, under no grad)."""
    import torch
    from repro_torch.models import layers as L
    real = L.moe

    def logged(p, x, **kw):
        with torch.no_grad():
            r = L.moe_route(p, x, top_k=kw["top_k"],
                            n_experts=kw["n_experts"],
                            capacity_factor=kw.get("capacity_factor", 1.25),
                            groups=kw.get("groups"))
        log.append({"tope": r["tope"], "dropped": int((~r["keep"]).sum()),
                    "entries": r["keep"].numel(), "cap": r["cap"]})
        return real(p, x, **kw)
    L.moe = logged
    try:
        yield
    finally:
        L.moe = real


def _moe_layer_check(dev, tag) -> dict:
    """(a): one full-width DBRX MoE layer in f32 (TF32 off) on the card
    against the port on the CPU at capacity factor 1.25: the same top-k
    experts and kept entries, outputs within MOE_LAYER_GATE * max|ref|."""
    import torch
    from repro_torch.configs import get
    from repro_torch.models import layers as L

    cfg = get(MOE_DBRX)
    d, ff, e, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = L.init_moe(gen, d, ff, e, torch.float32)
    # tokens that share a mean, as hidden states do: uneven expert loads
    x = (torch.randn(*MOE_LAYER_TOKENS, d, generator=gen, device=dev)
         + torch.randn(d, generator=gen, device=dev))
    kw = dict(top_k=k, n_experts=e, capacity_factor=cfg.capacity_factor)
    with torch.no_grad():
        t0 = time.perf_counter()
        out = L.moe(p, x, **kw)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        route = L.moe_route(p, x, **kw)
        pc = {n: t.cpu() for n, t in p.items()}
        del p
        torch.cuda.empty_cache()
        xc = x.cpu()
        t0 = time.perf_counter()
        ref = L.moe(pc, xc, **kw)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        rref = L.moe_route(pc, xc, **kw)
    del pc
    same_e = torch.equal(route["tope"].cpu(), rref["tope"])
    same_k = torch.equal(route["keep"].cpu(), rref["keep"])
    dmax, tol = _gate_err(out.cpu(), ref, MOE_LAYER_GATE, False)
    dropped = int((~rref["keep"]).sum())
    gates = rref["gates"].reshape(-1, e).sort(-1, descending=True).values
    margin = ((gates[:, k - 1] - gates[:, k]).min().item() if k < e
              else float("nan"))
    ok = same_e and same_k and dmax <= tol and bool(torch.isfinite(out).all())
    print(f"moe (a): one {cfg.name} MoE layer at full width (d {d}, ff {ff}, "
          f"{e} experts, top-{k}), f32, TF32 off, {x.shape[0]} x "
          f"{x.shape[1]} tokens, capacity factor {cfg.capacity_factor} (cap "
          f"{rref['cap']}): card vs the port on the CPU: top-k experts equal "
          f"{same_e}, kept entries equal {same_k} ({dropped} of "
          f"{rref['keep'].numel()} dropped), output max|d| {dmax:.3e} tol "
          f"{tol:.3e} ({MOE_LAYER_GATE}*max|ref|); smallest gap between a "
          f"token's k-th and (k+1)-th gate {margin:.3e}; host ms card "
          f"{card_ms:.1f} (first call), CPU {cpu_ms:.1f} "
          f"{'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit("chip_smoke: phase 16 (a): the MoE layer on the "
                         "card disagrees with the CPU")
    return {"max_abs": dmax, "tol": tol, "dropped": dropped,
            "entries": rref["keep"].numel(), "cap": rref["cap"],
            "gate_gap": margin}


def _k5_at_shape(dev, tag, shape, label: str, part: str) -> dict:
    """K5 bf16 at ``shape`` (B, H, Hkv, S, D), causal, against its plain
    version (one sample at a time) inside ``_k5_gate``'s bf16 bounds, and
    its device time there in turns with SDPA's, by the profiler (or CUDA
    events) and by ``kernels.timing.ahead_ms`` in K5_AHEAD_ROUNDS rounds
    (the order reversed every other round, the median kept).  ``label``
    names the shape in the printed lines, ``part`` the phase part that
    raises."""
    import torch
    import torch.nn.functional as F
    import repro_torch.kernels.flash_attn as FA

    b, h, hkv, s, d = shape
    gen = torch.Generator().manual_seed(SEED)
    q, k, v = ((torch.randn(b, n, s, d, generator=gen) * 0.5)
               .to(dev, torch.bfloat16) for n in (h, hkv, hkv))
    out = FA.flash_attention(q, k, v, causal=True)
    ref = _k5_plain(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    ok, text, dmax, share = _k5_gate(out, ref, torch.bfloat16)
    ok = ok and out.dtype == torch.bfloat16 and out.shape == q.shape
    print(f"{part}: K5 bf16 at {label} ({b}, {h} q / {hkv} kv heads, S {s}, "
          f"D {d}, causal) vs flash_attention_ref (f32 on the bf16 inputs, "
          f"one sample at a time): {text} {'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit(f"chip_smoke: {part}: K5 disagrees with its plain "
                         f"version at {shape}")
    del ref
    qf, kf, vf = q.float(), k.float(), v.float()
    plain = _time_ms({"plain": lambda: _k5_plain(qf, kf, vf)}, reps=1,
                     iters=1)["plain"][0]
    del qf, kf, vf
    torch.cuda.empty_cache()
    fns = {"k5": lambda: FA.flash_attention(q, k, v),
           "sdpa": lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True)}
    ev = _time_ms(fns, reps=5, iters=3)
    dev_ms = {}
    for n, fn in fns.items():
        br = _device_breakdown(fn)
        dev_ms[n] = br[0] if br is not None else float("nan")
    ms = {n: dev_ms[n] if math.isfinite(dev_ms[n]) else ev[n][0]
          for n in fns}
    flops = 2.0 * b * h * d * s * (s + 1)
    nbytes = 2 * (2 * b * h * s * d + 2 * b * hkv * s * d)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    print(f"  time: K5 bf16 {ms['k5']:.3f} ms ("
          f"{'profiler' if math.isfinite(dev_ms['k5']) else 'CUDA events'}"
          f"; events over 3 calls {ev['k5'][0]:.3f} [{ev['k5'][1]:.3f}, "
          f"{ev['k5'][2]:.3f}]), SDPA bf16 {ms['sdpa']:.3f} ms ("
          f"{'profiler' if math.isfinite(dev_ms['sdpa']) else 'CUDA events'}"
          f"; events {ev['sdpa'][0]:.3f}); bound "
          f"{max(t_ops, t_bytes):.3f} ms at the useful work "
          f"({flops:.3e} FLOP), {max(1.5 * t_ops, t_bytes):.3f} at the split "
          f"P's 1.5x; the plain version (f32, one sample at a time) "
          f"{plain:.3f} ms (CUDA events, one call after 3 warm ones); sm "
          f"clock, power, temperature {_clocks()} {tag}")
    runs = {n: [] for n in fns}
    for r in range(K5_AHEAD_ROUNDS):
        for n in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            runs[n].append(_ahead_ms(fns[n]))
    ahead = {n: sorted(v)[len(v) // 2] for n, v in runs.items()}
    print(f"  ahead: K5 bf16 {ahead['k5']:.3f} ms, SDPA bf16 "
          f"{ahead['sdpa']:.3f} ms (kernels.timing.ahead_ms: 20 calls "
          f"queued behind torch.cuda._sleep; median of {K5_AHEAD_ROUNDS} "
          f"rounds in turns, K5 {[round(x, 3) for x in runs['k5']]}, "
          f"SDPA {[round(x, 3) for x in runs['sdpa']]}) {tag}")
    return {"max_abs": dmax, "element_share": share, "ms": ms["k5"],
            "ahead_ms": ahead["k5"], "sdpa_ahead_ms": ahead["sdpa"],
            "sdpa_ms": ms["sdpa"], "plain_ms": plain,
            "events_ms": ev["k5"][0],
            "sdpa_events_ms": ev["sdpa"][0],
            "bound_ms": max(t_ops, t_bytes),
            "bound_split_ms": max(1.5 * t_ops, t_bytes)}


def _moe_k5_check(dev, tag) -> dict:
    """(b): K5 bf16 at DBRX's prefill shape against its plain version
    (one sample at a time), and its device time there beside SDPA's."""
    return _k5_at_shape(dev, tag, MOE_K5_SHAPE, f"{MOE_DBRX}'s prefill "
                        "shape", "moe (b)")


def _moe_dbrx_serve(dev, tag) -> dict:
    """(c): DBRX-132B at full width, MOE_DBRX_LAYERS of its 40 layers,
    bf16, serving MOE_REQUESTS prompts of MOE_PROMPT_LEN tokens through
    ``serve``: 4 K5 launches a prefill group and none in decode, finite
    logits, the first group's last-token logits against the plain scan
    within LM_BF16_GATE * max|ref|; the entries dropped per layer, host
    ms per group and step, one profiled prefill, and the MoE layer and
    its expert GEMMs timed at the prefill's shape."""
    import dataclasses
    import torch
    import torch.nn.functional as F
    import repro_torch.kernels.flash_attn as FA
    from repro_torch.configs import get
    from repro_torch.launch.serve import random_prompts, serve
    from repro_torch.models import layers as L
    from repro_torch.models.lm import build_lm

    full = get(MOE_DBRX)
    cfg = dataclasses.replace(full, n_layers=MOE_DBRX_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = build_lm(cfg, device=dev)
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_total, n_active = lm.param_counts(params)
    prompts = random_prompts(cfg.vocab_size, MOE_REQUESTS, MOE_PROMPT_LEN,
                             seed=SEED)
    FA.FLASH_ATTN_LAUNCHES = 0
    results, stats = serve(cfg, prompts, max_new=MOE_MAX_NEW,
                           slots=MOE_SLOTS, max_len=MOE_MAX_LEN,
                           params=params, device=dev)
    torch.cuda.synchronize()
    launches = FA.FLASH_ATTN_LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    groups = len(stats["prefill_ms"])
    dec = sorted(stats["decode_ms"])
    print(f"moe (c): {cfg.name} at {MOE_DBRX_LAYERS} of {full.n_layers} "
          f"layers (d_model {cfg.d_model}, {cfg.n_heads} q / "
          f"{cfg.n_kv_heads} kv heads of {cfg.hd}, {cfg.n_experts} experts "
          f"of d_ff {cfg.d_ff}, top-{cfg.top_k}, capacity factor "
          f"{cfg.capacity_factor}, vocab {cfg.vocab_size}; {n_total / 1e9:.3f}"
          f" G params ({n_active / 1e9:.3f} G active), {cfg.param_dtype}, "
          f"drawn in {init_s:.3f} s): {len(results)} prompts of "
          f"{MOE_PROMPT_LEN} tokens, {MOE_MAX_NEW} new tokens, "
          f"{MOE_SLOTS} slots, max_len {MOE_MAX_LEN}, in "
          f"{stats['wall_s']:.3f} s host clock; peak memory {peak:.2f} GiB "
          f"{tag}")
    print(f"  prefill per group (host clock): "
          f"{[round(t, 3) for t in stats['prefill_ms']]} ms; decode per "
          f"step: median {dec[len(dec) // 2]:.3f} ms [min {dec[0]:.3f}, max "
          f"{dec[-1]:.3f}] over {len(dec)} steps; K5 launches {launches} "
          f"({groups} groups x {MOE_DBRX_LAYERS} layers expected)")
    ok = (launches == groups * MOE_DBRX_LAYERS and groups == 2
          and sorted(results) == list(range(MOE_REQUESTS))
          and all(len(t) == MOE_MAX_NEW and all(0 <= x < cfg.vocab_size
                                                 for x in t)
                  for t in results.values()))
    if not ok:
        raise SystemExit("chip_smoke: phase 16 (c): DBRX serving did not "
                         "run K5 once per layer per prefill group, or its "
                         "tokens are wrong")
    batch = {"inputs": torch.tensor(prompts[:MOE_SLOTS], dtype=torch.int32,
                                    device=dev)}
    logs = {"k5": [], "scan": []}
    with torch.no_grad():
        FA.FLASH_ATTN_LAUNCHES = 0
        with _moe_log(logs["k5"]):
            cache = lm.init_cache(MOE_SLOTS, MOE_MAX_LEN)
            lg, cache = lm.prefill(params, batch, cache)
        n_prefill = FA.FLASH_ATTN_LAUNCHES
        tok = torch.argmax(lg, -1).to(torch.int32)
        FA.FLASH_ATTN_LAUNCHES = 0
        lgd, cache = lm.decode_step(params, {"inputs": tok}, cache)
        torch.cuda.synchronize()
        n_decode = FA.FLASH_ATTN_LAUNCHES
        del cache
        with _plain_scan(), _moe_log(logs["scan"]):
            ref, _ = lm.prefill(params, batch,
                                lm.init_cache(MOE_SLOTS, MOE_MAX_LEN))
    dmax, tol = _gate_err(lg, ref, LM_BF16_GATE, False)
    finite = bool(torch.isfinite(lg).all() and torch.isfinite(lgd).all())
    same = torch.equal(torch.argmax(lg, -1), torch.argmax(ref, -1))
    flips = [int((a["tope"] != b_["tope"]).any(-1).sum())
             for a, b_ in zip(logs["k5"], logs["scan"])]
    dropped = [r["dropped"] for r in logs["k5"]]
    print(f"  first group's prefill: {n_prefill} K5 launches, one decode "
          f"step {n_decode}; logits finite={finite}; vs the plain scan on "
          f"the same weights max|d| {dmax:.3e} tol {tol:.3e} "
          f"({LM_BF16_GATE}*max|ref|), greedy tokens equal {same}; entries "
          f"dropped per layer {dropped} of {logs['k5'][0]['entries']} (cap "
          f"{logs['k5'][0]['cap']} per expert); tokens whose top-"
          f"{cfg.top_k} experts differ from the scan's run per layer "
          f"{flips} {tag}")
    if not (finite and dmax <= tol and n_prefill == MOE_DBRX_LAYERS
            and n_decode == 0):
        raise SystemExit("chip_smoke: phase 16 (c): the served DBRX "
                         "prefill is wrong")
    del ref, logs
    torch.cuda.empty_cache()
    br = _device_breakdown(lambda: lm.prefill(
        params, batch, lm.init_cache(MOE_SLOTS, MOE_MAX_LEN)), top=1000)
    busy = wall = k5_ms = float("nan")
    if br is None:
        print("  one prefill under the profiler: not measured (no device "
              "time reported)")
    else:
        busy, wall, top = br
        k5_ms = sum(ms for name, ms, _ in top if "flash_attn" in name)
        print(f"  one prefill under the profiler: device busy {busy:.3f} ms "
              f"of {wall:.3f} ms wall (busy share {busy / wall:.3f}); K5 "
              f"{k5_ms:.3f} ms ({k5_ms / busy:.3f} of busy, "
              f"{k5_ms / MOE_DBRX_LAYERS:.3f} ms per launch) {tag}")
        for name, ms_k, calls in top[:8]:
            print(f"    {ms_k:.3f} ms in {calls} call(s): {name[:90]}")
    # one MoE layer at the prefill's shape, and its three expert GEMMs
    p0 = {n: t[0] for n, t in params["slots"][0]["moe_ep"].items()}
    wdt = p0["wg"].dtype
    x = torch.randn(MOE_SLOTS, MOE_PROMPT_LEN, cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED)
                    ).to(wdt)
    kw = dict(top_k=cfg.top_k, n_experts=cfg.n_experts,
              capacity_factor=cfg.capacity_factor)
    cap = L.moe_capacity(x.shape[0] * x.shape[1], **kw)[2]
    buf = torch.randn(cfg.n_experts, cap, cfg.d_model, device=dev,
                      dtype=wdt)

    def experts():
        h = torch.matmul(buf, p0["wg"])
        u = torch.matmul(buf, p0["wu"])
        return torch.matmul(F.silu(h) * u, p0["wd"])
    with torch.no_grad():
        t = _time_ms({"moe": lambda: L.moe(p0, x, **kw),
                      "experts": experts}, reps=3, iters=2)
    gemm_flops = 3 * 2.0 * cfg.n_experts * cap * cfg.d_model * cfg.d_ff
    useful = 3 * 2.0 * x.shape[0] * x.shape[1] * cfg.top_k * cfg.d_model \
        * cfg.d_ff
    g_bound = gemm_flops / PEAK_BF16_FLOPS * 1e3
    print(f"  one MoE layer at the prefill's shape ({MOE_SLOTS} x "
          f"{MOE_PROMPT_LEN} tokens, cap {cap}): {t['moe'][0]:.3f} ms "
          f"[{t['moe'][1]:.3f}, {t['moe'][2]:.3f}] (CUDA events over 2 "
          f"calls, median of 3), of which the expert GEMMs (3 batched "
          f"matmuls on ({cfg.n_experts}, {cap}, {cfg.d_model}) buffers, "
          f"cuBLAS, and the SwiGLU product) {t['experts'][0]:.3f} ms "
          f"({t['experts'][0] / t['moe'][0]:.3f}); their bound "
          f"{g_bound:.3f} ms ({gemm_flops:.3e} FLOP at 989 TFLOP/s, "
          f"{useful / gemm_flops:.3f} of it useful), so "
          f"{g_bound / t['experts'][0]:.3f} of the bound; K5 per launch "
          f"{k5_ms / MOE_DBRX_LAYERS:.3f} ms against {t['moe'][0]:.3f} of "
          f"MoE per layer {tag}")
    del params, lm, x, buf, p0
    torch.cuda.empty_cache()
    return {"k5_launches": launches, "groups": groups,
            "prefill_ms": stats["prefill_ms"], "decode_ms": stats["decode_ms"],
            "wall_s": stats["wall_s"], "peak_gib": peak,
            "params": n_total, "active": n_active, "gate_max_abs": dmax,
            "dropped": dropped, "route_flips": flips,
            "prefill_device": {"busy_ms": busy, "wall_ms": wall,
                               "k5_ms": k5_ms},
            "moe_layer_ms": t["moe"][0], "experts_ms": t["experts"][0],
            "experts_bound_ms": g_bound}


def _moe_mixtral(dev, tag) -> dict:
    """(d): Mixtral-8x7B at full width: MOE_MIX_LAYERS layers in bf16
    serving MOE_MIX_PROMPTS prompts of MOE_PROMPT_LEN tokens past its
    window (the ring cache wraps; 0 K5 launches, finite logits); then
    MOE_TRAIN_LAYERS layer with f32 params and AdamW, bf16 compute,
    MOE_TRAIN_STEPS ``make_train_step`` steps at batch 8 x 128."""
    import dataclasses
    import torch
    import repro_torch.kernels.flash_attn as FA
    from repro_torch.configs import get
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.launch.serve import random_prompts, serve
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models.lm import build_lm
    from repro_torch.optim import adamw_init

    full = get(MOE_MIXTRAL)
    cfg = dataclasses.replace(full, n_layers=MOE_MIX_LAYERS,
                              param_dtype=full.compute_dtype)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = build_lm(cfg, device=dev)
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED))
    prompts = random_prompts(cfg.vocab_size, MOE_MIX_PROMPTS,
                             MOE_PROMPT_LEN, seed=SEED)
    FA.FLASH_ATTN_LAUNCHES = 0
    results, stats = serve(cfg, prompts, max_new=MOE_MIX_NEW,
                           slots=MOE_SLOTS, max_len=MOE_MIX_MAX_LEN,
                           params=params, device=dev)
    torch.cuda.synchronize()
    launches = FA.FLASH_ATTN_LAUNCHES
    batch = {"inputs": torch.tensor(prompts[:MOE_SLOTS], dtype=torch.int32,
                                    device=dev)}
    finite = True
    with torch.no_grad():
        cache = lm.init_cache(MOE_SLOTS, MOE_MIX_MAX_LEN)
        lg, cache = lm.prefill(params, batch, cache)
        finite &= bool(torch.isfinite(lg).all())
        for _ in range(MOE_MIX_NEW):
            tok = torch.argmax(lg, -1).to(torch.int32)
            lg, cache = lm.decode_step(params, {"inputs": tok}, cache)
            finite &= bool(torch.isfinite(lg).all())
    torch.cuda.synchronize()
    launches_direct = FA.FLASH_ATTN_LAUNCHES - launches
    kpos = cache["slots"][0]["kpos"][0]
    window = kpos.shape[0]
    wrapped = int(kpos.min()) == MOE_PROMPT_LEN + MOE_MIX_NEW - window
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dec = sorted(stats["decode_ms"])
    ok = (finite and launches == 0 and launches_direct == 0 and wrapped
          and sorted(results) == list(range(MOE_MIX_PROMPTS))
          and all(len(t) == MOE_MIX_NEW for t in results.values()))
    print(f"moe (d): {cfg.name} at {MOE_MIX_LAYERS} of {full.n_layers} "
          f"layers ({cfg.n_experts} experts of d_ff {cfg.d_ff}, top-"
          f"{cfg.top_k}, window {cfg.sliding_window}, bf16): "
          f"{MOE_MIX_PROMPTS} prompts of {MOE_PROMPT_LEN} tokens, "
          f"{MOE_MIX_NEW} new tokens, max_len {MOE_MIX_MAX_LEN} (a ring of "
          f"{window} slots, wrapped {wrapped}); prefill "
          f"{[round(t, 3) for t in stats['prefill_ms']]} ms host, decode "
          f"median {dec[len(dec) // 2]:.3f} ms [min {dec[0]:.3f}, max "
          f"{dec[-1]:.3f}]; K5 launches {launches} serving, "
          f"{launches_direct} in a prefill and {MOE_MIX_NEW} decode steps "
          f"with logits finite={finite}; peak memory {peak:.2f} GiB "
          f"{'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit("chip_smoke: phase 16 (d): Mixtral serving ran K5, "
                         "gave non-finite logits or did not wrap its cache")
    serve_report = {"prefill_ms": stats["prefill_ms"],
                    "decode_ms": stats["decode_ms"], "peak_gib": peak,
                    "k5_launches": launches}
    del params, lm, cache, lg
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    lm = build_lm(cfg, device=dev)
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED))
    n_params = lm.param_counts(params)
    pipe = SyntheticTokenPipeline(cfg.vocab_size, MOE_TRAIN_SEQ,
                                  MOE_TRAIN_BATCH, seed=SEED)
    batch0 = {k: v.to(dev) for k, v in pipe.batch(0).items()}
    _, grads = value_and_grad(lm, params, batch0)
    moe_g = grads["slots"][0]["moe_tp"]
    idle = {n: [j for j in range(cfg.n_experts)
                if not bool(moe_g[n][0, j].abs().amax() > 0)]
            for n in ("wg", "wu", "wd")}
    router_g = float(moe_g["router"].abs().amax())
    del grads, moe_g
    torch.cuda.empty_cache()
    opt = adamw_init(params)
    step = make_train_step(lm)
    expert_leaves = {k: v.clone() for k, v in _leaf_items(params).items()
                     if "moe_tp" in k}
    ms, metrics, unchanged = [], [], None
    for s in range(MOE_TRAIN_STEPS):
        batch = {k: v.to(dev) for k, v in pipe.batch(s).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append((float(m["loss"]), float(m["gnorm"]), m["lr"]))
        if s == 0:
            now = _leaf_items(params)
            unchanged = [k for k in expert_leaves
                         if torch.equal(expert_leaves[k], now[k])]
            del expert_leaves, now
            torch.cuda.reset_peak_memory_stats()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    batch = {k: v.to(dev) for k, v in pipe.batch(MOE_TRAIN_STEPS).items()}
    br = _device_breakdown(lambda: step(params, opt, batch), top=8)
    finite = all(math.isfinite(x) for l, g, _ in metrics for x in (l, g))
    ok = (finite and not unchanged and not any(idle.values())
          and router_g > 0)
    print(f"moe (d): {cfg.name} at {MOE_TRAIN_LAYERS} of {full.n_layers} "
          f"layers ({n_params[0] / 1e9:.3f} G params, {n_params[1] / 1e9:.3f}"
          f" G active; f32 params and AdamW, bf16 compute), batch "
          f"{MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ}, {MOE_TRAIN_STEPS} "
          f"make_train_step steps: (loss, gnorm, lr) {metrics}; host ms per "
          f"step {[round(t, 3) for t in ms]} (synchronised); experts with no "
          f"gradient at step 1 {idle}, router max|g| {router_g:.3e}; expert "
          f"leaves unchanged after step 1 {unchanged}; peak memory over "
          f"steps 2-{MOE_TRAIN_STEPS} {peak:.2f} GiB {'ok' if ok else 'FAIL'}"
          f" {tag}")
    busy = None
    if br is None:
        print("  device time of one step: not measured (the profiler "
              "reported no device time)")
    else:
        busy, wall, top = br
        print(f"  profiler, one step: device busy {busy:.3f} ms of "
              f"{wall:.3f} ms wall (busy share {busy / wall:.3f}) {tag}")
        for name, ms_k, calls in top:
            print(f"    {ms_k:.3f} ms in {calls} call(s): {name[:90]}")
    if not ok:
        raise SystemExit("chip_smoke: phase 16 (d): Mixtral training gave "
                         "a non-finite loss or gnorm, or an expert took no "
                         "gradient or no update")
    del params, opt, lm
    torch.cuda.empty_cache()
    return {"serve": serve_report,
            "train": {"params": n_params, "step_ms": ms, "metrics": metrics,
                      "peak_gib": peak, "busy_ms": busy,
                      "wall_ms": None if br is None else br[1]}}


def _moe_card_vs_cpu(dev, tag) -> dict:
    """(e): the reduced Mixtral and the reduced DBRX with 8 experts in f32
    on the card against the CPU: loss within MOE_CHECK_LOSS_RTOL
    relative, grads within LM_GRAD_GATE of each leaf's max and equal bit
    for bit in a second card run (no float atomics), the served tokens
    equal."""
    import dataclasses
    import torch
    from repro_torch.configs import get
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.launch.serve import random_prompts, serve
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.lm import build_lm

    report = {}
    for name, changes in ((MOE_MIXTRAL, {}), (MOE_DBRX, {"n_experts": 8})):
        cfg = dataclasses.replace(get(name).reduced(), **changes)
        lms = {"cpu": build_lm(cfg, device="cpu"),
               "card": build_lm(cfg, device=dev)}
        p_cpu = lms["cpu"].init(torch.Generator().manual_seed(SEED))
        p_card = _tree_to(p_cpu, dev)
        batch = SyntheticTokenPipeline(cfg.vocab_size, MOE_CHECK_SEQ,
                                       MOE_CHECK_BATCH, seed=SEED).batch(0)
        ref_loss, ref = value_and_grad(lms["cpu"], p_cpu, batch)
        tb = {k: v.to(dev) for k, v in batch.items()}
        loss, got = value_and_grad(lms["card"], p_card, tb)
        again = _leaf_items(value_and_grad(lms["card"], p_card, tb)[1])
        g, r = _leaf_items(got), _leaf_items(ref)
        repeat = all(torch.equal(g[k], again[k]) for k in g)
        errs = {k: ((g[k].float().cpu() - r[k].float()).abs().max()
                    / r[k].float().abs().max().clamp_min(1e-30)).item()
                for k in r}
        leaf = max(errs, key=errs.get)
        rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        prompts = random_prompts(cfg.vocab_size, 6, 32, seed=SEED)
        kw = dict(max_new=8, slots=4, max_len=64)
        toks_cpu, _ = serve(cfg, prompts, params=p_cpu, device="cpu", **kw)
        toks_card, _ = serve(cfg, prompts, params=p_card, device=dev, **kw)
        ok = (rel <= MOE_CHECK_LOSS_RTOL and errs[leaf] <= LM_GRAD_GATE
              and toks_card == toks_cpu and repeat)
        print(f"moe (e): {cfg.name} ({cfg.n_experts} experts, top-"
              f"{cfg.top_k}), f32, TF32 off, card vs CPU: loss "
              f"{float(loss):.6f} vs {float(ref_loss):.6f}, rel {rel:.3e} "
              f"(gate {MOE_CHECK_LOSS_RTOL}); grads worst leaf {leaf} "
              f"{errs[leaf]:.3e} of its max (gate {LM_GRAD_GATE}), a "
              f"second card run's grads bit-identical {repeat}; 6 "
              f"served prompts x 8 tokens equal {toks_card == toks_cpu} "
              f"{'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"chip_smoke: phase 16 (e): {cfg.name} on the "
                             "card disagrees with the CPU")
        report[cfg.name + f"-e{cfg.n_experts}"] = {
            "loss_rel": rel, "worst_leaf": leaf, "worst": errs[leaf],
            "grads_repeat": repeat}
    return report


def _moe_phase(dev, tag) -> dict:
    """Phase 16: (a) a full-width DBRX MoE layer card vs CPU, (b) K5 at
    DBRX's prefill shape, (c) DBRX-132B serving at 4 of 40 layers with
    K5 in its prefill, (d) Mixtral-8x7B serving past its window and
    training at 1 layer, (e) the reduced MoE LMs card vs CPU.  Every
    failure raises."""
    t0 = time.perf_counter()
    report = {"layer": _moe_layer_check(dev, tag),
              "k5": _moe_k5_check(dev, tag),
              "dbrx": _moe_dbrx_serve(dev, tag),
              "mixtral": _moe_mixtral(dev, tag),
              "card_vs_cpu": _moe_card_vs_cpu(dev, tag)}
    report["phase_s"] = time.perf_counter() - t0
    print(f"moe phase: {report['phase_s']:.1f} s host clock {tag}")
    return report


# ---------------------------------------------------------------------------
# Phase 17: recurrent mixers, xLSTM-350M and Jamba-1.5-Large
# ---------------------------------------------------------------------------

HYB_XLSTM, HYB_JAMBA = "xlstm-350m", "jamba-1.5-large-398b"
HYB_BLOCK_TOKENS = (1, 256)   # (a): one full-width block of each kind, f32
HYB_BLOCK_GATE = 1e-4         # (a): card vs CPU and chunked vs stepwise
HYB_X_REQUESTS, HYB_X_PROMPT_LEN, HYB_SLOTS = 8, 2048, 4
HYB_X_MAX_LEN, HYB_MAX_NEW = 2064, 16  # xLSTM's prompts cut from 4,096
#                                        so that phase 21 fits the time
HYB_X_F32_GATE = 1e-4        # (b): served vs forward_train, f32, 8 layers
HYB_X_TRAIN_BATCH, HYB_X_TRAIN_SEQ, HYB_X_TRAIN_STEPS = 8, 512, 2
HYB_JAMBA_LAYERS = 4          # (d): the first half of Jamba's 8-layer period
HYB_J_REQUESTS, HYB_J_PROMPT_LEN, HYB_J_MAX_LEN = 8, 4080, 4096
HYB_K5_SHAPE = (4, 64, 8, 4080, 128)    # (d): Jamba's prefill group
HYB_CHECK_LOSS_RTOL = 1e-6    # (e): reduced LMs, card vs CPU
HYB_CHECK_BATCH, HYB_CHECK_SEQ = 4, 32


def _jamba_cut(cfg):
    """Jamba's first ``HYB_JAMBA_LAYERS`` layers: 3 Mamba slots and the
    attention slot, MoE at slots 1 and 3; no width changes."""
    import dataclasses
    return dataclasses.replace(cfg, n_layers=HYB_JAMBA_LAYERS,
                               pattern=cfg.pattern[:HYB_JAMBA_LAYERS])


def _hyb_gate(name, out, ref, rel, log, tag):
    """Print and return whether ``out`` is within ``rel * max|ref|`` of
    ``ref``."""
    dmax, tol = _gate_err(out.cpu(), ref.cpu(), rel, False)
    ok = dmax <= tol and bool(_finite(out))
    log.append(f"{name} {dmax / tol:.3f}")
    print(f"  {name}: max|d| {dmax:.3e} tol {tol:.3e} ({rel}*max|ref|, "
          f"{dmax / tol:.3f} of it) {'ok' if ok else 'FAIL'} {tag}")
    return ok


def _finite(t) -> bool:
    import torch
    return bool(torch.isfinite(t.float()).all())


def _hyb_blocks(dev, tag) -> dict:
    """(a): one full-width block of each recurrent kind in f32 (TF32
    off), HYB_BLOCK_TOKENS tokens from a nonzero state: Jamba's Mamba
    (d 8,192, d_inner 16,384, d_state 16, its chunk 128), xLSTM's mLSTM
    (d 1,024, 4 heads of 512, chunk 256) and sLSTM (d 1,024, inner
    1,408); outputs and states on the card against the port on the CPU,
    and on the card the chunked forms against ``mamba_step`` /
    ``mlstm_recurrent`` token by token and the sLSTM against itself
    resumed half way, all within HYB_BLOCK_GATE * max|ref|."""
    import torch
    from repro_torch.configs import get
    from repro_torch.models import ssm as S

    jamba, xl = get(HYB_JAMBA), get(HYB_XLSTM)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, s = HYB_BLOCK_TOKENS
    report, fails = {}, []
    for kind in ("mamba", "mlstm", "slstm"):
        cfg = jamba if kind == "mamba" else xl
        d = cfg.d_model
        if kind == "mamba":
            p = S.init_mamba(gen, d, expand=cfg.mamba_expand,
                             d_state=cfg.mamba_d_state,
                             d_conv=cfg.mamba_d_conv)
            st = S.MambaState(
                torch.randn(b, cfg.mamba_d_conv - 1, p["conv_w"].shape[1],
                            generator=gen, device=dev),
                0.5 * torch.randn(b, *p["A_log"].shape, generator=gen,
                                  device=dev))

            def run(p_, x_, st_):
                return S.mamba_forward(p_, x_, st_, chunk=cfg.mamba_chunk)

            def steps(p_, x_, st_):
                ys = []
                for t in range(x_.shape[1]):
                    y, st_ = S.mamba_step(p_, x_[:, t:t + 1], st_)
                    ys.append(y)
                return torch.cat(ys, 1), st_
        elif kind == "mlstm":
            h = cfg.n_heads
            p = S.init_mlstm(gen, d, n_heads=h, proj_factor=cfg.mlstm_proj)
            dh = p["wq"].shape[1] // h
            st = S.MLSTMState(
                0.1 * torch.randn(b, h, dh, dh, generator=gen, device=dev),
                0.1 * torch.randn(b, h, dh, generator=gen, device=dev),
                torch.randn(b, h, generator=gen, device=dev))

            def run(p_, x_, st_):
                return S.mlstm_chunkwise(p_, x_, st_, n_heads=cfg.n_heads,
                                         chunk=cfg.mlstm_chunk)

            def steps(p_, x_, st_):
                return S.mlstm_recurrent(p_, x_, st_, n_heads=cfg.n_heads)
        else:
            p = S.init_slstm(gen, d, n_heads=cfg.n_heads,
                             proj_factor=cfg.slstm_proj)
            di = p["down"].shape[0]
            st = S.SLSTMState(
                torch.randn(b, di, generator=gen, device=dev),
                torch.rand(b, di, generator=gen, device=dev) + 0.5,
                torch.randn(b, di, generator=gen, device=dev),
                0.5 * torch.randn(b, di, generator=gen, device=dev))

            def run(p_, x_, st_):
                return S.slstm_forward(p_, x_, st_)

            def steps(p_, x_, st_):
                half = x_.shape[1] // 2
                y1, st1 = S.slstm_forward(p_, x_[:, :half], st_)
                y2, st2 = S.slstm_forward(p_, x_[:, half:], st1)
                return torch.cat([y1, y2], 1), st2
        x = torch.randn(b, s, d, generator=gen, device=dev)
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, new = run(p, x, st)
            torch.cuda.synchronize()
            card_ms = (time.perf_counter() - t0) * 1e3
            y_st, new_st = steps(p, x, st)
            pc = {k: v.cpu() for k, v in p.items()}
            st_c = type(st)(*(t.cpu() for t in st))
            t0 = time.perf_counter()
            y_ref, new_ref = run(pc, x.cpu(), st_c)
            cpu_ms = (time.perf_counter() - t0) * 1e3
        n_params = sum(v.numel() for v in p.values())
        print(f"hybrid (a): one full-width {kind} block ({cfg.name}, "
              f"d_model {d}, {n_params / 1e6:.1f} M params), f32, TF32 "
              f"off, {b} x {s} tokens from a nonzero state; host ms card "
              f"{card_ms:.1f} (first call), CPU {cpu_ms:.1f} {tag}")
        log = []
        ok = _hyb_gate("card vs CPU, output", y, y_ref, HYB_BLOCK_GATE, log,
                       tag)
        for name, a, r in zip(new._fields, new, new_ref):
            ok &= _hyb_gate(f"card vs CPU, state {name}", a, r,
                            HYB_BLOCK_GATE, log, tag)
        what = ("resumed half way" if kind == "slstm" else
                "mamba_step" if kind == "mamba" else "mlstm_recurrent")
        ok &= _hyb_gate(f"chunked vs {what} on the card, output", y_st, y,
                        HYB_BLOCK_GATE, log, tag)
        for name, a, r in zip(new._fields, new_st, new):
            ok &= _hyb_gate(f"chunked vs {what} on the card, state {name}",
                            a, r, HYB_BLOCK_GATE, log, tag)
        report[kind] = {"params": n_params, "card_ms": card_ms,
                        "cpu_ms": cpu_ms, "gate_shares": log, "ok": ok}
        if not ok:
            fails.append(kind)
        del p, pc, st, st_c, x, y, new, y_st, new_st, y_ref, new_ref
        torch.cuda.empty_cache()
    if fails:
        raise SystemExit(f"chip_smoke: phase 17 (a): the full-width {fails} "
                         "block(s) disagree")
    return report


def _serve_vs_train(lm, params, rows, rel: float, what: str, tag) -> dict:
    """Prefill ``rows`` and take one greedy decode step, then hold the
    prefill's last-token logits and the step's against
    ``forward_train`` on the prompt and that token, at the same
    positions: within ``rel * max|ref|``, or four times
    ``forward_train``'s own spread when only ``mlstm_chunk`` halves (the
    same function, the mLSTM's sums in another order) where that is
    larger.  Returns the gates, ``ok``, the token and the cache after
    the step."""
    import dataclasses
    import torch
    from repro_torch.models.lm import build_lm

    cfg, s = lm.cfg, rows.shape[1]
    with torch.no_grad():
        cache = lm.init_cache(rows.shape[0], s + HYB_MAX_NEW)
        lg_p, cache = lm.prefill(params, {"inputs": rows}, cache)
        tok = torch.argmax(lg_p, -1).to(torch.int32)
        lg_d, cache = lm.decode_step(params, {"inputs": tok}, cache)
        seq = {"inputs": torch.cat([rows, tok], 1)}
        ref = lm.forward_train(params, seq)[:, s - 1:s + 1].clone()
        torch.cuda.empty_cache()
        half = build_lm(dataclasses.replace(
            cfg, mlstm_chunk=cfg.mlstm_chunk // 2), device=lm.device)
        alt = half.forward_train(params, seq)[:, s - 1:s + 1].clone()
    torch.cuda.empty_cache()
    gates, ok = {}, _finite(lg_p) and _finite(lg_d)
    for i, (name, got) in enumerate((("prefill", lg_p), ("decode", lg_d))):
        d_, t_ = _gate_err(got, ref[:, i:i + 1], rel, False)
        spread = (alt[:, i:i + 1] - ref[:, i:i + 1]).abs().max().item()
        gate = max(t_, 4 * spread)
        ok &= d_ <= gate
        gates[name] = {"max_abs": d_, "gate": gate, "share": d_ / gate,
                       "rel_tol": t_, "spread": spread,
                       "max_ref": ref[:, i].abs().max().item()}
    same = torch.equal(torch.argmax(torch.cat([lg_p, lg_d], 1), -1),
                       torch.argmax(ref, -1))
    n_x = cfg.pattern.count("x") * lm.repeats
    txt = "; ".join(
        f"{n} (position {s - 1 + i}): max|d| {g['max_abs']:.3e}, gate "
        f"{g['gate']:.3e} ({g['share']:.3f} of it; {rel}*max|ref| "
        f"{g['rel_tol']:.3e}, spread {g['spread']:.3e})"
        for i, (n, g) in enumerate(gates.items()))
    print(f"  {what}, {cfg.n_layers} layers ({n_x} mLSTM): one group's "
          f"prefill last-token logits and first decode step vs "
          f"forward_train at the same positions, gate max({rel}*max|ref|, "
          f"4 x forward_train's own spread at mlstm_chunk "
          f"{cfg.mlstm_chunk // 2}): {txt}; greedy tokens equal {same} "
          f"{'ok' if ok else 'FAIL'} {tag}")
    return {"gates": gates, "ok": ok, "tok": tok, "cache": cache,
            "tokens_equal": same}


def _hyb_xlstm_serve(dev, tag) -> dict:
    """(b): xLSTM-350M at all 24 layers, bf16, serving HYB_X_REQUESTS
    prompts of HYB_X_PROMPT_LEN tokens through ``serve`` (HYB_SLOTS
    slots, HYB_MAX_NEW new tokens): no K5 launch, every token in the
    vocabulary; one group's prefill last-token logits and first decode
    step against ``forward_train`` (:func:`_serve_vs_train`) in bf16 at
    all 24 layers within LM_BF16_GATE * max|ref|, and in f32 (TF32 off)
    at one pattern period (8 layers) within HYB_X_F32_GATE * max|ref|,
    each or four times ``forward_train``'s own spread when only
    ``mlstm_chunk`` halves, where that is larger (the mLSTM's normaliser
    amplifies rounding: ``tests/test_torch_hybrid.py``); host ms per
    group and step, the busy share
    and top kernels of one profiled prefill and decode step, peak
    memory."""
    import dataclasses
    import torch
    import repro_torch.kernels.flash_attn as FA
    from repro_torch.configs import get
    from repro_torch.launch.serve import random_prompts, serve
    from repro_torch.models.lm import build_lm

    cfg = get(HYB_XLSTM)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = build_lm(cfg, device=dev)
    params = lm._cast(lm.init(torch.Generator(device=dev).manual_seed(SEED)))
    n_params = lm.param_counts(params)[0]
    prompts = random_prompts(cfg.vocab_size, HYB_X_REQUESTS,
                             HYB_X_PROMPT_LEN, seed=SEED)
    FA.FLASH_ATTN_LAUNCHES = 0
    results, stats = serve(cfg, prompts, max_new=HYB_MAX_NEW,
                           slots=HYB_SLOTS, max_len=HYB_X_MAX_LEN,
                           params=params, device=dev)
    torch.cuda.synchronize()
    launches = FA.FLASH_ATTN_LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dec = sorted(stats["decode_ms"])
    groups = len(stats["prefill_ms"])
    print(f"hybrid (b): {cfg.name} at all {cfg.n_layers} layers (pattern "
          f"{''.join(cfg.pattern)}, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads, vocab {cfg.vocab_size}, tied embeddings; "
          f"{n_params / 1e9:.4f} G params, bf16): {len(results)} prompts of "
          f"{HYB_X_PROMPT_LEN} tokens, {HYB_MAX_NEW} new tokens, "
          f"{HYB_SLOTS} slots, in {stats['wall_s']:.3f} s host clock; "
          f"prefill per group {[round(t, 3) for t in stats['prefill_ms']]} "
          f"ms; decode per step median {dec[len(dec) // 2]:.3f} ms [min "
          f"{dec[0]:.3f}, max {dec[-1]:.3f}] over {len(dec)} steps; K5 "
          f"launches {launches}; peak memory {peak:.2f} GiB {tag}")
    ok = (launches == 0 and groups == 2
          and sorted(results) == list(range(HYB_X_REQUESTS))
          and all(len(t) == HYB_MAX_NEW and all(0 <= x < cfg.vocab_size
                                                 for x in t)
                  for t in results.values()))
    if not ok:
        raise SystemExit("chip_smoke: phase 17 (b): xLSTM serving ran K5 "
                         "or its tokens are wrong")
    rows = torch.tensor(prompts[:HYB_SLOTS], dtype=torch.int32, device=dev)
    g16 = _serve_vs_train(lm, params, rows, LM_BF16_GATE, "bf16", tag)
    with torch.no_grad():
        br_dec = _device_breakdown(lambda: lm.decode_step(
            params, {"inputs": g16["tok"]}, g16["cache"]), top=6)
    del g16["cache"]
    torch.cuda.empty_cache()
    # the same check in f32 (TF32 off) on one pattern period, where the
    # amplification leaves the gate its teeth
    cfg32 = dataclasses.replace(cfg, n_layers=len(cfg.pattern),
                                compute_dtype="float32")
    lm32 = build_lm(cfg32, device=dev)
    p32 = lm32.init(torch.Generator(device=dev).manual_seed(SEED))
    g32 = _serve_vs_train(lm32, p32, rows, HYB_X_F32_GATE, "f32", tag)
    del lm32, p32, g32["cache"]
    torch.cuda.empty_cache()
    if not (g16["ok"] and g32["ok"]):
        raise SystemExit("chip_smoke: phase 17 (b): xLSTM's served logits "
                         "disagree with forward_train")
    br = _device_breakdown(lambda: lm.prefill(
        params, {"inputs": rows}, lm.init_cache(HYB_SLOTS, HYB_X_MAX_LEN)),
        top=8, cuda_only=True)
    prof = {}
    for name, b_ in (("prefill", br), ("decode step", br_dec)):
        if b_ is None:
            print(f"  one {name} under the profiler: not measured (no "
                  "device time reported)")
            continue
        busy, wall, top = b_
        prof[name] = {"busy_ms": busy, "wall_ms": wall,
                      "top": [(n[:90], m, c) for n, m, c in top]}
        print(f"  one {name} under the profiler: device busy {busy:.3f} ms "
              f"of {wall:.3f} ms wall (busy share {busy / wall:.3f}) {tag}")
        for n, ms_k, calls in top[:6]:
            print(f"    {ms_k:.3f} ms in {calls} call(s): {n[:90]}")
    del params, lm
    torch.cuda.empty_cache()
    return {"params": n_params, "prefill_ms": stats["prefill_ms"],
            "decode_ms": stats["decode_ms"], "wall_s": stats["wall_s"],
            "peak_gib": peak, "k5_launches": launches,
            "gate_bf16": g16["gates"], "gate_f32": g32["gates"],
            "profile": prof}


def _hyb_xlstm_train(dev, tag) -> dict:
    """(c): xLSTM-350M at full width and depth, f32 params and AdamW,
    bf16 compute, HYB_X_TRAIN_STEPS ``make_train_step`` steps at batch
    HYB_X_TRAIN_BATCH x HYB_X_TRAIN_SEQ: every loss and gnorm finite,
    host ms a step, the busy share of a profiled step, peak memory."""
    import torch
    from repro_torch.configs import get
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.lm import build_lm
    from repro_torch.optim import adamw_init

    cfg = get(HYB_XLSTM)
    torch.cuda.empty_cache()
    lm = build_lm(cfg, device=dev)
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED))
    opt = adamw_init(params)
    step = make_train_step(lm)
    pipe = SyntheticTokenPipeline(cfg.vocab_size, HYB_X_TRAIN_SEQ,
                                  HYB_X_TRAIN_BATCH, seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    ms, metrics = [], []
    for s in range(HYB_X_TRAIN_STEPS):
        batch = {k: v.to(dev) for k, v in pipe.batch(s).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append((float(m["loss"]), float(m["gnorm"]), m["lr"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    batch = {k: v.to(dev) for k, v in pipe.batch(HYB_X_TRAIN_STEPS).items()}
    br = _device_breakdown(lambda: step(params, opt, batch), top=8,
                           cuda_only=True)
    finite = all(math.isfinite(x) for l, g, _ in metrics for x in (l, g))
    print(f"hybrid (c): {cfg.name} at all {cfg.n_layers} layers "
          f"({lm.param_counts(params)[0] / 1e9:.4f} G params; f32 params "
          f"and AdamW, bf16 compute), batch {HYB_X_TRAIN_BATCH} x "
          f"{HYB_X_TRAIN_SEQ}, {HYB_X_TRAIN_STEPS} make_train_step steps: "
          f"(loss, gnorm, lr) {metrics}; host ms per step "
          f"{[round(t, 3) for t in ms]} (synchronised); peak memory "
          f"{peak:.2f} GiB {'ok' if finite else 'FAIL'} {tag}")
    busy = wall = None
    if br is None:
        print("  device time of one step: not measured (the profiler "
              "reported no device time)")
    else:
        busy, wall, top = br
        print(f"  profiler, one step: device busy {busy:.3f} ms of "
              f"{wall:.3f} ms wall (busy share {busy / wall:.3f}) {tag}")
        for n, ms_k, calls in top[:6]:
            print(f"    {ms_k:.3f} ms in {calls} call(s): {n[:90]}")
    if not finite:
        raise SystemExit("chip_smoke: phase 17 (c): xLSTM training gave a "
                         "non-finite loss or gnorm")
    del params, opt, lm
    torch.cuda.empty_cache()
    return {"step_ms": ms, "metrics": metrics, "peak_gib": peak,
            "busy_ms": busy, "wall_ms": wall}


def _hyb_jamba_serve(dev, tag) -> dict:
    """(d): Jamba-1.5-Large at full width, its first HYB_JAMBA_LAYERS
    layers, bf16, serving HYB_J_REQUESTS prompts of HYB_J_PROMPT_LEN
    tokens (HYB_SLOTS slots, HYB_MAX_NEW new tokens, capacity factor
    1.25): K5 once a prefill group, in the attention slot, and never in
    decode; the first group's last-token logits against the same model
    with K5 replaced by the plain scan within LM_BF16_GATE * max|ref|;
    entries dropped per MoE layer, peak memory, one profiled prefill,
    one Mamba layer timed at the prefill's shape; then K5 at Jamba's
    prefill shape against its plain version and SDPA."""
    import torch
    import repro_torch.kernels.flash_attn as FA
    from repro_torch.configs import get
    from repro_torch.launch.serve import random_prompts, serve
    from repro_torch.models import ssm as S
    from repro_torch.models.lm import build_lm

    full = get(HYB_JAMBA)
    cfg = _jamba_cut(full)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = build_lm(cfg, device=dev)
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_total, n_active = lm.param_counts(params)
    prompts = random_prompts(cfg.vocab_size, HYB_J_REQUESTS,
                             HYB_J_PROMPT_LEN, seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    FA.FLASH_ATTN_LAUNCHES = 0
    results, stats = serve(cfg, prompts, max_new=HYB_MAX_NEW,
                           slots=HYB_SLOTS, max_len=HYB_J_MAX_LEN,
                           params=params, device=dev)
    torch.cuda.synchronize()
    launches = FA.FLASH_ATTN_LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    groups = len(stats["prefill_ms"])
    dec = sorted(stats["decode_ms"])
    n_attn = cfg.pattern.count("a") * lm.repeats
    print(f"hybrid (d): {cfg.name} at {HYB_JAMBA_LAYERS} of {full.n_layers} "
          f"layers (pattern {''.join(cfg.pattern)}, d_model {cfg.d_model}, "
          f"Mamba d_inner {cfg.mamba_expand * cfg.d_model} d_state "
          f"{cfg.mamba_d_state}, {cfg.n_heads} q / {cfg.n_kv_heads} kv heads "
          f"of {cfg.hd}, {cfg.n_experts} experts of d_ff {cfg.d_ff}, top-"
          f"{cfg.top_k} at slots 1 and 3, capacity factor "
          f"{cfg.capacity_factor}, vocab {cfg.vocab_size}; {n_total / 1e9:.3f}"
          f" G params ({n_active / 1e9:.3f} G active), {cfg.param_dtype}, "
          f"drawn in {init_s:.3f} s, peak while drawing {init_peak:.2f} "
          f"GiB): {len(results)} prompts of {HYB_J_PROMPT_LEN} tokens, "
          f"{HYB_MAX_NEW} new tokens, {HYB_SLOTS} slots, max_len "
          f"{HYB_J_MAX_LEN}, in {stats['wall_s']:.3f} s host clock; peak "
          f"memory serving {peak:.2f} GiB {tag}")
    print(f"  prefill per group (host clock): "
          f"{[round(t, 3) for t in stats['prefill_ms']]} ms; decode per "
          f"step: median {dec[len(dec) // 2]:.3f} ms [min {dec[0]:.3f}, max "
          f"{dec[-1]:.3f}] over {len(dec)} steps; K5 launches {launches} "
          f"({groups} groups x {n_attn} attention layer expected)")
    ok = (launches == groups * n_attn and groups == 2
          and sorted(results) == list(range(HYB_J_REQUESTS))
          and all(len(t) == HYB_MAX_NEW and all(0 <= x < cfg.vocab_size
                                                 for x in t)
                  for t in results.values()))
    if not ok:
        raise SystemExit("chip_smoke: phase 17 (d): Jamba serving did not "
                         "run K5 once per prefill group, or its tokens are "
                         "wrong")
    batch = {"inputs": torch.tensor(prompts[:HYB_SLOTS], dtype=torch.int32,
                                    device=dev)}
    logs = {"k5": [], "scan": []}
    with torch.no_grad():
        FA.FLASH_ATTN_LAUNCHES = 0
        with _moe_log(logs["k5"]):
            cache = lm.init_cache(HYB_SLOTS, HYB_J_MAX_LEN)
            lg, cache = lm.prefill(params, batch, cache)
        n_prefill = FA.FLASH_ATTN_LAUNCHES
        tok = torch.argmax(lg, -1).to(torch.int32)
        FA.FLASH_ATTN_LAUNCHES = 0
        lgd, cache = lm.decode_step(params, {"inputs": tok}, cache)
        torch.cuda.synchronize()
        n_decode = FA.FLASH_ATTN_LAUNCHES
        del cache
        with _plain_scan(), _moe_log(logs["scan"]):
            ref, _ = lm.prefill(params, batch,
                                lm.init_cache(HYB_SLOTS, HYB_J_MAX_LEN))
    dmax, tol = _gate_err(lg, ref, LM_BF16_GATE, False)
    finite = _finite(lg) and _finite(lgd)
    same = torch.equal(torch.argmax(lg, -1), torch.argmax(ref, -1))
    flips = [int((a["tope"] != b_["tope"]).any(-1).sum())
             for a, b_ in zip(logs["k5"], logs["scan"])]
    dropped = [r["dropped"] for r in logs["k5"]]
    print(f"  first group's prefill: {n_prefill} K5 launches, one decode "
          f"step {n_decode}; logits finite={finite}; vs the plain scan on "
          f"the same weights max|d| {dmax:.3e} tol {tol:.3e} "
          f"({dmax / tol:.3f} of {LM_BF16_GATE}*max|ref|), greedy tokens "
          f"equal {same}; entries dropped per MoE layer {dropped} of "
          f"{logs['k5'][0]['entries']} (cap {logs['k5'][0]['cap']} per "
          f"expert); tokens whose top-{cfg.top_k} experts differ from the "
          f"scan's run per MoE layer {flips} {tag}")
    if not (finite and dmax <= tol and n_prefill == n_attn
            and n_decode == 0):
        raise SystemExit("chip_smoke: phase 17 (d): the served Jamba "
                         "prefill is wrong")
    del ref, logs
    torch.cuda.empty_cache()
    br = _device_breakdown(lambda: lm.prefill(
        params, batch, lm.init_cache(HYB_SLOTS, HYB_J_MAX_LEN)), top=1000)
    busy = wall = k5_ms = float("nan")
    if br is None:
        print("  one prefill under the profiler: not measured (no device "
              "time reported)")
    else:
        busy, wall, top = br
        k5_ms = sum(ms for name, ms, _ in top if "flash_attn" in name)
        print(f"  one prefill under the profiler: device busy {busy:.3f} ms "
              f"of {wall:.3f} ms wall (busy share {busy / wall:.3f}); K5 "
              f"{k5_ms:.3f} ms ({k5_ms / busy:.3f} of busy) {tag}")
        for name, ms_k, calls in top[:8]:
            print(f"    {ms_k:.3f} ms in {calls} call(s): {name[:90]}")
    # one Mamba layer at the prefill's shape, from a zero state
    p0 = {n: t[0] for n, t in lm._cast(params)["slots"][0]["mamba"].items()}
    x = torch.randn(HYB_SLOTS, HYB_J_PROMPT_LEN, cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED)
                    ).to(p0["in_proj"].dtype)
    st = S.init_mamba_state(HYB_SLOTS, p0, x.dtype)
    with torch.no_grad():
        t = _time_ms({"mamba": lambda: S.mamba_forward(
            p0, x, st, chunk=cfg.mamba_chunk)}, reps=3, iters=1)
        br_m = _device_breakdown(lambda: S.mamba_forward(
            p0, x, st, chunk=cfg.mamba_chunk), top=6)
    di, ds = p0["A_log"].shape
    tok_n = HYB_SLOTS * HYB_J_PROMPT_LEN
    gemm_flops = 2.0 * tok_n * cfg.d_model * (3 * di) + 2.0 * tok_n * di * (
        p0["x_proj"].shape[1] + p0["dt_proj"].shape[0])
    scan_bytes = 4.0 * tok_n * di * ds * 6      # dA, dBx, the stack, C
    print(f"  one Mamba layer at the prefill's shape ({HYB_SLOTS} x "
          f"{HYB_J_PROMPT_LEN} tokens, chunk {cfg.mamba_chunk}): "
          f"{t['mamba'][0]:.3f} ms [{t['mamba'][1]:.3f}, {t['mamba'][2]:.3f}]"
          f" (CUDA events, median of 3); its projections {gemm_flops:.3e} "
          f"FLOP ({gemm_flops / PEAK_BF16_FLOPS * 1e3:.3f} ms at 989 "
          f"TFLOP/s), its scan's chunk tensors about {scan_bytes / 1e9:.1f} "
          f"GB of traffic ({scan_bytes / PEAK_BYTES * 1e3:.3f} ms at 3.35 "
          f"TB/s) {tag}")
    mamba_busy = None
    if br_m is not None:
        mamba_busy = br_m[0]
        print(f"    profiler: device busy {br_m[0]:.3f} ms of {br_m[1]:.3f} "
              f"ms wall")
        for name, ms_k, calls in br_m[2]:
            print(f"    {ms_k:.3f} ms in {calls} call(s): {name[:90]}")
    del params, lm, p0, x, st
    torch.cuda.empty_cache()
    k5 = _k5_at_shape(dev, tag, HYB_K5_SHAPE, f"{HYB_JAMBA}'s prefill shape",
                      "hybrid (d)")
    return {"k5_launches": launches, "groups": groups,
            "prefill_ms": stats["prefill_ms"], "decode_ms": stats["decode_ms"],
            "wall_s": stats["wall_s"], "peak_gib": peak,
            "init_peak_gib": init_peak, "params": n_total,
            "active": n_active, "gate_share": dmax / tol,
            "dropped": dropped, "route_flips": flips,
            "prefill_device": {"busy_ms": busy, "wall_ms": wall,
                               "k5_ms": k5_ms},
            "mamba_layer_ms": t["mamba"][0], "mamba_busy_ms": mamba_busy,
            "k5": k5}


def _hyb_card_vs_cpu(dev, tag) -> dict:
    """(e): the reduced xLSTM and Jamba in f32 on the card against the
    CPU: loss within HYB_CHECK_LOSS_RTOL relative; grads within
    LM_GRAD_GATE of each leaf's max (for xLSTM the larger of that and
    four times the CPU's own spread when only ``mlstm_chunk`` changes,
    the amplification of ``tests/test_torch_hybrid.py``) and equal bit
    for bit in a second card run; greedy tokens equal."""
    import dataclasses
    import torch
    from repro_torch.configs import get
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.launch.serve import random_prompts, serve
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.lm import build_lm

    report = {}
    for name in (HYB_XLSTM, HYB_JAMBA):
        cfg = get(name).reduced()
        lms = {"cpu": build_lm(cfg, device="cpu"),
               "card": build_lm(cfg, device=dev)}
        p_cpu = lms["cpu"].init(torch.Generator().manual_seed(SEED))
        p_card = _tree_to(p_cpu, dev)
        batch = SyntheticTokenPipeline(cfg.vocab_size, HYB_CHECK_SEQ,
                                       HYB_CHECK_BATCH, seed=SEED).batch(0)
        ref_loss, ref = value_and_grad(lms["cpu"], p_cpu, batch)
        r = _leaf_items(ref)
        spread = 0.0
        if "x" in cfg.pattern:
            for chunk in (4, 16):
                other = build_lm(dataclasses.replace(cfg, mlstm_chunk=chunk),
                                 device="cpu")
                o = _leaf_items(value_and_grad(other, p_cpu, batch)[1])
                spread = max(spread, max(
                    ((o[k] - r[k]).abs().max()
                     / r[k].abs().max().clamp_min(1e-30)).item() for k in r))
        gate = max(LM_GRAD_GATE, 4 * spread)
        tb = {k: v.to(dev) for k, v in batch.items()}
        loss, got = value_and_grad(lms["card"], p_card, tb)
        again = _leaf_items(value_and_grad(lms["card"], p_card, tb)[1])
        g = _leaf_items(got)
        repeat = all(torch.equal(g[k], again[k]) for k in g)
        errs = {k: ((g[k].float().cpu() - r[k].float()).abs().max()
                    / r[k].float().abs().max().clamp_min(1e-30)).item()
                for k in r}
        leaf = max(errs, key=errs.get)
        rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        prompts = random_prompts(cfg.vocab_size, 6, 32, seed=SEED)
        kw = dict(max_new=8, slots=4, max_len=64)
        toks_cpu, _ = serve(cfg, prompts, params=p_cpu, device="cpu", **kw)
        toks_card, _ = serve(cfg, prompts, params=p_card, device=dev, **kw)
        ok = (rel <= HYB_CHECK_LOSS_RTOL and errs[leaf] <= gate
              and toks_card == toks_cpu and repeat)
        print(f"hybrid (e): {cfg.name} (pattern {''.join(cfg.pattern)}), "
              f"f32, TF32 off, card vs CPU: loss {float(loss):.6f} vs "
              f"{float(ref_loss):.6f}, rel {rel:.3e} (gate "
              f"{HYB_CHECK_LOSS_RTOL}); grads worst leaf {leaf} "
              f"{errs[leaf]:.3e} of its max (gate {gate:.3e}: "
              f"max({LM_GRAD_GATE}, 4 x the CPU's re-chunking spread "
              f"{spread:.3e})), a second card run's grads bit-identical "
              f"{repeat}; 6 served prompts x 8 tokens equal "
              f"{toks_card == toks_cpu} {'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"chip_smoke: phase 17 (e): {cfg.name} on the "
                             "card disagrees with the CPU")
        report[cfg.name] = {"loss_rel": rel, "worst_leaf": leaf,
                            "worst": errs[leaf], "gate": gate,
                            "grads_repeat": repeat}
    return report


def _hybrid_phase(dev, tag) -> dict:
    """Phase 17: (a) full-width Mamba, mLSTM and sLSTM blocks card vs
    CPU and chunked vs stepwise, (b) xLSTM-350M serving at all 24
    layers, (c) xLSTM-350M training at full size, (d) Jamba-1.5-Large
    serving at its first 4 layers with K5 in the attention slot, and K5
    at Jamba's prefill shape, (e) the reduced xLSTM and Jamba card vs
    CPU.  Every failure raises."""
    t0 = time.perf_counter()
    report = {"blocks": _hyb_blocks(dev, tag),
              "xlstm_serve": _hyb_xlstm_serve(dev, tag),
              "xlstm_train": _hyb_xlstm_train(dev, tag),
              "jamba": _hyb_jamba_serve(dev, tag),
              "card_vs_cpu": _hyb_card_vs_cpu(dev, tag)}
    report["phase_s"] = time.perf_counter() - t0
    print(f"hybrid phase: {report['phase_s']:.1f} s host clock {tag}")
    return report


# ---------------------------------------------------------------------------
# Phase 18: the LM frontends, InternVL2-76B (patch projector, K5 in its
# prefill) and Whisper-small (encoder-decoder), and the three other dense
# decoders
# ---------------------------------------------------------------------------

FRONT_VLM, FRONT_ASR = "internvl2-76b", "whisper-small"
FRONT_VLM_LAYERS = 8          # (a): the first 8 of InternVL2's 80 layers
FRONT_REQUESTS, FRONT_SLOTS, FRONT_MAX_NEW = 8, 4, 16
FRONT_TEXT_LEN = 3824         # after 256 patches: 4,080 prompt positions
FRONT_MAX_LEN = 4096
FRONT_K5_SHAPE = (4, 64, 8, 4080, 128)   # (d): InternVL2's prefill group
FRONT_ASR_PROMPT, FRONT_ASR_NEW = 64, 32  # (b): Whisper's requests
FRONT_ASR_F32_GATE = 1e-4     # (b): served vs forward_train in f32
FRONT_ASR_TRAIN = ["--batch", "8", "--seq", "448", "--steps", "3"]
FRONT_CHECK_LOSS_RTOL = 1e-6  # (c): reduced LMs, card vs CPU
FRONT_CHECK_BATCH, FRONT_CHECK_SEQ = 4, 32
DENSE_ARCHS = ("qwen1.5-32b", "internlm2-20b", "yi-34b")
DENSE_LAYERS = 2              # (e): the first 2 layers of each, bf16
DENSE_PROMPTS, DENSE_PROMPT_LEN, DENSE_MAX_NEW = 4, 4080, 16
DENSE_K5_SHAPES = {"qwen1.5-32b": (4, 40, 40, 4080, 128),   # g = 1
                   "yi-34b": (4, 56, 8, 4080, 128)}         # g = 7
# InternLM2-20B's K5 shape (4, 48 / 8, 4,080, 128) is DBRX's: phase 16 (b)


def _embeds(cfg, n: int, dev, seed: int = SEED) -> dict:
    """The embeddings ``cfg``'s prefill reads beside its tokens
    (``models.lm.embedding_inputs``) for ``n`` requests on ``dev``,
    N(0, 0.1^2) in f32 as the training pipeline draws them."""
    import torch
    from repro_torch.models.lm import embedding_inputs
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {k: torch.randn(n, *shape, generator=gen, device=dev).mul_(0.1)
            for k, shape in embedding_inputs(cfg).items()}


def _step_serve(lm, params, rows, extra: dict, slots: int, max_new: int,
                max_len: int):
    """Serve the token prompts ``rows`` (n, S) and their embeddings
    ``extra`` ({name: (n, ...)}) through ``make_prefill_step`` /
    ``make_decode_step``, the step API that InternVL2 and Whisper serve
    through (``serve`` takes tokens only): groups of ``slots`` requests
    in order, a prefill, then greedy decode to ``max_new`` tokens.
    Returns (tokens per request, {"prefill_ms", "decode_ms"}), host
    clock, each ending in reading the tokens back."""
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    prefill, decode = make_prefill_step(lm), make_decode_step(lm)
    out, stats = [], {"prefill_ms": [], "decode_ms": []}
    with torch.no_grad():
        for g in range(0, rows.shape[0], slots):
            batch = {"inputs": rows[g:g + slots],
                     **{k: v[g:g + slots] for k, v in extra.items()}}
            cache = lm.init_cache(batch["inputs"].shape[0], max_len)
            t = time.perf_counter()
            logits, cache = prefill(params, batch, cache)
            tok = torch.argmax(logits, -1).to(torch.int32)
            toks = [tok[:, 0].tolist()]
            stats["prefill_ms"].append((time.perf_counter() - t) * 1e3)
            for _ in range(max_new - 1):
                t = time.perf_counter()
                tok, logits, cache = decode(params, {"inputs": tok}, cache)
                toks.append(tok[:, 0].tolist())
                stats["decode_ms"].append((time.perf_counter() - t) * 1e3)
            out += [list(r) for r in zip(*toks)]
    return out, stats


def _k5_vs_scan(lm, params, batch, max_len: int, what: str, tag) -> dict:
    """One prefill of ``batch`` with K5 against the same prefill on the
    plain scan (``_plain_scan``), last-token logits within LM_BF16_GATE
    * max|ref|; K5's launches in that prefill and in one decode step
    after it.  The padded vocabulary columns (-1e30 in both) are left
    out of the gate."""
    import torch
    import repro_torch.kernels.flash_attn as FA
    with torch.no_grad():
        FA.FLASH_ATTN_LAUNCHES = 0
        lg, cache = lm.prefill(params, batch, lm.init_cache(
            batch["inputs"].shape[0], max_len))
        n_prefill = FA.FLASH_ATTN_LAUNCHES
        tok = torch.argmax(lg, -1).to(torch.int32)
        FA.FLASH_ATTN_LAUNCHES = 0
        lgd, cache = lm.decode_step(params, {"inputs": tok}, cache)
        torch.cuda.synchronize()
        n_decode = FA.FLASH_ATTN_LAUNCHES
        del cache
        with _plain_scan():
            ref, _ = lm.prefill(params, batch, lm.init_cache(
                batch["inputs"].shape[0], max_len))
    v = lm.cfg.vocab_size       # the padding's -1e30 would set the scale
    dmax, tol = _gate_err(lg[..., :v], ref[..., :v], LM_BF16_GATE, False)
    finite = _finite(lg) and _finite(lgd)
    same = torch.equal(torch.argmax(lg, -1), torch.argmax(ref, -1))
    n_attn = lm.cfg.pattern.count("a") * lm.repeats
    ok = finite and dmax <= tol and n_prefill == n_attn and n_decode == 0
    print(f"  {what}: {n_prefill} K5 launches in one prefill ({n_attn} "
          f"attention layers), {n_decode} in a decode step; logits finite="
          f"{finite}; vs the plain scan on the same weights max|d| "
          f"{dmax:.3e} tol {tol:.3e} ({dmax / tol:.3f} of {LM_BF16_GATE}"
          f"*max|ref|), greedy tokens equal {same} "
          f"{'ok' if ok else 'FAIL'} {tag}")
    return {"ok": ok, "max_abs": dmax, "tol": tol, "share": dmax / tol,
            "k5_prefill": n_prefill, "k5_decode": n_decode,
            "tokens_equal": same}


def _front_vlm(dev, tag) -> dict:
    """(a): InternVL2-76B at full width, its first FRONT_VLM_LAYERS
    layers, bf16, serving FRONT_REQUESTS requests of 256 patch
    embeddings + FRONT_TEXT_LEN tokens through the step API
    (FRONT_SLOTS slots, FRONT_MAX_NEW new tokens): K5 once per layer per
    prefill group and never in decode, every token in the vocabulary;
    the first group's last-token logits against the plain scan within
    LM_BF16_GATE * max|ref|; host ms per group and step, one profiled
    prefill, peak memory."""
    import dataclasses
    import torch
    import repro_torch.kernels.flash_attn as FA
    from repro_torch.configs import get
    from repro_torch.launch.serve import random_prompts
    from repro_torch.models.lm import build_lm

    full = get(FRONT_VLM)
    cfg = dataclasses.replace(full, n_layers=FRONT_VLM_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = build_lm(cfg, device=dev)
    t0 = time.perf_counter()
    params = lm._cast(lm.init(torch.Generator(device=dev).manual_seed(SEED)))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = lm.param_counts(params)[0]
    rows = torch.tensor(random_prompts(cfg.vocab_size, FRONT_REQUESTS,
                                       FRONT_TEXT_LEN, seed=SEED),
                        dtype=torch.int32, device=dev)
    extra = _embeds(cfg, FRONT_REQUESTS, dev)
    prompt = cfg.n_patches + FRONT_TEXT_LEN
    torch.cuda.reset_peak_memory_stats()
    FA.FLASH_ATTN_LAUNCHES = 0
    t0 = time.perf_counter()
    toks, stats = _step_serve(lm, params, rows, extra, FRONT_SLOTS,
                              FRONT_MAX_NEW, FRONT_MAX_LEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = FA.FLASH_ATTN_LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    groups = len(stats["prefill_ms"])
    dec = sorted(stats["decode_ms"])
    print(f"frontends (a): {cfg.name} at {FRONT_VLM_LAYERS} of "
          f"{full.n_layers} layers (d_model {cfg.d_model}, {cfg.n_heads} q / "
          f"{cfg.n_kv_heads} kv heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, patch_proj {cfg.frontend_dim} x {cfg.d_model};"
          f" {n_params / 1e9:.3f} G params, {cfg.param_dtype}, drawn in "
          f"{init_s:.3f} s): {FRONT_REQUESTS} requests of {cfg.n_patches} "
          f"patch embeddings + {FRONT_TEXT_LEN} tokens ({prompt} prompt "
          f"positions) through make_prefill_step / make_decode_step, "
          f"{FRONT_MAX_NEW} new tokens, {FRONT_SLOTS} slots, max_len "
          f"{FRONT_MAX_LEN}, in {wall:.3f} s host clock; peak memory "
          f"serving {peak:.2f} GiB {tag}")
    print(f"  prefill per group (host clock): "
          f"{[round(t, 3) for t in stats['prefill_ms']]} ms; decode per "
          f"step: median {dec[len(dec) // 2]:.3f} ms [min {dec[0]:.3f}, max "
          f"{dec[-1]:.3f}] over {len(dec)} steps; K5 launches {launches} "
          f"({groups} groups x {FRONT_VLM_LAYERS} layers expected)")
    ok = (launches == groups * FRONT_VLM_LAYERS and groups == 2
          and len(toks) == FRONT_REQUESTS
          and all(len(t) == FRONT_MAX_NEW and all(0 <= x < cfg.vocab_size
                                                   for x in t)
                  for t in toks))
    if not ok:
        raise SystemExit("chip_smoke: phase 18 (a): InternVL2 serving did "
                         "not run K5 once per layer per prefill group, or "
                         "its tokens are wrong")
    batch = {"inputs": rows[:FRONT_SLOTS],
             **{k: v[:FRONT_SLOTS] for k, v in extra.items()}}
    gate = _k5_vs_scan(lm, params, batch, FRONT_MAX_LEN,
                       "first group's prefill", tag)
    if not gate["ok"]:
        raise SystemExit("chip_smoke: phase 18 (a): the served InternVL2 "
                         "prefill is wrong")
    torch.cuda.empty_cache()
    br = _device_breakdown(lambda: lm.prefill(
        params, batch, lm.init_cache(FRONT_SLOTS, FRONT_MAX_LEN)), top=1000)
    busy = pwall = k5_ms = float("nan")
    if br is None:
        print("  one prefill under the profiler: not measured (no device "
              "time reported)")
    else:
        busy, pwall, top = br
        k5_ms = sum(ms for name, ms, _ in top if "flash_attn" in name)
        print(f"  one prefill under the profiler: device busy {busy:.3f} ms "
              f"of {pwall:.3f} ms wall (busy share {busy / pwall:.3f}); K5 "
              f"{k5_ms:.3f} ms ({k5_ms / busy:.3f} of busy, "
              f"{k5_ms / FRONT_VLM_LAYERS:.3f} ms per launch) {tag}")
        for name, ms_k, calls in top[:8]:
            print(f"    {ms_k:.3f} ms in {calls} call(s): {name[:90]}")
    del params, lm, extra
    torch.cuda.empty_cache()
    return {"k5_launches": launches, "groups": groups, "params": n_params,
            "prefill_ms": stats["prefill_ms"], "decode_ms": stats["decode_ms"],
            "wall_s": wall, "peak_gib": peak, "gate": gate,
            "prefill_device": {"busy_ms": busy, "wall_ms": pwall,
                               "k5_ms": k5_ms}}


def _asr_vs_train(lm, params, rows, frames, rel: float, what: str,
                  tag) -> dict:
    """Whisper: prefill ``rows`` with ``frames`` and take one greedy
    decode step, then hold the prefill's last-token logits and the
    step's against ``forward_train`` on the prompt and that token at the
    same positions, within ``rel * max|ref|`` over the vocabulary (the
    padded columns, -1e30 in both, left out)."""
    import torch
    s = rows.shape[1]
    with torch.no_grad():
        cache = lm.init_cache(rows.shape[0], s + 1)
        lg_p, cache = lm.prefill(params, {"inputs": rows,
                                          "frame_embeds": frames}, cache)
        tok = torch.argmax(lg_p, -1).to(torch.int32)
        lg_d, cache = lm.decode_step(params, {"inputs": tok}, cache)
        ref = lm.forward_train(params, {
            "inputs": torch.cat([rows, tok], 1),
            "frame_embeds": frames})[:, s - 1:s + 1]
    del cache
    gates, ok = {}, _finite(lg_p) and _finite(lg_d)
    v = lm.cfg.vocab_size       # the padding's -1e30 would set the scale
    for i, (name, got) in enumerate((("prefill", lg_p), ("decode", lg_d))):
        d_, t_ = _gate_err(got[..., :v], ref[:, i:i + 1, :v], rel, False)
        ok &= d_ <= t_
        gates[name] = {"max_abs": d_, "tol": t_, "share": d_ / t_}
    same = torch.equal(torch.argmax(torch.cat([lg_p, lg_d], 1), -1),
                       torch.argmax(ref, -1))
    txt = "; ".join(f"{n} (position {s - 1 + i}): max|d| {g['max_abs']:.3e}"
                    f" tol {g['tol']:.3e} ({g['share']:.3f} of it)"
                    for i, (n, g) in enumerate(gates.items()))
    print(f"  {what}: one group's prefill last-token logits and first "
          f"decode step vs forward_train at the same positions, gate "
          f"{rel}*max|ref|: {txt}; greedy tokens equal {same} "
          f"{'ok' if ok else 'FAIL'} {tag}")
    return {"gates": gates, "ok": ok, "tokens_equal": same}


def _front_asr(dev, tag) -> dict:
    """(b): Whisper-small at full size (12 encoder + 12 decoder layers),
    bf16 compute, serving FRONT_REQUESTS requests of 1,500 frame
    embeddings and FRONT_ASR_PROMPT-token prompts through the step API
    (FRONT_ASR_NEW new tokens): 0 K5 launches; one group's prefill and
    first decode step against ``forward_train`` within LM_BF16_GATE *
    max|ref|, and in f32 within FRONT_ASR_F32_GATE * max|ref|; then
    ``launch.train.main`` at batch 8 x 448, 3 steps, f32 params and
    AdamW: finite losses and gnorms, host ms per step, the busy share of
    a profiled step."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    import repro_torch.kernels.flash_attn as FA
    from repro_torch.configs import get
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.serve import random_prompts
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.lm import build_lm, embedding_inputs
    from repro_torch.optim import adamw_init

    cfg = get(FRONT_ASR)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = build_lm(cfg, device=dev)
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED))
    p16 = lm._cast(params)
    n_params = lm.param_counts(params)[0]
    rows = torch.tensor(random_prompts(cfg.vocab_size, FRONT_REQUESTS,
                                       FRONT_ASR_PROMPT, seed=SEED),
                        dtype=torch.int32, device=dev)
    extra = _embeds(cfg, FRONT_REQUESTS, dev)
    max_len = FRONT_ASR_PROMPT + FRONT_ASR_NEW
    FA.FLASH_ATTN_LAUNCHES = 0
    t0 = time.perf_counter()
    toks, stats = _step_serve(lm, p16, rows, extra, FRONT_SLOTS,
                              FRONT_ASR_NEW, max_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = FA.FLASH_ATTN_LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dec = sorted(stats["decode_ms"])
    print(f"frontends (b): {cfg.name} at full size ({cfg.enc_layers} "
          f"encoder + {cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, vocab {cfg.vocab_size}; "
          f"{n_params / 1e9:.4f} G params, f32 drawn, bf16 compute): "
          f"{FRONT_REQUESTS} requests of {cfg.enc_positions} frame "
          f"embeddings + {FRONT_ASR_PROMPT} tokens through the step API, "
          f"{FRONT_ASR_NEW} new tokens, {FRONT_SLOTS} slots, in {wall:.3f} "
          f"s host clock; prefill per group "
          f"{[round(t, 3) for t in stats['prefill_ms']]} ms; decode per "
          f"step median {dec[len(dec) // 2]:.3f} ms [min {dec[0]:.3f}, max "
          f"{dec[-1]:.3f}] over {len(dec)} steps; K5 launches {launches}; "
          f"peak memory {peak:.2f} GiB {tag}")
    ok = (launches == 0 and len(stats["prefill_ms"]) == 2
          and len(toks) == FRONT_REQUESTS
          and all(len(t) == FRONT_ASR_NEW and all(0 <= x < cfg.vocab_size
                                                   for x in t)
                  for t in toks))
    if not ok:
        raise SystemExit("chip_smoke: phase 18 (b): Whisper serving ran K5 "
                         "or its tokens are wrong")
    frames = extra["frame_embeds"][:FRONT_SLOTS]
    g16 = _asr_vs_train(lm, p16, rows[:FRONT_SLOTS], frames, LM_BF16_GATE,
                        "bf16", tag)
    del p16
    lm32 = build_lm(dataclasses.replace(cfg, compute_dtype="float32"),
                    device=dev)
    g32 = _asr_vs_train(lm32, params, rows[:FRONT_SLOTS], frames,
                        FRONT_ASR_F32_GATE, "f32 (TF32 off)", tag)
    with torch.no_grad():
        br_p = _device_breakdown(lambda: lm.prefill(
            lm._cast(params), {"inputs": rows[:FRONT_SLOTS],
                               "frame_embeds": frames},
            lm.init_cache(FRONT_SLOTS, max_len)), top=6, cuda_only=True)
    del params, lm32, extra
    torch.cuda.empty_cache()
    if not (g16["ok"] and g32["ok"]):
        raise SystemExit("chip_smoke: phase 18 (b): Whisper's served "
                         "logits disagree with forward_train")
    if br_p is not None:
        print(f"  one prefill under the profiler: device busy "
              f"{br_p[0]:.3f} ms of {br_p[1]:.3f} ms wall (busy share "
              f"{br_p[0] / br_p[1]:.3f}) {tag}")

    out = tempfile.mkdtemp(prefix="chip_smoke_whisper_")
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = train_mod.main(["--arch", FRONT_ASR, *FRONT_ASR_TRAIN,
                              "--ckpt-every", "1000", "--out", out,
                              "--device", str(dev)])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        peak_t = torch.cuda.max_memory_allocated() / 2 ** 30
        ckpt = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(out) for f in fs) / 2 ** 30
    finally:
        shutil.rmtree(out, ignore_errors=True)
    hist = run["history"]
    finite = all(math.isfinite(h[k]) for h in hist for k in ("loss",
                                                              "gnorm"))
    # one more step of the trained model, profiled
    params = run["params"]
    del run
    batch_n, seq = int(FRONT_ASR_TRAIN[1]), int(FRONT_ASR_TRAIN[3])
    batch = {k: v.to(dev) for k, v in SyntheticTokenPipeline(
        cfg.vocab_size, seq, batch_n, seed=SEED,
        extra=embedding_inputs(cfg)).batch(len(hist)).items()}
    step = make_train_step(lm)
    opt = adamw_init(params)
    br = _device_breakdown(lambda: step(params, opt, batch), top=8,
                           cuda_only=True)
    print(f"  launch.train.main --arch {FRONT_ASR} {' '.join(FRONT_ASR_TRAIN)}"
          f" (f32 params and AdamW, bf16 compute): (step, loss, gnorm, host "
          f"ms) {[(h['step'], round(h['loss'], 4), round(h['gnorm'], 4), h['ms']) for h in hist]};"
          f" {train_s:.3f} s with the draw and its {ckpt:.2f} GiB "
          f"checkpoint; peak memory {peak_t:.2f} GiB "
          f"{'ok' if finite else 'FAIL'} {tag}")
    busy = twall = None
    if br is None:
        print("  device time of one step: not measured (the profiler "
              "reported no device time)")
    else:
        busy, twall, top = br
        print(f"  profiler, one step: device busy {busy:.3f} ms of "
              f"{twall:.3f} ms wall (busy share {busy / twall:.3f}) {tag}")
        for n, ms_k, calls in top[:6]:
            print(f"    {ms_k:.3f} ms in {calls} call(s): {n[:90]}")
    del params, opt, lm, batch
    torch.cuda.empty_cache()
    if not finite:
        raise SystemExit("chip_smoke: phase 18 (b): Whisper training gave a "
                         "non-finite loss or gnorm")
    return {"params": n_params, "k5_launches": launches,
            "prefill_ms": stats["prefill_ms"], "decode_ms": stats["decode_ms"],
            "wall_s": wall, "peak_gib": peak, "gate_bf16": g16["gates"],
            "gate_f32": g32["gates"],
            "prefill_busy_ms": None if br_p is None else br_p[0],
            "train": {"history": hist, "s": train_s, "peak_gib": peak_t,
                      "ckpt_gib": ckpt, "busy_ms": busy, "wall_ms": twall}}


def _front_card_vs_cpu(dev, tag) -> dict:
    """(c): the reduced InternVL2 and Whisper in f32 on the card against
    the CPU: loss within FRONT_CHECK_LOSS_RTOL relative, grads within
    LM_GRAD_GATE of each leaf's max and equal bit for bit in a second
    card run (Whisper's unused encoder leaves zero), greedy tokens of 6
    requests through the step API equal."""
    import torch
    from repro_torch.configs import get
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.launch.serve import random_prompts
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.lm import build_lm, embedding_inputs

    report = {}
    for name in (FRONT_VLM, FRONT_ASR):
        cfg = get(name).reduced()
        lms = {"cpu": build_lm(cfg, device="cpu"),
               "card": build_lm(cfg, device=dev)}
        p_cpu = lms["cpu"].init(torch.Generator().manual_seed(SEED))
        p_card = _tree_to(p_cpu, dev)
        batch = SyntheticTokenPipeline(cfg.vocab_size, FRONT_CHECK_SEQ,
                                       FRONT_CHECK_BATCH, seed=SEED,
                                       extra=embedding_inputs(cfg)).batch(0)
        ref_loss, ref = value_and_grad(lms["cpu"], p_cpu, batch)
        tb = {k: v.to(dev) for k, v in batch.items()}
        loss, got = value_and_grad(lms["card"], p_card, tb)
        again = _leaf_items(value_and_grad(lms["card"], p_card, tb)[1])
        g, r = _leaf_items(got), _leaf_items(ref)
        repeat = all(torch.equal(g[k], again[k]) for k in g)
        errs = {k: ((g[k].float().cpu() - r[k].float()).abs().max()
                    / r[k].float().abs().max().clamp_min(1e-30)).item()
                for k in r}
        unused = [k for k in r if k.startswith("enc_slots")
                  and ("xattn" in k or "lnx" in k)]
        zero = all(not bool(g[k].any()) and not bool(r[k].any())
                   for k in unused)
        leaf = max(errs, key=errs.get)
        rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        rows = torch.tensor(random_prompts(cfg.vocab_size, 6, 16, seed=SEED),
                            dtype=torch.int32)
        emb = _embeds(cfg, 6, "cpu", seed=SEED + 1)
        kw = dict(slots=4, max_new=8, max_len=32)
        toks_cpu, _ = _step_serve(lms["cpu"], p_cpu, rows, emb, **kw)
        toks_card, _ = _step_serve(
            lms["card"], p_card, rows.to(dev),
            {k: v.to(dev) for k, v in emb.items()}, **kw)
        ok = (rel <= FRONT_CHECK_LOSS_RTOL and errs[leaf] <= LM_GRAD_GATE
              and toks_card == toks_cpu and repeat and zero)
        print(f"frontends (c): {cfg.name}, f32, TF32 off, card vs CPU: loss "
              f"{float(loss):.6f} vs {float(ref_loss):.6f}, rel {rel:.3e} "
              f"(gate {FRONT_CHECK_LOSS_RTOL}); grads worst leaf {leaf} "
              f"{errs[leaf]:.3e} of its max (gate {LM_GRAD_GATE}), a second "
              f"card run's grads bit-identical {repeat}, {len(unused)} "
              f"unused encoder leaves zero on both {zero}; 6 requests x 8 "
              f"tokens through the step API equal {toks_card == toks_cpu} "
              f"{'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"chip_smoke: phase 18 (c): {cfg.name} on the "
                             "card disagrees with the CPU")
        report[cfg.name] = {"loss_rel": rel, "worst_leaf": leaf,
                            "worst": errs[leaf], "grads_repeat": repeat,
                            "unused_zero": zero}
    return report


def _dense_serve(dev, tag) -> dict:
    """(e): Qwen1.5-32B, InternLM2-20B and Yi-34B at full width, each cut
    to its first DENSE_LAYERS layers, weights drawn in bf16, serving
    DENSE_PROMPTS prompts of DENSE_PROMPT_LEN tokens through ``serve``:
    K5 once per layer per prefill group and never in decode, the
    prefill's last-token logits against the plain scan within
    LM_BF16_GATE * max|ref|; then K5 at Qwen's (g = 1) and Yi's (g = 7)
    prefill shapes against its plain version and SDPA."""
    import dataclasses
    import torch
    import repro_torch.kernels.flash_attn as FA
    from repro_torch.configs import get
    from repro_torch.launch.serve import random_prompts, serve
    from repro_torch.models.lm import build_lm

    report = {}
    for name in DENSE_ARCHS:
        full = get(name)
        cfg = dataclasses.replace(full, n_layers=DENSE_LAYERS,
                                  param_dtype=full.compute_dtype)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lm = build_lm(cfg, device=dev)
        params = lm.init(torch.Generator(device=dev).manual_seed(SEED))
        n_params = lm.param_counts(params)[0]
        prompts = random_prompts(cfg.vocab_size, DENSE_PROMPTS,
                                 DENSE_PROMPT_LEN, seed=SEED)
        FA.FLASH_ATTN_LAUNCHES = 0
        results, stats = serve(cfg, prompts, max_new=DENSE_MAX_NEW,
                               slots=DENSE_PROMPTS, max_len=FRONT_MAX_LEN,
                               params=params, device=dev)
        torch.cuda.synchronize()
        launches = FA.FLASH_ATTN_LAUNCHES
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        dec = sorted(stats["decode_ms"])
        print(f"frontends (e): {cfg.name} at {DENSE_LAYERS} of "
              f"{full.n_layers} layers (d_model {cfg.d_model}, {cfg.n_heads} "
              f"q / {cfg.n_kv_heads} kv heads of {cfg.hd}, qkv bias "
              f"{cfg.qkv_bias}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
              f"{n_params / 1e9:.3f} G params, bf16): {DENSE_PROMPTS} "
              f"prompts of {DENSE_PROMPT_LEN} tokens, {DENSE_MAX_NEW} new "
              f"tokens, prefill {[round(t, 3) for t in stats['prefill_ms']]}"
              f" ms host, decode median {dec[len(dec) // 2]:.3f} ms; K5 "
              f"launches {launches} ({len(stats['prefill_ms'])} group x "
              f"{DENSE_LAYERS} layers expected); peak memory {peak:.2f} GiB "
              f"{tag}")
        ok = (launches == DENSE_LAYERS and len(stats["prefill_ms"]) == 1
              and sorted(results) == list(range(DENSE_PROMPTS))
              and all(len(t) == DENSE_MAX_NEW for t in results.values()))
        batch = {"inputs": torch.tensor(prompts, dtype=torch.int32,
                                        device=dev)}
        gate = _k5_vs_scan(lm, lm._cast(params), batch, FRONT_MAX_LEN,
                           "the prefill", tag)
        if not (ok and gate["ok"]):
            raise SystemExit(f"chip_smoke: phase 18 (e): {cfg.name} serving "
                             "did not run K5 once per layer, or its logits "
                             "disagree with the plain scan")
        del params, lm
        torch.cuda.empty_cache()
        report[name] = {"k5_launches": launches, "params": n_params,
                        "prefill_ms": stats["prefill_ms"],
                        "decode_ms": stats["decode_ms"], "peak_gib": peak,
                        "gate": gate}
    for name, shape in DENSE_K5_SHAPES.items():
        report[name]["k5"] = _k5_at_shape(
            dev, tag, shape, f"{name}'s prefill shape", "frontends (e)")
    return report


def _frontends_phase(dev, tag) -> dict:
    """Phase 18: (a) InternVL2-76B serving at 8 of 80 layers through the
    step API with K5 in its prefill, (b) Whisper-small serving and
    training at full size, (c) the reduced InternVL2 and Whisper card vs
    CPU, (d) K5 at InternVL2's prefill shape, (e) Qwen1.5-32B,
    InternLM2-20B and Yi-34B serving at 2 layers with K5, and K5 at
    Qwen's and Yi's shapes.  Every failure raises."""
    t0 = time.perf_counter()
    report = {"internvl2": _front_vlm(dev, tag),
              "whisper": _front_asr(dev, tag),
              "card_vs_cpu": _front_card_vs_cpu(dev, tag),
              "k5": _k5_at_shape(dev, tag, FRONT_K5_SHAPE,
                                 f"{FRONT_VLM}'s prefill shape",
                                 "frontends (d)"),
              "dense": _dense_serve(dev, tag)}
    report["phase_s"] = time.perf_counter() - t0
    print(f"frontends phase: {report['phase_s']:.1f} s host clock {tag}")
    return report


# ---------------------------------------------------------------------------
# Phase 19: the LM half of sharding
# ---------------------------------------------------------------------------

SHARD_SPAWN_S = 900        # each spawn's deadline and collective timeout
SHARD_LAYERS = 2           # (a): 2 of StableLM-2-12B's 40 layers, so
                           # that phases 20 and 21 fit the script's time
SHARD_PROMPT_LEN = 4080    # one prefill group of SHARD_SLOTS prompts
SHARD_SLOTS = 4
SHARD_DECODE = 8           # decode steps, fed the one-process tokens
                           # (16 before PR 40; cut for the script's time)
SHARD_MAX_LEN = 4096
SHARD_DBRX_LAYERS = 1      # (b): 1 of DBRX's 40 layers, f32 compute (2
                           # before PR 40; cut for the script's time)
SHARD_DBRX_DECODE = 2      # (b): fsdp_serve gathers every data-split leaf
                           # each step, ~7 GB through gloo's host copies
SHARD_F32_GATE = 1e-4      # f32 logits, sharded vs one process, rel.
                           # max(1, max|ref|)
SHARD_MIX_CFS = (1.0, 0.5, 0.25)   # (c): lowered until entries drop
SHARD_TRAIN_LAYERS = 2     # (d): StableLM at 2 of 40, fsdp_train, f32
SHARD_TRAIN_BATCH, SHARD_TRAIN_SEQ = 8, 128
SHARD_TRAIN_LR = 1e-3
SHARD_LOSS_RTOL = 1e-6
# (e): K5 alone at each rank's heads on a model axis of 2
SHARD_K5_SHAPES = {"stablelm_mp2": (4, 16, 4, 4080, 160),
                   "dbrx_mp2": (4, 24, 4, 4080, 128)}
SHARD_NOTE = ("gloo ranks sharing one card: a collective is a host copy, "
              "not a link between cards")


def _shard_cfg(part: str, cf: float = 0.0):
    """The configuration of part (a)-(d): (a) StableLM-2-12B at
    SHARD_LAYERS, bf16 (weights rounded to bf16 as drawn, as phase 10);
    (b) DBRX-132B at SHARD_DBRX_LAYERS, f32 params and compute (so the
    router's inputs, and with them the drops, are comparable bit for
    bit: bf16 moves them by an ulp between a sharded sum and one
    product); (c) Mixtral-8x7B at one layer, f32, capacity factor
    ``cf``; (d) StableLM at SHARD_TRAIN_LAYERS, f32 params and compute."""
    import dataclasses
    from repro_torch.configs import get
    if part == "a":
        full = get(LM_ARCH)
        return dataclasses.replace(full, n_layers=SHARD_LAYERS,
                                   param_dtype=full.compute_dtype)
    if part == "b":
        return dataclasses.replace(get(MOE_DBRX), n_layers=SHARD_DBRX_LAYERS,
                                   param_dtype="float32",
                                   compute_dtype="float32")
    if part == "c":
        return dataclasses.replace(get("mixtral-8x7b"), n_layers=1,
                                   param_dtype="float32",
                                   compute_dtype="float32",
                                   capacity_factor=cf)
    return dataclasses.replace(get(LM_ARCH), n_layers=SHARD_TRAIN_LAYERS,
                               compute_dtype="float32")


@contextlib.contextmanager
def _drops_recorded(log: list):
    """Appends, for every ``moe_route`` call, the entries each dispatch
    group drops."""
    import repro_torch.models.layers as L
    real = L.moe_route

    def recorded(*a, **kw):
        r = real(*a, **kw)
        log.append((~r["keep"]).sum(-1).tolist())
        return r
    L.moe_route = recorded
    try:
        yield log
    finally:
        L.moe_route = real


@contextlib.contextmanager
def _routes(log: list, replay: bool = False, flips=None):
    """Records every ``moe_route`` call's routing in ``log`` (on the
    host), or with ``replay`` hands each call ``log``'s next routing
    instead of its own (the one-process run's, as its tokens are fed to
    the decode steps), appending to ``flips`` the entries whose experts
    the call's own routing chose otherwise (near ties that a sum's bf16
    rounding flips)."""
    import repro_torch.models.layers as L
    real = L.moe_route
    it = iter(log) if replay else None

    def routed(*a, **kw):
        r = real(*a, **kw)
        if not replay:
            log.append({k: v.cpu() if hasattr(v, "cpu") else v
                        for k, v in r.items()})
            return r
        want = next(it)
        if flips is not None:
            flips.append((int((r["tope"].cpu() != want["tope"]).sum()),
                          want["tope"].numel()))
        dev = r["tope"].device
        return {k: v.to(dev) if hasattr(v, "to") else v
                for k, v in want.items()}
    L.moe_route = routed
    try:
        yield log
    finally:
        L.moe_route = real


def _shard_prompts(cfg):
    import torch
    from repro_torch.launch.serve import random_prompts
    return torch.tensor(random_prompts(cfg.vocab_size, SHARD_SLOTS,
                                       SHARD_PROMPT_LEN, seed=SEED),
                        dtype=torch.int32)


def _shard_serve_one(cfg, dev, layout=None, steps: int = SHARD_DECODE,
                     batch=None, max_len: int = SHARD_MAX_LEN,
                     record_routes: bool = False) -> dict:
    """One process: a prefill group (``batch``, tokens and embeddings on
    the host, default SHARD_SLOTS prompts of SHARD_PROMPT_LEN tokens)
    and ``steps`` greedy decode steps, under a layout-only mesh context
    ``layout`` (dp, mp) when given (the MoE then takes its dispatch
    groups from it); the logits of every step (f32, on the host), the
    tokens, the entries dropped per prefill MoE call and group, and with
    ``record_routes`` every MoE call's routing (:func:`_routes`)."""
    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.lm import build_lm
    lm = build_lm(cfg, device=dev)
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED))
    mesh = None if layout is None else SH.Mesh(*layout)
    drops, lgs, routes = [], [], []
    with torch.no_grad(), SH.mesh_context(mesh), (
            _routes(routes) if record_routes else contextlib.nullcontext()):
        prefill, dec = make_prefill_step(lm), make_decode_step(lm)
        batch = {k: v.to(dev) for k, v in (batch or {
            "inputs": _shard_prompts(cfg)}).items()}
        cache = lm.init_cache(batch["inputs"].shape[0], max_len)
        with _drops_recorded(drops):
            logits, cache = prefill(params, batch, cache)
        lgs.append(logits[:, 0].float().cpu())
        tok = torch.argmax(logits, -1).to(torch.int32)
        toks = [tok.cpu()]
        for _ in range(steps):
            tok, logits, cache = dec(params, {"inputs": tok}, cache)
            lgs.append(logits[:, 0].float().cpu())
            toks.append(tok.cpu())
    torch.cuda.synchronize()
    del lm, params, cache, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"logits": torch.stack(lgs), "tokens": torch.cat(toks, 1),
            "drops": drops, "routes": routes}


def _shard_draw(lm, mesh, mc, dev):
    """This rank's blocks of ``lm``'s weights (seed SEED on the card,
    the one-process draw), kept leaf by leaf as drawn; the ranks draw in
    turn, so one full leaf is in flight on the card at a time."""
    import torch
    from repro_torch.distributed import sharding as SH

    def keep(path, t):
        return SH.local_block(t, SH.param_spec(path, t.ndim, mc),
                              mesh).clone()
    params = None
    for r in range(mesh.size):
        if mesh.rank == r:
            params = lm.init(torch.Generator(device=dev).manual_seed(SEED),
                             keep=keep)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        mesh.barrier()
    return params


def _spec_bytes(tree, specs, mesh) -> int:
    """Bytes of this rank's blocks of ``tree``'s tensors under
    ``specs``."""
    import numpy as np
    from repro_torch.distributed import sharding as SH
    total = 0

    def add(t, s):
        nonlocal total
        if hasattr(t, "numel"):
            total += int(np.prod(SH.local_shape(t.shape, s, mesh))) * \
                t.element_size()
        return t
    SH._zip_map(add, tree, specs)
    return total


def _tree_bytes(tree) -> int:
    from repro_torch.models.lm import _tree_map
    n = []
    _tree_map(lambda t: n.append(t.numel() * t.element_size())
              if hasattr(t, "numel") else None, tree)
    return sum(n)


def _shard_serve_rank(mesh, dev, job, part: str) -> dict:
    """A serving part on one rank (phase 19 (a)-(c), phase 20's): the
    weights drawn as blocks, the bytes held against the specs' blocks, a
    prefill group (``job[part]["batch"]``, tokens and embeddings, or
    SHARD_SLOTS prompts of SHARD_PROMPT_LEN tokens; a cache of
    ``job[part]["max_len"]`` or SHARD_MAX_LEN) with K5 and the
    collectives counted, the drops of its dispatch group, then (decode
    parts) as many steps as the one-process run took, fed its tokens;
    rank 0 gathers the logits."""
    import torch
    import repro_torch.kernels.flash_attn as FA
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.steps import (abstract_params, make_decode_step,
                                          make_prefill_step)
    from repro_torch.models.lm import build_lm
    cfg = job[part]["cfg"]
    max_len = job[part].get("max_len", SHARD_MAX_LEN)
    batch = {k: v.to(dev) for k, v in job[part].get("batch", {}).items()}
    if not batch:
        batch = {"inputs": _shard_prompts(cfg).to(dev)}
    rows = batch["inputs"].shape[0]
    torch.cuda.reset_peak_memory_stats()
    rec = {}
    flips = []
    replay = (_routes(job[part]["routes"], replay=True, flips=flips)
              if job[part].get("routes") else contextlib.nullcontext())
    with torch.no_grad(), SH.mesh_context(mesh, fsdp=cfg.fsdp_serve) as mc, \
            replay:
        lm = build_lm(cfg, device=dev)
        t0 = time.perf_counter()
        params = _shard_draw(lm, mesh, mc, dev)
        rec["draw_s"] = time.perf_counter() - t0
        _, meta = abstract_params(cfg)
        with SH.mesh_context(None):
            meta_cache = build_lm(cfg, device="meta").init_cache(
                rows, max_len)
        cache = lm.init_cache(rows, max_len)
        rec["bytes"] = {
            "params": _tree_bytes(params),
            "params_specs": _spec_bytes(meta, SH.param_specs(meta, mc),
                                        mesh),
            "cache": _tree_bytes(cache),
            "cache_specs": _spec_bytes(meta_cache, SH.cache_specs(
                meta_cache, mc), mesh)}
        del meta, meta_cache
        prefill, dec = make_prefill_step(lm), make_decode_step(lm)
        lspec = SH.constrain((rows,), "batch") + (None, "model")
        FA.FLASH_ATTN_LAUNCHES = 0
        before = dict(mesh.counts)
        drops = []
        torch.cuda.synchronize()
        mesh.barrier()
        t0 = time.perf_counter()
        with _drops_recorded(drops):
            logits, cache = prefill(params, batch, cache)
        torch.cuda.synchronize()
        rec["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        rec["k5"] = FA.FLASH_ATTN_LAUNCHES
        rec["coll_prefill"] = {k: n - before.get(k, 0)
                               for k, n in mesh.counts.items()
                               if n != before.get(k, 0)}
        rec["drops"] = drops
        lgs = [SH.gather_block(logits, lspec, mesh)[:, 0].float().cpu()]
        toks = job[part].get("tokens")
        steps = 0 if toks is None else toks.shape[1] - 1
        before, ms = dict(mesh.counts), []
        for i in range(steps):
            t0 = time.perf_counter()
            _, logits, cache = dec(params, {"inputs": toks[:, i:i + 1]
                                            .to(dev)}, cache)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            snap = dict(mesh.counts)
            lgs.append(SH.gather_block(logits, lspec, mesh)[:, 0]
                       .float().cpu())
            for k, n in mesh.counts.items():   # the comparison's gathers
                before[k] = before.get(k, 0) + n - snap.get(k, 0)
        rec["decode_ms"] = ms
        rec["coll_decode"] = {k: (n - before.get(k, 0)) / max(steps, 1)
                              for k, n in mesh.counts.items()
                              if n != before.get(k, 0)}
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec["route_flips"] = flips
        if mesh.rank == 0:
            rec["logits"] = torch.stack(lgs).numpy()
    del params, cache, lm, logits, prefill, dec, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _shard_train_rank(mesh, dev, job, part: str = "d") -> dict:
    """A training part on one rank (phase 19 (d), phase 20's): the
    sharded value_and_grad and one train step (fsdp_train) on
    ``job[part]["batch"]`` (tokens and embeddings, or SyntheticTokenPipeline's
    SHARD_TRAIN_BATCH x SHARD_TRAIN_SEQ), then the one-process step on
    rank 0, and every leaf of the grads and new params gathered and held
    against it there.  With ``job[part]["spread"]``, rank 0 also takes
    the one-process loss and grads of each way listed there (a config
    whose sums run in another order, nothing else changed; ``"ulp"``:
    every param moved one ulp up or down): their largest distance from
    the first's is the spread a gate takes four times (xLSTM's,
    ROADMAP)."""
    import torch
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models.lm import build_lm
    from repro_torch.optim import adamw_init
    cfg = job[part]["cfg"]
    torch.cuda.reset_peak_memory_stats()
    batch = job[part].get("batch")
    if batch is None:
        batch = SyntheticTokenPipeline(cfg.vocab_size, SHARD_TRAIN_SEQ,
                                       SHARD_TRAIN_BATCH, seed=SEED).batch(0)
    batch = {k: v.to(dev) for k, v in batch.items()}
    lm = build_lm(cfg, device=dev)
    rec = {}
    with SH.mesh_context(mesh, fsdp=cfg.fsdp_train) as mc:
        params = _shard_draw(lm, mesh, mc, dev)
        specs = SH.param_specs(params, mc)
        loss, grads = value_and_grad(lm, params, batch)
        step = make_train_step(lm, base_lr=SHARD_TRAIN_LR, warmup=1,
                               total=10)
        opt = adamw_init(params)
        before = dict(mesh.counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        rec["step_ms"] = (time.perf_counter() - t0) * 1e3
        rec["coll_step"] = {k: n - before.get(k, 0)
                            for k, n in mesh.counts.items()
                            if n != before.get(k, 0)}
        rec["loss"] = float(loss)
        rec["step_loss"] = float(metrics["loss"])
        rec["gnorm"] = float(metrics["gnorm"])
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    # only the blocks to compare stay: rank 0's one-process step needs
    # the card (a full f32 model, its grads and AdamW's state)
    del opt, metrics, step
    gc.collect()
    torch.cuda.empty_cache()
    one = None
    if mesh.rank == 0:
        with SH.mesh_context(None):
            full = lm.init(torch.Generator(device=dev).manual_seed(SEED))
            l1, g1 = value_and_grad(lm, full, batch)
            step1 = make_train_step(lm, base_lr=SHARD_TRAIN_LR, warmup=1,
                                    total=10)
            full, _, m1 = step1(full, adamw_init(full), batch)
        one = {"loss": float(l1), "gnorm": float(m1["gnorm"]),
               "grads": _leaf_items(g1), "params": _leaf_items(full)}
        del full, g1
        gc.collect()
        torch.cuda.empty_cache()
        for way in job[part].get("spread", ()):
            with SH.mesh_context(None):
                lm2 = lm if way == "ulp" else build_lm(way, device=dev)
                p2 = lm2.init(torch.Generator(device=dev).manual_seed(SEED))
                if way == "ulp":        # every param up or down one ulp
                    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
                    for t in _leaf_items(p2).values():
                        sign = torch.randint(0, 2, t.shape, generator=gen,
                                             device=dev).to(t.dtype) * 2 - 1
                        t.mul_(1 + sign * torch.finfo(t.dtype).eps)
                l2, g2 = value_and_grad(lm2, p2, batch)
            dl = abs(float(l2) - one["loss"])
            dg = max((g.float() - one["grads"][k].float()).abs().max().item()
                     / max(one["grads"][k].abs().max().item(), 1e-30)
                     for k, g in _leaf_items(g2).items())
            rec.setdefault("spreads", []).append(
                ("ulp" if way == "ulp" else "reordered", dl, dg))
            rec["spread_loss"] = max(rec.get("spread_loss", 0.0), dl)
            rec["spread_grad"] = max(rec.get("spread_grad", 0.0), dg)
            del lm2, p2, g2
            gc.collect()
            torch.cuda.empty_cache()
    mesh.barrier()
    worst_g, got_p = (0.0, None), {}

    def spec_at(key):
        s = specs
        for part in key.split("/"):
            s = s[int(part)] if isinstance(s, list) else s[part]
        return s
    for k, g in _leaf_items(grads).items():
        whole = SH.gather_block(g, spec_at(k), mesh)
        if one is not None:
            ref = one["grads"][k]
            d = (whole.float() - ref.float()).abs().max().item()
            r = d / max(ref.abs().max().item(), 1e-30)
            if r >= worst_g[0]:
                worst_g = (r, k)
        del whole
    adam = job[part].get("adam", True)
    for k, p in (_leaf_items(params).items() if adam else ()):
        whole = SH.gather_block(p, spec_at(k), mesh)
        if one is not None:
            got_p[k] = whole
    if one is not None:
        rec["one_loss"], rec["one_gnorm"] = one["loss"], one["gnorm"]
        rec["grad_worst"] = worst_g
    if one is not None and adam:
        # the head's columns for the tokens the batch does not target
        # take softmax-sized gradients (p_v h, about 1/V of a target's):
        # 0.298 of the head sits under the determined level at full width
        # on the H100 (every other leaf at most 0.0015; PERF.md), held by
        # the 2 * lr bound but left out of the share
        rec["adam"] = _adam_gate(got_p, one["params"], [one["grads"]],
                                 SHARD_TRAIN_LR,
                                 share_exempt=("head", "embed"))
    del got_p, one, grads, params, lm
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _lm_shard_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of a phase 19 or 20 spawn: its (dp, mp) mesh over gloo on
    the card, then the job's parts in order (``"train"`` parts by
    :func:`_shard_train_rank`, the others by :func:`_shard_serve_rank`)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.mesh import make_dev_mesh
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_dev_mesh(job["dp"], job["mp"], backend="gloo", device=dev,
                         timeout_s=SHARD_SPAWN_S)
    out = {}
    for part in job["parts"]:
        out[part] = (_shard_train_rank(mesh, dev, job, part)
                     if job[part].get("train")
                     else _shard_serve_rank(mesh, dev, job, part))
    return out


def _coll_txt(c: dict) -> str:
    return ", ".join(f"{k} {v:g}" for k, v in sorted(c.items())) or "none"


def _shard_spawn(dev, dp: int, mp: int, job: dict, tag,
                 rank_fn=None, phase: str = "19",
                 name: str = "lm sharding") -> list:
    from repro_torch.launch.mesh import spawn
    job = dict(job, dp=dp, mp=mp, device=str(dev))
    t0 = time.perf_counter()
    # the ranks' allocators grow segments in place: a rank drawing a
    # 10.5 GiB leaf beside the others' blocks can find its own reserved
    # memory in pieces otherwise
    prev = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        out = spawn(rank_fn or _lm_shard_rank, dp * mp, backend="gloo",
                    args=(job,), timeout_s=SHARD_SPAWN_S)
    except RuntimeError as e:
        raise SystemExit(f"chip_smoke: phase {phase} (dp{dp} x mp{mp}, "
                         f"parts {job['parts']}) failed: {e}")
    finally:
        if prev is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = prev
    print(f"{name}: dp{dp} x mp{mp} spawn, parts {job['parts']}, "
          f"{time.perf_counter() - t0:.1f} s host clock with the ranks' "
          f"start-up ({SHARD_NOTE}) {tag}")
    return out


def _shard_check_serve(part: str, label: str, out: list, ref: dict,
                       cfg, dp: int, mp: int, gate: float, floor_one: bool,
                       tag, k5_want=None, name: str = "lm sharding",
                       phase: str = "19") -> dict:
    """Gates of a serving part on the ranks' records: every rank's bytes
    equal to its specs' blocks and ``k5_want`` K5 launches per rank
    (default: where the prefill passes 2,048 tokens with no window, one
    per layer); each step's logits within ``gate`` of the one-process
    run's; prints the per-rank readings."""
    import torch
    recs = [r[part] for r in out]
    got = torch.from_numpy(recs[0]["logits"])
    want = ref["logits"][:got.shape[0]]
    v = cfg.vocab_size
    errs = [_gate_err(got[i, :, :v], want[i, :, :v], gate, floor_one)
            for i in range(got.shape[0])]
    agree = int((got[..., :v].argmax(-1) == want[..., :v].argmax(-1)).sum())
    total = got.shape[0] * got.shape[1]
    if k5_want is None:
        k5_want = cfg.n_layers if cfg.sliding_window is None else 0
    ok_bytes = all(r["bytes"]["params"] == r["bytes"]["params_specs"] and
                   r["bytes"]["cache"] == r["bytes"]["cache_specs"]
                   for r in recs)
    ok_k5 = all(r["k5"] == k5_want for r in recs)
    ok_logits = all(d <= tol for d, tol in errs) and bool(
        torch.isfinite(got).all())
    worst = max(errs, key=lambda e: e[0] / e[1])
    print(f"{name} ({part}): {label} on dp{dp} x mp{mp}: "
          f"{cfg.n_heads // mp} q / {cfg.n_kv_heads // mp} kv heads, "
          f"d_ff {cfg.d_ff // mp} per rank; {len(errs)} steps (prefill + "
          f"{len(errs) - 1} decode fed the one-process tokens): worst "
          f"max|d| {worst[0]:.3e} tol {worst[1]:.3e} (gate {gate} of "
          f"{'max(1, max|ref|)' if floor_one else 'max|ref|'}); greedy "
          f"tokens agree {agree}/{total}; K5 launches per rank "
          f"{[r['k5'] for r in recs]} (want {k5_want}) "
          f"{'ok' if ok_logits and ok_k5 and ok_bytes else 'FAIL'} {tag}")
    for i, r in enumerate(recs):
        b = r["bytes"]
        print(f"  rank {i}: params {b['params'] / 2 ** 30:.3f} GiB (specs' "
              f"blocks {b['params_specs'] / 2 ** 30:.3f}), cache "
              f"{b['cache'] / 2 ** 30:.3f} GiB (specs' "
              f"{b['cache_specs'] / 2 ** 30:.3f}); drawn in "
              f"{r['draw_s']:.2f} s; peak {r['peak_gib']:.2f} GiB; prefill "
              f"{r['prefill_ms']:.1f} ms, collectives per prefill group: "
              f"{_coll_txt(r['coll_prefill'])}; decode "
              f"{[round(x, 1) for x in r['decode_ms']]} ms, collectives "
              f"per decode step: {_coll_txt(r['coll_decode'])} (host clock, "
              f"{SHARD_NOTE})")
    if not (ok_logits and ok_k5 and ok_bytes):
        raise SystemExit(f"chip_smoke: phase {phase} ({part}) on dp{dp} x "
                         f"mp{mp}: logits, K5 launches or bytes off")
    return {"worst": worst, "agree": agree, "total": total,
            "k5": [r["k5"] for r in recs],
            "bytes": [r["bytes"] for r in recs],
            "peak_gib": [r["peak_gib"] for r in recs],
            "prefill_ms": [r["prefill_ms"] for r in recs],
            "decode_ms": [r["decode_ms"] for r in recs],
            "coll_prefill": [r["coll_prefill"] for r in recs],
            "coll_decode": [r["coll_decode"] for r in recs]}


def _shard_drops(out: list, part: str, dp: int, mp: int) -> list:
    """Per MoE call, the drops of each data rank's group (model rank 0's;
    every model rank of a data rank must agree)."""
    per = []
    for d in range(dp):
        rows = [out[d * mp + m][part]["drops"] for m in range(mp)]
        if any(r != rows[0] for r in rows):
            raise SystemExit(f"chip_smoke: phase 19 ({part}): model ranks of "
                             f"data rank {d} dropped different entries")
        per.append(rows[0])
    return [[g for d in range(dp) for g in per[d][i]]
            for i in range(len(per[0]))]


def _lm_sharding_phase(dev, tag, rank_fn=None) -> dict:
    """Phase 19: the LM half of sharding (module doc).  ``rank_fn``: the
    ranks' body (default ``_lm_shard_rank``; a CPU rehearsal wraps it)."""
    import torch
    t_phase = time.perf_counter()
    report = {"k5": {}}
    torch.cuda.empty_cache()
    for name, shape in SHARD_K5_SHAPES.items():
        report["k5"][name] = _k5_at_shape(
            dev, tag, shape, f"{name.split('_')[0]}'s per-rank heads at mp 2",
            "lm sharding (e)")
    torch.cuda.empty_cache()
    # ---- one-process references ----------------------------------------
    cfg_a, cfg_b, cfg_d = _shard_cfg("a"), _shard_cfg("b"), _shard_cfg("d")
    ref_a = _shard_serve_one(cfg_a, dev)
    ref_b = _shard_serve_one(cfg_b, dev, layout=(2, 2),
                             steps=SHARD_DBRX_DECODE)
    ref_c = None
    for cf in SHARD_MIX_CFS:
        cfg_c = _shard_cfg("c", cf)
        two = _shard_serve_one(cfg_c, dev, layout=(2, 1), steps=0)
        if sum(sum(g) for g in two["drops"]):
            one = _shard_serve_one(cfg_c, dev, steps=0)
            ref_c = (cfg_c, two, one)
            break
    if ref_c is None:
        raise SystemExit(f"chip_smoke: phase 19 (c): Mixtral dropped no "
                         f"entry at capacity factors {SHARD_MIX_CFS}")
    jobs = {"a": {"cfg": cfg_a, "tokens": ref_a["tokens"]},
            "b": {"cfg": cfg_b, "tokens": ref_b["tokens"]},
            "c": {"cfg": ref_c[0]}, "d": {"cfg": cfg_d, "train": True}}
    # ---- (a) StableLM-2-12B on dp1 x mp2, then (a), (b), (d) on dp2 x mp2
    label_a = (f"{cfg_a.name} at {cfg_a.n_layers} of 40 layers, "
               f"{cfg_a.compute_dtype}, {SHARD_SLOTS} x {SHARD_PROMPT_LEN} "
               "tokens")
    out_12 = _shard_spawn(dev, 1, 2, dict(jobs, parts=["a"]), tag, rank_fn)
    report["a_mp2"] = _shard_check_serve("a", label_a, out_12, ref_a, cfg_a,
                                         1, 2, LM_BF16_GATE, False, tag)
    out_22 = _shard_spawn(dev, 2, 2, dict(jobs, parts=["a", "b", "d"]), tag,
                          rank_fn)
    report["a_dp2mp2"] = _shard_check_serve("a", label_a, out_22, ref_a,
                                            cfg_a, 2, 2, LM_BF16_GATE, False,
                                            tag)
    # ---- (b) DBRX-132B ----------------------------------------------------
    label_b = (f"{cfg_b.name} at {cfg_b.n_layers} of 40 layers, f32, "
               f"moe_ep, fsdp_serve, {SHARD_SLOTS} x {SHARD_PROMPT_LEN} "
               f"tokens")
    report["b"] = _shard_check_serve("b", label_b, out_22, ref_b, cfg_b, 2,
                                     2, SHARD_F32_GATE, True, tag)
    got = _shard_drops(out_22, "b", 2, 2)
    ok = got == ref_b["drops"]
    print(f"lm sharding (b): entries dropped per MoE layer and dispatch "
          f"group in the prefill, sharded {got} vs one process under "
          f"mesh_context(Mesh(2, 2)) (groups 2) {ref_b['drops']} "
          f"{'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit("chip_smoke: phase 19 (b): the sharded DBRX dropped "
                         "other entries than the one-process run with the "
                         "mesh's groups")
    report["b"]["drops"] = got
    # ---- (c) Mixtral-8x7B, the groups follow the mesh ----------------------
    out_21 = _shard_spawn(dev, 2, 1, dict(jobs, parts=["c"]), tag, rank_fn)
    cfg_c, two, one = ref_c
    rec = out_21[0]["c"]
    lg = torch.from_numpy(rec["logits"])[0]
    v = cfg_c.vocab_size
    d2, tol = _gate_err(lg[:, :v], two["logits"][0][:, :v], SHARD_F32_GATE,
                        True)
    d1, _ = _gate_err(lg[:, :v], one["logits"][0][:, :v], SHARD_F32_GATE,
                      True)
    got = _shard_drops(out_21, "c", 2, 1)
    ok = d2 <= tol < d1 and got == two["drops"]
    print(f"lm sharding (c): {cfg_c.name} at 1 of 32 layers, f32, capacity "
          f"factor {cfg_c.capacity_factor} (the first of {SHARD_MIX_CFS} "
          f"that drops), dp2 x mp1 prefill of {SHARD_SLOTS} x "
          f"{SHARD_PROMPT_LEN}: vs one process with 2 groups max|d| "
          f"{d2:.3e} (tol {tol:.3e}), vs one group {d1:.3e} (must exceed "
          f"it); drops sharded {got}, 2 groups {two['drops']}, 1 group "
          f"{one['drops']} {'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit("chip_smoke: phase 19 (c): the dispatch groups do "
                         "not follow the mesh")
    report["c"] = {"cf": cfg_c.capacity_factor, "d_two": d2, "d_one": d1,
                   "drops": got, "drops_one": one["drops"]}
    # ---- (d) one train step of StableLM -------------------------------------
    recs = [r["d"] for r in out_22]
    r0 = recs[0]
    lrel = abs(r0["loss"] - r0["one_loss"]) / abs(r0["one_loss"])
    gr, gleaf = r0["grad_worst"]
    adam = r0["adam"]
    head = adam["per_leaf"].get("head", (0, 1, 0.0))
    emb = adam["per_leaf"].get("embed", (0, 1, 0.0))
    ok = (lrel <= SHARD_LOSS_RTOL and gr <= LM_GRAD_GATE and adam["ok"]
          and all(math.isfinite(r["gnorm"]) for r in recs))
    print(f"lm sharding (d): {cfg_d.name} at {cfg_d.n_layers} layers, f32 "
          f"params and compute, fsdp_train, dp2 x mp2, batch "
          f"{SHARD_TRAIN_BATCH} x {SHARD_TRAIN_SEQ}, one make_train_step "
          f"at lr {SHARD_TRAIN_LR}: loss {r0['loss']:.7f} vs one process "
          f"{r0['one_loss']:.7f} (rel {lrel:.2e}, gate {SHARD_LOSS_RTOL}); "
          f"gnorm {r0['gnorm']:.6f} vs {r0['one_gnorm']:.6f}; grads worst "
          f"{gr:.3e} of the leaf's max ({gleaf}, gate {LM_GRAD_GATE}); new "
          f"params worst {adam['ratio']:.3f} of the gate ({adam['leaf']}), "
          f"{adam['loose']} of {adam['total']} elements of the leaves other "
          f"than head and embed under the determined level (share "
          f"{adam['loose'] / max(adam['total'], 1):.4f}, at most "
          f"{LM_LOOSE_SHARE}; head {head[0] / head[1]:.4f}, embed "
          f"{emb[0] / emb[1]:.4f}), all within {adam['loose_max']:.2e} "
          f"(2 * lr = {2 * SHARD_TRAIN_LR:g}) {'ok' if ok else 'FAIL'} {tag}")
    for i, r in enumerate(recs):
        print(f"  rank {i}: step {r['step_ms']:.1f} ms host clock, peak "
              f"{r['peak_gib']:.2f} GiB, collectives per train step: "
              f"{_coll_txt(r['coll_step'])} ({SHARD_NOTE})")
    if not ok:
        raise SystemExit("chip_smoke: phase 19 (d): the sharded train step "
                         "disagrees with the one-process step")
    report["d"] = {"loss": r0["loss"], "one_loss": r0["one_loss"],
                   "loss_rel": lrel, "grad_worst": gr, "adam": adam,
                   "step_ms": [r["step_ms"] for r in recs],
                   "peak_gib": [r["peak_gib"] for r in recs],
                   "coll_step": [r["coll_step"] for r in recs]}
    report["k5_launches"] = {"a_dp1xmp2": report["a_mp2"]["k5"],
                             "a_dp2xmp2": report["a_dp2mp2"]["k5"],
                             "b_dp2xmp2": report["b"]["k5"]}
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"lm sharding phase: {report['phase_s']:.1f} s host clock {tag}")
    return report


# ---------------------------------------------------------------------------
# Phase 20: the sharded recurrent slots and frontends
# ---------------------------------------------------------------------------

REC_JAMBA_LAYERS = 4       # (a): Jamba's first 4 layers (3 Mamba + attention)
REC_PROMPT_LEN = 4080      # (a): past 2,048 tokens: K5 in the attention slot
REC_SLOTS = 4
REC_DECODE = 8             # decode steps of (a)-(d), fed the one-process
                           # run's tokens
REC_MAX_LEN = 4096
REC_X_PROMPT_LEN, REC_X_MAX_LEN = 256, 272    # (b): xLSTM-350M, f32
REC_X_SPREAD_CHUNK = 64    # (b): the one-process run re-chunked (default 256)
REC_X_CUT = ("x", "s")      # (b2), (bt): one mLSTM and one sLSTM layer; at
                            # 8 layers a one-ulp move of every f32 param moves
                            # a grad leaf by 0.28 of its max (PERF.md)
REC_X_TRAIN_BATCH, REC_X_TRAIN_SEQ = 8, 128
REC_VLM_LAYERS = 2         # (c): 2 of InternVL2-76B's 80 layers
REC_VLM_TEXT = 3824        # (c): after 256 patches, 4,080 prompt positions
REC_ASR_PROMPT, REC_ASR_MAX_LEN = 64, 128   # (d): Whisper-small, 1,500
                                            # frames
REC_ASR_TRAIN_BATCH, REC_ASR_TRAIN_SEQ = 4, 64
REC_K5_SHAPE = (4, 32, 4, 4080, 128)   # (e): Jamba's per-rank heads at mp 2


def _rec_cfg(part: str):
    """The configuration of phase 20's part: (a) Jamba-1.5-Large's first
    REC_JAMBA_LAYERS layers, bf16; (b) xLSTM-350M whole, f32 params and
    compute, (b2) and its train step (bt) cut to REC_X_CUT at full width;
    (c) InternVL2-76B at REC_VLM_LAYERS, bf16; (d) Whisper-small whole as
    configured (f32 params, bf16 compute), ``dt`` its train step in
    f32."""
    import dataclasses
    from repro_torch.configs import get
    if part == "a":
        full = get(HYB_JAMBA)
        return dataclasses.replace(full, n_layers=REC_JAMBA_LAYERS,
                                   pattern=full.pattern[:REC_JAMBA_LAYERS],
                                   param_dtype=full.compute_dtype)
    if part in ("b", "b2", "bt"):
        full = dataclasses.replace(get(HYB_XLSTM), param_dtype="float32",
                                   compute_dtype="float32")
        if part == "b":
            return full
        return dataclasses.replace(full, n_layers=len(REC_X_CUT),
                                   pattern=REC_X_CUT)
    if part == "c":
        full = get(FRONT_VLM)
        return dataclasses.replace(full, n_layers=REC_VLM_LAYERS,
                                   param_dtype=full.compute_dtype)
    if part == "d":
        return get(FRONT_ASR)
    return dataclasses.replace(get(FRONT_ASR), compute_dtype="float32")


def _rec_batches(cfgs: dict) -> dict:
    """Each part's batch on the host: token prompts from a numpy seed
    and the embeddings the config reads (``_embeds``); the train parts'
    tokens from ``SyntheticTokenPipeline``."""
    import torch
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.launch.serve import random_prompts

    def prompts(cfg, n):
        return torch.tensor(random_prompts(cfg.vocab_size, REC_SLOTS, n,
                                           seed=SEED), dtype=torch.int32)

    def train(cfg, b, s):
        return {**SyntheticTokenPipeline(cfg.vocab_size, s, b,
                                         seed=SEED).batch(0),
                **_embeds(cfg, b, torch.device("cpu"), seed=SEED + 1)}
    return {
        "a": {"inputs": prompts(cfgs["a"], REC_PROMPT_LEN)},
        "b": {"inputs": prompts(cfgs["b"], REC_X_PROMPT_LEN)},
        "b2": {"inputs": prompts(cfgs["b2"], REC_X_PROMPT_LEN)},
        "bt": train(cfgs["bt"], REC_X_TRAIN_BATCH, REC_X_TRAIN_SEQ),
        "c": {"inputs": prompts(cfgs["c"], REC_VLM_TEXT),
              **_embeds(cfgs["c"], REC_SLOTS, torch.device("cpu"))},
        "d": {"inputs": prompts(cfgs["d"], REC_ASR_PROMPT),
              **_embeds(cfgs["d"], REC_SLOTS, torch.device("cpu"))},
        "dt": train(cfgs["dt"], REC_ASR_TRAIN_BATCH, REC_ASR_TRAIN_SEQ)}


def _rec_check_train(part: str, label: str, out: list, dp: int, mp: int,
                     tag) -> dict:
    """Gates of a phase 20 train part on the ranks' records: loss within
    SHARD_LOSS_RTOL and grads within LM_GRAD_GATE of the one-process
    step's, each at least four times the one-process spread where the
    part took one; params by phase 15's AdamW rule where the part holds
    them; prints the per-rank readings."""
    recs = [r[part] for r in out]
    r0 = recs[0]
    lrel = abs(r0["loss"] - r0["one_loss"]) / abs(r0["one_loss"])
    ltol = max(SHARD_LOSS_RTOL, 4 * r0.get("spread_loss", 0.0)
               / abs(r0["one_loss"]))
    gr, gleaf = r0["grad_worst"]
    gtol = max(LM_GRAD_GATE, 4 * r0.get("spread_grad", 0.0))
    adam = r0.get("adam")
    ok = (lrel <= ltol and gr <= gtol and (adam is None or adam["ok"])
          and all(math.isfinite(r["gnorm"]) for r in recs))
    spread = ("" if "spread_grad" not in r0 else
              f" (gates at 4 x the one-process spread, the larger under "
              f"mlstm_chunk {REC_X_SPREAD_CHUNK} (reordered) and under a "
              f"one-ulp move of every param (ulp): "
              + ", ".join(f"{w} loss {a:.3e} grads {b:.3e}"
                          for w, a, b in r0["spreads"]) + ")")
    params = ("params not held" if adam is None else
              f"new params worst {adam['ratio']:.3f} of the gate "
              f"({adam['leaf']}), {adam['loose']} of {adam['total']} "
              f"elements other than the vocabulary's under the determined "
              f"level, all within {adam['loose_max']:.2e} (2 * lr = "
              f"{2 * SHARD_TRAIN_LR:g})")
    print(f"lm sharding recurrent ({part}): {label} on dp{dp} x mp{mp}, one "
          f"make_train_step at lr {SHARD_TRAIN_LR}: loss {r0['loss']:.7f} vs "
          f"one process {r0['one_loss']:.7f} (rel {lrel:.2e}, gate "
          f"{ltol:.2e}); gnorm {r0['gnorm']:.6f} vs {r0['one_gnorm']:.6f}; "
          f"grads worst {gr:.3e} of the leaf's max ({gleaf}, gate "
          f"{gtol:.2e}){spread}; {params} {'ok' if ok else 'FAIL'} {tag}")
    for i, r in enumerate(recs):
        print(f"  rank {i}: step {r['step_ms']:.1f} ms host clock, peak "
              f"{r['peak_gib']:.2f} GiB, collectives per train step: "
              f"{_coll_txt(r['coll_step'])} ({SHARD_NOTE})")
    if not ok:
        raise SystemExit(f"chip_smoke: phase 20 ({part}): the sharded train "
                         "step disagrees with the one-process step")
    return {"loss": r0["loss"], "one_loss": r0["one_loss"],
            "loss_rel": lrel, "loss_gate": ltol, "grad_worst": gr,
            "grad_gate": gtol, "adam": adam,
            "spread_grad": r0.get("spread_grad"),
            "step_ms": [r["step_ms"] for r in recs],
            "peak_gib": [r["peak_gib"] for r in recs],
            "coll_step": [r["coll_step"] for r in recs]}


def _lm_sharding_recurrent_phase(dev, tag, rank_fn=None) -> dict:
    """Phase 20: the sharded recurrent slots and frontends (module doc).
    ``rank_fn``: the ranks' body (default ``_lm_shard_rank``; a CPU
    rehearsal wraps it)."""
    import dataclasses
    import torch
    t_phase = time.perf_counter()
    name = "lm sharding recurrent"
    torch.cuda.empty_cache()
    report = {"k5": _k5_at_shape(
        dev, tag, REC_K5_SHAPE, "Jamba's (InternVL2's) per-rank heads at mp "
        "2", f"{name} (e)")}
    torch.cuda.empty_cache()
    cfgs = {p: _rec_cfg(p) for p in ("a", "b", "b2", "bt", "c", "d", "dt")}
    batches = _rec_batches(cfgs)
    max_len = {"a": REC_MAX_LEN, "b": REC_X_MAX_LEN, "b2": REC_X_MAX_LEN,
               "c": REC_MAX_LEN, "d": REC_ASR_MAX_LEN}
    # ---- one-process references, each freed before the next --------------
    # Jamba's MoE routes recorded: its ranks take them, as its tokens
    ref = {p: _shard_serve_one(cfgs[p], dev, steps=REC_DECODE,
                               batch=batches[p], max_len=max_len[p],
                               record_routes=p == "a")
           for p in ("a", "b", "b2", "c", "d")}
    # xLSTM's own spread: its prefill re-chunked, nothing else changed
    spread, gate = {}, {}
    for p in ("b", "b2"):
        moved = _shard_serve_one(dataclasses.replace(
            cfgs[p], mlstm_chunk=REC_X_SPREAD_CHUNK), dev, steps=0,
            batch=batches[p], max_len=REC_X_MAX_LEN)
        v = cfgs[p].vocab_size
        spread[p] = (moved["logits"][0][..., :v]
                     - ref[p]["logits"][0][..., :v]).abs().max().item()
        scale = max(1.0, ref[p]["logits"][..., :v].abs().max().item())
        gate[p] = max(SHARD_F32_GATE, 4 * spread[p] / scale)
    jobs = {p: {"cfg": cfgs[p], "batch": batches[p], "max_len": max_len[p],
                "tokens": ref[p]["tokens"], "routes": ref[p]["routes"]}
            for p in ref}
    jobs["bt"] = {"cfg": cfgs["bt"], "batch": batches["bt"], "train": True,
                  "adam": False, "spread": [dataclasses.replace(
                      cfgs["bt"], mlstm_chunk=REC_X_SPREAD_CHUNK), "ulp"]}
    jobs["dt"] = {"cfg": cfgs["dt"], "batch": batches["dt"], "train": True}
    # ---- (a) Jamba and (c) InternVL2 on dp1 x mp2 -------------------------
    out_12 = _shard_spawn(dev, 1, 2, dict(jobs, parts=["a", "c"]), tag,
                          rank_fn, phase="20", name=name)
    ca, cc = cfgs["a"], cfgs["c"]
    report["a"] = _shard_check_serve(
        "a", f"{ca.name} at {ca.n_layers} of 72 layers ({''.join(ca.pattern)}"
        f"), {ca.compute_dtype}, moe_ep, fsdp_serve, {REC_SLOTS} x "
        f"{REC_PROMPT_LEN} tokens",
        out_12, ref["a"], ca, 1, 2, LM_BF16_GATE, False, tag,
        k5_want=ca.pattern.count("a"), name=name, phase="20")
    flips = [f for r in out_12 for f in r["a"]["route_flips"]]
    n_flip, n_all = sum(f for f, _ in flips), sum(n for _, n in flips)
    report["a"]["route_flips"] = (n_flip, n_all)
    print(f"{name} (a): the ranks' MoE calls took the one-process run's "
          f"routes (as its tokens); their own routers chose another expert "
          f"for {n_flip} of {n_all} entries over {len(flips)} calls on "
          f"{len(out_12)} ranks (near ties that the sums' bf16 rounding "
          f"flips) {tag}")
    report["c"] = _shard_check_serve(
        "c", f"{cc.name} at {cc.n_layers} of 80 layers, {cc.compute_dtype}, "
        f"{REC_SLOTS} x "
        f"({cc.n_patches} patches + {REC_VLM_TEXT} tokens) through the step "
        "API", out_12, ref["c"], cc, 1, 2, LM_BF16_GATE, False, tag,
        k5_want=cc.n_layers, name=name, phase="20")
    del out_12
    # ---- (b) xLSTM and (d) Whisper on dp2 x mp2, each with a train step ---
    out_22 = _shard_spawn(dev, 2, 2, dict(
        jobs, parts=["b", "b2", "bt", "d", "dt"]), tag, rank_fn, phase="20",
        name=name)
    cb, cd = cfgs["b"], cfgs["d"]
    for p in ("b", "b2"):
        depth = (f"all {cb.n_layers} layers" if p == "b" else
                 f"{cfgs[p].n_layers} layers ({''.join(REC_X_CUT)})")
        report[p] = _shard_check_serve(
            p, f"{cb.name} at {depth}, f32, {REC_SLOTS} x {REC_X_PROMPT_LEN} "
            f"tokens (gate {gate[p]:.3e}: 4 x the one-process prefill's "
            f"spread under mlstm_chunk {REC_X_SPREAD_CHUNK}, "
            f"{spread[p]:.3e}, where above {SHARD_F32_GATE})", out_22,
            ref[p], cfgs[p], 2, 2, gate[p], True, tag, k5_want=0, name=name,
            phase="20")
        report[p]["spread"] = spread[p]
    report["bt"] = _rec_check_train(
        "bt", f"{cb.name} at {cfgs['bt'].n_layers} layers "
        f"({''.join(REC_X_CUT)}), f32, fsdp_train, batch {REC_X_TRAIN_BATCH} "
        f"x {REC_X_TRAIN_SEQ}", out_22, 2, 2, tag)
    report["d"] = _shard_check_serve(
        "d", f"{cd.name} whole ({cd.enc_layers} + {cd.n_layers} layers), "
        f"{cd.compute_dtype} compute, {REC_SLOTS} x ({cd.enc_positions} "
        f"frames + "
        f"{REC_ASR_PROMPT} tokens) through the step API", out_22, ref["d"],
        cd, 2, 2, LM_BF16_GATE, False, tag, k5_want=0, name=name,
        phase="20")
    report["dt"] = _rec_check_train(
        "dt", f"{cd.name} whole, f32, fsdp_train, batch {REC_ASR_TRAIN_BATCH}"
        f" x ({cd.enc_positions} frames + {REC_ASR_TRAIN_SEQ} tokens)",
        out_22, 2, 2, tag)
    report["k5_launches"] = {"jamba_dp1xmp2": report["a"]["k5"],
                             "internvl2_dp1xmp2": report["c"]["k5"],
                             "xlstm_dp2xmp2": report["b"]["k5"],
                             "xlstm_cut_dp2xmp2": report["b2"]["k5"],
                             "whisper_dp2xmp2": report["d"]["k5"]}
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"{name} phase: {report['phase_s']:.1f} s host clock {tag}")
    return report


# ---- 21. the dry-run: heads the model axis does not divide, live on the
# card and traced with no device ------------------------------------------
DRY_SPAWN_S = 900          # each spawn's deadline and collective timeout
DRY_S_LAYERS = 2           # (a): 2 of StableLM-2-12B's 40 layers
DRY_S_MP = 16              # (a): 32 q / 8 kv heads on 16 ranks: 2 q, 1 kv
DRY_SLOTS = 4
DRY_PROMPT_LEN = 4080      # (a): 4 x 4,080 tokens, K5 on each rank's heads
DRY_B_MP = 8               # (b): Whisper's 12 heads and 1,500 positions,
#                            xLSTM's 4 heads, none divided by 8
DRY_ASR_PROMPT = 64        # (b): Whisper's decoder prompt
DRY_X_PROMPT = 256         # (b): xLSTM's prompt (its trace: a few ops a
#                            token in the sLSTM's loop)
DRY_X_TRAIN = (4, 128)     # (b): xLSTM's train batch and length
DRY_K5_SHAPE = (4, 2, 1, 4080, 160)   # (a)'s per-rank K5 launch
DRY_MEM_RATIO = (0.85, 1.30)  # live max_memory_allocated / dry peak_hbm
DRY_CLI = (("stablelm-12b", "prefill_32k", "single"),
           ("yi-34b", "decode_32k", "multi"))
DRY_F_TOKENS = (2, 4096)   # (f): StableLM's train step on (a)'s 16 ranks
#                            (its trace: 2.47 GiB a rank under "seq")
DRY_F_LABEL = "stablelm_train"
DRY_G_CHUNK = 128          # (g): Jamba's mamba_chunk, one chunk's backward


def _dry_cells():
    """(label, config, cell) of phase 21's live runs: (a) StableLM-2-12B
    cut to DRY_S_LAYERS layers on mp DRY_S_MP, a prefill through K5, and
    (f) its train step of DRY_F_TOKENS under ``act_shard="seq"``; (b)
    Whisper-small and xLSTM-350M whole on mp DRY_B_MP, a prefill and a
    decode step each and an xLSTM train step."""
    import dataclasses
    from repro_torch.configs import ShapeCell, get
    s = dataclasses.replace(get("stablelm-12b"), n_layers=DRY_S_LAYERS,
                            act_shard="seq")
    w, x = get("whisper-small"), get("xlstm-350m")
    return {
        "a": [("stablelm_prefill", s,
               ShapeCell("p", "prefill", DRY_PROMPT_LEN, DRY_SLOTS)),
              (DRY_F_LABEL, s,
               ShapeCell("t", "train", DRY_F_TOKENS[1], DRY_F_TOKENS[0]))],
        "b": [("whisper_prefill", w,
               ShapeCell("p", "prefill", DRY_ASR_PROMPT, DRY_SLOTS)),
              ("whisper_decode", w,
               ShapeCell("d", "decode", DRY_ASR_PROMPT, DRY_SLOTS)),
              ("xlstm_prefill", x,
               ShapeCell("p", "prefill", DRY_X_PROMPT, DRY_SLOTS)),
              ("xlstm_decode", x,
               ShapeCell("d", "decode", DRY_X_PROMPT, DRY_SLOTS)),
              ("xlstm_train", x,
               ShapeCell("t", "train", DRY_X_TRAIN[1], DRY_X_TRAIN[0]))]}


def _dry_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of a phase 21 spawn: its dp1 x mp mesh over gloo on the
    card, then each of the job's steps on inputs drawn from one seed on
    every rank (``dryrun.live_inputs``), run once under
    ``dryrun.run_step``'s trace: the collectives, FLOPs and K5 calls it
    recorded, its K5 launches, the peak of ``max_memory_allocated`` over
    the step, and (rank 0) the gathered prefill logits."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch.kernels.flash_attn as FA
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_dev_mesh
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_dev_mesh(1, job["mp"], backend="gloo", device=dev,
                         timeout_s=DRY_SPAWN_S)
    out = {}
    for label, cfg, cell in job["cells"]:
        mc = D.cell_context(cfg, cell, mesh)
        lm, args = D.live_inputs(cfg, cell, mesh, mc, dev, seed=SEED)
        seq = None
        if label == DRY_F_LABEL:
            seq = _dry_seq_vs_batch(cfg, mc, args, dev)
        mesh.counts.clear()
        mesh.traffic.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        launches = FA.FLASH_ATTN_LAUNCHES
        res, tr, _ = D.run_step(lm, cfg, cell, mc, args)
        torch.cuda.synchronize()
        rec = {"counts": dict(mesh.counts),
               "traffic": {k: dict(v) for k, v in mesh.traffic.items()},
               "flops": tr.flops, "k5": tr.k5,
               "k5_launches": FA.FLASH_ATTN_LAUNCHES - launches,
               "k5_shapes": tr.k5_shapes, "before": before,
               "max_alloc": torch.cuda.max_memory_allocated()}
        if cell.step == "train":
            rec["finite"] = bool(torch.isfinite(res[2]["loss"]).item())
            if seq is not None:
                rec["seq"] = dict(seq, transport=f"{mesh.backend} on "
                                  f"{dev.type} tensors")
        else:
            logits = res[0] if cell.step == "prefill" else res[1]
            rec["finite"] = bool(torch.isfinite(
                logits[..., :cfg.vocab_size]).all().item())
            spec = SH.constrain((cell.global_batch,), "batch",
                                mc=mc) + (None, "model")
            whole = SH.gather_block(logits, spec, mesh)
            if rank == 0:
                rec["logits"] = whole.float().cpu().numpy()
        out[label] = rec
        del args, res, lm
        torch.cuda.empty_cache()
    return out


def _dry_seq_vs_batch(cfg, mc, args, dev) -> dict:
    """(f) on one rank: the loss and grads of the step's first
    microbatch under ``act_shard="seq"`` and ``"batch"`` on the rank's
    blocks (no trace): the loss's error of ``max(1, |batch's|)``, the
    worst grad leaf's of its max, and each layout's model-axis
    collectives."""
    import dataclasses
    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.lm import build_lm
    params, _, batch = args
    first = {k: torch.chunk(v, max(cfg.microbatch, 1))[0]
             for k, v in batch.items()}
    got, counts = {}, {}
    with SH.mesh_context(mc):
        for act in ("seq", "batch"):
            lm = build_lm(dataclasses.replace(cfg, act_shard=act),
                          device=dev)
            snap = dict(mc.mesh.counts)
            got[act] = value_and_grad(lm, params, first)
            counts[act] = {k: n - snap.get(k, 0)
                           for k, n in mc.mesh.counts.items()
                           if k.endswith("/model") and n != snap.get(k, 0)}
    (ls, gs), (lb, gb) = got["seq"], got["batch"]
    from repro_torch.optim.adamw import _leaves
    worst = 0.0
    for (_, a), (_, b) in zip(_leaves(gs), _leaves(gb)):
        scale = float(b.float().abs().max())
        if scale > 0:
            worst = max(worst, float((a.float() - b.float()).abs().max())
                        / scale)
    loss_err = abs(float(ls) - float(lb)) / max(1.0, abs(float(lb)))
    del got, gs, gb
    torch.cuda.empty_cache()
    return {"loss_err": loss_err, "grad_err": worst, "counts": counts,
            "loss": float(ls)}


def _dry_one(cfg, cell, dev):
    """The one-process step on the card of the same draws (a mesh of
    one rank), its logits."""
    import torch
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.launch import dryrun as D
    mesh = Mesh(1, 1, device=dev)
    mc = D.cell_context(cfg, cell, mesh)
    lm, args = D.live_inputs(cfg, cell, mesh, mc, dev, seed=SEED)
    with torch.no_grad():
        res, _, _ = D.run_step(lm, cfg, cell, mc, args)
    logits = res[0] if cell.step == "prefill" else res[1]
    out = logits.float().cpu()
    del args, res, lm
    torch.cuda.empty_cache()
    return out


def _dry_check(part: str, label: str, cfg, cell, mp: int, recs: list,
               dev, tag) -> dict:
    """(c) for one live run: the dry-run's trace of rank 0's step on a
    dp1 x mp abstract mesh against rank 0's record (collectives, FLOPs
    and K5 calls equal), every rank's K5 launches equal to its trace's
    calls, the dry-run's peak_hbm_bytes beside the live
    max_memory_allocated (ratio gated at DRY_MEM_RATIO), finite outputs,
    and a serving step's gathered logits against the one-process run's
    (LM_BF16_GATE; xLSTM's bf16 logits move by their own size under a
    re-chunking (phase 20 (b)), so only finite there)."""
    import torch
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.launch import dryrun as D
    name = "dryrun"
    t0 = time.perf_counter()
    dry = D.trace_step(cfg, cell, Mesh(1, mp))
    t_dry = time.perf_counter() - t0
    live = recs[0][label]
    got = {"counts": dict(dry["mesh"].counts),
           "traffic": {k: dict(v) for k, v in dry["mesh"].traffic.items()},
           "flops": dry["trace"].flops, "k5": dry["trace"].k5}
    same = {k: got[k] == live[k] for k in got}
    launches = [r[label]["k5_launches"] for r in recs]
    peak = dry["memory"]["peak_hbm_bytes"]
    ratio = live["max_alloc"] / peak
    ok_mem = DRY_MEM_RATIO[0] <= ratio <= DRY_MEM_RATIO[1]
    finite = all(r[label]["finite"] for r in recs)
    print(f"{name} ({part}) {label}: {cfg.name} at {cfg.n_layers} layers, "
          f"{cell.step} of {cell.global_batch} x {cell.seq_len} on dp1 x "
          f"mp{mp} gloo ranks: the trace of rank 0's step ({t_dry:.1f} s, "
          f"meta device) predicts collectives {same['counts']} "
          f"({_coll_txt(live['counts'])}), wire bytes {same['traffic']}, "
          f"FLOPs {same['flops']} ({got['flops']:.6e} vs "
          f"{live['flops']:.6e}), K5 calls {same['k5']} ({got['k5']} vs "
          f"{live['k5']}); K5 launches per rank {sorted(set(launches))}; "
          f"memory: dry peak_hbm_bytes {peak} vs live max_memory_allocated "
          f"{live['max_alloc']} (allocated before the step "
          f"{live['before']}, dry arguments "
          f"{dry['memory']['argument_bytes']}), ratio {ratio:.4f} (gate "
          f"{DRY_MEM_RATIO}); finite {finite} {tag}")
    rec = {"same": same, "k5": got["k5"], "k5_launches": launches,
           "flops": got["flops"], "peak_hbm_bytes": peak,
           "max_alloc": live["max_alloc"], "ratio": ratio,
           "dry_s": t_dry, "k5_shapes": live["k5_shapes"][:1]}
    bad = [k for k, v in same.items() if not v]
    if bad or not finite or not ok_mem or any(
            n != got["k5"] for n in launches):
        raise SystemExit(f"chip_smoke: phase 21 ({part}) {label}: the "
                         f"dry-run's {bad} differ from the live ranks', or "
                         f"memory ratio {ratio:.4f} outside {DRY_MEM_RATIO},"
                         f" or K5 launches {launches} != {got['k5']}, or "
                         f"finite {finite}")
    if "logits" in live and cfg.name != "xlstm-350m":
        want = _dry_one(cfg, cell, dev)
        have = torch.from_numpy(live["logits"])
        v = cfg.vocab_size
        d, tol = _gate_err(have[..., :v], want[..., :v], LM_BF16_GATE, False)
        print(f"  {label}: the ranks' gathered logits vs the one-process "
              f"run on the card, same draws: max|d| {d:.4e} (tol {tol:.4e}"
              f", {LM_BF16_GATE} of max|ref|) {'ok' if d <= tol else 'FAIL'}"
              f" {tag}")
        rec["logits_err"] = (d, tol)
        if not d <= tol:
            raise SystemExit(f"chip_smoke: phase 21 ({part}) {label}: the "
                             "sharded logits disagree with one process")
    return rec


def _dry_seq_check(label: str, mp: int, recs: list, tag) -> dict:
    """(f): every rank's ``"seq"`` loss and grads against ``"batch"``'s
    within LM_BF16_GATE (of the loss's ``max(1, |ref|)``, of each grad
    leaf's max), reduce-scatters where ``"batch"`` has none, and the
    transport they ran on (gloo takes the card's tensors for
    ``reduce_scatter``; nothing is staged through host memory)."""
    seqs = [r[label]["seq"] for r in recs]
    loss_err = max(q["loss_err"] for q in seqs)
    grad_err = max(q["grad_err"] for q in seqs)
    c = seqs[0]["counts"]
    transport = sorted({q["transport"] for q in seqs})
    print(f"dryrun (f) {label}: act_shard 'seq' vs 'batch' on the {mp} "
          f"ranks' blocks, the step's first microbatch: loss "
          f"{seqs[0]['loss']:.6f}, worst |d| over ranks {loss_err:.3e} of "
          f"max(1, |loss|), worst grad leaf {grad_err:.3e} of its max (gate "
          f"{LM_BF16_GATE}); model-axis collectives of its loss's grads: "
          f"seq {_coll_txt(c['seq'])}, batch {_coll_txt(c['batch'])}; "
          f"reduce_scatter transport {transport} {tag}")
    ok = (loss_err <= LM_BF16_GATE and grad_err <= LM_BF16_GATE
          and c["seq"].get("reduce_scatter/model", 0) > 0
          and "reduce_scatter/model" not in c["batch"])
    if not ok:
        raise SystemExit(f"chip_smoke: phase 21 (f) {label}: 'seq' against "
                         f"'batch': loss {loss_err:.3e}, grads {grad_err:.3e}"
                         f", collectives {c}, transport {transport}")
    return {"loss_err": loss_err, "grad_err": grad_err, "counts": c,
            "transport": transport}


def _dry_mamba_op(dev, tag) -> dict:
    """(g): one Mamba layer at Jamba-1.5-Large's width (d 8,192, d_inner
    16,384, bf16) on phase 17 (d)'s prefill shape (HYB_SLOTS x
    HYB_J_PROMPT_LEN) from a random state, through the scan operator
    and through the plain checkpointed loop: output and new state
    bit-identical; one chunk of DRY_G_CHUNK steps in f32 (the scan's
    dtype), the backward operator's gradients against autograd through
    the plain body: bit-identical."""
    import torch
    from repro_torch.configs import get
    from repro_torch.models import ssm as S
    cfg = get(HYB_JAMBA)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = S.init_mamba(gen, cfg.d_model, expand=cfg.mamba_expand,
                     d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv,
                     dtype=torch.bfloat16)
    di, ds = p["A_log"].shape
    x = torch.randn(HYB_SLOTS, HYB_J_PROMPT_LEN, cfg.d_model, device=dev,
                    generator=gen).to(torch.bfloat16)
    st = S.MambaState(
        torch.randn(HYB_SLOTS, cfg.mamba_d_conv - 1, di, device=dev,
                    generator=gen).to(torch.bfloat16),
        torch.randn(HYB_SLOTS, di, ds, device=dev, generator=gen))

    def plain_scan(dt, x_c, A, bmat, cmat, h0, chunk):
        h, ys = h0, []
        for i in range(dt.shape[1] // chunk):
            sl = slice(i * chunk, (i + 1) * chunk)
            h, y = S._recompute(S._mamba_chunk, h, dt[:, sl], x_c[:, sl],
                                bmat[:, sl], cmat[:, sl], A)
            ys.append(y)
        return torch.cat(ys, 1), h
    op_scan = S._mamba_scan_chunked
    t0 = time.perf_counter()
    with torch.no_grad():
        y_op, new_op = S.mamba_forward(p, x, st, chunk=cfg.mamba_chunk)
        S._mamba_scan_chunked = plain_scan
        try:
            y_pl, new_pl = S.mamba_forward(p, x, st, chunk=cfg.mamba_chunk)
        finally:
            S._mamba_scan_chunked = op_scan
    fwd_same = (torch.equal(y_op, y_pl) and torch.equal(new_op.ssm,
                                                        new_pl.ssm)
                and torch.equal(new_op.conv, new_pl.conv))
    del p, x, st, y_op, y_pl, new_op, new_pl
    torch.cuda.empty_cache()
    b, l = HYB_SLOTS, DRY_G_CHUNK

    def leaf(*shape):
        return torch.randn(shape, device=dev, generator=gen)
    h, xb, bb, cb = leaf(b, di, ds), leaf(b, l, di), leaf(b, l, ds), \
        leaf(b, l, ds)
    dtb = torch.nn.functional.softplus(leaf(b, l, di) - 4)
    a = -torch.exp(leaf(di, ds).clamp(-2, 2))
    g_h, g_y = leaf(b, di, ds), leaf(b, l, di)
    ins = [t.requires_grad_(True) for t in (h, dtb, xb, bb, cb, a)]
    outs = torch.ops.repro_torch.mamba_chunk_scan(*ins)
    g_op = torch.autograd.grad(outs, ins, (g_h, g_y))
    outs = S._mamba_chunk(*ins)
    g_pl = torch.autograd.grad(outs, ins, (g_h, g_y))
    bwd_same = all(torch.equal(u, v) for u, v in zip(g_op, g_pl))
    secs = time.perf_counter() - t0
    del ins, outs, g_op, g_pl
    torch.cuda.empty_cache()
    print(f"dryrun (g): one Mamba layer at {HYB_JAMBA}'s width (d "
          f"{cfg.d_model}, d_inner {di}, bf16) on {HYB_SLOTS} x "
          f"{HYB_J_PROMPT_LEN} tokens from a random state, chunk "
          f"{cfg.mamba_chunk}, through repro_torch::mamba_chunk_scan vs the "
          f"plain checkpointed loop: output and state bit-identical "
          f"{fwd_same}; one {b} x {l} x {di} x {ds} f32 chunk's backward "
          f"operator vs autograd through the plain body: gradients "
          f"bit-identical {bwd_same} ({secs:.1f} s host clock) {tag}")
    if not (fwd_same and bwd_same):
        raise SystemExit("chip_smoke: phase 21 (g): the scan operator "
                         "differs from the plain loop on the card")
    return {"forward_bit_identical": fwd_same,
            "backward_bit_identical": bwd_same, "seconds": secs}


def _dry_cli(tag) -> dict:
    """(d): ``python -m repro_torch.launch.dryrun`` on DRY_CLI's cells, in
    fresh processes started together (no jax there), each ending
    ``ok``."""
    import json
    import subprocess
    import tempfile
    out = {}
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ,
               PYTHONPATH=os.path.join(here, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        t0 = time.perf_counter()
        procs = [(cell, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             cell[0], "--shape", cell[1], "--multi-pod", cell[2], "--out",
             os.path.join(tmp, str(i))], env=env, cwd=here,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for i, cell in enumerate(DRY_CLI)]
        for i, ((arch, shape, pods), proc) in enumerate(procs):
            try:
                stdout, stderr = proc.communicate(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            secs = time.perf_counter() - t0
            tagf = f"{arch}__{shape}__{'mp' if pods == 'multi' else 'sp'}"
            path = os.path.join(tmp, str(i), tagf + ".json")
            rec = json.load(open(path)) if os.path.exists(path) else {}
            ok = proc.returncode == 0 and rec.get("status") == "ok"
            first = (stdout.strip().splitlines() or [""])[0]
            print(f"dryrun (d): python -m repro_torch.launch.dryrun --arch "
                  f"{arch} --shape {shape} --multi-pod {pods}: exit "
                  f"{proc.returncode}, status {rec.get('status')}, done "
                  f"{secs:.1f} s host clock after both started: "
                  f"{first[:200]} {tag}")
            if not ok:
                raise SystemExit(f"chip_smoke: phase 21 (d): the dry-run of "
                                 f"{tagf} did not end ok: {stderr[-1500:]}")
            out[tagf] = {"seconds": secs, "memory": rec["memory"],
                         "roofline": rec["roofline"], "cost": rec["cost"]}
    return out


def _dryrun_phase(dev, tag, rank_fn=None) -> dict:
    """Phase 21: the dry-run and the heads the model axis does not divide
    (module doc).  ``rank_fn``: the ranks' body (default ``_dry_rank``; a
    CPU rehearsal wraps it)."""
    import torch
    from repro_torch.launch.mesh import spawn
    t_phase = time.perf_counter()
    name = "dryrun"
    torch.cuda.empty_cache()
    report = {"k5": _k5_at_shape(
        dev, tag, DRY_K5_SHAPE, "StableLM-2-12B's per-rank heads at mp 16 "
        "(the model axis does not divide its 8 kv heads)", f"{name} (e)")}
    torch.cuda.empty_cache()
    report["mamba_op"] = _dry_mamba_op(dev, tag)
    cells = _dry_cells()
    for part, mp in (("a", DRY_S_MP), ("b", DRY_B_MP)):
        job = {"mp": mp, "device": str(dev), "cells": cells[part]}
        t0 = time.perf_counter()
        prev = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            recs = spawn(rank_fn or _dry_rank, mp, backend="gloo",
                         args=(job,), timeout_s=DRY_SPAWN_S)
        except RuntimeError as e:
            raise SystemExit(f"chip_smoke: phase 21 ({part}, dp1 x mp{mp}) "
                             f"failed: {e}")
        finally:
            if prev is None:
                os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = prev
        print(f"{name} ({part}): dp1 x mp{mp} spawn, "
              f"{[c[0] for c in cells[part]]}, "
              f"{time.perf_counter() - t0:.1f} s host clock with the ranks' "
              f"start-up ({SHARD_NOTE}) {tag}")
        for label, cfg, cell in cells[part]:
            report[label] = _dry_check(part, label, cfg, cell, mp, recs, dev,
                                       tag)
            if "seq" in recs[0][label]:
                report[label]["seq"] = _dry_seq_check(label, mp, recs, tag)
        del recs
        torch.cuda.empty_cache()
    report["cli"] = _dry_cli(tag)
    report["k5_launches"] = {"stablelm_dp1xmp16":
                             report["stablelm_prefill"]["k5_launches"][0],
                             "whisper_dp1xmp8":
                             report["whisper_prefill"]["k5_launches"][0],
                             "xlstm_dp1xmp8":
                             report["xlstm_prefill"]["k5_launches"][0]}
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"{name} phase: {report['phase_s']:.1f} s host clock {tag}")
    return report


def main(json_path: str = "") -> int:
    t_start = time.perf_counter()
    sys.stdout.reconfigure(line_buffering=True)   # a cut run keeps its log
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 3
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    # Every phase reads a fresh, empty tile cache (phase 12 fills its
    # own): a cache left on the machine never steers a plan or a gate.
    import shutil
    import tempfile
    plans_dir = tempfile.mkdtemp(prefix="chip_smoke_plans_")
    try:
        with _plan_cache(os.path.join(plans_dir, "sd_plans.json")):
            return _smoke(json_path, t_start)
    finally:
        shutil.rmtree(plans_dir, ignore_errors=True)


def _smoke(json_path: str, t_start: float) -> int:
    """Phases 1-20 (see the module doc) and the final two lines."""
    import torch
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch.nn.functional as F
    import repro_torch.kernels.sd_conv as K
    from repro_torch import sd
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.accounting import BENCHMARKS
    from repro_torch.core.deconv import conv_valid, same_deconv_pads
    from repro_torch.kernels import ops
    from repro_torch.kernels.autotune import (GemmPlan, gemm_grid,
                                              gemm_smem_bytes)
    from repro_torch.kernels.build import build
    from repro_torch.launch.serve_gen import GenServer, serve_async
    from repro_torch.models.generative import GenerativeModel, build as mk

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = _card_line()
    tag = f"[{card}]"
    print(f"device: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s) visible")

    # ---- 1. build ------------------------------------------------------
    builds = build(SOURCES)
    for name in SOURCES:
        print(f"build: nvcc {name}.cu for sm_90a in "
              f"{builds[name].seconds:.2f} s (host clock, the {len(SOURCES)} "
              f"sources in parallel) {tag}")
        for line in builds[name].ptxas.splitlines():
            if any(k in line for k in ("registers", "smem", "spill",
                                       "Compiling entry")):
                print(f"  ptxas: {line.strip()}")
    built = builds["sd_fused"]
    sass = {}
    for name, label, kern in (("sd_fused", "K1 float", "igemm_kernel"),
                              ("sd_conv", "K2 f32", "igemm_kernel"),
                              ("sd_filter_grad", "K3",
                               "sd_filter_grad_kernel"),
                              ("sd_wino", "K4", "sd_wino_kernel")):
        sass[name] = _sass_counts(builds[name].path, kern)
        print(f"sass: {label} ({sass[name]['functions']} instantiations of "
              f"{kern} in {builds[name].path.name}): "
              f"{sass[name]['HMMA']} HMMA, {sass[name]['HMMA_TF32']} of them "
              f"on TF32 operands (HMMA...TF32) {tag}")
        if not (sass[name]["functions"] and sass[name]["HMMA_TF32"]):
            raise SystemExit(f"chip_smoke: {label} has no TF32 HMMA")
    for name, label in (("sd_fused_int8", "K1 int8"),
                        ("sd_conv_int8", "K2 int8")):
        sass[name] = q = _sass_counts(builds[name].path, "igemm_kernel")
        print(f"sass: {label} ({q['functions']} instantiations of "
              f"igemm_kernel in {builds[name].path.name}): {q['IMMA']} IMMA "
              f"(s8 mma.sync), {q['IDP.4A']} IDP.4A (dp4a) {tag}")
        if not (q["functions"] and q["IMMA"]) or q["IDP.4A"]:
            raise SystemExit(f"chip_smoke: {label} does not run on the s8 "
                             "tensor cores alone (IMMA > 0, IDP.4A = 0)")

    # ---- 2. per-layer check against the plain version ------------------
    gen = torch.Generator().manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def layer_case(l, batch, act, dtype=torch.float32):
        pads = same_deconv_pads(l.k, l.s)
        x = randn(batch, *l.in_hw, l.cin)
        w = randn(l.k, l.k, l.cin, l.cout,
                  scale=1.0 / (l.k * l.k * l.cin) ** 0.5)
        scale = randn(l.cout, scale=0.1) + 1.0
        bias = randn(l.cout, scale=0.1)
        plan = sd.plan(w.shape, l.s, pads, backend="fused", act=act,
                       device=dev).bind(w.to(dtype), scale.to(dtype), bias)
        return x.to(dtype), plan

    def run_both(x, p):
        pk, pi = p.pk, p.pi
        geo = dict(bias=p.bias, act=p.act,
                   pad=((pi[0], pi[0]), (pi[1], pi[1])),
                   crop=(pk[0] + p.padding[0][0], pk[1] + p.padding[1][0]),
                   out_space=p.out_shape(x.shape[1:3]))
        out = ops.sd_deconv_presplit_fused(
            x, p.ws, p.kernel, p.stride, p.padding,
            output_padding=p.output_padding, bias=p.bias, act=p.act,
            plan=p.tile)
        ref = K.sd_fused_ref(x, p.ws, p.stride, **geo)
        torch.cuda.synchronize()
        return out, ref

    max_err = 0.0
    failures = []
    print(f"check: K1 vs sd_fused_ref, f32, batch 4, gate "
          f"{F32_GATE}*max(1,max|ref|) {tag}")
    for net, fn in BENCHMARKS.items():
        layers = fn().layers
        for i, l in enumerate(layers):
            if l.kind != "deconv":
                continue
            act = "linear" if i == len(layers) - 1 else "relu"
            x, p = layer_case(l, 4, act)
            out, ref = run_both(x, p)
            d, tol = _gate_err(out, ref, F32_GATE, True)
            max_err = max(max_err, d)
            ok = d <= tol and tuple(out.shape) == tuple(ref.shape)
            print(f"  {net}/{l.name} {tuple(x.shape)}->{tuple(out.shape)} "
                  f"max|d| {d:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{net}/{l.name}")
    # output_padding past the shuffled support (op > pad_hi), tanh, and
    # forced GEMM tiles: ragged in M, N and K, split-K with an uneven last
    # split, Cin not a multiple of 4 (4-byte copies), stride 1.
    odd = [((2, 5, 6, 3), (4, 4, 3, 2), 2, 0, 1, None),
           ((2, 5, 6, 3), (4, 4, 3, 2), 2, 1, (1, 0), None),
           ((3, 13, 11, 40), (5, 5, 40, 24), 2, 2, 1,
            GemmPlan(32, 2)),
           ((2, 9, 10, 70), (3, 3, 70, 5), 2, 1, 1,
            GemmPlan(16, 5)),
           ((1, 6, 7, 7), (5, 5, 7, 3), 1, 2, 0, GemmPlan(16, 3))]
    for sx, sw_, st, padv, op, tile in odd:
        x = randn(*sx)
        w = randn(*sw_, scale=0.2)
        bias = randn(sw_[-1], scale=0.1)
        p = sd.plan(w.shape, st, padv, backend="fused", act="tanh",
                    output_padding=op, tile=tile, device=dev).bind(
                        w, bias=bias)
        out, ref = run_both(x, p)
        d, tol = _gate_err(out, ref, F32_GATE, True)
        max_err = max(max_err, d)
        ok = d <= tol and tuple(out.shape) == tuple(ref.shape)
        print(f"  odd {sx} k{sw_[0]} s{st} p{padv} op{op} tile {tile} "
              f"max|d| {d:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"odd {sx}")
    dcgan_layers = [(i, l) for i, l in enumerate(BENCHMARKS["dcgan"]().layers)
                    if l.kind == "deconv"]
    print(f"check: K1 vs sd_fused_ref, bf16 in/out, f32 accumulation, "
          f"batch 4, gate {BF16_GATE}*max|ref| {tag}")
    for i, l in dcgan_layers:
        act = "linear" if i == 3 else "relu"
        x, p = layer_case(l, 4, act, torch.bfloat16)
        out, ref = run_both(x, p)
        d, tol = _gate_err(out, ref, BF16_GATE, False)
        ok = d <= tol and out.dtype == torch.bfloat16
        print(f"  dcgan/{l.name} bf16 max|d| {d:.3e} tol {tol:.3e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"dcgan/{l.name} bf16")
    # bf16 on forced tiles: Cin and N not multiples of 8 (element copies),
    # split-K with an uneven last split.
    for sx, sw_, st, padv, op, tile in odd[2:4]:
        x = randn(*sx).bfloat16()
        w = randn(*sw_, scale=0.2).bfloat16()
        bias = randn(sw_[-1], scale=0.1)
        p = sd.plan(w.shape, st, padv, backend="fused", act="tanh",
                    output_padding=op, tile=tile, device=dev).bind(
                        w, bias=bias)
        out, ref = run_both(x, p)
        d, tol = _gate_err(out, ref, BF16_GATE, False)
        ok = d <= tol and out.dtype == torch.bfloat16
        print(f"  odd {sx} k{sw_[0]} s{st} p{padv} op{op} bf16 tile {tile} "
              f"max|d| {d:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"odd {sx} bf16")
    if failures:
        raise SystemExit(f"chip_smoke: kernel disagrees with its plain "
                         f"version on {failures}")

    # ---- timing at the serving bucket ----------------------------------
    print(f"time: DCGAN layers at batch {BUCKET}, f32, K1 / plain / library "
          f"in turns (inputs L2-resident): device ms of one call (ahead: "
          f"CUDA events over 20 calls queued behind torch.cuda._sleep; "
          f"profiler: the kernels of one profiled call summed, median of 3) "
          f"and CUDA events over 20 back-to-back calls (median [min, max] "
          f"of 7 rounds; the host's time per call included); bound: the "
          f"useful work at the {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s CUDA "
          f"cores, tc bound: the work the kernel does (its GEMM, three "
          f"products per multiply-add) at the "
          f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32 tensor cores; bf16: "
          f"one product at the {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 "
          f"tensor cores, and beside it at the TF32 rate of the path the "
          f"kernel takes {tag}")
    per_layer = []
    for i, l in dcgan_layers:
        act = "linear" if i == 3 else "relu"
        x, p = layer_case(l, BUCKET, act)
        pi, pk = p.pi, p.pk
        geo = dict(bias=p.bias, act=p.act,
                   pad=((pi[0], pi[0]), (pi[1], pi[1])),
                   crop=(pk[0] + p.padding[0][0], pk[1] + p.padding[1][0]),
                   out_space=p.out_shape(x.shape[1:3]))
        kern = lambda plan=None, x=x, ws=p.ws: (     # noqa: E731
            ops.sd_deconv_presplit_fused(x, ws, p.kernel, p.stride,
                                         p.padding, bias=p.bias, act=p.act,
                                         plan=plan))
        plain = lambda: K.sd_fused_ref(x, p.ws, p.stride, **geo)  # noqa
        # Library yardstick: the same-size transposed conv in one cuDNN
        # call (NCHW, symmetric crop 2 + output_padding 1 -> in*s).
        x_cf = x.permute(0, 3, 1, 2).contiguous()
        w_t = torch.randn(l.cin, l.cout, l.k, l.k, device=dev)
        lib = lambda: F.conv_transpose2d(                 # noqa: E731
            x_cf, w_t, p.bias, stride=l.s, padding=2, output_padding=1)
        assert lib().shape[2:] == kern().shape[1:3]
        g = K.gemm_launch(x.shape, p.ws.shape, p.stride, geo["pad"],
                          geo["crop"], geo["out_space"])
        if not per_layer:
            # Split-K sums its partials in a fixed order: two runs agree.
            plan = g.plan if g.plan.splits > 1 else GemmPlan(64, 3)
            same = torch.equal(kern(plan), kern(plan))
            print(f"  dcgan/{l.name} K1 run twice with {plan}: "
                  f"{'bit-identical' if same else 'DIFFERS'}")
            if not same:
                raise SystemExit("chip_smoke: K1 with split-K is not "
                                 "deterministic")
            (plo_h, phi_h), (plo_w, phi_w) = geo["pad"]
            ref64 = K.shuffle_epilogue(
                conv_valid(F.pad(x.double(), (0, 0, plo_w, phi_w, plo_h,
                                              phi_h)), p.ws.double()),
                p.stride, p.bias.double(), p.act, geo["crop"],
                geo["out_space"], torch.float64)
            scale = max(1.0, ref64.abs().max().item())
            prec = {n: (y_.double() - ref64).abs().max().item() / scale
                    for n, y_ in (("k1", kern()), ("plain", plain()))}
            print(f"  precision: dcgan/{l.name} at batch {BUCKET} against "
                  f"the f64 product: max|d| / max(1, max|ref|) K1 "
                  f"{prec['k1']:.3e}, plain (cuDNN f32, TF32 off) "
                  f"{prec['plain']:.3e} {tag}")
        t = _time_ms({"k1": kern, "plain": plain, "lib": lib})
        dv = {n: _device_ms(f) for n, f in (("k1", kern), ("plain", plain),
                                            ("lib", lib))}
        xb, wb = x.bfloat16(), p.ws.bfloat16()
        dv["bf16"] = _device_ms(lambda: kern(None, xb, wb))
        (ev, ev_lo, ev_hi) = t["k1"]
        ms = dv["k1"][1]
        y = kern()
        flops = 2.0 * BUCKET * l.macs()
        nbytes = sum(t.numel() * t.element_size()
                     for t in (x, p.ws, p.bias, y))
        t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        kernel_flops = 2.0 * g.geom.m * g.geom.n * g.geom.k
        t_tc = max(3 * kernel_flops / PEAK_TF32_FLOPS * 1e3, t_bytes)
        grid = gemm_grid(g.geom, g.plan)
        print(f"  dcgan/{l.name} launch: {g.plan}, GEMM M {g.geom.m} x N "
              f"{g.geom.n} x K {g.geom.k}, grid {grid[0]} x {grid[1]} x "
              f"{grid[2]} blocks of 128 threads"
              f"{', then the ordered split sum' if grid[2] > 1 else ''}, "
              f"{gemm_smem_bytes(g.geom, g.plan)} B dynamic shared memory "
              f"per block")
        rec = {"layer": f"dcgan/{l.name}", "x": list(x.shape),
               "y": list(y.shape), "plan": str(g.plan), "ms": ms,
               "profiler_ms": dv["k1"][0], "events_ms": ev,
               "events_ms_min": ev_lo, "events_ms_max": ev_hi,
               "plain_ms": dv["plain"][1], "plain_events_ms": t["plain"][0],
               "library_ms": dv["lib"][1],
               "library_profiler_ms": dv["lib"][0],
               "library_events_ms": t["lib"][0],
               "bf16_ms": dv["bf16"][1], "bf16_profiler_ms": dv["bf16"][0],
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "tc_bound_ms": t_tc,
               "bf16_tc_bound_ms": max(kernel_flops / PEAK_BF16_FLOPS * 1e3,
                                       t_bytes / 2),
               "bf16_tf32_path_bound_ms": max(
                   kernel_flops / PEAK_TF32_FLOPS * 1e3, t_bytes / 2),
               "flops": flops, "kernel_flops": kernel_flops,
               "bytes": nbytes, "launches_per_batch": 1}
        per_layer.append(rec)
        print(f"  dcgan/{l.name} {tuple(x.shape)}->{tuple(y.shape)}: K1 "
              f"device {ms:.4f} ms (profiler {_ms_txt(dv['k1'][0])}), events "
              f"{ev:.4f} [{ev_lo:.4f}, {ev_hi:.4f}]; plain device "
              f"{rec['plain_ms']:.4f} / events {rec['plain_events_ms']:.4f}; "
              f"conv_transpose2d device {rec['library_ms']:.4f} (profiler "
              f"{_ms_txt(dv['lib'][0])}) / events "
              f"{rec['library_events_ms']:.4f}; K1 bf16 device "
              f"{rec['bf16_ms']:.4f} (profiler {_ms_txt(dv['bf16'][0])}); "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, useful "
              f"{flops / 1e9:.3f} GFLOP), tc bound {t_tc:.4f} ms (3 x "
              f"{kernel_flops / 1e9:.3f} GFLOP; bf16 "
              f"{rec['bf16_tc_bound_ms']:.4f}, on its TF32 path "
              f"{rec['bf16_tf32_path_bound_ms']:.4f}); {flops / ms / 1e9:.1f} "
              f"useful TFLOP/s; sm clock, power, temperature {_clocks()} "
              f"{tag}")
    d1 = per_layer[0]
    gate_ms = d1["profiler_ms"] if d1["profiler_ms"] is not None else d1["ms"]
    ok = gate_ms <= K1_D1_MS_LIMIT
    how = "profiler" if d1["profiler_ms"] is not None else "ahead events"
    print(f"gate: K1 f32 on dcgan/d1 at batch {BUCKET}: {gate_ms:.4f} ms of "
          f"device time ({how}), limit {K1_D1_MS_LIMIT} ms "
          f"{'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit("chip_smoke: K1 on DCGAN d1 is over its time limit")

    # ---- 3. serve full-width DCGAN through the port --------------------
    server = GenServer(nets=("dcgan",), device="cuda", max_batch=BUCKET,
                       seed=SEED)
    built_cells = server.warmup()
    reqs = server.random_requests("dcgan", SERVE_REQUESTS, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.SD_FUSED_LAUNCHES = 0
    results, stats = serve_async(server, reqs)
    torch.cuda.synchronize()
    launches = K.SD_FUSED_LAUNCHES
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    lat = stats["latency_ms"]
    print(f"serve: {stats['served']} DCGAN requests (full width, f32) in "
          f"{stats['wall_s']:.4f} s host clock: {stats['req_per_s']:.1f} "
          f"req/s, p50 {lat['p50']} ms, p95 {lat['p95']} ms, "
          f"{stats['launches']} launches, {stats['compiles']} cells "
          f"({built_cells} built in warmup), peak memory {peak_mib:.1f} "
          f"MiB {tag}")
    print(f"  K1 launches in the serving run: {launches} "
          f"(3 deconv layers x {stats['launches']} batches)")
    if launches != 3 * stats["launches"] or launches == 0:
        raise SystemExit("chip_smoke: serving did not run K1 once per "
                         "deconv layer per batch")
    if stats["served"] != SERVE_REQUESTS or stats["shed"]:
        raise SystemExit(f"chip_smoke: served {stats['served']} of "
                         f"{SERVE_REQUESTS}, shed {stats['shed']}")
    model, params = server.model("dcgan")
    plain_model = GenerativeModel(model.spec, "sd_kernel",
                                  engine_backend="torch", device=dev)
    z = torch.stack([r.latent for r in reqs])
    out = torch.stack([results[r.rid] for r in reqs])
    with torch.no_grad():
        ref = plain_model.apply(params, z)
    d, tol = _gate_err(out, ref, F32_GATE, True)
    finite = bool(torch.isfinite(out).all())
    print(f"  outputs {tuple(out.shape)} finite={finite}; vs torch backend "
          f"on the card max|d| {d:.3e} tol {tol:.3e} {tag}")
    cpu_params = {k: {n: t.cpu() for n, t in v.items()}
                  for k, v in params.items()}
    cpu_ref = GenerativeModel(model.spec, "native", device="cpu").apply(
        cpu_params, z[:2].cpu())
    d_cpu, tol_cpu = _gate_err(out[:2].cpu(), cpu_ref, F32_GATE, True)
    print(f"  vs native F.conv_transpose2d on the CPU (2 requests) "
          f"max|d| {d_cpu:.3e} tol {tol_cpu:.3e}")
    if not (finite and d <= tol and d_cpu <= tol_cpu
            and tuple(out.shape) == (SERVE_REQUESTS, 64, 64, 3)):
        raise SystemExit("chip_smoke: served outputs are wrong")

    # ---- where one full batch's time goes -------------------------------
    full = [r.latent for r in reqs[:BUCKET]]
    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.run_group("dcgan", full)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = sorted(host)[len(host) // 2]
    breakdown = _device_breakdown(lambda: server.run_group("dcgan", full))
    print(f"batch: one DCGAN batch of {BUCKET} through run_group: "
          f"{host_ms:.3f} ms host clock (median of 10, synchronised) "
          f"{tag}")
    if breakdown is None:
        print("  device time per kernel: not measured (the profiler "
              "reported no device time)")
    else:
        busy, wall, top = breakdown
        print(f"  profiler: device busy {busy:.3f} ms of {wall:.3f} ms wall "
              f"(idle share {1 - busy / wall:.3f}) {tag}")
        for name, ms_k, calls in top:
            print(f"    {ms_k:.4f} ms in {calls} call(s): {name[:90]}")

    # ---- 4. the six paper networks through K1 --------------------------
    print(f"nets: each paper network once at batch 1, K1 vs torch backend "
          f"{tag}")
    for net in BENCHMARKS:
        m = mk(net, "sd_kernel", engine_backend="fused", device=dev)
        params = m.init(torch.Generator().manual_seed(SEED))
        np_params = {k: {n: t.cpu().numpy() for n, t in v.items()}
                     for k, v in params.items()}
        params = params_from_numpy(np_params, dev, spec=m.spec)
        x = torch.randn(m.input_shape(1), generator=gen).to(dev)
        ref_m = mk(net, "sd_kernel", engine_backend="torch", device=dev)
        K.SD_FUSED_LAUNCHES = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            y = m.apply(params, x)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        n = K.SD_FUSED_LAUNCHES
        with torch.no_grad():
            r = ref_m.apply(params, x)
        d, tol = _gate_err(y, r, F32_GATE, True)
        ndc = len(m.spec.deconv_layers())
        ok = (d <= tol and n == ndc and bool(torch.isfinite(y).all()))
        print(f"  {net}: out {tuple(y.shape)} K1 launches {n}/{ndc} "
              f"max|d| {d:.3e} tol {tol:.3e} first-call {dt:.2f} ms host "
              f"clock {'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"chip_smoke: {net} failed")

    # ---- 5. train full-width DCGAN through K1, K2 and K3 ----------------
    train = _train_phase(dev, tag, randn)

    # ---- 6. serve full-width DCGAN through K4 (Winograd) ----------------
    wino = _wino_phase(dev, tag, randn)

    # ---- 7. serve int8 DCGAN through K1's int8 branch --------------------
    int8 = _int8_phase(dev, tag, randn)

    # ---- 8. serve VoxGAN (3-D) through K2 and K2's int8 pair -------------
    nd = _nd_phase(dev, tag, randn)

    # ---- 9. serve calibrated, chained int8 DCGAN and VoxGAN --------------
    chain = _chain_phase(dev, tag, randn)

    # ---- 10. K5 and StableLM-2-12B serving with long prompts -------------
    torch.cuda.empty_cache()
    lm = _lm_phase(dev, tag)

    # ---- 11. WaveGAN (rank 1) through H=1 launches of K1, K1 int8, K4,
    # and its K2 + K3 backward ------------------------------------------
    torch.cuda.empty_cache()
    wave = _wavegan_phase(dev, tag, randn)

    # ---- 12. measured tiles and the per-layer algorithm -----------------
    pre = _pretune_phase(dev, tag)

    # ---- 13. the executor registry: every registered impl ---------------
    torch.cuda.empty_cache()
    reg = _registry_phase(dev, tag)

    # ---- 14. scale-out: Cout-sharded and data-parallel DCGAN ----------
    torch.cuda.empty_cache()
    scale = _scaleout_phase(dev, tag)

    # ---- 15. checkpoints and dense-LM training ---------------------------
    torch.cuda.empty_cache()
    ckpt = _ckpt_phase(dev, tag)

    # ---- 16. MoE decoders: DBRX-132B (K5 in its prefill) and Mixtral-8x7B
    torch.cuda.empty_cache()
    moe = _moe_phase(dev, tag)

    # ---- 17. recurrent mixers: xLSTM-350M, Jamba-1.5-Large (K5 in its
    # attention slot)
    torch.cuda.empty_cache()
    hyb = _hybrid_phase(dev, tag)

    # ---- 18. the LM frontends: InternVL2-76B (K5 in its prefill) and
    # Whisper-small; Qwen1.5-32B, InternLM2-20B and Yi-34B (K5 in theirs)
    torch.cuda.empty_cache()
    front = _frontends_phase(dev, tag)

    # ---- 19. the LM half of sharding: StableLM-2-12B, DBRX-132B and
    # Mixtral-8x7B tensor-, data- and expert-parallel on gloo ranks (K5 on
    # each rank's heads), one sharded train step
    torch.cuda.empty_cache()
    shard = _lm_sharding_phase(dev, tag)

    # ---- 20. the sharded recurrent slots and frontends: Jamba-1.5-Large,
    # xLSTM-350M, InternVL2-76B and Whisper-small on gloo ranks (K5 on each
    # rank's heads in Jamba's and InternVL2's prefills), two train steps
    torch.cuda.empty_cache()
    rec = _lm_sharding_recurrent_phase(dev, tag)

    # ---- 21. the dry-run: StableLM-2-12B on 16 gloo ranks (2 q / 1 kv
    # heads each, K5 on them), Whisper-small and xLSTM-350M on 8, each
    # step predicted by its trace on the meta device; two cells of
    # python -m repro_torch.launch.dryrun
    torch.cuda.empty_cache()
    dry = _dryrun_phase(dev, tag)

    if "jax" in sys.modules or "repro" in sys.modules:
        raise SystemExit("chip_smoke: JAX or the JAX package was imported")
    total = {k: sum(r[k] for r in per_layer)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                       "flops", "bytes")}
    bound_by = ("operations" if total["flops"] / PEAK_F32_FLOPS
                >= total["bytes"] / PEAK_BYTES else "bytes")
    kernels = [{
        "name": "sd_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sd_fused.cu",
        "replaces": "src/repro/kernels/sd_conv.py:352",
        "launches": train["k1_launches"], "launches_serve": launches,
        "max_abs_err": max_err,
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"], "bound_by": bound_by,
        "library_ms": total["library_ms"],
        "events_ms": sum(r["events_ms"] for r in per_layer),
        "tc_bound_ms": sum(r["tc_bound_ms"] for r in per_layer),
        "sass_hmma_tf32": sass["sd_fused"]["HMMA_TF32"]}] + \
        train["kernels"] + \
        [wino["kernel"], int8["kernel"], nd["kernel"], lm["kernel"]]
    for k in kernels:
        # phase 11: WaveGAN's launches and per-layer device ms (up1 / up2
        # / to_audio; K4's on k17/s4 at those widths)
        name = k["name"]
        if name in wave["ms"]:
            k["wavegan_ms"] = wave["ms"][name]
        if name == "sd_fused_int8":
            k["launches_wavegan_dynamic"] = wave["launches"][name]
            k["launches_wavegan_calibrated"] = wave["launches"][
                "sd_fused_int8_calibrated"]
        elif name == "sd_wino":
            k["launches_wavegan_dryrun"] = wave["launches"][name]
        elif name in wave["launches"]:
            k["launches_wavegan"] = wave["launches"][name]
        if name == "sd_fused":
            k["wavegan_max_abs_err"] = wave["k1_max_abs_err"]
        if name in ("sd_conv", "sd_filter_grad"):
            k["wavegan_max_abs_err"] = wave["backward_max_abs_err"]
        if name in pre["launches"]:
            # phase 12: the pretuned f32 server's 48-request run
            k["launches_pretuned"] = pre["launches"][name]
        if name == "sd_fused_int8":
            k["launches_pretuned_calibrated"] = pre["int8"]["launches"]
        if name in pre["switch"]["launches"]:
            # phase 12 (f): the switched server's 48-request run
            k["launches_switched"] = pre["switch"]["launches"][name]
        if name in ("sd_conv", "sd_filter_grad"):
            k["launches_switched_train"] = pre["switch"]["train_launches"][
                "K2" if name == "sd_conv" else "K3"]
        if name in REGISTRY_KERNELS:
            # phase 13 (a)-(d): the self-checks, every impl at full width
            # and sd_fn's J_G^T c
            k["launches_registry"] = reg["launches"][REGISTRY_KERNELS[name]]
        if name in SCALE_KERNELS:
            # phase 14: rank 0's launches over the sharded runs
            k["launches_sharded"] = scale["launches"].get(
                SCALE_KERNELS[name], 0)
        if name in CKPT_KERNELS:
            # phase 15 (a): train_gen.main's 6 checkpointed GAN steps
            k["launches_checkpoint_train"] = ckpt["gan"]["launches"][name]
        if k["name"] in ("sd_conv", "sd_filter_grad", "sd_wino"):
            k["sass_hmma_tf32"] = sass[k["name"]]["HMMA_TF32"]
        if k["name"] == "sd_conv":
            k["launches_serve_3d"] = nd["k2_launches_serve_3d"]
        if name == "flash_attn":
            # phase 16 (c): the DBRX serving run, and (b)'s timing at
            # DBRX's prefill shape
            k["launches_moe"] = moe["dbrx"]["k5_launches"]
            # phase 17 (d): Jamba's serving run and K5 at its prefill
            # shape; phase 17 (b): xLSTM's serving run, which has none
            k["launches_hybrid"] = hyb["jamba"]["k5_launches"]
            k["launches_xlstm"] = hyb["xlstm_serve"]["k5_launches"]
            # phase 18: InternVL2's serving run (a), Whisper's (b), the
            # three dense decoders' (e); K5 at InternVL2's prefill shape
            # (d) and at Qwen's and Yi's (e)
            k["launches_frontends"] = front["internvl2"]["k5_launches"]
            k["launches_whisper"] = front["whisper"]["k5_launches"]
            k["launches_dense"] = {n: r["k5_launches"]
                                   for n, r in front["dense"].items()}
            # K5 timed at each prefill shape: device ms and ahead ms
            # phase 19: each rank's K5 launches in the sharded prefills
            # ((a) on dp1 x mp2 and dp2 x mp2, (b)), and K5 at the
            # per-rank shapes of StableLM and DBRX at mp 2
            k["launches_lm_sharding"] = shard["k5_launches"]
            # phase 20: each rank's K5 launches in the sharded prefills of
            # Jamba and InternVL2 (xLSTM and Whisper have none), and K5 at
            # Jamba's per-rank shape at mp 2
            k["launches_lm_sharding_recurrent"] = rec["k5_launches"]
            # phase 21: each rank's K5 launches in the dry-run's live
            # prefills (StableLM at mp 16; Whisper and xLSTM have none),
            # and K5 at StableLM's per-rank shape at mp 16
            k["launches_dryrun"] = dry["k5_launches"]
            for shape, r in (("moe", moe["k5"]),
                             ("hybrid", hyb["jamba"]["k5"]),
                             ("internvl2", front["k5"]),
                             ("qwen", front["dense"]["qwen1.5-32b"]["k5"]),
                             ("yi", front["dense"]["yi-34b"]["k5"]),
                             ("stablelm_mp2", shard["k5"]["stablelm_mp2"]),
                             ("dbrx_mp2", shard["k5"]["dbrx_mp2"]),
                             ("jamba_mp2", rec["k5"]),
                             ("stablelm_mp16", dry["k5"])):
                k[f"ms_{shape}_shape"] = r["ms"]
                k[f"ahead_ms_{shape}_shape"] = r["ahead_ms"]
                k[f"max_abs_err_{shape}_shape"] = r["max_abs"]
                k[f"plain_ms_{shape}_shape"] = r["plain_ms"]
                k[f"library_ms_{shape}_shape"] = r["sdpa_ms"]
                k[f"library_ahead_ms_{shape}_shape"] = r["sdpa_ahead_ms"]
                k[f"bound_ms_{shape}_shape"] = r["bound_ms"]
        if k["name"] in ("sd_fused_int8", "sd_conv_int8"):
            k["sass_imma"] = sass[k["name"]]["IMMA"]
            k["sass_idp4a"] = sass[k["name"]]["IDP.4A"]
        if k["name"] == "sd_fused_int8":
            # complete since the calibrated half: the main numbers are
            # phase 9's (static row, int8 out), phase 7's launches beside
            k.update(chain["record"], launches_dynamic=k["launches"],
                     complete=True,
                     max_abs_err=max(k["max_abs_err"],
                                     chain["record"]["max_abs_err"]))
    report = {"card": card, "kernels": kernels,
              "per_layer": per_layer + train["per_layer"],
              "train": train["train"],
              "backward_precision_d1": train["precision_d1"],
              "winograd": {k: wino[k] for k in ("per_layer", "serve",
                                                "peak_mib", "batch_host_ms",
                                                "batch_device",
                                                "precision_d1")},
              "int8": {k: v for k, v in int8.items() if k != "kernel"},
              "nd": {k: v for k, v in nd.items() if k != "kernel"},
              "chain": {k: v for k, v in chain.items() if k != "record"},
              "lm": lm["report"], "wavegan": wave["report"],
              "pretune": pre, "registry": reg, "scaleout": scale,
              "checkpoint": ckpt, "moe": moe, "hybrid": hyb,
              "frontends": front, "lm_sharding": shard,
              "lm_sharding_recurrent": rec, "dryrun": dry,
              "serve": {k: stats[k] for k in
                        ("served", "launches", "req_per_s", "wall_s",
                         "latency_ms")},
              "peak_mib": peak_mib,
              "nvcc_s": {n: builds[n].seconds for n in SOURCES},
              "batch_host_ms": host_ms, "batch_device": breakdown,
              "ptxas": {n: builds[n].ptxas for n in SOURCES}}
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)),
                    exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(report, f, indent=1)
    elapsed = time.perf_counter() - t_start
    print(f"total {elapsed:.1f} s host clock (limit {TIME_LIMIT_S} s) {tag}")
    print("(below: ms/plain_ms/bound_ms/library_ms summed over DCGAN's "
          f"three deconv layers at batch {BUCKET} (K1's, K2's, K3's and K4's "
          f"ms, plain_ms and library_ms are device time, ahead events, their "
          f"events over back-to-back calls as events_ms; tc_bound_ms their "
          f"3xTF32 work at the TF32 tensor cores); launches counted in the "
          f"{GAN_STEPS}-step training run, K1's serving-run count as "
          f"launches_serve; K4's in the winograd serving run; K1 int8's "
          f"launches and ms/plain_ms/bound_ms from phase 9 (the calibrated "
          f"serving run; the static-row launches summed over DCGAN's three "
          f"layers, ms and plain_ms device time by ahead events as for "
          f"K1-K4, int_mm_ms torch._int_mm on the same GEMM operands), "
          f"phase 7's dynamic serving run as launches_dynamic, the dynamic "
          f"launch's device ms in the same rounds as "
          f"ms_dynamic_same_rounds; K2's f32 VoxGAN "
          f"serving run as "
          f"launches_serve_3d; K2 int8's ms/plain_ms/bound_ms summed over "
          f"VoxGAN's three tap convs at batch {BUCKET} (device time by ahead "
          f"events, int_mm_ms torch._int_mm on the same GEMM operands), its "
          f"launches in the int8 VoxGAN serving run; K5's ms/plain_ms/library_ms are device "
          f"time at the serving shape {LM_K5_SHAPE} (B, H, Hkv, S, D) in "
          f"bf16 (CUDA events where the profiler reports none), ms_f32 the "
          f"f32 kernel's on the same inputs, bound_ms at the useful work, "
          f"bound_split_ms at the bf16 kernel's split P, bound_f32_ms and "
          f"bound_f32_tc_ms the f32 kernel's on the CUDA cores and in "
          f"3xTF32, its launches in phase 10's serving run; phase 11, "
          f"WaveGAN: launches_wavegan* counted in its f32 / dynamic / "
          f"calibrated serving runs (K1, K1 int8), its J_G^T c run (K2, K3) "
          f"and the winograd dryrun (K4), wavegan_ms the device ms (ahead "
          f"events) per layer up1 / up2 / to_audio at batch {BUCKET}, K4's "
          f"on k17/s4 at those widths; phase 12: launches_pretuned counted "
          f"in the pretuned f32 server's serving run (K1, K4), "
          f"launches_pretuned_calibrated in the pretuned calibrated int8 "
          f"server's (K1 int8), launches_switched in the serving run of the "
          f"server whose cache binds layers to K4 (K1, K4) and "
          f"launches_switched_train in its J_G^T c (K2, K3); phase 13: "
          f"launches_registry counted over its self-checks, every impl at "
          f"full width and sd_fn's J_G^T c (K1, K1 int8, K2, K3, K4); phase "
          f"14: launches_sharded counted on rank 0 over its sharded runs, "
          f"gloo ranks on one card (K1, K1 int8, K2, K2 int8, K3, K4); "
          f"phase 15: launches_checkpoint_train counted over train_gen.main's"
          f" {CKPT_GAN_STEPS} checkpointed GAN steps (K1, K2, K3); phase 16: "
          f"K5's launches_moe counted in DBRX-132B's serving run, "
          f"ms_moe_shape, max_abs_err_moe_shape (bf16), plain_ms_moe_shape, "
          f"library_ms_moe_shape (SDPA) and bound_ms_moe_shape at its prefill"
          f" shape {MOE_K5_SHAPE}; phase 17: K5's launches_hybrid counted in "
          f"Jamba-1.5-Large's serving run (first {HYB_JAMBA_LAYERS} layers), "
          f"launches_xlstm in xLSTM-350M's, the *_hybrid_shape numbers as "
          f"the *_moe_shape ones at Jamba's prefill shape {HYB_K5_SHAPE}; "
          f"phase 18: K5's launches_frontends counted in InternVL2-76B's "
          f"serving run (first {FRONT_VLM_LAYERS} layers, step API), "
          f"launches_whisper in Whisper-small's, launches_dense in each "
          f"dense decoder's (first {DENSE_LAYERS} layers), the "
          f"*_internvl2_shape / *_qwen_shape / *_yi_shape numbers as the "
          f"*_moe_shape ones at {FRONT_K5_SHAPE} / "
          f"{DENSE_K5_SHAPES['qwen1.5-32b']} / {DENSE_K5_SHAPES['yi-34b']}, "
          f"ahead_ms and library_ahead_ms by kernels.timing.ahead_ms in "
          f"turns, at every shape; phase 19: K5's launches_lm_sharding per "
          f"rank in the sharded prefills, the *_stablelm_mp2_shape / "
          f"*_dbrx_mp2_shape numbers at the per-rank shapes "
          f"{SHARD_K5_SHAPES['stablelm_mp2']} / "
          f"{SHARD_K5_SHAPES['dbrx_mp2']}; phase 20: K5's "
          f"launches_lm_sharding_recurrent per rank in the sharded prefills "
          f"of Jamba, InternVL2, xLSTM and Whisper, the *_jamba_mp2_shape "
          f"numbers at Jamba's per-rank shape {REC_K5_SHAPE}) {tag}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default="", metavar="PATH",
                    help="also write the full report (per-layer times, "
                         "serving stats, ptxas output) to PATH")
    sys.exit(main(ap.parse_args().json))
