#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run (non-zero exit, no result line):

1. environment: CUDA must be available; prints the torch, CUDA and nvcc
   versions, whether ``triton`` imports, and the card's name and power
   limit;
2. build: compiles every ``paddle_tpu_torch/csrc/*.cu`` with nvcc (one
   process per source, in parallel) into ``build/paddle_tpu_torch/``;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card at its path's shapes (bf16 out: max abs <= 2e-2; paged m, l
   and flash lse: |diff| <= 1e-3 * max(|ref|, 1); flash backward dq, dk,
   dv: max |diff| <= 2e-2 * max |ref|; fused AdamW p, m, v: max |diff| <=
   1e-6 * max(|ref|, 1) with GradScaler's found-inf flag at 0 and with no
   flag, and bit for bit unchanged with the flag at 1, each timed; int8 / int4 weight-only GEMMs: max |diff| <=
   1e-2 * max |plain|, the bf16 output's rounding, at Llama-3-8B's four
   products for m = 8, 32, 64 and 256 (each timed) and at the kernels'
   edges (m from 1 to 256 around every 8-row tile and the decode / wgmma
   boundary at K = 14336, N = 384, where the decode grid takes stream-K
   shares that do not divide a tile's steps; one column tile at the
   smallest K; f32 out), ffn2 twice bitwise equal, with each kernel's
   ptxas line and local-memory accesses; the paged decode on bf16 and on
   int8 pages at the serving path's shapes and at its edges (groups of 1, 2
   and 8 query heads, d = 64, one row of 2048 tokens, a batch with no
   token, 64 rows; empty rows exactly out 0, m -1e30, l 0), twice at the
   path's shape (bitwise equal), split by kernel, with its ptxas line and
   its wrapper's host µs a call; the grouped GEMMs of the MoE layer, gmm
   in both orientations with and without bias, tgmm and the fused gate +
   up + swiglu with its residuals: max |diff| <= 1e-2 * max |plain| at M =
   32768 routed rows for a router draw and a skewed set with an empty
   group, an 8192-row group and trash rows, whose output rows and
   empty-group dW must be exact zeros, and all three at their tiles'
   edges (M = 8200 in groups of 1, 127, 129, 0, 4095, 63, 65 and 1000
   rows, at the layer's widths and at K = 1000, N = 520; NaN and inf in
   the trash rows of lhs and dout; tgmm and the swiglu twice, bitwise
   equal; the swiglu with and without its residuals, the same y bit for
   bit), the swiglu split by kernel with its host µs a call, with the
   ptxas line of each wgmma kernel (the grouped GEMMs' and the flash
   forward, dK/dV and dQ kernels', with their local-memory accesses in the
   built code); the flash forward and backward also at their wgmma tiles'
   edges (b = 2, sq = 200, sk = 333; q_offset = 37 with kv_len = 300; GQA
   32/8 and 16/4 at d = 64, causal and non-causal), the backward twice at
   the training shape (bitwise equal), and each timed flash shape's ratio
   to SDPA and its wrapper's host µs per call; at decode shapes, 1-8
   query rows against a cache whose columns past kv_len are zeros
   (Llama-3-8B b 4, sq 1, sk 544, kv_len 513 and 543, GQA 32/8, d 128;
   llama-350m b 8, sq 1-8, sk 256, 16/16 heads, d 64), each timed beside
   SDPA given ``k[:, :kv_len]``; the flash forward (out,
   lse) and backward (dq, dk, dv) with an additive f32 mask [b, 1, S, S]
   (finite biases, -inf blocks, rows that see nothing), a bool mask [b, S,
   S] and packed segment ids (3-6 segments a row), causal, at b2 S2048
   32/32 d128 and b2 S1000 GQA 16/4 d64, with the unmasked tolerances and
   exact zeros (out, dq) and the empty lse on rows that see nothing, each
   timed beside the unmasked kernels and SDPA given the same mask, its
   bound counting the pairs it lets through and the mask read once, and
   the host µs of a call through the ``paddle_tpu_torch::flash_fwd``
   operator; the flash forward (out, lse) and backward at ViT-L16's
   attention (b 64, 197 tokens, 16 heads of 64, non-causal), each timed
   beside its bound and SDPA's; the flash forward (out, lse) and backward
   at the UNet's attention (bench_unet's batch 32: level 1 self-attention
   at 256 tokens and cross-attention at 256 x 77, 12 heads of 32; level 2
   at 64 and 64 x 77, heads of 64) and ViT-H14's (b 32, 257 tokens, 16
   heads of 80), each timed beside its bound and SDPA's (the backward run
   twice, bitwise equal), and at the head-dim kernels' edges at d 16, 32
   and 80 (sq 200 / sk 333 with GQA 16/4, causal and non-causal with
   kv_len 300, q_offset 37; sk 1, whose dq and dk are 0 exactly and are
   held against max |dv|; sq 1 / sk 77; rows that see nothing) and at d
   48, 96, 112 (sq 100 / sk 77, GQA 8/2), with the head-dim kernels'
   ptxas lines, local-memory accesses and shared memory; the selective scan's
   forward (y and the chunk states) and backward (du, ddelta, dA, dB, dC)
   at b16 l1024 d1536 n16 and at the chunk-parallel backward's edges
   (lengths 1, 63, 64, 65, 150 and 1001, d = 100 and 200, n = 5, a strong
   decay, each in f32 and bf16), the log-depth scan's forward (y, the
   state entering each span) and backward kernels at the same shape
   (span 64) and at its spans' edges (spans 8, 16, 32 and 64; lengths 1,
   65, 100, 150 and 1001; d = 72, 100 and 200; a strong decay; B . C
   cancelling at span 32), each in f32 and bf16, timed beside the
   sequential kernels, the WKV
   forward (y) and backward (dr, dk, dv, dlogw, du) at b16 l1024 h12 d64
   with the model's decay ramp and at the chunk-parallel kernels' edges
   (lengths 1, 15, 16, 17, 63, 64, 65, 150 and 1001, d = 64 and 128, 1, 3
   and 13 heads, a strong decay, logw = -1e10 (w = 0), and logw >= 0 on
   three channels, whose dlogw must be exactly 0, each in f32 and bf16),
   and the SSD forward (y, the chunk states) and backward
   (dx, ddt, dA, dB, dC, dD) at b8 l1024 h24 dh64 ds64 with x, B and C
   strided as the model's and at its edges (lengths 1, 63, 64, 65, 150
   and 1001, 3, 4, 7 and 13 heads, every dh, ds in {64, 128}, a strong
   decay, a_t = 0, in bf16); every output finite, each within 1e-4 of max
   |plain| in f32 I/O and 1e-2 in bf16 I/O, all computing in f32, the
   three backwards and the SSD and WKV forwards twice at the path's shape
   (bitwise equal; the scan forward too, y and the chunk states), the scan
   forward's and the chunk-parallel kernels' ptxas lines and local-memory
   accesses, their ms split by kernel (``torch.profiler``), the host µs a
   call of the scan, WKV and SSD forward and WKV backward wrappers, and, for the scan,
   the special-function unit's floor for its exponentials beside the
   bound), with its time, its bound (H100
   SXM: 3.35 TB/s HBM, 989 TFLOP/s bf16 dense; the scan 67 TFLOP/s f32
   non-tensor, its decay is elementwise), the plain version's time
   and a library yardstick (``scaled_dot_product_attention`` forward or
   backward, ``torch.optim.AdamW(fused=True)``, a bf16 ``torch.matmul`` of
   the same shape, ``torch._grouped_mm``; timed here only, never called by
   the port), and the host ms of one decode step's 128 weight-only wrapper
   calls;
4. serving: Llama-3-8B at full width and depth (random weights from a
   seeded generator, drawn on the card) behind
   ``ServingEngine(max_seq_len=2048)`` serves 8 requests of 32 new tokens;
   checks the tokens, the kernels' launch counts (L x prefill chunks, L x
   decode steps), a clean drain, and teacher-forced agreement with the
   dense forward;
5. where a decode step's time goes (host clock, ``torch.profiler``);
5b. quantized serving: the same requests through two engines, one at a
   time: A (``quantize="int8"``, ``kv_cache_dtype="int8"``) and B
   (``quantize="int4"``); checks the tokens, the launch counts (int8 paged
   = L x decode steps and no bf16 paged launch in A, the reverse in B;
   weight-only GEMMs = 4 L x (decode steps + prefill chunks of bucket <=
   256); flash = L x prefill chunks), a clean drain, and first-token
   logits and teacher-forced agreement against the dense forward over the
   run's dequantized weights, ties within the bf16 noise (run A: or within
   the int8 pool's own first-token logit change against a bf16 pool, which
   must stay <= 1.0); profiles a decode step of each (one weight-only
   kernel a product at most, none of a second pass);
5c. decode steps of bf16, int8 and int4 engines (bf16 pools) over one
   model, alternated round by round: host ms per step, paired;
5d. the shared-prefix cache: 8 prompts of a 1024-token prefix (64 blocks)
   and seeded tails of 33-480 tokens, 32 new tokens each, the first alone,
   then the other 7, through an engine with the prefix cache and one
   without, on a bf16 and on an int8 pool; checks the hits (7 x 64 blocks,
   7 x 1024 tokens saved), that only the first request's first chunk ran
   at offset 0 and the hits prefilled their tails only, the launch counts
   (flash = L x prefill chunks, paged = L x decode steps on the pool's page
   type), a clean drain with the cached blocks, and the streams against
   the cache-off engine's: equal, or equal up to a first divergence that
   the dense forward calls a tie, and each stream's teacher-forced
   agreement with the dense forward (phase 4's rule; the int8 pool's
   noise from 5b widens the tie window there, as in 5b); prints the hit
   requests' TTFT with the cache on and off;
5e. speculative decoding, k = 4: phase 4's 8 prompts through a Llama-3-8B
   verifier with an independent drafter of 2 layers (seed + 1; run A,
   bf16 and int8 pools) and drafting with itself (run B), each against
   plain decoding on the same settings; checks the tokens (as 5d), the
   launch counts (paged = L_v x verify steps + L_d x draft steps, draft
   steps = (k + 1) x verify steps; flash = (L_v + L_d) x prefill chunks),
   a clean drain and run B's acceptance >= 0.5; prints the acceptance,
   the tokens committed per verify step and the decode ms per token
   against plain decoding;
5f. a fleet: ``Fleet(model, ServingConfig(max_seq_len=2048), replicas=2,
   router="affinity")`` of Llama-3-8B on one card, the replicas reading
   one stack of fused weights (card memory after each; the second may add
   less than 4 GiB); 16 prompts in two groups of 8, each group on its own
   seeded 1024-token prefix with tails of 33-480 tokens, 32 new tokens
   each, A0 and B0 alone, then the other 14: each group on the replica
   holding its prefix (>= 14 affinity hits); after 3 fleet steps, with
   in-flight and queued work on both, ``fleet.replica_die`` kills group
   B's replica: one failover, rerouted + transferred == its live requests,
   a ``replica_die`` postmortem with ring records, all 16 finished, the
   survivor drained clean; launches over both replicas (flash = L x
   prefill chunks, recomputes included; paged = L x decode steps); the
   registry's TTFT / TPOT / step p50 and p99 per replica, ``/metrics`` and
   ``/healthz`` of ``metrics.serve()`` over loopback, the requests' Chrome
   trace under ``build/``; the card's memory back within 64 MiB once the
   fleet is dropped; the streams against one engine's (as 5d); then two
   engines on one stack alternate rounds of decode steps with telemetry
   on and off: host ms a step both ways, the 8 streams identical;
5g. decoding: (a) Llama-3-8B at full width and depth, 4 prompts of 512
   seeded tokens, 32 new tokens, greedy, through ``generate`` (layer by
   layer over the model's KV cache: the flash forward at sq = 1 a decode
   step), ``fused_generate`` dense and paged, and a ``ServingDecoder``
   stepped by hand (a prefill span, then 31 steps); checks the launch
   counts exactly (flash 32 x 32 / 32 / 32 / 32, paged 0 / 0 / 32 x 31 /
   0, no weight-only GEMM), the ``ServingDecoder``'s tokens bit for bit
   those of ``fused_generate``, and every first divergence of ``generate``
   and the paged route from the dense fused route a tie within phase 4's
   noise (as 5d); prints each decoder's host ms a token, peak memory and
   a decode step's host ms, device busy ms, idle share and device ms by
   group under ``torch.profiler`` (the difference between 9 new tokens
   and 1, over 8); (b) ``bench.py:503-590``'s bench_decode on llama-350m
   (24 layers, bf16, batch 8, prompt 128): ``fused_generate`` in bf16,
   int8, int4 and bf16 paged, the launch counts of a 128-token run
   exactly (weight-only 4 x 24 x 127, paged 24 x 127, flash 24), the
   per-token slope (t(128) - t(32)) / 96 as the median of 3 pairs with the
   variants interleaved in each round, tokens/s = 8 / slope, the paged
   streams against the dense ones (ties within this model's bf16 noise),
   and a ``ServingDecoder(paged=True, quantize="int8")`` stepped over the
   pages of an int8 dense decoder's prefill, bit for bit
   ``fused_generate(paged=True, quantize="int8")``; the card's memory back
   within 64 MiB of before the phase;
6. training: the Llama-2-7B widths (``bench.py``'s 7B proxy: vocab 32000,
   hidden 4096, intermediate 11008, 32 heads, bf16, fused loss) at 4
   layers, batch 2 x 2048 seeded tokens, 10 ``TrainStep`` steps with AdamW
   (lr 3e-4, weight decay 0.1, bf16 moments) and clip 1.0; checks finite,
   falling losses and L flash forward + L flash backward launches per
   step; times the step at 4 and 2 layers and profiles one;
6b. the 7B proxy at its 32 layers, as ``bench.py:132-140`` trains it
   (``recompute=True, recompute_policy="save_dots"``), batch 2 x 2048, 6
   ``TrainStep`` steps (AdamW lr 3e-4, weight decay 0.1, bf16 moments,
   clip 1.0); checks falling losses, 32 x steps flash forward and flash
   backward launches (``save_dots`` keeps flash's out and lse) and no
   plain-route flash call; prints the peak memory, the step host ms, tokens/s
   and the model-FLOP share at 32 layers, and profiles a step;
6c. the ``full`` policy at 4 layers: the first step's loss bit for bit and
   its gradient global norm within 1e-3 of a model without recompute from
   the same seed, then 4 steps of each policy (none, ``full``,
   ``save_dots``) with their launch counts (``full``: 2 L x steps flash
   forward launches), peak memory and step host ms;
6d. packed sequences at the 7B widths, 4 layers: 3-6 segments of random
   lengths a row, positions restarting per segment, the label of each
   segment's first token ignored, 6 steps; checks falling losses, L x steps
   flash launches each way, and one packed row's logits against each of
   its segments run alone (relative L2 <= 0.1);
6e. ``bench.py:325-342``'s long context: 24 layers, hidden 1024, 8 heads of
   128, b1 x 16384, ``save_dots``, 3 steps; checks finite losses and the
   flash launch counts, prints the step host ms and the peak memory;
7. eager: the same model rebuilt, 5 steps of ``loss.backward();
   FusedAdamW.step()``; checks falling losses and one fused AdamW launch
   per step;
8. MoE training: ``bench.py``'s MoE-Llama (vocab 32000, hidden 1024,
   intermediate 2816, 12 layers, 8 heads, 8 experts top-2 every 2nd
   layer, capacity factor 2.0, bf16, fused loss) at full width and depth,
   batch 8 x 2048 seeded tokens, 10 ``TrainStep`` steps with AdamW (lr
   3e-4, bf16 moments) and clip 1.0; checks finite, falling losses, a
   fresh-batch loss above ln(vocab) / 2, and per step 6 fused swiglu, 18
   gmm and 12 tgmm launches, 12 flash forward and 12 flash backward, no
   fused AdamW or paged launch; prints the experts' loads, the step time,
   tokens/s, the model-FLOP share, peak memory and a profiled step;
9. Mamba training: ``bench.py``'s Mamba-130m (vocab 32000, hidden 768, 24
   layers, state 16, conv 4, expand 2, dt_rank 48, scan chunk 64, bf16) at
   full width and depth, batch 16 x 1024 seeded tokens, 10 ``TrainStep``
   steps with AdamW (lr 3e-4, bf16 moments) and clip 1.0; checks finite,
   falling losses, a fresh-batch loss above ln(vocab) / 2 and per step 24
   scan forward and 24 scan backward launches and no other kernel of the
   port; prints the step time, tokens/s, the model-FLOP share (``6 N``),
   peak memory and a profiled step;
9b. Mamba-130m on the log-depth scan: phase 9's model, seed and batch
   with ``FLAGS_mamba_logdepth_scan`` set, 10 ``TrainStep`` steps; checks
   every loss within 1e-3 relative of phase 9's and per step 24 log-depth
   forward and 24 log-depth backward launches, no sequential scan launch
   and no other kernel; prints the step time beside phase 9's;
10. RWKV training: ``bench.py``'s RWKV-169m (vocab 32000, hidden 768, 12
   layers, head_dim 64, intermediate 2688, bf16) at full width and depth,
   as phase 9, with 12 WKV forward and 12 WKV backward launches per step;
11. Mamba-2 training: ``bench.py``'s Mamba-2 (vocab 32000, hidden 768, 24
   layers, state 64, head_dim 64, 24 heads, SSD chunk 128, bf16, untied
   head) at full width and depth, batch 8 x 1024 seeded tokens, as phase
   9, with 24 SSD forward and 24 SSD backward launches per step; its
   profiled step is grouped into SSD forward, SSD backward, conv, cuBLAS,
   copies, the AdamW span and the rest;
12. the Paddle training loop on the Llama-2-7B widths at 2 layers (phase
   6's config at half its depth), batch 2 x 2048 from a ``DataLoader``
   over 8 seeded numpy rows (shuffled, two forked process workers,
   ``places="cuda"``):
   (a) an f32 model under ``auto_cast(level="O1")`` with AdamW, 10 steps:
   falling losses, 2 x 10 flash forward and backward launches (the
   white-listed cast fed the bf16 kernels); (b) ``amp.decorate(level=
   "O2")`` with ``AdamW(multi_precision=True, grad_clip=
   ClipGradByGlobalNorm(1.0))`` over ``LinearWarmup(CosineAnnealingDecay(
   3e-4, 20), 5, 0, 3e-4)`` and ``GradScaler(init_loss_scaling=2**15)``,
   20 steps: falling losses, the scheduler's own learning rates, bf16
   parameters each the cast of its f32 master, every master moved; (d)
   the model, optimizer and scaler state after (b)'s step 10 loaded into
   fresh ones, which run steps 11-20 on the same batches: the same losses
   and final parameters bit for bit; (c) ``FusedAdamW`` under the same
   scaler for 6 steps with one gradient set to inf at step 3: 6 fused
   AdamW launches, the flat master, m and v bit for bit across step 3,
   the scale halved, step 4 updating; each sub-run's host ms a step, peak
   memory and the optimizer's share of a profiled step's device time;
13. ViT and the high-level API: ``bench.py:258-290``'s ViT-L16 (image 224,
   patch 16, hidden 1024, 24 layers, 16 heads, 1000 classes, bf16; random
   weights from a seeded generator on the card) through
   ``Model(vit).prepare(AdamW(3e-4, grad_clip=ClipGradByGlobalNorm(1.0)),
   CrossEntropyLoss(), Accuracy(topk=(1, 5)))``; (a) ``fit`` under
   ``auto_cast(level="O2")`` on 4 batches of 64 seeded f32 images (each
   its class's prototype plus noise, 10 classes), 2 epochs, a held-out
   batch evaluated after each, ``EarlyStopping`` and ``save_dir``: falling
   losses, top-1 rising from epoch 1 to 2, flash launches 24 x (8 steps + 2
   eval batches) forward and 24 x 8 backward and no other kernel of the
   port, the checkpoints ``0``, ``1``, ``final`` and ``best_model``; the
   step's host ms, images/s, the model-FLOP share (``bench.py:278-280``)
   and peak memory, and a profiled step (device ms by group, the
   optimizer's span, the idle share); (b) ``evaluate`` and ``predict(
   stack_outputs=True)``: shapes, finite; (c) ``save`` then ``load`` into a
   fresh Model: predictions bit for bit, and epoch 2 resumed from the
   epoch-1 checkpoint (numpy's RNG set to the epoch's start): the losses
   and every parameter bit for bit (the patch conv on cuDNN's deterministic
   algorithms); (d) ``amp.debugging``: operator statistics over one eval
   batch (conv2d 1, linear 6 L + 1, flash_attention L, layer_norm 2 L + 1
   calls, no NaN / Inf; its cost against the plain batch), the tensor
   checker raising ``FloatingPointError`` on conv2d with an inf in the
   patch bias and continuing in ``CHECK_NAN_INF``, ``check_numerics``;
   (e) ``MoELayer(gate, [8 expert modules])`` at phase 8's widths, 8 x 2048
   tokens, a forward and backward against ``MLPExperts`` with the same
   weights on the capacity route (out, dx, the gate's and experts'
   gradients within 2e-2 of max |reference|), launching no kernel of the
   port; (f) ViT-H14 (patch 14, 32 x 1280, 16 heads of 80, 632 M
   parameters, bf16) at full width and depth through ``TrainStep`` with
   AdamW (lr 3e-4) and clip 1.0 as ``bench_vit`` trains ViT-L16, batch 32,
   6 steps: finite losses, 32 x steps forward and backward launches of
   the head-dim flash kernels and no other kernel of the port, the step's
   host ms, images/s, model-FLOP share and peak memory;
14. the UNet: ``bench.py:424-446``'s bench_unet, sdxl-small (channels 192,
   384, 768, 12 heads, 2 transformer layers, 275,657,476 parameters, bf16)
   at full width and depth, batch 32 of 4 x 32 x 32 latents, t in [0,
   1000), a 77 x 768 context, ``TrainStep(model, loss_fn, AdamW(lr=
   1e-4))`` with the MSE to a fixed noise, 8 steps: the parameter count,
   finite losses, per step 44 flash forward and 44 backward launches (20
   at d 32 on the head-dim kernels, 24 at d 64 on the 64 / 128 ones) and no
   other kernel of the port; the step's host ms, images/s, peak memory,
   the model-FLOP share of 989 TFLOP/s (3 x the forward's operations,
   counted from the layers' shapes) and a profiled step (idle share,
   device ms by group);
15. Paddle-style block-attention decode: Llama-3-8B at full width and
   depth (phase 5g (a)'s weights, batch 4 x prompt 512, 32 new tokens),
   each layer composed from ``incubate.nn.functional``:
   ``fused_rms_norm(residual=)``, projections through ``fused_linear``
   (bf16 ``[in, out]``) and in two more runs ``weight_only_linear`` int8
   and int4 (JAX's ``quant_weights`` layouts of the fused route's
   quantized values), ``fused_rotary_position_embedding``,
   ``block_multihead_attention`` over a ``PagedKVCache`` a layer (one
   prefill at T = 512, then T = 1 decode steps on the paged kernel) and
   ``swiglu``; the f32 tail. Checks: the greedy tokens agree with
   ``generate`` (bf16) and with ``fused_generate(quantize=...)`` over the
   dense model with the run's dequantized weights (int8, int4) under phase
   4's rule; launches: paged 32 x 31 a run, weight-only 7 x 32 x 31 a
   quantized run (every decode product passes ``kernel_takes`` at m = 4;
   the prefill's m = 2048 takes the dequantize route), no flash;
   ``masked_multihead_attention`` against one more block decode step
   (bf16 out within 2e-2); each run's host ms a token and peak memory,
   and the paged and weight-only kernels timed at these shapes beside
   their bounds;
16. hybrid parallel on one card: (a) ``init_parallel_env()`` (NCCL, world
   size 1, a ``file://`` store), ``fleet.init`` and
   ``ShardedTrainStep(stage=P_G_OS, clip_norm=1.0)`` on phase 6's
   Llama-2-7B widths at 4 layers with ``context_parallel=True`` (sep 1:
   attention is the flash call, a ring of one hop), 10 steps on phase 6's
   seeded weights and batch: losses within 2e-2 of phase 6's ``TrainStep``
   at every step, L x steps flash forward and backward launches, the step
   host ms beside phase 6's; (b) the ring schedule of
   ``ops/fused/ring_attention`` with 4 ranks in one process at phase 6e's
   long context (S 16384 in four shards of 4096, 32 heads of 128, bf16,
   causal): out and lse, and dq, dk, dv, against one flash call over the
   whole sequence within phase 3's flash tolerances, 10 forward and 10
   backward launches (the 6 strictly later blocks skipped), and Ulysses
   at n = 4 (4 + 4 launches) the same way; each timed beside the one
   call;
17. pipeline and offload on one card: (a) the 7B widths at 8 layers in
   bf16, batch 8 x 2048, through ``PipelineTrainStep`` with 4 stages in
   one process and 8 micro-batches, ``1f1b``, ``vpp`` (2 groups of layers
   a stage) and ``zb``, 6 steps each on a fresh seeded batch a step,
   against ``TrainStep`` on the same model and batches (AdamW lr 3e-4,
   weight decay 0.1, bf16 moments, no
   clip): every loss within 1e-3 relative; each parameter tensor with at
   most half of its elements beyond one bf16 step (2^-7 relative + 1e-6)
   of TrainStep's (the micro-batch gradient sums round otherwise) and
   within 0.25 of TrainStep's own update of it (|p - p_ref| <= 0.25 |p_ref
   - p0|: a tensor left unmoved fails); every parameter within one bf16
   step of the same micro-batches run as one stage; the flash launches (8
   x 8 forward and backward a step, ``zb``'s B and W one backward), each
   run's step ms and peak memory; (b) phase 6's configuration through ``OffloadedTrainStep``
   (NCCL, world size 1, optimizer state pinned on the host): every loss
   within 1e-3 relative and every parameter within one bf16 step of phase
   6's, the host state's bytes as predicted, the peak device memory below
   phase 6's, the step ms and the side stream's copy ms a step.

The last lines are the kernels' JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12         # dense tensor-core bf16
F32_FLOP_PER_S = 67e12           # f32 outside the tensor cores
OUT_ATOL = 2e-2                  # bf16 outputs vs the f32 plain version
STATS_RTOL = 1e-3                # paged (m, l), flash lse vs the plain version
BWD_RTOL = 2e-2                  # flash dq/dk/dv: max |diff| / max |plain| (bf16)
ADAMW_TOL = 1e-6                 # fused AdamW: max |diff| / max(|plain|, 1)
AGREE_MIN = 0.90                 # teacher-forced greedy agreement (bf16 ties)
LOGITS_REL_L2 = 0.1              # first-token logits, engine vs dense
WO_RTOL = 1e-2                   # weight-only GEMM: max |diff| / max |plain|
KV_NOISE_MAX = 1.0               # int8 vs bf16 pool, max first-token logit change
PROMPT_LENS = (17, 64, 200, 333, 511, 700, 1024, 1500)
NEW_TOKENS = 32
PREFIX_LEN = 1024                # phase 5d: the shared prefix (64 blocks)
PREFIX_TAILS = (33, 480)         # phase 5d: the 8 tails' length range
SPEC_K = 4                       # phase 5e: drafted tokens an iteration
DRAFT_LAYERS = 2                 # phase 5e run A: the independent drafter
FLEET_KILL_STEP = 3              # phase 5f: fleet steps before the failover
FLEET_MEM_SLACK = 64 * 2**20     # phase 5f: memory back after the fleet
REPLICA_MEM_MAX = 4 * 2**30      # phase 5f: what a second replica may add
DECODE_BATCH, DECODE_PROMPT = 4, 512   # phase 5g (a): Llama-3-8B decoders
DECODE_MEM_SLACK = 64 * 2**20    # phase 5g: memory back after the phase
# phase 5g (b): bench.py:503-590's bench_decode on llama-350m: batch 8,
# prompt 128, the per-token slope between 32 and 128 new tokens, the
# median of 3 interleaved pairs
BENCH_BATCH, BENCH_PROMPT, BENCH_LO, BENCH_HI, BENCH_PAIRS = 8, 128, 32, 128, 3
# device ms of a decode step by kernel group (profile_decode, phase 5g)
DECODE_GROUPS = {"flash": ("flash_fwd",), "paged": ("paged_kernel",),
                 "weight-only": ("wo_gemm",),
                 "matmul": ("gemm", "gemv", "nvjet", "cutlass", "xmma")}
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_STEPS, EAGER_STEPS = 10, 5
LONG_SEQ, LONG_STEPS = 16384, 3  # phase 6e: bench.py's long-context cell
GG_RTOL = 1e-2                   # grouped GEMMs: max |diff| / max |plain|
# group starts off every 64- and 128-row boundary, a one-row group, an
# empty group and 2720 trash rows at M = 8200
GG_RAGGED = (1, 127, 129, 0, 4095, 63, 65, 1000)
GG_RAGGED_M = 8200
MOE_BATCH, MOE_SEQ, MOE_STEPS = 8, 2048, 10
SSM_F32_RTOL = 1e-4              # scan, WKV in f32 I/O: max |diff| / max |plain|
SSM_BF16_RTOL = 1e-2             # the same in bf16 I/O (one bf16 rounding)
SSM_STEPS = 10
H100_SMS, SFU_EX2_PER_CLOCK = 132, 16   # H100 SXM: SMs, ex2 per clock per SM


class SmokeFailure(Exception):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)
    print(f"  ok: {what}")


def smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(torch, fn, reps=10, flush=None):
    """Mean device ms of ``fn`` over ``reps`` launches, each timed alone
    with CUDA events after ``flush`` evicted the 50 MB L2 (the serving
    path meets each layer's K/V and weights cold). A device-side sleep
    queued before the start event keeps the card busy while the host
    enqueues ``fn``, so host overhead stays out of the interval."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(4_000_000)     # ~2 ms at H100 clocks
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound(flops, nbytes, flop_per_s=BF16_FLOP_PER_S):
    t_ops, t_bytes = flops / flop_per_s, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ulp_noise(torch, model, ids, gen, rows=slice(None)):
    """Phase 4's bf16 noise on ``ids [1, s]``: the dense forward's f32
    logits at ``rows``, the same with every input embedding moved one ulp
    (:func:`perturbed_logits`), and the largest change between them."""
    with torch.inference_mode():
        logits = model(ids)[0, rows]
        moved = perturbed_logits(torch, model, ids, gen)[rows]
    return logits, moved, (logits - moved).abs().max().item()


def perturbed_logits(torch, model, ids, gen):
    """The dense forward with every input embedding moved by about one bf16
    ulp (relative Gaussian noise of 2^-8): how far bf16 rounding alone
    moves this model's logits. Returns f32 logits ``[s, vocab]``."""
    from paddle_tpu_torch.models import lm_head_tail

    m, s = model.model, ids.shape[1]
    x = m.embed_tokens(ids)
    noise = torch.randn(x.shape, generator=gen, device=x.device)
    x = (x.float() * (1 + 2.0 ** -8 * noise)).to(x.dtype)
    for layer in m.layers:
        x = layer(x, m.rope_cos[:s], m.rope_sin[:s])
    return lm_head_tail(x[0], m.norm.weight, model.lm_head.weight.t(),
                        model.config.rms_norm_eps)


def phase_environment(torch):
    print("== phase 1: environment")
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False")
    from paddle_tpu_torch.ops.cuda import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "not importable"
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}, triton {triton_v}")
    print(f"  nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    print(f"  card: {smi()} ({torch.cuda.device_count()} visible)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    print("== phase 2: build")
    from paddle_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"  built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
          f"(per source: "
          f"{json.dumps({k: round(v, 1) for k, v in secs.items()})})")
    for name in sorted(secs):
        for line in (_build.ptxas_report(name) or "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def phase_kernels(torch, gen, flush):
    print("== phase 3: kernels against their plain versions")
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from paddle_tpu_torch.ops.fused.flash_attention import (
        flash_attention, flash_attn_reference)

    rows = {}
    dev = "cuda"
    hq, hk, d = 32, 8, 128
    flash_cases = [("one-shot S=512", 512, 512, 0),
                   ("one-shot S=2048", 2048, 2048, 0),
                   ("carry S=512 at offset 1024", 512, 1536, 1024)]
    # correctness only, off the timed set: the smallest prefill bucket, a
    # ragged tile with kv_len, and head_dim 64
    for label, sq, sk, nq, nk, dd, causal, off, kv_len in (
            ("S=16", 16, 16, hq, hk, d, True, 0, None),
            ("ragged sq=49 kv_len=70", 49, 96, hq, hk, d, True, 21, 70),
            ("d=64 non-causal kv_len=100", 100, 128, 8, 2, 64, False, None,
             100)):
        q = torch.randn(2, sq, nq, dd, generator=gen, device=dev).bfloat16()
        k = torch.randn(2, sk, nk, dd, generator=gen, device=dev).bfloat16()
        v = torch.randn(2, sk, nk, dd, generator=gen, device=dev).bfloat16()
        kw = dict(causal=causal, q_offset=off, kv_len=kv_len)
        diff = (flash_attention(q, k, v, **kw).float()
                - flash_attn_reference(q, k, v, **kw).float())
        err = diff.abs().max().item()
        check(math.isfinite(err) and err <= OUT_ATOL,
              f"flash {label}: max |kernel - plain| = {err:.3e} <= {OUT_ATOL}")
    flash_err, flash_row = 0.0, None
    for label, sq, sk, off in flash_cases:
        q = torch.randn(1, sq, hq, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(1, sk, hk, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(1, sk, hk, d, generator=gen, device=dev).bfloat16()
        out = flash_attention(q, k, v, causal=True, q_offset=off)
        ref = flash_attn_reference(q, k, v, causal=True, q_offset=off)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        check(math.isfinite(err) and err <= OUT_ATOL,
              f"flash {label}: max |kernel - plain| = {err:.3e} <= {OUT_ATOL}")
        flash_err = max(flash_err, err)
        ms = time_ms(torch, lambda: flash_attention(q, k, v, causal=True,
                                                    q_offset=off), flush=flush)
        plain = time_ms(torch, lambda: flash_attn_reference(
            q, k, v, causal=True, q_offset=off), reps=3, flush=flush)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if sq == sk and off == 0:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            # the carry case is bottom-right causal (off = sk - sq): SDPA
            # runs that mask on its fused backends
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=causal_lower_right(sq, sk),
                enable_gqa=True)
        lib_ms = time_ms(torch, lib, flush=flush)
        pairs = sum(min(sk, off + r + 1) for r in range(sq))
        flops = 4 * d * hq * pairs
        nbytes = 2 * (2 * sq * hq * d + 2 * sk * hk * d)
        b_ms, b_by = bound(flops, nbytes)
        host = host_us_per_call(torch, lambda: flash_attention(
            q, k, v, causal=True, q_offset=off))
        print(f"  flash {label}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
              f"{b_ms / ms:.1%} of it), plain {plain:.3f} ms, "
              f"sdpa {lib_ms:.4f} ms ({ms / lib_ms:.2f}x sdpa); wrapper "
              f"{host:.1f} us a call on the host")
        if sq == 512 and off == 0:
            flash_row = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms)
        del q, k, v, out, ref
    flash_row["max_abs_err"] = max(flash_err,
                                   check_flash_decode(torch, gen, flush))
    rows["flash_attention"] = flash_row

    print_paged_ptxas()
    rows["paged_attention"] = check_paged(torch, gen, flush, quant=False)
    rows["paged_attention_int8"] = check_paged(torch, gen, flush, quant=True)
    print_weight_only_ptxas()
    rows["int8_matmul"] = check_weight_only(torch, gen, flush, int4=False)
    rows["int4_matmul"] = check_weight_only(torch, gen, flush, int4=True)
    torch.cuda.empty_cache()
    rows["flash_attention_bwd"] = check_flash_backward(torch, gen, flush)
    torch.cuda.empty_cache()
    fwd_err, bwd_err = check_flash_masks(torch, gen, flush)
    torch.cuda.empty_cache()
    print_mma_flash_ptxas()
    mma_rows, hd_fwd, hd_bwd = check_flash_head_dims(torch, gen, flush)
    rows.update(mma_rows)
    torch.cuda.empty_cache()
    for name, err in (("flash_attention", max(fwd_err, hd_fwd)),
                      ("flash_attention_bwd", max(bwd_err, hd_bwd))):
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    rows["fused_adamw"] = check_fused_adamw(torch, gen)
    torch.cuda.empty_cache()
    rows.update(check_grouped_gemm(torch, gen, flush))
    torch.cuda.empty_cache()
    print_ssm_ptxas()
    rows.update(check_selective_scan(torch, gen, flush))
    torch.cuda.empty_cache()
    rows.update(check_selective_scan_logdepth(torch, gen, flush, rows))
    torch.cuda.empty_cache()
    rows.update(check_wkv(torch, gen, flush))
    torch.cuda.empty_cache()
    rows.update(check_ssd(torch, gen, flush))
    torch.cuda.empty_cache()
    return rows


# phase 3: the flash forward at decode shapes (1-8 query rows against a
# cache whose columns past kv_len hold large values the kernel must never
# read): Llama-3-8B's generate step (b 4, a 544-slot cache) and llama-350m's
# d 64 heads (b 8, 256 slots)
FLASH_DECODE_CASES = (
    [("Llama-3-8B decode kv_len 513", 4, 1, 544, 513, 32, 8, 128),
     ("Llama-3-8B decode kv_len 543", 4, 1, 544, 543, 32, 8, 128)]
    + [(f"llama-350m sq={sq}", 8, sq, 256, 130 + sq, 16, 16, 64)
       for sq in range(1, 9)])


def check_flash_decode(torch, gen, flush):
    """The flash forward at FLASH_DECODE_CASES against its plain version
    (bottom-right causal: q_offset = kv_len - sq). The k columns past
    kv_len are scaled by 8 and the v columns moved by 100, so a kernel that
    read one would miss by far more than OUT_ATOL. Each case is timed
    beside SDPA given ``k[:, :kv_len]`` and ``causal_lower_right`` (the
    same function on SDPA's fused backends); the bound counts the pairs
    the rows see and the k / v columns below kv_len read once. Returns the
    largest max |kernel - plain|."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from paddle_tpu_torch.ops.fused.flash_attention import (
        flash_attention, flash_attn_reference)

    dev, worst, card = "cuda", 0.0, smi()
    for label, b, sq, sk, kv_len, hq, hk, d in FLASH_DECODE_CASES:
        q = torch.randn(b, sq, hq, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, sk, hk, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, sk, hk, d, generator=gen, device=dev).bfloat16()
        k[:, kv_len:] *= 8
        v[:, kv_len:] += 100
        run = lambda: flash_attention(q, k, v, causal=True,  # noqa: E731
                                      kv_len=kv_len)
        out = run()
        ref = flash_attn_reference(q, k, v, causal=True, kv_len=kv_len)
        err = (out.float() - ref.float()).abs().max().item()
        check(math.isfinite(err) and err <= OUT_ATOL,
              f"flash {label} (k, v past kv_len scaled / moved): max "
              f"|kernel - plain| = {err:.3e} <= {OUT_ATOL}")
        worst = max(worst, err)
        ms = time_ms(torch, run, flush=flush)
        plain = time_ms(torch, lambda: flash_attn_reference(
            q, k, v, causal=True, kv_len=kv_len), reps=3, flush=flush)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k[:, :kv_len],
                                                  v[:, :kv_len]))
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=causal_lower_right(sq, kv_len),
            enable_gqa=True), flush=flush)
        pairs = sum(kv_len - sq + r + 1 for r in range(sq))
        b_ms, b_by = bound(4 * d * hq * pairs * b,
                           2 * (2 * b * sq * hq * d + 2 * b * kv_len * hk * d))
        print(f"  flash {label}: {ms:.4f} ms (bound {b_ms:.4f} ms by "
              f"{b_by}, {b_ms / ms:.1%} of it), plain {plain:.3f} ms, sdpa "
              f"(causal_lower_right) {lib_ms:.4f} ms ({ms / lib_ms:.2f}x "
              f"sdpa); on {card}")
        del q, k, v, out, ref
    return worst


PAGED_LENS = [0, 1, 16, 17, 1000, 2048, 700, 1532]
# the paged kernel's edges: (what, lens, kv heads, group, d)
PAGED_EDGES = (
    ("group 1", PAGED_LENS, 8, 1, 128), ("group 2", PAGED_LENS, 8, 2, 128),
    ("group 8", PAGED_LENS, 4, 8, 128), ("d 64", PAGED_LENS, 8, 4, 64),
    ("batch 1 at 2048 tokens", [2048], 8, 4, 128),
    ("an all-empty batch", [0] * 8, 8, 4, 128),
    ("64 rows", "64 rows", 8, 4, 128),
    ("16 kv heads, group 1, d 64 (llama-350m)",
     [128, 129, 143, 144, 160, 200, 254, 255], 16, 1, 64))
# the contiguous table of fused_generate(paged=True) and ServingDecoder
# (row b on blocks b * pps ..., row 0 on block 0, every row equally long):
# (what, rows, tokens a row, kv heads, group, d, pages a row) at the first
# and the last decode step of phase 5g's Llama-3-8B (prompt 512, 32 new
# tokens) and llama-350m (prompt 128, 128 new tokens) runs
PAGED_CONTIGUOUS = (
    ("Llama-3-8B decode", 4, 512, 8, 4, 128, 34),
    ("Llama-3-8B decode", 4, 542, 8, 4, 128, 34),
    ("llama-350m decode", 8, 128, 16, 1, 64, 16),
    ("llama-350m decode", 8, 254, 16, 1, 64, 16))


def paged_inputs(torch, gen, lens=PAGED_LENS, kvh=8, group=4, d=128,
                 quant=False, blocks=1025, page=16, pps=128,
                 contiguous=False):
    """The serving path's decode table and one layer's pool: rows of
    ``lens`` tokens on distinct shuffled blocks (block 0 never used), null
    table tails; or, ``contiguous``, the pool of exactly ``B * pps`` blocks
    under ``contiguous_page_table``. q [B, kvh group, d] and the pool [kvh,
    blocks, page, d] in bf16, or int8 with its block-major scales [blocks,
    kvh, page]. Returns the positional arguments and the keyword arguments
    of ``paged_attention``."""
    from paddle_tpu_torch.incubate.nn.functional import contiguous_page_table
    from paddle_tpu_torch.models.kv_cache import quantize_kv

    dev, B = "cuda", len(lens)
    blocks = B * pps if contiguous \
        else max(blocks, sum(-(-n // page) for n in lens) + 1)
    k, v = (torch.randn(kvh, blocks, page, d, generator=gen, device=dev)
            for _ in range(2))
    kw = dict(return_stats=True)
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        kw.update(k_scales=ks.transpose(0, 1).contiguous(),
                  v_scales=vs.transpose(0, 1).contiguous())
    else:
        k, v = k.bfloat16(), v.bfloat16()
    q = torch.randn(B, kvh * group, d, generator=gen, device=dev).bfloat16()
    if contiguous:
        table = contiguous_page_table(B, pps, device=dev)
    else:
        perm = torch.randperm(blocks - 1, generator=gen, device=dev) + 1
        table = torch.zeros(B, pps, dtype=torch.int32, device=dev)
        at = 0
        for i, n in enumerate(lens):
            used = -(-n // page)
            table[i, :used] = perm[at:at + used].int()
            at += used
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return (q, k, v, table, lens), kw


def check_paged_once(torch, what, args, kw):
    """One call of the paged kernel against its plain version: out within
    OUT_ATOL, m and l within STATS_RTOL of max(|plain|, 1), empty rows
    exactly (out 0, m -1e30, l 0). Returns max |out - plain|."""
    from paddle_tpu_torch.ops.cuda.paged_attention import (
        paged_attention, paged_attention_reference)

    out, m, l = paged_attention(*args, **kw)
    rout, rm, rl = paged_attention_reference(*args, **kw)
    torch.cuda.synchronize()
    err = (out.float() - rout.float()).abs().max().item()
    check(math.isfinite(err) and err <= OUT_ATOL,
          f"{what} out: max |kernel - plain| = {err:.3e} <= {OUT_ATOL}")
    for name, a, r in (("m", m, rm), ("l", l, rl)):
        rel = ((a - r).abs() / r.abs().clamp_min(1.0)).max().item()
        check(rel <= STATS_RTOL, f"{what} {name}: max |diff|/max(|ref|,1) = "
                                 f"{rel:.3e} <= {STATS_RTOL}")
    empty = args[4] == 0
    check(bool((m[empty] == -1e30).all() and (l[empty] == 0).all()
               and (out[empty] == 0).all()),
          f"{what} empty rows ({int(empty.sum())}): m = -1e30, l = 0, "
          f"out = 0")
    return err


def check_paged(torch, gen, flush, quant):
    """The paged decode kernel on bf16 (or int8) pages against its plain
    version at the serving path's shapes (q [8, 32, 128], one layer's pool
    [8, 1025, 16, 128], int8 with its block-major scales [1025, 8, 16],
    lens PAGED_LENS) and at ``PAGED_EDGES`` (groups of 1, 2 and 8, d = 64,
    one row of 2048 tokens, a batch with no token, 64 rows of 0 to 2048
    tokens, llama-350m's 16 heads of 64), bf16 pages also on
    ``PAGED_CONTIGUOUS``; the path's shape twice (bitwise equal); timed
    there, split by kernel, with the wrapper's host µs a call."""
    from paddle_tpu_torch.ops.cuda.paged_attention import (
        paged_attention, paged_attention_reference)

    kind = "int8 pages" if quant else "bf16 pages"
    err = 0.0
    for what, lens, kvh, group, d in PAGED_EDGES:
        if lens == "64 rows":
            lens = torch.randint(0, 2049, (64,), generator=gen,
                                 device="cuda").tolist()
            lens[:3] = [0, 2048, 1]
        args, kw = paged_inputs(torch, gen, lens, kvh, group, d, quant)
        err = max(err, check_paged_once(torch, f"paged {kind}, {what}",
                                        args, kw))
        del args, kw
    for what, B, n, kvh, group, d, pps in () if quant else PAGED_CONTIGUOUS:
        args, kw = paged_inputs(torch, gen, [n] * B, kvh, group, d, pps=pps,
                                contiguous=True)
        err = max(err, check_paged_once(
            torch, f"paged {kind}, contiguous table, {what}: {B} rows of "
                   f"{n} tokens, {kvh} kv heads, group {group}, d {d}",
            args, kw))
        del args, kw
    torch.cuda.empty_cache()
    args, kw = paged_inputs(torch, gen, quant=quant)
    err = max(err, check_paged_once(torch, f"paged {kind}", args, kw))
    first = paged_attention(*args, **kw)
    again = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          f"paged {kind} run twice: out, m and l bitwise equal")
    ms = time_ms(torch, lambda: paged_attention(*args, **kw), reps=20,
                 flush=flush)
    plain = time_ms(torch, lambda: paged_attention_reference(*args, **kw),
                    reps=5, flush=flush)
    split = kernel_split(torch, lambda: paged_attention(*args, **kw),
                         ("paged_",))
    host = host_us_per_call(torch, lambda: paged_attention(*args, **kw))
    q, table = args[0], args[3]
    B, hq, d = q.shape
    hk = args[1].shape[0]
    tokens = sum(PAGED_LENS)
    flops = 4 * hq * d * tokens
    row = 2 * d + 2 * 4 if quant else 2 * 2 * d   # K and V (+ 2 scales)
    nbytes = (tokens * hk * row                   # each valid row read once
              + 2 * 2 * B * hq * d                # q in, out back
              + 4 * (table.numel() + B) + 2 * 4 * B * hq)  # table, lens, m, l
    b_ms, b_by = bound(flops, nbytes)
    print(f"  paged decode, {kind} (lens {PAGED_LENS}): {ms:.4f} ms (bound "
          f"{b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of it), plain "
          f"{plain:.3f} ms, library: none; by kernel (ms a call): {split}; "
          f"wrapper {host:.1f} us a call on the host")
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, max_abs_err=err)


# Llama-3-8B's four decode products of one layer: (name, K, N)
WO_SHAPES = (("qkv", 4096, 6144), ("out", 4096, 4096),
             ("ffn1", 4096, 28672), ("ffn2", 14336, 4096))
# llama-350m's (phase 5g's bench_decode workload), checked at its decode
# rows (m = 8) and its prefill's (m = 8 x 128, the dequantize-then-matmul
# route)
WO_SHAPES_350M = (("qkv", 1024, 3072), ("out", 1024, 1024),
                  ("ffn1", 1024, 5632), ("ffn2", 2816, 1024))


def library_int8pack(torch, x, w, scale, int4):
    """PyTorch's own weight-only product at the same shape, timed as a
    yardstick only: ``_weight_int8pack_mm`` (int8, per-channel scales) or
    ``_weight_int4pack_mm`` (int4 in its own packing, group 128 with zero
    points, on random codes)."""
    K, N = x.shape[1], scale.shape[0]
    if not int4:
        wt, sc = w.t().contiguous(), scale.bfloat16()
        return lambda: torch._weight_int8pack_mm(x, wt, sc)
    raw = torch.randint(0, 256, (N, K // 2), dtype=torch.uint8,
                        device=x.device)
    packed = torch._convert_weight_to_int4pack(raw, 8)
    sz = torch.ones(K // 128, N, 2, dtype=torch.bfloat16, device=x.device)
    return lambda: torch._weight_int4pack_mm(x, packed, 128, sz)


# the weight-only kernels' edges: rows around each 8-row tile and the
# decode / wgmma boundary (64 | 65), one column tile (N = 128), N = 384 at K
# = 14336 (at m = 8 the decode grid takes stream-K shares that do not divide
# a tile's steps; checked on the plan the wrapper launches), the smallest K
# of the rule
WO_EDGE_M = (1, 7, 8, 9, 16, 17, 33, 63, 64, 65, 128, 255, 256)


def check_weight_only(torch, gen, flush, int4):
    """The int8 (int4) weight-only GEMM against its plain version: the four
    products of Llama-3-8B at every row count the serving path gives the
    kernels (m = 8 decode; the prefill buckets m = 32, 64 and 256), each
    timed beside its bound, the plain version, a bf16 ``torch.matmul``,
    ``torch._weight_{int8,int4}pack_mm`` and the wrapper's host µs a call;
    the kernels' edges (``WO_EDGE_M`` at K = 14336, N = 384; m in {1, 8, 64,
    65, 256} at N = 128 and the smallest K the rule admits, bf16 and f32
    out; f32 out at ``out`` for m = 8 and 256); llama-350m's four products
    (``WO_SHAPES_350M``) at m = 8 and 1024, each call's launches checked
    against the dispatch rule; ffn2 at m = 8 twice, bitwise
    equal. The kernels line's numbers sum one layer's four m = 8 products.
    Then the host cost of one decode step's 128 wrapper calls."""
    from paddle_tpu_torch.ops.cuda import int8_matmul as wo

    kind = "int4" if int4 else "int8"
    fn = wo.int4_weight_matmul if int4 else wo.int8_weight_matmul
    plain_fn = wo.int4_weight_matmul_reference if int4 \
        else wo.int8_weight_matmul_reference
    dev = torch.cuda.current_device()
    row = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
               max_abs_err=0.0)
    by = set()

    def operands(m, K, N):
        w = torch.randint(-128, 128, (K // 2 if int4 else K, N),
                          dtype=torch.int8, device="cuda", generator=gen)
        if not int4:
            w.clamp_(-127, 127)
        scale = torch.rand(N, generator=gen, device="cuda") * 2e-3 + 1e-4
        x = torch.randn(m, K, generator=gen, device="cuda").bfloat16()
        return x, w, scale

    def held(label, x, w, scale, out_dtype=torch.bfloat16):
        m, K = x.shape
        N = w.shape[1]
        count = "int4_launches" if int4 else "launches"
        before = getattr(wo, count)
        out = fn(x, w, scale, out_dtype)
        launched = getattr(wo, count) - before
        ref = plain_fn(x, w, scale, out_dtype)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        peak = ref.float().abs().max().item()
        takes = wo.kernel_takes(m, K, N, int4)
        check(launched == int(takes),
              f"{kind} GEMM {label} m={m} K={K} N={N}: {launched} launches "
              f"== {int(takes)}")
        if takes:
            p = wo._plan(m, K, N, int4, dev)   # the grid the wrapper launched
            grid = (f"{'wgmma' if p.kind else 'decode'} kernel, {p.ctas} "
                    f"CTAs x {p.units / p.ctas:.2f} of {p.units} units")
        else:
            grid = "the dequantize-then-matmul route"
        check(out.dtype == out_dtype and math.isfinite(err)
              and err <= WO_RTOL * peak,
              f"{kind} GEMM {label} m={m} K={K} N={N} "
              f"{str(out_dtype).split('.')[1]} ({grid}): max |kernel - "
              f"plain| = {err:.3e} = {err / peak:.2e} of max |plain| <= "
              f"{WO_RTOL}")
        row["max_abs_err"] = max(row["max_abs_err"], err)

    decode = []     # the four m = 8 products, kept for the host timing
    for m in (8, 32, 64, 256):
        for name, K, N in WO_SHAPES:
            x, w, scale = operands(m, K, N)
            held(name, x, w, scale)
            ms = time_ms(torch, lambda: fn(x, w, scale), reps=20, flush=flush)
            plain = time_ms(torch, lambda: plain_fn(x, w, scale), reps=5,
                            flush=flush)
            wb = (wo.unpack_int4_packed(w) if int4 else w).bfloat16()
            lib = time_ms(torch, lambda: torch.matmul(x, wb), reps=20,
                          flush=flush)
            nbytes = w.numel() + 2 * m * K + 2 * m * N + 4 * N
            b_ms, b_by = bound(2 * m * K * N, nbytes)
            pack = time_ms(torch, library_int8pack(torch, x, w, scale, int4),
                           reps=20 if m == 8 else 3, flush=flush)
            host = host_us_per_call(torch, lambda: fn(x, w, scale))
            print(f"  {kind} GEMM {name} m={m} K={K} N={N}: {ms:.4f} ms "
                  f"(bound {b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of it), "
                  f"plain {plain:.3f} ms, bf16 torch.matmul {lib:.4f} ms, "
                  f"torch._weight_{kind}pack_mm {pack:.4f} ms; wrapper "
                  f"{host:.1f} us a call on the host")
            if m == 8:
                row["ms"] += ms
                row["plain_ms"] += plain
                row["bound_ms"] += b_ms
                row["library_ms"] += lib
                by.add(b_by)
                decode.append((x, w, scale, wb))
            del w, x, wb
    kmin = 256 if int4 else 128
    stream_k = wo._plan(8, 14336, 384, int4, dev)
    check(stream_k.units % stream_k.ctas != 0,
          f"{kind} edge K=14336 N=384 at m=8 takes stream-K shares that do "
          f"not divide a tile's {stream_k.steps} steps ({stream_k.units} "
          f"units over {stream_k.ctas} CTAs)")
    for m in WO_EDGE_M:
        held("edge", *operands(m, 14336, 384))
    for m in (1, 8, 64, 65, 256):
        x, w, scale = operands(m, kmin, 128)
        for out_dtype in (torch.bfloat16, torch.float32):
            held("edge, one column tile", x, w, scale, out_dtype)
    for m in (8, 256):
        held("out", *operands(m, 4096, 4096), torch.float32)
    for m in (8, 8 * 128):
        for name, K, N in WO_SHAPES_350M:
            held(f"llama-350m {name}", *operands(m, K, N))
    x, w, scale = operands(8, 14336, 4096)
    first, second = fn(x, w, scale), fn(x, w, scale)
    torch.cuda.synchronize()
    check(torch.equal(first, second),
          f"{kind} GEMM ffn2 m=8 twice (split tiles summed in a fixed "
          f"order): bitwise equal")
    del x, w, scale, first, second
    row["bound_by"] = "bytes" if by == {"bytes"} else "operations"
    print(f"  {kind} GEMMs of one decode layer (4 products, m = 8): "
          f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, plain "
          f"{row['plain_ms']:.3f} ms, bf16 torch.matmul "
          f"{row['library_ms']:.4f} ms")
    wrapper = host_ms_per_step(torch, [lambda a=a: fn(*a[:3])
                                       for a in decode])
    bf16 = host_ms_per_step(torch, [lambda a=a: torch.matmul(a[0], a[3])
                                    for a in decode])
    print(f"  {kind} host ms to enqueue one decode step's 128 products "
          f"(32 layers x 4, m = 8), runs {fmt_ms(wrapper)}: "
          f"{1e3 * min(wrapper) / 128:.1f} us per wrapper call at best; "
          f"bf16 torch.matmul at the same shapes {fmt_ms(bf16)}")
    return row


def print_weight_only_ptxas():
    """ptxas's line and the SASS's local accesses of each weight-only
    kernel: the decode kernel per 8-row tiles of x (MT), kind and output
    type, the wgmma kernel per 64-row blocks a warpgroup (MB) and column
    tile."""
    import re

    pattern = re.compile(r"(wo_gemm_kernel|wo_gemm_wgmma_kernel)I((?:Li\d+E)+)"
                         r"Lb([01])E(13__nv_bfloat16|f)E")

    def label(m):
        dims = ", ".join(re.findall(r"Li(\d+)E", m.group(2)))
        kind = "int4" if m.group(3) == "1" else "int8"
        out = "bf16" if m.group(4) != "f" else "f32"
        return f"{m.group(1)}<{dims}, {kind}, {out} out>"

    print_ptxas(("int8_matmul",), pattern, label)


def host_ms_per_step(torch, calls, layers=32, reps=7):
    """Host ms to enqueue ``layers`` rounds of ``calls`` back to back (the
    device drained before each round, so no launch waits for a full
    queue), one number per rep after two warm-up reps."""
    out = []
    for rep in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(layers):
            for c in calls:
                c()
        t = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if rep >= 2:
            out.append(t)
    return out


def fmt_ms(ts):
    return "[" + ", ".join(f"{t:.3f}" for t in ts) + "] ms"


def host_us_per_call(torch, fn, calls=32, reps=5):
    """Host µs to enqueue one call of ``fn`` (the median of ``reps`` rounds
    of ``calls`` calls back to back, the device drained before each
    round): what a wrapper costs the host, tensor-map encoding included."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) * 1e6 / calls)
    torch.cuda.synchronize()
    return statistics.median(out)


def check_flash_backward(torch, gen, flush):
    """The forward's lse and the backward against their plain versions: the
    slice's shape (timed; the backward run twice, bitwise equal),
    Llama-3-8B's GQA heads, a ragged tile with ``q_offset`` and ``kv_len``,
    head_dim 64 (non-causal and causal GQA), rows that see no column, and
    the wgmma tiles' edges (b = 2, sq = 200, sk = 333; q_offset = 37 and
    kv_len = 300; GQA 32/8 and 16/4 at d = 64, causal and non-causal)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    from paddle_tpu_torch.ops.fused.flash_attention import (
        flash_attn_bwd_reference, flash_attn_reference)

    dev, row, err_max = "cuda", None, 0.0
    # (label, b, sq, sk, hq, hk, d, causal, q_offset, kv_len, timed)
    cases = [("slice b=2 S=2048 heads 32/32 d=128", TRAIN_BATCH, TRAIN_SEQ,
              TRAIN_SEQ, 32, 32, 128, True, 0, TRAIN_SEQ, True),
             ("GQA S=2048 heads 32/8", 1, 2048, 2048, 32, 8, 128, True, 0,
              2048, False),
             ("ragged sq=49 q_offset=21 kv_len=70", 2, 49, 96, 32, 8, 128,
              True, 21, 70, False),
             ("d=64 non-causal kv_len=100", 2, 100, 128, 8, 2, 64, False, 0,
              100, False),
             ("d=64 causal S=512 heads 16/4", 2, 512, 512, 16, 4, 64, True,
              0, 512, False),
             ("rows 0-15 see nothing (q_offset=-16)", 1, 80, 64, 8, 8, 128,
              True, -16, 64, False),
             # the wgmma tiles' edges: sq, sk off every multiple of 64 and
             # 128 (a load or store spilling into the next batch's rows),
             # a diagonal and a kv_len edge inside a tile
             ("b=2 sq=200 sk=333 (bottom-right)", 2, 200, 333, 32, 8, 128,
              True, 133, 333, False),
             ("b=2 sq=200 sk=333 q_offset=37 kv_len=300", 2, 200, 333, 32, 8,
              128, True, 37, 300, False),
             ("d=64 GQA 32/8 causal q_offset=37 kv_len=300", 2, 200, 333, 32,
              8, 64, True, 37, 300, False),
             ("d=64 GQA 32/8 non-causal kv_len=300", 2, 200, 333, 32, 8, 64,
              False, 0, 300, False),
             ("d=64 GQA 16/4 non-causal S=256", 2, 256, 256, 16, 4, 64, False,
              0, 256, False)]
    for label, b, sq, sk, hq, hk, d, causal, off, kv_len, timed in cases:
        scale = d ** -0.5
        q = torch.randn(b, sq, hq, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, sk, hk, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, sk, hk, d, generator=gen, device=dev).bfloat16()
        do = torch.randn(b, sq, hq, d, generator=gen, device=dev).bfloat16()
        fwd = lambda: flash_attention_cuda(  # noqa: E731
            q, k, v, causal, scale, off, kv_len, return_lse=True)
        bwd = lambda: flash_attention_bwd_cuda(  # noqa: E731
            q, k, v, out, lse, do, causal, scale, off, kv_len)
        plain_bwd = lambda: flash_attn_bwd_reference(  # noqa: E731
            q, k, v, out, lse, do, causal, scale, kv_len, off)
        out, lse = fwd()
        rout, rlse = flash_attn_reference(q, k, v, causal, scale, kv_len, off,
                                          return_lse=True)
        torch.cuda.synchronize()
        err = (out.float() - rout.float()).abs().max().item()
        check(math.isfinite(err) and err <= OUT_ATOL,
              f"flash fwd {label}: max |kernel - plain| = {err:.3e} <= "
              f"{OUT_ATOL}")
        rel = ((lse - rlse).abs() / rlse.abs().clamp_min(1.0)).max().item()
        check(rel <= STATS_RTOL, f"flash fwd {label} lse: max |diff| / "
                                 f"max(|ref|, 1) = {rel:.3e} <= {STATS_RTOL}")
        del rout, rlse
        grads, refs = bwd(), plain_bwd()
        torch.cuda.synchronize()
        for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
            diff = (g.float() - r.float()).abs().max().item()
            peak = r.float().abs().max().item()
            check(math.isfinite(diff) and diff <= BWD_RTOL * peak,
                  f"flash bwd {label} {name}: max |kernel - plain| = "
                  f"{diff:.3e} = {diff / peak:.3e} of max |plain| <= "
                  f"{BWD_RTOL}")
            err_max = max(err_max, diff)
        if timed:
            again = bwd()
            torch.cuda.synchronize()
            check(all(torch.equal(a, g) for a, g in zip(again, grads)),
                  f"flash bwd {label}: a second run is bitwise equal")
            del again
        del grads, refs
        if timed:
            fwd_ms = time_ms(torch, fwd, flush=flush)
            fwd_plain = time_ms(torch, lambda: flash_attn_reference(
                q, k, v, causal, scale, kv_len, off, return_lse=True),
                reps=3, flush=flush)
            ms = time_ms(torch, bwd, flush=flush)
            plain = time_ms(torch, plain_bwd, reps=3, flush=flush)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            with torch.no_grad():
                fwd_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal), flush=flush)
            sdpa_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)
            dot = do.transpose(1, 2)
            lib = time_ms(torch, lambda: torch.autograd.grad(
                sdpa_out, (qt, kt, vt), dot, retain_graph=True), flush=flush)
            del qt, kt, vt, sdpa_out
            pairs = b * sum(min(kv_len, off + r + 1) for r in range(sq))
            flops = 10 * d * hq * pairs          # 5 products, 2.5 x forward
            nbytes = (2 * b * (3 * sq * hq * d + 2 * sk * hk * d)  # q,o,dO,k,v
                      + 4 * b * hq * sq                            # lse
                      + 2 * b * (sq * hq * d + 2 * sk * hk * d))   # dq,dk,dv
            b_ms, b_by = bound(flops, nbytes)
            # the forward with lse: q, k, v in, out and lse back
            f_ms, f_by = bound(
                4 * d * hq * pairs,
                2 * b * (2 * sq * hq * d + 2 * sk * hk * d) + 4 * b * hq * sq)
            print(f"  flash bwd {label}: {ms:.4f} ms (bound {b_ms:.4f} ms by "
                  f"{b_by}, {b_ms / ms:.1%} of it), plain {plain:.3f} ms, "
                  f"sdpa backward {lib:.4f} ms ({ms / lib:.2f}x sdpa), "
                  f"wrapper {host_us_per_call(torch, bwd):.1f} us a call on "
                  f"the host; the forward with lse {fwd_ms:.4f} ms (bound "
                  f"{f_ms:.4f} ms by {f_by}, {f_ms / fwd_ms:.1%} of it), "
                  f"plain "
                  f"{fwd_plain:.3f} ms, sdpa forward {fwd_lib:.4f} ms "
                  f"({fwd_ms / fwd_lib:.2f}x sdpa), wrapper "
                  f"{host_us_per_call(torch, fwd):.1f} us a call on the host")
            row = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib)
        del q, k, v, do, out, lse
    row["max_abs_err"] = err_max
    return row


# phase 3: the flash kernels at the UNet's, ViT-H14's and ViT-L16's shapes
# (phases 14 and 13) and at the head-dim kernels' edges: (label, b, sq, sk,
# hq, hk, d, causal, q_offset (None: bottom-right), kv_len (None: sk),
# timed). sdxl-small at bench_unet's batch 32: level 1 runs 16 x 16 = 256
# tokens at d 32, level 2 and the middle 8 x 8 = 64 tokens at d 64 (the
# wgmma kernels), every cross-attention 77 text tokens; ViT-L16 (bench_vit,
# b 64) 197 tokens (196 patches and the class token) at d 64
HEADDIM_CASES = (
    ("UNet level 1 self b=32 S=256 heads 12 d=32", 32, 256, 256, 12, 12, 32,
     False, None, None, True),
    ("UNet level 1 cross b=32 sq=256 sk=77 heads 12 d=32", 32, 256, 77, 12,
     12, 32, False, None, None, True),
    ("UNet level 2 self b=32 S=64 heads 12 d=64", 32, 64, 64, 12, 12, 64,
     False, None, None, True),
    ("UNet level 2 cross b=32 sq=64 sk=77 heads 12 d=64", 32, 64, 77, 12, 12,
     64, False, None, None, True),
    ("ViT-H14 b=32 S=257 heads 16 d=80", 32, 257, 257, 16, 16, 80, False,
     None, None, True),
    ("ViT-L16 b=64 S=197 heads 16 d=64", 64, 197, 197, 16, 16, 64, False,
     None, None, True),
) + tuple(
    case for d in (16, 32, 80) for case in (
        (f"d={d} b=2 sq=200 sk=333 GQA 16/4 causal", 2, 200, 333, 16, 4, d,
         True, None, None, False),
        (f"d={d} b=2 sq=200 sk=333 GQA 16/4 non-causal kv_len=300", 2, 200,
         333, 16, 4, d, False, 0, 300, False),
        (f"d={d} b=2 sq=200 sk=333 causal q_offset=37 kv_len=300", 2, 200,
         333, 8, 8, d, True, 37, 300, False),
        (f"d={d} b=4 sq=130 sk=1", 4, 130, 1, 8, 8, d, False, None, None,
         False),
        (f"d={d} b=4 sq=1 sk=77", 4, 1, 77, 8, 8, d, False, None, None,
         False),
        (f"d={d} b=2 sq=80 sk=64 causal, rows 0-15 see nothing", 2, 80, 64,
         8, 8, d, True, -16, None, False))
) + tuple(
    (f"d={d} b=2 sq=100 sk=77 GQA 8/2 non-causal", 2, 100, 77, 8, 2, d,
     False, None, None, False) for d in (48, 96, 112))


def check_flash_head_dims(torch, gen, flush):
    """The flash forward (out, lse) and backward (dq, dk, dv) against their
    plain versions at ``HEADDIM_CASES``, with phase 3's tolerances; the timed
    cases' backward run twice (bitwise equal) and each timed beside its
    bound and SDPA's forward or backward. Where one column is seen (sk = 1)
    P is 1 and dS = P (dP - delta) is 0 exactly: dq and dk are then rounding
    noise on both sides, and are held to the tolerance against max |dv|.
    Returns ``(rows, fwd_err, bwd_err)``: the rows of the head-dim kernels
    (timed at UNet level 1's self-attention) and the largest |kernel -
    plain| of the wgmma kernels' forward and backward here."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda.flash_attention import (
        WGMMA_HEAD_DIMS, flash_attention_bwd_cuda, flash_attention_cuda)
    from paddle_tpu_torch.ops.fused.flash_attention import (
        flash_attn_bwd_reference, flash_attn_reference)

    dev = "cuda"
    errs = {True: [0.0, 0.0], False: [0.0, 0.0]}   # wgmma?: [fwd, bwd]
    rows = {}
    for (label, b, sq, sk, hq, hk, d, causal, off, kv_len,
         timed) in HEADDIM_CASES:
        scale = d ** -0.5
        kv_len = sk if kv_len is None else kv_len
        off = kv_len - sq if off is None else off
        q, do = (torch.randn(b, sq, hq, d, generator=gen, device=dev)
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn(b, sk, hk, d, generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        fwd = lambda: flash_attention_cuda(  # noqa: E731
            q, k, v, causal, scale, off, kv_len, return_lse=True)
        bwd = lambda: flash_attention_bwd_cuda(  # noqa: E731
            q, k, v, out, lse, do, causal, scale, off, kv_len)
        plain_bwd = lambda: flash_attn_bwd_reference(  # noqa: E731
            q, k, v, out, lse, do, causal, scale, kv_len, off)
        out, lse = fwd()
        rout, rlse = flash_attn_reference(q, k, v, causal, scale, kv_len, off,
                                          return_lse=True)
        torch.cuda.synchronize()
        err = (out.float() - rout.float()).abs().max().item()
        check(math.isfinite(err) and err <= OUT_ATOL,
              f"flash fwd {label}: max |kernel - plain| = {err:.3e} <= "
              f"{OUT_ATOL}")
        rel = ((lse - rlse).abs() / rlse.abs().clamp_min(1.0)).max().item()
        check(rel <= STATS_RTOL, f"flash fwd {label} lse: max |diff| / "
                                 f"max(|ref|, 1) = {rel:.3e} <= {STATS_RTOL}")
        del rout, rlse
        wg = d in WGMMA_HEAD_DIMS
        errs[wg][0] = max(errs[wg][0], err)
        grads, refs = bwd(), plain_bwd()
        torch.cuda.synchronize()
        dv_peak = refs[2].float().abs().max().item()
        for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
            diff = (g.float() - r.float()).abs().max().item()
            peak = r.float().abs().max().item()
            if kv_len == 1 and name != "dv":
                peak, what = dv_peak, "max |dv| (dS = 0 exactly)"
            else:
                what = "max |plain|"
            check(math.isfinite(diff) and diff <= BWD_RTOL * peak,
                  f"flash bwd {label} {name}: max |kernel - plain| = "
                  f"{diff:.3e} = {diff / peak:.3e} of {what} <= {BWD_RTOL}")
            errs[wg][1] = max(errs[wg][1], diff)
        del refs
        if not timed:
            del q, k, v, do, out, lse, grads
            continue
        again = bwd()
        torch.cuda.synchronize()
        check(all(torch.equal(a, g) for a, g in zip(again, grads)),
              f"flash bwd {label}: a second run is bitwise equal")
        del again, grads
        fwd_ms = time_ms(torch, fwd, flush=flush)
        fwd_plain = time_ms(torch, lambda: flash_attn_reference(
            q, k, v, causal, scale, kv_len, off, return_lse=True), reps=3,
            flush=flush)
        bwd_ms = time_ms(torch, bwd, flush=flush)
        bwd_plain = time_ms(torch, plain_bwd, reps=3, flush=flush)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        with torch.no_grad():
            fwd_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), flush=flush)
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)
        dot = do.transpose(1, 2)
        bwd_lib = time_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), dot, retain_graph=True), flush=flush)
        pairs = b * sq * sk
        q_bytes, kv_bytes = 2 * b * sq * hq * d, 2 * b * sk * hk * d
        lse_bytes = 4 * b * hq * sq
        # forward: q, k, v in, out and lse back; backward: q, out, dout, k,
        # v and lse in, dq, dk and dv back
        f_ms, f_by = bound(4 * d * hq * pairs,
                           2 * q_bytes + 2 * kv_bytes + lse_bytes)
        b_ms, b_by = bound(10 * d * hq * pairs,
                           4 * q_bytes + 4 * kv_bytes + lse_bytes)
        print(f"  flash fwd {label} (with lse): {fwd_ms:.4f} ms (bound "
              f"{f_ms:.4f} ms by {f_by}, {f_ms / fwd_ms:.1%} of it), plain "
              f"{fwd_plain:.3f} ms, sdpa forward {fwd_lib:.4f} ms "
              f"({fwd_ms / fwd_lib:.2f}x sdpa); bwd {bwd_ms:.4f} ms (bound "
              f"{b_ms:.4f} ms by {b_by}, {b_ms / bwd_ms:.1%} of it), plain "
              f"{bwd_plain:.3f} ms, sdpa backward {bwd_lib:.4f} ms "
              f"({bwd_ms / bwd_lib:.2f}x sdpa)")
        if not rows:   # the first timed case: UNet level 1 at d = 32
            rows = {"flash_attention_mma": dict(
                        ms=fwd_ms, plain_ms=fwd_plain, bound_ms=f_ms,
                        bound_by=f_by, library_ms=fwd_lib),
                    "flash_attention_mma_bwd": dict(
                        ms=bwd_ms, plain_ms=bwd_plain, bound_ms=b_ms,
                        bound_by=b_by, library_ms=bwd_lib)}
        del q, k, v, do, out, lse, qt, kt, vt, sdpa_out
    rows["flash_attention_mma"]["max_abs_err"] = errs[False][0]
    rows["flash_attention_mma_bwd"]["max_abs_err"] = errs[False][1]
    return rows, errs[True][0], errs[True][1]


def print_mma_flash_ptxas():
    """ptxas's line and the SASS's local accesses of each head-dim flash
    kernel (per head dim, masked or not), and their dynamic shared
    memory."""
    import re

    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda.flash_attention import MMA_HEAD_DIMS

    pattern = re.compile(r"(flash_mma_(?:fwd|dkdv|dq|delta)_kernel)"
                         r"ILi(\d+)E(?:Lb([01])E)?")

    def label(m):
        masked = "" if m.group(3) is None else f", masked {m.group(3)}"
        return f"{m.group(1)}<{m.group(2)}{masked}>"

    print_ptxas(("flash_attention_mma",), pattern, label)
    smem = _build.load("flash_attention_mma").ptt_flash_mma_smem_bytes
    print("  head-dim flash kernels' dynamic shared memory (forward, dK/dV, "
          "dQ): " + ", ".join(f"d={d} {smem(d, 0)} / {smem(d, 1)} / "
                              f"{smem(d, 2)}" for d in MMA_HEAD_DIMS))


# masked flash cases of phase 3: (label, b, S, hq, hk, d), causal, each with
# an additive f32 mask [b, 1, S, S] (finite biases, -inf blocks, rows 100-103
# hidden whole), a bool mask [b, S, S] (rows 200-203 hidden) and packed
# segment ids (3-6 segments a row)
MASK_SHAPES = (("b=2 S=2048 heads 32/32 d=128", TRAIN_BATCH, TRAIN_SEQ, 32, 32,
                128),
               ("b=2 S=1000 GQA 16/4 d=64", 2, 1000, 16, 4, 64))
MASK_KINDS = ("additive f32 [b,1,S,S]", "bool [b,S,S]", "segments")


def packed_segments(torch, gen, b, s, device="cuda"):
    """int32 segment ids [b, s]: 3-6 segments a row, cut at random places,
    and the positions [b, s] restarting at each segment's start."""
    seg = torch.zeros(b, s, dtype=torch.int32, device=device)
    pos = torch.arange(s, device=device).repeat(b, 1)
    for i in range(b):
        n = int(torch.randint(3, 7, (1,), generator=gen, device=device))
        cuts = torch.randperm(s - 1, generator=gen, device=device)[:n - 1] + 1
        cuts = cuts.sort().values
        seg[i] = torch.searchsorted(cuts, torch.arange(s, device=device),
                                    right=True).int()
        starts = torch.cat([torch.zeros(1, dtype=cuts.dtype, device=device),
                            cuts])
        pos[i] -= starts[seg[i].long()]
    return seg, pos


def flash_mask_case(torch, gen, kind, b, s, device="cuda"):
    """The keyword arguments of one masked case and the ``[b, 1 | hq, S,
    S]`` bool map of the pairs it lets through (before the causal rule)."""
    if kind.startswith("additive"):
        mask = torch.randn(b, 1, s, s, generator=gen, device=device) * 2
        mask[..., 256:512, 128:384] = float("-inf")
        mask[..., 100:104, :] = float("-inf")
        return dict(attn_mask=mask), mask > float("-inf")
    if kind.startswith("bool"):
        mask = torch.rand(b, s, s, generator=gen, device=device) > 0.3
        mask[:, 200:204, :] = False
        return dict(attn_mask=mask), mask[:, None]
    seg, _ = packed_segments(torch, gen, b, s, device)
    return (dict(q_segment_ids=seg, kv_segment_ids=seg),
            seg[:, None, :, None] == seg[:, None, None, :])


def check_flash_masks(torch, gen, flush):
    """Masks and segment ids in the flash forward (out, lse) and backward
    (dq, dk, dv) against their plain versions at ``MASK_SHAPES``, with the
    unmasked tolerances; rows that see nothing give exact zeros, the empty
    lse and zero dq. Each case timed beside the unmasked kernels and SDPA
    given the same mask (a yardstick only); the bound counts the pairs the
    case lets through, and the mask and segment ids read once. Returns the
    max |kernel - plain| of the forward and of the backward."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    from paddle_tpu_torch.ops.fused.flash_attention import (
        EMPTY_ROW_LSE, flash_attention, flash_attn_bwd_reference,
        flash_attn_reference)

    dev, fwd_err, bwd_err = "cuda", 0.0, 0.0
    for label, b, S, hq, hk, d in MASK_SHAPES:
        scale = d ** -0.5
        q = torch.randn(b, S, hq, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, S, hk, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, S, hk, d, generator=gen, device=dev).bfloat16()
        do = torch.randn(b, S, hq, d, generator=gen, device=dev).bfloat16()
        causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
        out0, lse0 = flash_attention_cuda(q, k, v, True, scale, 0, S, True)
        u_fwd = time_ms(torch, lambda: flash_attention_cuda(
            q, k, v, True, scale, 0, S, True), flush=flush)
        u_bwd = time_ms(torch, lambda: flash_attention_bwd_cuda(
            q, k, v, out0, lse0, do, True, scale, 0, S), flush=flush)
        del out0, lse0
        qkv_bytes = 2 * b * (3 * S * hq * d + 2 * S * hk * d)   # q,o,dO,k,v
        for kind in MASK_KINDS:
            kw, lets = flash_mask_case(torch, gen, kind, b, S)
            what = f"flash {kind} {label}"
            fwd = lambda: flash_attention_cuda(  # noqa: E731
                q, k, v, True, scale, 0, S, True, **kw)
            out, lse = fwd()
            rout, rlse = flash_attn_reference(q, k, v, True, scale, S, 0,
                                              True, **kw)
            torch.cuda.synchronize()
            err = (out.float() - rout.float()).abs().max().item()
            check(math.isfinite(err) and err <= OUT_ATOL,
                  f"{what} fwd: max |kernel - plain| = {err:.3e} <= "
                  f"{OUT_ATOL}")
            rel = ((lse - rlse).abs() / rlse.abs().clamp_min(1.0)).max().item()
            check(rel <= STATS_RTOL, f"{what} lse: max |diff| / max(|ref|, "
                                     f"1) = {rel:.3e} <= {STATS_RTOL}")
            empty = rlse == EMPTY_ROW_LSE                       # [b, hq, S]
            rows = empty.transpose(1, 2)                        # [b, S, hq]
            check(bool((lse[empty] == EMPTY_ROW_LSE).all())
                  and bool((out[rows] == 0).all())
                  and (int(empty.sum()) > 0) == (kind != "segments"),
                  f"{what}: {int(empty.sum())} rows see nothing: out exactly "
                  f"0 and lse {EMPTY_ROW_LSE:.4e} there")
            fwd_err = max(fwd_err, err)
            del rout, rlse
            bwd = lambda: flash_attention_bwd_cuda(  # noqa: E731
                q, k, v, out, lse, do, True, scale, 0, S, **kw)
            grads = bwd()
            refs = flash_attn_bwd_reference(q, k, v, out, lse, do, True,
                                            scale, S, 0, **kw)
            torch.cuda.synchronize()
            for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
                diff = (g.float() - r.float()).abs().max().item()
                peak = r.float().abs().max().item()
                check(math.isfinite(diff) and diff <= BWD_RTOL * peak,
                      f"{what} bwd {name}: max |kernel - plain| = {diff:.3e}"
                      f" = {diff / peak:.3e} of max |plain| <= {BWD_RTOL}")
                bwd_err = max(bwd_err, diff)
            check(bool((grads[0][rows] == 0).all()),
                  f"{what}: dq exactly 0 on the rows that see nothing")
            del grads, refs
            ms, b_ms_ = time_ms(torch, fwd, flush=flush), \
                time_ms(torch, bwd, flush=flush)
            # SDPA given the same pairs: an additive mask as bf16, else bool
            if kind.startswith("additive"):
                sd_mask = kw["attn_mask"].masked_fill(~causal, float("-inf")
                                                      ).bfloat16()
            else:
                sd_mask = lets & causal
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            gqa = dict(enable_gqa=True) if hk != hq else {}
            with torch.no_grad():
                lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=sd_mask, **gqa), flush=flush)
            so = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sd_mask,
                                                **gqa)
            dot = do.transpose(1, 2)
            lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
                so, (qt, kt, vt), dot, retain_graph=True), flush=flush)
            del qt, kt, vt, so, sd_mask
            pairs = int((lets & causal).sum()) * (hq // lets.shape[1])
            extra = sum(t.numel() * t.element_size() for t in kw.values())
            f_ms, f_by = bound(4 * d * pairs, 2 * b * (2 * S * hq * d + 2 * S
                                                       * hk * d)
                               + 4 * b * hq * S + extra)
            g_ms, g_by = bound(10 * d * pairs, qkv_bytes + 4 * b * hq * S
                               + 2 * b * (S * hq * d + 2 * S * hk * d) + extra)
            print(f"  {what}: fwd+lse {ms:.4f} ms ({ms / u_fwd:.2f}x the "
                  f"unmasked {u_fwd:.4f}; bound {f_ms:.4f} by {f_by}, "
                  f"{f_ms / ms:.1%} of it; sdpa {lib_fwd:.4f}), bwd "
                  f"{b_ms_:.4f} ms ({b_ms_ / u_bwd:.2f}x the unmasked "
                  f"{u_bwd:.4f}; bound {g_ms:.4f} by {g_by}, "
                  f"{g_ms / b_ms_:.1%} of it; sdpa backward {lib_bwd:.4f}); "
                  f"{pairs / (b * hq * S * (S + 1) / 2):.1%} of the causal "
                  f"pairs seen")
            del out, lse, kw, lets
        if label.startswith("b=2 S=2048"):
            qg = q.detach().requires_grad_()
            op = host_us_per_call(torch, lambda: flash_attention(
                qg, k, v, causal=True))
            bare = host_us_per_call(torch, lambda: flash_attention_cuda(
                q, k, v, True, scale, 0, S, True))
            print(f"  flash host us a call at {label}: "
                  f"{op:.1f} through the paddle_tpu_torch::flash_fwd "
                  f"operator with grad, {bare:.1f} the bare wrapper")
            del qg
        del q, k, v, do, causal
    torch.cuda.empty_cache()
    return fwd_err, bwd_err


def check_fused_adamw(torch, gen):
    """The fused AdamW kernel against its plain version at the slice's
    parameter count and at an unaligned n = 1000, with GradScaler's
    found-inf flag: at 1 the launch must leave p, m and v bit for bit as
    they were, at 0 (and with no flag) it must match the plain version.
    The row's time is the launch with the flag at 0, the scaler's path."""
    from paddle_tpu_torch.ops.cuda.fused_adamw import (fused_adamw,
                                                       fused_adamw_reference)

    dev, hyper, step = "cuda", (3e-4, 0.9, 0.95, 1e-8, 0.1), 10
    flag0 = torch.zeros((), dtype=torch.int32, device=dev)
    flag1 = torch.ones((), dtype=torch.int32, device=dev)
    row, err_max = None, 0.0
    for n in (train_config(4).num_params(), 1000):
        p = torch.randn(n, generator=gen, device=dev)
        g = torch.randn(n, generator=gen, device=dev) * 1e-2
        m = torch.randn(n, generator=gen, device=dev) * 1e-3
        v = torch.rand(n, generator=gen, device=dev) * 1e-5
        before = [t.clone() for t in (p, m, v)]
        fused_adamw(p, g, m, v, *hyper, step, found_inf=flag1)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((p, m, v), before)),
              f"fused_adamw n={n} found_inf=1: p, m, v bit for bit as they "
              f"were")
        del before
        for flag in (flag0, None):
            refs = fused_adamw_reference(p, g, m, v, *hyper, step)
            q, mq, vq = p.clone(), m.clone(), v.clone()
            fused_adamw(q, g, mq, vq, *hyper, step, found_inf=flag)
            torch.cuda.synchronize()
            for name, a, r in zip(("p", "m", "v"), (q, mq, vq), refs):
                err = (a - r).abs().max().item()
                tol = ADAMW_TOL * max(r.abs().max().item(), 1.0)
                check(math.isfinite(err) and err <= tol,
                      f"fused_adamw n={n} found_inf="
                      f"{'0' if flag is not None else 'None'} {name}: max "
                      f"|kernel - plain| = {err:.3e} <= {tol:.3e}")
                err_max = max(err_max, err)
            del refs, q, mq, vq
        if row is None:
            ms = time_ms(torch, lambda: fused_adamw(p, g, m, v, *hyper, step,
                                                    found_inf=flag0))
            ms_none = time_ms(torch, lambda: fused_adamw(p, g, m, v, *hyper,
                                                         step))
            ms_skip = time_ms(torch, lambda: fused_adamw(
                p, g, m, v, *hyper, step, found_inf=flag1))
            plain = time_ms(torch, lambda: fused_adamw_reference(
                p, g, m, v, *hyper, step), reps=3)
            param = torch.nn.Parameter(p)
            param.grad = g
            opt = torch.optim.AdamW([param], lr=hyper[0],
                                    betas=hyper[1:3], eps=hyper[3],
                                    weight_decay=hyper[4], fused=True)
            lib = time_ms(torch, opt.step)
            del opt, param
            b_ms, b_by = bound(15 * n, 28 * n)
            print(f"  fused_adamw n={n}: {ms:.4f} ms at found_inf=0 (bound "
                  f"{b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of it), "
                  f"{ms_none:.4f} ms with no flag, {ms_skip:.4f} ms at "
                  f"found_inf=1 (skipped), plain {plain:.3f} ms, "
                  f"torch.optim.AdamW(fused=True) {lib:.4f} ms")
            row = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib)
        del p, g, m, v
    row["max_abs_err"] = err_max
    return row


def moe_config(layers=12):
    """``bench.py``'s MoE-Llama (``bench.py:216-233``) at ``layers``."""
    from paddle_tpu_torch.models import MoELlamaConfig

    return MoELlamaConfig(vocab_size=32000, hidden_size=1024,
                          intermediate_size=2816, num_hidden_layers=layers,
                          num_attention_heads=8, num_key_value_heads=8,
                          max_position_embeddings=MOE_SEQ, dtype="bfloat16",
                          moe_num_experts=8, moe_topk=2, moe_every=2,
                          moe_capacity_factor=2.0, aux_loss_alpha=0.01,
                          fused_loss=True)


def router_sizes(torch, gen):
    """Kept rows per expert of one ``GShardGate`` draw (bf16, seeded
    Xavier weights) over phase 8's 16384 tokens of unit-variance hidden
    states."""
    from paddle_tpu_torch.parallel import GShardGate

    cfg = moe_config()
    gate = GShardGate(cfg.hidden_size, cfg.moe_num_experts,
                      capacity_factor=cfg.moe_capacity_factor, device="cuda",
                      dtype=torch.bfloat16)
    x = torch.randn(MOE_BATCH * MOE_SEQ, cfg.hidden_size, generator=gen,
                    device="cuda").bfloat16()
    with torch.no_grad():
        idx, slot, _, _ = gate._route_sparse(x)
    kept = (slot < gate.capacity(x.shape[0])).int()
    return torch.zeros(cfg.moe_num_experts, dtype=torch.int32,
                       device="cuda").scatter_add_(0, idx.long(), kept)


def check_grouped_gemm(torch, gen, flush):
    """The three grouped-GEMM kernels against their plain versions at one
    MoE layer's products of phase 8 (M = 32768 routed rows, hidden 1024,
    intermediate 2816, 8 experts): gmm (the w2 forward, and the dlhs through
    w2 and w1 with ``transpose_rhs``, each orientation also with the other
    bias setting), tgmm (dW2, dW1) and the fused swiglu with its residuals,
    for a router draw's sizes (timed) and a skewed set with an empty group,
    an 8192-row group and trash rows. The kernels line sums each kernel's
    products of one layer: gmm 3, tgmm 2, swiglu 1."""
    from paddle_tpu_torch.ops.cuda.grouped_gemm import (
        gmm, gmm_reference, gmm_swiglu, gmm_swiglu_reference, tgmm,
        tgmm_reference)

    print_wgmma_ptxas()
    cfg = moe_config()
    d, h, E = cfg.hidden_size, cfg.intermediate_size, cfg.moe_num_experts
    M = 2 * MOE_BATCH * MOE_SEQ

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).bfloat16()

    w1, b1 = rnd(E, d, 2 * h, scale=d ** -0.5), rnd(E, 2 * h, scale=0.1)
    w2, b2 = rnd(E, h, d, scale=h ** -0.5), rnd(E, d, scale=0.1)
    bh = rnd(E, h, scale=0.1)
    xs, hs, dy, dh = rnd(M, d), rnd(M, h), rnd(M, d), rnd(M, 2 * h)
    sets = {"router draw": router_sizes(torch, gen),
            "skewed": torch.tensor([8192, 0, 4000, 4096, 3000, 4096, 4096,
                                    4000], dtype=torch.int32, device="cuda")}
    names = ("grouped_gemm", "grouped_gemm_tgmm", "grouped_gemm_swiglu")
    rows = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                    max_abs_err=0.0) for k in names}
    by = {k: set() for k in names}
    for label, sizes in sets.items():
        kept = int(sizes.sum())           # the host reads the sizes here only
        offs_host = [0] + torch.cumsum(sizes, 0).tolist()
        offs = torch.cumsum(sizes, 0, dtype=torch.int32)
        empty = [g for g in range(E) if offs_host[g + 1] == offs_host[g]]
        print(f"  grouped GEMM sizes ({label}): {sizes.tolist()}, "
              f"{M - kept} trash rows")

        def loop(fn):
            return lambda: [fn(g, offs_host[g], offs_host[g + 1])
                            for g in range(E)]

        # (row, label, kernel, plain, flops, bytes, library call, the
        #  per-group torch.matmul loop); library None: not timed
        products = [
            ("grouped_gemm", "gmm w2 forward + b2 [M,2816]x[8,2816,1024]",
             lambda: gmm(hs, w2, sizes, b2),
             lambda: gmm_reference(hs, w2, sizes, b2), 2 * kept * h * d,
             2 * (kept * h + E * h * d + E * d + M * d),
             lambda: torch._grouped_mm(hs, w2, offs=offs),
             loop(lambda g, a, b: hs[a:b] @ w2[g])),
            ("grouped_gemm", "gmm w2 forward, no bias", lambda: gmm(
                hs, w2, sizes), lambda: gmm_reference(hs, w2, sizes),
             0, 0, None, None),
            ("grouped_gemm", "gmm dlhs through w2 [M,1024]x[8,2816,1024]^T",
             lambda: gmm(dy, w2, sizes, None, True),
             lambda: gmm_reference(dy, w2, sizes, None, True),
             2 * kept * h * d, 2 * (kept * d + E * h * d + M * h),
             lambda: torch._grouped_mm(dy, w2.transpose(1, 2), offs=offs),
             loop(lambda g, a, b: dy[a:b] @ w2[g].t())),
            ("grouped_gemm", "gmm transpose_rhs + bias", lambda: gmm(
                dy, w2, sizes, bh, True),
             lambda: gmm_reference(dy, w2, sizes, bh, True), 0, 0, None,
             None),
            ("grouped_gemm", "gmm dlhs through w1 [M,5632]x[8,1024,5632]^T",
             lambda: gmm(dh, w1, sizes, None, True),
             lambda: gmm_reference(dh, w1, sizes, None, True),
             4 * kept * h * d, 2 * (2 * kept * h + 2 * E * h * d + M * d),
             lambda: torch._grouped_mm(dh, w1.transpose(1, 2), offs=offs),
             loop(lambda g, a, b: dh[a:b] @ w1[g].t())),
            ("grouped_gemm_tgmm", "tgmm dW2 [M,2816]^T x [M,1024]",
             lambda: tgmm(hs, dy, sizes),
             lambda: tgmm_reference(hs, dy, sizes), 2 * kept * h * d,
             2 * (kept * h + kept * d + E * h * d),
             lambda: torch._grouped_mm(hs.t(), dy, offs=offs),
             loop(lambda g, a, b: hs[a:b].t() @ dy[a:b])),
            ("grouped_gemm_tgmm", "tgmm dW1 [M,1024]^T x [M,5632]",
             lambda: tgmm(xs, dh, sizes),
             lambda: tgmm_reference(xs, dh, sizes), 4 * kept * h * d,
             2 * (kept * d + 2 * kept * h + 2 * E * h * d),
             lambda: torch._grouped_mm(xs.t(), dh, offs=offs),
             loop(lambda g, a, b: xs[a:b].t() @ dh[a:b])),
            ("grouped_gemm_swiglu", "swiglu [M,1024]x[8,1024,5632] + b1",
             lambda: gmm_swiglu(xs, w1, sizes, b1),
             lambda: gmm_swiglu_reference(xs, w1, sizes, b1),
             4 * kept * h * d,
             2 * (kept * d + 2 * E * d * h + 2 * E * h + 3 * M * h),
             lambda: swiglu_pair(torch._grouped_mm(xs, w1, offs=offs), h),
             loop(lambda g, a, b: swiglu_pair(xs[a:b] @ w1[g], h))),
        ]
        for row, what, fn, plain_fn, flops, nbytes, lib, per_group in \
                products:
            outs, refs = fn(), plain_fn()
            torch.cuda.synchronize()
            outs = outs if isinstance(outs, tuple) else (outs,)
            refs = refs if isinstance(refs, tuple) else (refs,)
            for i, (o, r) in enumerate(zip(outs, refs)):
                err = (o.float() - r.float()).abs().max().item()
                peak = r.float().abs().max().item()
                check(o.dtype == torch.bfloat16 and math.isfinite(err)
                      and err <= GG_RTOL * peak,
                      f"{what} ({label}) out {i}: max |kernel - plain| = "
                      f"{err:.3e} = {err / peak:.2e} of max |plain| <= "
                      f"{GG_RTOL}")
                rows[row]["max_abs_err"] = max(rows[row]["max_abs_err"],
                                               err)
                if row == "grouped_gemm_tgmm":
                    check(all(bool((o[g] == 0).all()) for g in empty),
                          f"{what} ({label}): dW of the empty groups "
                          f"{empty} exact zeros")
                else:
                    check(bool((o[kept:] == 0).all()),
                          f"{what} ({label}) out {i}: the {M - kept} trash "
                          f"rows exact zeros")
            if row == "grouped_gemm_swiglu":
                y_only = gmm_swiglu(xs, w1, sizes, b1, emit_residuals=False)
                check(bool((y_only[0] == outs[0]).all()),
                      f"swiglu ({label}) without residuals: the same y")
            if row == "grouped_gemm_tgmm":
                check(torch.equal(fn(), outs[0]),
                      f"{what} ({label}) run twice: bitwise equal")
            del outs, refs
            if label != "router draw" or not flops:
                continue
            ms = time_ms(torch, fn, flush=flush)
            plain = time_ms(torch, plain_fn, reps=3, flush=flush)
            loop_ms = time_ms(torch, per_group, flush=flush)
            lib_ms = None
            if lib is not None:
                try:
                    lib_ms = time_ms(torch, lib, flush=flush)
                except (RuntimeError, TypeError, AttributeError) as e:
                    print(f"    torch._grouped_mm refused it: {e}")
            b_ms, b_by = bound(flops, nbytes)
            by[row].add(b_by)
            ratio = "" if lib_ms is None else f" ({ms / lib_ms:.2f}x)"
            print(f"  {what}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
                  f"{b_ms / ms:.1%} of it), plain {plain:.3f} ms, "
                  f"torch._grouped_mm "
                  f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}"
                  f"{ratio}, per-group torch.matmul loop {loop_ms:.4f} ms")
            if row == "grouped_gemm_swiglu":
                split = kernel_split(torch, fn, ("swiglu_wgmma",))
                print(f"    by kernel (ms a call): {split}; wrapper "
                      f"{host_us_per_call(torch, fn):.1f} us a call on the "
                      f"host")
            r = rows[row]
            r["ms"] += ms
            r["plain_ms"] += plain
            r["bound_ms"] += b_ms
            r["library_ms"] = None if lib_ms is None or r["library_ms"] \
                is None else r["library_ms"] + lib_ms
    for k in names:
        rows[k]["bound_by"] = "bytes" if by[k] == {"bytes"} else "operations"
    # the swiglu yardstick is a product plus the activation: no one call
    rows["grouped_gemm_swiglu"]["library_ms"] = None
    for k in ("grouped_gemm", "grouped_gemm_tgmm"):
        r, lib = rows[k], rows[k]["library_ms"]
        if lib:
            print(f"  {k} sum: {r['ms']:.4f} ms, {r['bound_ms'] / r['ms']:.1%} "
                  f"of its bound, {r['ms'] / lib:.2f}x torch._grouped_mm "
                  f"({lib:.4f} ms)")
    torch.cuda.synchronize()
    del w1, b1, w2, b2, bh, xs, hs, dy, dh
    for k, err in check_grouped_gemm_edges(torch, gen).items():
        rows[k]["max_abs_err"] = max(rows[k]["max_abs_err"], err)
    return rows


def print_ptxas(sources, pattern, label):
    """Each kernel of ``sources`` whose mangled name matches ``pattern``:
    what ptxas reported (registers at entry, spills, any wgmma
    serialisation message) and the local-memory loads and stores in the
    built code (``cuobjdump -sass``: ptxas counts spills before a
    ``setmaxnreg`` budget applies); ``label`` names a match."""
    import re

    from paddle_tpu_torch.ops.cuda import _build

    for src in sources:
        name = None
        for line in (_build.ptxas_report(src) or "").splitlines():
            if "Compiling entry function" in line:
                m = pattern.search(line)
                name = None if m is None else label(m)
            elif name is not None and ("spill" in line or "registers" in line):
                print(f"  ptxas {name}: "
                      f"{line.replace('ptxas info    :', '').strip()}")
            if "Performance Loss" in line and pattern.search(line):
                # wgmma serialised; the message names its kernel
                what = re.split(r" (?:for|in) the function", line)[0]
                print(f"  ptxas {label(pattern.search(line))}: "
                      f"{what.split(':', 1)[1].strip()}")
        sass = _build.sass_local_accesses(_build.library_path(src))
        for symbol, (st, ld) in sass.items():
            m = pattern.search(symbol)
            if m is not None:
                print(f"  sass {label(m)}: {st} local stores, {ld} local "
                      f"loads")


def print_wgmma_ptxas():
    """What ptxas reported for each wgmma kernel (the gmm, tgmm and fused
    swiglu of ``csrc/grouped_gemm.cu``, the flash forward, dK/dV and dQ
    kernels), with the local-memory accesses in the built code, and the
    dynamic shared memory they launch with."""
    import re

    from paddle_tpu_torch.ops.cuda import _build

    pattern = re.compile(r"(t?gmm_wgmma_kernel|swiglu_wgmma_kernel|"
                         r"flash_fwd_kernel|flash_bwd_dkdv_kernel|"
                         r"flash_bwd_dq_kernel)"
                         r"(?:ILb([01])E|ILi(\d+)ELb([01])E|ILi(\d+)E)?")

    def label(m):
        if m.group(2) is not None:
            return f"{m.group(1)}<transpose_rhs {m.group(2)}>"
        if m.group(3) is not None:     # the flash kernels: <d, masked>
            return f"{m.group(1)}<{m.group(3)}, masked {m.group(4)}>"
        return m.group(1) + ("" if m.group(5) is None else f"<{m.group(5)}>")

    print_ptxas(("grouped_gemm", "flash_attention", "flash_attention_bwd"),
                pattern, label)
    smem = _build.load("grouped_gemm").ptt_wgmma_smem_bytes()
    fwd = _build.load("flash_attention").ptt_flash_fwd_smem_bytes
    bwd = _build.load("flash_attention_bwd").ptt_flash_bwd_smem_bytes
    print(f"  wgmma kernels' dynamic shared memory: gmm, tgmm and swiglu {smem} "
          f"bytes; flash forward {fwd(64)} / {fwd(128)} (d = 64 / 128), dK/dV "
          f"{bwd(64, 0)} / {bwd(128, 0)}, dQ {bwd(64, 1)} / {bwd(128, 1)}. "
          f"The producer warpgroups drop to 40 (grouped GEMMs) or 24 "
          f"(flash) registers and the consumers rise to 232 or 240 "
          f"(setmaxnreg)")


def print_ssm_ptxas():
    """ptxas's line and the SASS's local accesses of the scan forward, the
    log-depth scan's forward and backward (per I/O type and span), and
    of each chunk-parallel SSM kernel: the scan backward's three, the SSD
    forward's and backward's two each and the WKV forward's and backward's
    two each (per I/O type; the SSD's per head and state width, the WKV's
    per head width)."""
    import re

    pattern = re.compile(r"(scan_ld_fwd_kernel|scan_ld_bwd_kernel|"
                         r"scan_fwd_kernel|scan_bwd_local_kernel|"
                         r"scan_bwd_pass_kernel|scan_bwd_kernel|ssd_fwd_carry_kernel|"
                         r"ssd_fwd_chunk_kernel|ssd_bwd_carry_kernel|"
                         r"ssd_bwd_kernel|wkv_fwd_carry_kernel|"
                         r"wkv_fwd_chunk_kernel|wkv_bwd_carry_kernel|"
                         r"wkv_bwd_chunk_kernel)(I(f|13__nv_bfloat16)"
                         r"(?:Li(\d+)E(?:Li(\d+)E)?)?E)?")

    def label(m):
        if m.group(2) is None:
            return m.group(1)
        dt = "f32" if m.group(3) == "f" else "bf16"
        dims = "".join(f", {d}" for d in m.group(4, 5) if d is not None)
        return f"{m.group(1)}<{dt}{dims}>"

    print_ptxas(("selective_scan", "ssd", "wkv"), pattern, label)


def print_paged_ptxas():
    """ptxas's line and the SASS's local accesses of the paged decode
    kernel at the serving path's instantiations (d = 128, group 4, bf16
    and int8 pages)."""
    import re

    pattern = re.compile(r"(paged_kernel)ILi(128)ELi(4)E(13__nv_bfloat16|a)E")

    def label(m):
        kind = "bf16" if m.group(4) != "a" else "int8"
        return f"{m.group(1)}<{m.group(2)}, {m.group(3)}, {kind} pages>"

    print_ptxas(("paged_attention",), pattern, label)


def kernel_split(torch, fn, keys, reps=5):
    """Device ms per call of each kernel ``fn`` launches (``torch.profiler``,
    warm): those whose names hold one of ``keys`` by name, the others (the
    wrapper's sums of partials and casts) together."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out, rest = {}, 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0) / 1e3 / reps
        if t <= 0:
            continue
        m = re.search(r"\w*(?:%s)\w*" % "|".join(keys), e.key)
        if m is None:
            rest += t
        else:
            name = re.search(r"(\w+_kernel)", m.group(0))
            name = name.group(1) if name else m.group(0)
            out[name] = out.get(name, 0.0) + t
    if not out and rest == 0:
        return "not measured (the profiler recorded no device time)"
    return ", ".join(f"{k} {v:.4f}" for k, v in out.items()) \
        + f", the wrapper's sums and casts {rest:.4f} ms"


def sfu_floor_ms(exps):
    """The least ms for ``exps`` ex2 on the special-function units: 16 a
    clock on each of the 132 SMs at the card's top SM clock."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    return exps / (H100_SMS * SFU_EX2_PER_CLOCK * mhz * 1e6) * 1e3, mhz


def check_grouped_gemm_edges(torch, gen):
    """The three wgmma grouped GEMMs at their edges against their plain
    versions: M = 8200 rows in the ``GG_RAGGED`` groups (starts off every
    64- and 128-row boundary, a one-row group, an empty group, 2720 trash
    rows). gmm in both orientations with and without bias, and tgmm, at the
    MoE layer's w2 widths (K = 2816, N = 1024); the fused swiglu with and
    without its residuals at its widths (K = 1024, N = 2816); each also at
    an odd width (K = 1000, N = 520: multiples of 8, not of 64 or 128).
    Then NaN and inf in the trash rows (of lhs for gmm and the swiglu, of
    lhs and dout for tgmm): the kept rows and every dW equal the plain
    version's and, bit for bit, the NaN-free run's. Every output within
    ``GG_RTOL`` of max |plain|, trash rows and the empty group's dW exact
    zeros, tgmm and the swiglu twice bitwise equal, the swiglu's y without
    residuals bit for bit its y with them. Returns the largest |kernel -
    plain| per kernel row."""
    from paddle_tpu_torch.ops.cuda.grouped_gemm import (
        gmm, gmm_reference, gmm_swiglu, gmm_swiglu_reference, tgmm,
        tgmm_reference)

    M, E = GG_RAGGED_M, len(GG_RAGGED)
    sizes = torch.tensor(GG_RAGGED, dtype=torch.int32, device="cuda")
    kept = sum(GG_RAGGED)
    empty = [g for g, s in enumerate(GG_RAGGED) if s == 0]
    errs = {"grouped_gemm": 0.0, "grouped_gemm_tgmm": 0.0,
            "grouped_gemm_swiglu": 0.0}

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).bfloat16()

    def held(row, what, out, ref, same=None):
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        peak = ref.float().abs().max().item()
        zeros = [out[g] for g in empty] if row == "grouped_gemm_tgmm" \
            else [out[kept:]]
        check(math.isfinite(err) and err <= GG_RTOL * peak
              and all(bool((z == 0).all()) for z in zeros)
              and (same is None or torch.equal(out, same)),
              f"{what}: max |kernel - plain| = {err:.3e} = "
              f"{err / peak:.2e} of max |plain| <= {GG_RTOL}, "
              + ("empty-group dW" if row == "grouped_gemm_tgmm"
                 else f"the {M - kept} trash rows") + " exact zeros"
              + ("" if same is None else ", bitwise equal to the NaN-free "
                 "run"))
        errs[row] = max(errs[row], err)

    def poisoned(t):
        t = t.clone()
        t[kept::2] = float("nan")
        t[kept + 1::2] = float("inf")
        return t

    print(f"  grouped GEMM edges: M = {M}, sizes {list(GG_RAGGED)}")
    for label, K, N in (("layer widths", 2816, 1024), ("odd width", 1000,
                                                        520)):
        x, xt, dout = rnd(M, K), rnd(M, N), rnd(M, N)
        w = rnd(E, K, N, scale=K ** -0.5)
        bn, bk = rnd(E, N, scale=0.1), rnd(E, K, scale=0.1)
        for tr, lhs, bias in ((False, x, None), (False, x, bn),
                              (True, xt, None), (True, xt, bk)):
            held("grouped_gemm", f"gmm K={K} N={N} transpose_rhs={tr} "
                 f"bias={bias is not None} ({label})",
                 gmm(lhs, w, sizes, bias, tr),
                 gmm_reference(lhs, w, sizes, bias, tr))
        dw = tgmm(x, dout, sizes)
        held("grouped_gemm_tgmm", f"tgmm [{M},{K}]^T x [{M},{N}] ({label})",
             dw, tgmm_reference(x, dout, sizes))
        check(torch.equal(tgmm(x, dout, sizes), dw),
              f"tgmm ({label}) run twice: bitwise equal")
        xn, doutn = poisoned(x), poisoned(dout)
        for tr, lhs, lhs_n, bias in ((False, x, xn, bn),
                                     (True, xt, poisoned(xt), None)):
            held("grouped_gemm", f"gmm with NaN/inf trash rows, "
                 f"transpose_rhs={tr} ({label})",
                 gmm(lhs_n, w, sizes, bias, tr),
                 gmm_reference(lhs_n, w, sizes, bias, tr),
                 same=gmm(lhs, w, sizes, bias, tr))
        held("grouped_gemm_tgmm", f"tgmm with NaN/inf trash rows in lhs "
             f"and dout ({label})", tgmm(xn, doutn, sizes),
             tgmm_reference(xn, doutn, sizes), same=dw)
        del x, xt, dout, w, xn, doutn, dw
    for label, K, N in (("swiglu widths", 1024, 2816), ("odd width", 1000,
                                                         520)):
        x = rnd(M, K)
        w1, b1 = rnd(E, K, 2 * N, scale=K ** -0.5), rnd(E, 2 * N, scale=0.1)
        outs = gmm_swiglu(x, w1, sizes, b1)
        for name, o, r in zip("ygu", outs, gmm_swiglu_reference(x, w1, sizes,
                                                                b1)):
            held("grouped_gemm_swiglu", f"swiglu {name} [{M},{K}]x[{E},{K},"
                 f"{2 * N}] + b1 ({label})", o, r)
        y_only = gmm_swiglu(x, w1, sizes, b1, emit_residuals=False)
        again = gmm_swiglu(x, w1, sizes, b1)
        torch.cuda.synchronize()
        check(y_only[1] is None and torch.equal(y_only[0], outs[0]),
              f"swiglu ({label}) without residuals: y bit for bit y with "
              f"them")
        check(all(torch.equal(a, o) for a, o in zip(again, outs)),
              f"swiglu ({label}) run twice: bitwise equal")
        xn = poisoned(x)
        for name, o, r, same in zip(
                "ygu", gmm_swiglu(xn, w1, sizes, b1),
                gmm_swiglu_reference(xn, w1, sizes, b1), outs):
            held("grouped_gemm_swiglu", f"swiglu {name} with NaN/inf trash "
                 f"rows ({label})", o, r, same=same)
        del x, w1, b1, outs, y_only, again, xn
    return errs


SSM_B, SSM_L = 16, 1024          # phases 9 and 10: batch 16 x 1024 tokens


def mamba_config():
    """``bench.py``'s Mamba-130m (``bench.py:298-306``)."""
    from paddle_tpu_torch.models import MambaConfig

    return MambaConfig(vocab_size=32000, hidden_size=768,
                       num_hidden_layers=24, state_size=16,
                       conv_kernel=4, expand=2, scan_chunk=64,
                       dtype="bfloat16")


def rwkv_config():
    """``bench.py``'s RWKV-169m (``bench.py:401-405``)."""
    from paddle_tpu_torch.models import RwkvConfig

    return RwkvConfig(vocab_size=32000, hidden_size=768,
                      num_hidden_layers=12, head_dim=64, wkv_chunk=32,
                      wkv_subchunk=16, dtype="bfloat16")


def rel_err(a, ref):
    """``(max |a - ref|, max |a - ref| / max |ref|)`` in f32."""
    diff = (a.float() - ref.float()).abs().max().item()
    return diff, diff / max(ref.float().abs().max().item(), 1e-30)


def check_pair(what, outs, refs, names, tol):
    """Each kernel output against the plain version's within ``tol`` of
    max |plain|; returns the largest max |diff|."""
    worst = 0.0
    for name, a, r in zip(names, outs, refs):
        diff, rel = rel_err(a, r)
        check(math.isfinite(diff) and rel <= tol,
              f"{what} {name}: max |kernel - plain| / max |plain| = "
              f"{rel:.3e} <= {tol}")
        worst = max(worst, diff)
    return worst


def plain_vjp(torch, fn, ins, dy, dtype=None):
    """The plain version's forward and its autograd gradients in f32 (or
    ``dtype``)."""
    xs = [t.detach().to(dtype or torch.float32).requires_grad_() for t in ins]
    y = fn(*xs)
    return y.detach(), torch.autograd.grad(y, xs, dy.to(xs[0].dtype))


SCAN_CASES = (                   # b, l, d, n, strong decay
    (1, 1, 100, 5, False), (2, 63, 100, 5, False), (2, 64, 100, 16, False),
    (2, 65, 100, 5, True), (2, 150, 100, 5, False), (2, 1001, 200, 16, True))


def scan_inputs(torch, gen, b, l, d, n, dt, strong):
    """u, delta = softplus of seeded normals, A from the S4D init (-1 .. -n
    per channel), B, C and a cotangent dy. ``strong``: A = -1e4 on three
    channels and delta = 20 on a stretch of the sequence, so that
    exp(delta A) is exactly 0 in f32 there."""
    import torch.nn.functional as F

    dev = "cuda"
    u = torch.randn(b, l, d, generator=gen, device=dev).to(dt)
    delta = F.softplus(torch.randn(b, l, d, generator=gen, device=dev))
    A = -torch.arange(1, n + 1, dtype=torch.float32,
                      device=dev).expand(d, n).contiguous()
    if strong:
        A[:3] = -1e4
        delta[:, l // 3:l // 2 + 1] = 20.0
    B = torch.randn(b, l, n, generator=gen, device=dev).to(dt)
    C = torch.randn(b, l, n, generator=gen, device=dev).to(dt)
    dy = torch.randn(b, l, d, generator=gen, device=dev).to(dt)
    return (u, delta.to(dt), A, B, C), dy


def cancel_bc(B, C):
    """C with its last state set so that every step's B . C is about 1e-4 of
    its terms (computed in float64): y_t's and du_t's share from step t's
    own input is that sum times delta_t u_t (dy_t)."""
    C = C.clone()
    part = (B[..., :-1].double() * C[..., :-1].double()).sum(-1)
    C[..., -1] = (-part / B[..., -1].double() * (1 - 1e-4)).to(C.dtype)
    return C


def check_selective_scan(torch, gen, flush):
    """The scan's forward and backward kernels against their plain version
    at phase 9's shape (b16 l1024 d1536 n16; A from the S4D init, delta =
    softplus of seeded normals) in f32 I/O within SSM_F32_RTOL of the plain
    version evaluated in float64 (y sums n products that can cancel: at one
    step every channel's y is delta u times one sum C . B, and a draw whose
    sum nearly cancels puts an f32 sum of the rounded terms, the plain
    version's, far from float64 against max |y|; the kernels take that
    share from an exact dot; each f32 case prints the kernel's and the
    plain f32 version's y error against float64) and in the path's bf16
    within SSM_BF16_RTOL, the forward's chunk states too; and at
    the backward's edges (``SCAN_CASES``, each in f32 and bf16; the f32 step
    also with every B . C cancelling, ``cancel_bc``): one step, a
    chunk less one, one, one more, lengths off every tile, d = 100 and 200
    (off the 64-channel tile and the 128 channels of a partial; d = 100 in
    bf16 also off the forward's 16-byte rows), n = 5, and a strong decay
    (exp(delta A) = 0). The forward (y and the chunk states) and the
    backward twice at the path's shape, each bitwise equal. Timed in bf16,
    each split by kernel, with each wrapper's host µs a call; the bound
    counts the JAX audit's
    10 / 25 ops per (b, l, d, n) at the f32 non-tensor rate; beside it the
    special-function unit's floor for the exponentials (one per (b, l, d, n)
    forward, three backward)."""
    from paddle_tpu_torch.ops.cuda import selective_scan as ss

    names = ("du", "ddelta", "dA", "dB", "dC")
    rows, errs = {}, [0.0, 0.0]
    cases = [(*c, dt) for c in SCAN_CASES
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(SSM_B, SSM_L, 1536, 16, False, torch.float32),
              (SSM_B, SSM_L, 1536, 16, False, torch.bfloat16)]

    def held(what, ins, dy, dt):
        tol = SSM_F32_RTOL if dt == torch.float32 else SSM_BF16_RTOL
        y, bounds = ss.selective_scan_fwd(*ins)
        grads = ss.selective_scan_bwd(*ins, bounds, dy)
        torch.cuda.synchronize()
        ref_dt = torch.float64 if dt == torch.float32 else torch.float32
        with torch.no_grad():
            y_ref, b_ref = ss.selective_scan_reference(
                *(t.to(ref_dt) for t in ins), ss.KERNEL_CHUNK, True, ref_dt)
            if dt == torch.float32:
                y_f32 = ss.selective_scan_reference(*ins)
                peak = y_ref.abs().max().item()
                k64, p64 = ((t.double() - y_ref).abs().max().item() / peak
                            for t in (y, y_f32))
                print(f"  {what} y against float64: kernel {k64:.3e}, plain "
                      f"f32 {p64:.3e} of max |y|; kernel against plain f32 "
                      f"{rel_err(y, y_f32)[1]:.3e}")
                del y_f32
        errs[0] = max(errs[0], check_pair(
            what, (y.float(), bounds), (y_ref.to(dt), b_ref),
            ("y", "chunk states"), tol))
        _, g_ref = plain_vjp(torch, lambda *a: ss.selective_scan_reference(
            *a, ss.KERNEL_CHUNK, dtype=ref_dt), ins, dy, ref_dt)
        errs[1] = max(errs[1], check_pair(
            what, grads, [g.to(t.dtype) for g, t in zip(g_ref, ins)],
            names, tol))
        del y, grads, y_ref, b_ref, g_ref

    for b, l, d, n, strong, dt in cases:
        what = (f"selective scan b{b} l{l} d{d} n{n} {str(dt)[6:]}"
                + (" strong decay" if strong else ""))
        ins, dy = scan_inputs(torch, gen, b, l, d, n, dt, strong)
        held(what, ins, dy, dt)
        if l == 1 and dt == torch.float32:
            # the same draw with every step's B . C cancelling
            u, delta, A, B, C = ins
            held(what + " B . C cancels", (u, delta, A, B, cancel_bc(B, C)),
                 dy, dt)
    # timing at the path's shape and dtype (the last case)
    torch.cuda.empty_cache()
    ms = time_ms(torch, lambda: ss.selective_scan_fwd(*ins), flush=flush)
    y, bounds = ss.selective_scan_fwd(*ins)
    y2, bounds2 = ss.selective_scan_fwd(*ins)
    torch.cuda.synchronize()
    check(torch.equal(y, y2) and torch.equal(bounds, bounds2),
          f"selective scan forward b{b} l{l} d{d} n{n} run twice: y and the "
          f"chunk states bitwise equal")
    del y, y2, bounds2
    fwd_split = kernel_split(torch, lambda: ss.selective_scan_fwd(*ins),
                             ("scan_fwd_",))
    fwd_host = host_us_per_call(torch, lambda: ss.selective_scan_fwd(*ins))
    grads = ss.selective_scan_bwd(*ins, bounds, dy)
    again = ss.selective_scan_bwd(*ins, bounds, dy)
    torch.cuda.synchronize()
    check(all(torch.equal(a, r) for a, r in zip(again, grads)),
          f"selective scan backward b{b} l{l} d{d} n{n} run twice: bitwise "
          f"equal")
    del grads, again
    bwd_ms = time_ms(torch, lambda: ss.selective_scan_bwd(*ins, bounds, dy),
                     flush=flush)
    split = kernel_split(torch, lambda: ss.selective_scan_bwd(
        *ins, bounds, dy), ("scan_bwd_",))
    bwd_host = host_us_per_call(torch, lambda: ss.selective_scan_bwd(
        *ins, bounds, dy))
    xs = [t.float() for t in ins]
    with torch.no_grad():
        plain = time_ms(torch, lambda: ss.selective_scan_reference(*xs),
                        reps=3)
    xg = [t.requires_grad_() for t in xs]
    plain_both = time_ms(torch, lambda: torch.autograd.grad(
        ss.selective_scan_reference(*xg), xg, dy.float()), reps=3)
    nc = -(-l // ss.KERNEL_CHUNK)
    io = 2                                   # bf16 bytes per element
    fwd_bytes = (3 * b * l * d * io + 2 * b * l * n * io + 4 * d * n
                 + 4 * b * nc * n * d)
    bwd_bytes = (5 * b * l * d * io + 4 * b * l * n * io + 8 * d * n
                 + 4 * b * nc * n * d)
    for key, t, plain_t, ops, nbytes, exps in (
            ("selective_scan", ms, plain, 10, fwd_bytes, 1),
            ("selective_scan_bwd", bwd_ms, plain_both - plain, 25,
             bwd_bytes, 3)):
        b_ms, b_by = bound(ops * b * l * d * n, nbytes, F32_FLOP_PER_S)
        sfu, mhz = sfu_floor_ms(exps * b * l * d * n)
        print(f"  {key} (b{b} l{l} d{d} n{n}, bf16): {t:.4f} ms (bound "
              f"{b_ms:.4f} ms by {b_by} at 67 TFLOP/s f32 and 3.35 TB/s, "
              f"{b_ms / t:.1%} of it; special-function floor {sfu:.4f} ms "
              f"for {exps} ex2 per (b, l, d, n) at 16 a clock on 132 SMs, "
              f"{mhz:.0f} MHz), plain {plain_t:.3f} ms, library: none")
        rows[key] = dict(ms=t, plain_ms=plain_t, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None)
    print(f"  selective_scan by kernel (ms a call): {fwd_split}; wrapper "
          f"{fwd_host:.1f} us a call on the host")
    print(f"  selective_scan_bwd by kernel (ms a call): {split}; wrapper "
          f"{bwd_host:.1f} us a call on the host")
    print(f"  (plain fwd + bwd {plain_both:.3f} ms; the backward's plain ms "
          f"is that minus the forward's)")
    rows["selective_scan"]["max_abs_err"] = errs[0]
    rows["selective_scan_bwd"]["max_abs_err"] = errs[1]
    return rows


# phase 3: the log-depth scan (FLAGS_mamba_logdepth_scan) at its spans' edges
LOGDEPTH_CASES = (               # b, l, d, n, span, strong decay
    (1, 1, 100, 5, 8, False), (2, 65, 100, 16, 16, False),
    (2, 150, 200, 5, 64, True), (2, 100, 100, 16, 32, False),
    (1, 64, 72, 16, 8, True), (2, 1001, 200, 16, 64, False))


def check_selective_scan_logdepth(torch, gen, flush, seq_rows):
    """The log-depth scan's forward (y, the state entering each span) and
    backward (du, ddelta, dA, dB, dC) kernels against their plain versions
    (the transcriptions of JAX's ``logdepth=True`` bodies) by the
    sequential scan's gates: f32 I/O within SSM_F32_RTOL of the plain
    version in float64, bf16 I/O within SSM_BF16_RTOL of it in f32; at
    phase 9's shape (b16 l1024 d1536 n16, span 64) and at the spans' edges
    (``LOGDEPTH_CASES``: one step, lengths off the span, spans 8, 16, 32 and
    64, d = 72, 100 and 200, n = 5 and 16, a strong decay, and, for span
    32, every step's B . C cancelling), each in f32 and bf16; the forward
    and backward twice at the path's shape, bitwise equal. Timed in bf16
    beside the sequential kernels at the same shape; the bound is the
    sequential scan's (the same function: 10 / 25 ops per (b, l, d, n) at
    the f32 non-tensor rate, the same bytes)."""
    from paddle_tpu_torch.ops.cuda import selective_scan as ss

    names = ("du", "ddelta", "dA", "dB", "dC")
    rows, errs = {}, [0.0, 0.0]
    cases = [(*c, dt) for c in LOGDEPTH_CASES
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(SSM_B, SSM_L, 1536, 16, 64, False, torch.float32),
              (SSM_B, SSM_L, 1536, 16, 64, False, torch.bfloat16)]

    def held(what, ins, dy, dt, span):
        tol = SSM_F32_RTOL if dt == torch.float32 else SSM_BF16_RTOL
        y, bounds = ss.selective_scan_logdepth_fwd(*ins, span)
        grads = ss.selective_scan_logdepth_bwd(*ins, bounds, dy, span)
        torch.cuda.synchronize()
        ref_dt = torch.float64 if dt == torch.float32 else torch.float32
        with torch.no_grad():
            xs = [t.to(ref_dt) for t in ins]
            y_ref, b_ref = ss.selective_scan_logdepth_reference(*xs, span,
                                                                ref_dt)
            g_ref = ss.selective_scan_logdepth_bwd_reference(
                *xs, b_ref, dy.to(ref_dt), span, ref_dt)
        errs[0] = max(errs[0], check_pair(
            what, (y.float(), bounds), (y_ref.to(dt), b_ref),
            ("y", "span states"), tol))
        errs[1] = max(errs[1], check_pair(
            what, grads, [g.to(t.dtype) for g, t in zip(g_ref, ins)], names,
            tol))
        del y, bounds, grads, y_ref, b_ref, g_ref, xs

    for b, l, d, n, span, strong, dt in cases:
        what = (f"log-depth scan span {span} b{b} l{l} d{d} n{n} "
                f"{str(dt)[6:]}" + (" strong decay" if strong else ""))
        ins, dy = scan_inputs(torch, gen, b, l, d, n, dt, strong)
        held(what, ins, dy, dt, span)
        if span == 32 and dt == torch.float32:
            u, delta, A, B, C = ins
            held(what + " B . C cancels", (u, delta, A, B, cancel_bc(B, C)),
                 dy, dt, span)
    torch.cuda.empty_cache()
    span = 64
    ms = time_ms(torch, lambda: ss.selective_scan_logdepth_fwd(*ins, span),
                 flush=flush)
    y, bounds = ss.selective_scan_logdepth_fwd(*ins, span)
    y2, bounds2 = ss.selective_scan_logdepth_fwd(*ins, span)
    grads = ss.selective_scan_logdepth_bwd(*ins, bounds, dy, span)
    again = ss.selective_scan_logdepth_bwd(*ins, bounds, dy, span)
    torch.cuda.synchronize()
    check(torch.equal(y, y2) and torch.equal(bounds, bounds2)
          and all(torch.equal(a, r) for a, r in zip(again, grads)),
          f"log-depth scan b{b} l{l} d{d} n{n} run twice: forward and "
          f"backward bitwise equal")
    del y, y2, bounds2, grads, again
    bwd_ms = time_ms(torch, lambda: ss.selective_scan_logdepth_bwd(
        *ins, bounds, dy, span), flush=flush)
    xs = [t.float() for t in ins]
    with torch.no_grad():
        _, b32 = ss.selective_scan_logdepth_reference(*xs, span)
        plain = time_ms(torch, lambda: ss.selective_scan_logdepth_reference(
            *xs, span), reps=3)
        plain_bwd = time_ms(
            torch, lambda: ss.selective_scan_logdepth_bwd_reference(
                *xs, b32, dy.float(), span), reps=3)
    del xs, b32
    nc = -(-l // span)
    io = 2                                   # bf16 bytes per element
    fwd_bytes = (3 * b * l * d * io + 2 * b * l * n * io + 4 * d * n
                 + 4 * b * nc * n * d)
    bwd_bytes = (5 * b * l * d * io + 4 * b * l * n * io + 8 * d * n
                 + 4 * b * nc * n * d)
    for key, seq, t, plain_t, ops, nbytes in (
            ("selective_scan_logdepth", "selective_scan", ms, plain, 10,
             fwd_bytes),
            ("selective_scan_logdepth_bwd", "selective_scan_bwd", bwd_ms,
             plain_bwd, 25, bwd_bytes)):
        b_ms, b_by = bound(ops * b * l * d * n, nbytes, F32_FLOP_PER_S)
        print(f"  {key} (b{b} l{l} d{d} n{n}, span {span}, bf16): {t:.4f} "
              f"ms (bound {b_ms:.4f} ms by {b_by}, {b_ms / t:.1%} of it), "
              f"the sequential kernel {seq_rows[seq]['ms']:.4f} ms "
              f"({t / seq_rows[seq]['ms']:.2f}x), plain {plain_t:.3f} ms, "
              f"library: none")
        rows[key] = dict(ms=t, plain_ms=plain_t, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None)
    rows["selective_scan_logdepth"]["max_abs_err"] = errs[0]
    rows["selective_scan_logdepth_bwd"]["max_abs_err"] = errs[1]
    return rows


WKV_CASES = (                    # b, l, h, d, strong decay, logw >= 0
    (2, 1, 3, 64, False, False), (2, 15, 1, 64, False, True),
    (2, 16, 3, 64, True, False), (1, 17, 13, 64, True, True),
    (2, 63, 3, 64, False, True), (2, 64, 1, 64, True, False),
    (2, 65, 3, 64, True, True), (2, 150, 13, 64, False, False),
    (1, 1001, 3, 64, True, True), (2, 1, 1, 128, False, True),
    (2, 17, 3, 128, True, True), (2, 33, 13, 128, False, False),
    (1, 150, 3, 128, True, False), (1, 1001, 1, 128, False, True))


def wkv_inputs(torch, gen, b, l, h, d, dt, strong, clamp, ramp=None):
    """r, k, v (0.5 x seeded normals), logw (``ramp``: the model's decay
    ramp through ``rwkv_log_decay``; else uniform in -5.02 .. -0.02), the
    bonus 0.5 plus noise and a cotangent dy. ``strong``: logw = -1e10 (w =
    0) on five channels; ``clamp``: logw = 0, 0.5 and 2 on three channels,
    whose dlogw must be exactly 0."""
    from paddle_tpu_torch.ops.fused.rwkv import rwkv_log_decay

    dev = "cuda"
    r, k, v = (0.5 * torch.randn(b, l, h, d, generator=gen, device=dev)
               for _ in range(3))
    if ramp is not None:
        logw = rwkv_log_decay(ramp.expand(h, d).bfloat16()).float()
    else:
        logw = -5 * torch.rand(h, d, generator=gen, device=dev) - 0.02
    if strong:
        logw[0, :3] = -1e10
        logw[-1, -2:] = -1e10
    if clamp:
        logw[0, 3:6] = torch.tensor([0.0, 0.5, 2.0], device=dev)
    u = 0.5 + 0.1 * torch.randn(h, d, generator=gen, device=dev)
    dy = torch.randn(b, l, h, d, generator=gen, device=dev).to(dt)
    return (r.to(dt), k.to(dt), v.to(dt), logw.contiguous(), u), dy


def check_wkv(torch, gen, flush):
    """The WKV forward and backward kernels against their plain version at
    phase 10's shape (b16 l1024 h12 d64; logw from the model's decay ramp
    through ``rwkv_log_decay``, the bonus 0.5 plus noise), in f32 I/O within
    SSM_F32_RTOL and in the path's bf16 within SSM_BF16_RTOL; and at the
    chunk-parallel kernels' edges (``WKV_CASES``, each in f32 and bf16):
    one step, a sub-chunk less one, one, one more, a chunk less one, one,
    one more, lengths off every chunk (150, 1001), d = 64 and 128 (chunks
    of 64 and 32), 1, 3 and 13 heads, a strong decay (logw = -1e10, w = 0)
    and logw >= 0 on three channels (dlogw exactly 0 there). Every case
    checks all outputs for finite values. The forward and the backward twice
    at the path's shape, bitwise equal; each split by kernel, with its
    wrapper's host µs a call. Timed in bf16; the bound is the JAX audit's 2 b h
    l (c + 2d) d operations (c = 64, the JAX route's kernel chunk at b >=
    16; x 3 for the backward) at 989 TFLOP/s against the bytes."""
    from paddle_tpu_torch.ops.cuda import wkv as wk

    dev = "cuda"
    names = ("dr", "dk", "dv", "dlogw", "du")
    hd = 64
    ramp = torch.tensor([-6.0 + 5.0 * (i / (hd - 1)) ** 0.7
                         for i in range(hd)], device=dev)
    rows, errs = {}, [0.0, 0.0]
    types = (torch.float32, torch.bfloat16)
    cases = [(*c, dt, False) for c in WKV_CASES for dt in types]
    cases += [(SSM_B, SSM_L, 12, hd, False, False, dt, True) for dt in types]
    for b, l, h, d, strong, clamp, dt, path in cases:
        tol = SSM_F32_RTOL if dt == torch.float32 else SSM_BF16_RTOL
        what = (f"wkv b{b} l{l} h{h} d{d} {str(dt)[6:]}"
                + (" strong decay" if strong else "")
                + (" logw >= 0" if clamp else ""))
        ins, dy = wkv_inputs(torch, gen, b, l, h, d, dt, strong, clamp,
                             ramp if path else None)
        y = wk.wkv_fwd(*ins)
        grads = wk.wkv_bwd(*ins, dy)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t.float()).all())
                  for t in (y, *grads)),
              f"{what}: y and every gradient finite")
        if clamp:
            check(bool((grads[3][0, 3:6] == 0).all()),
                  f"{what}: dlogw exactly 0 where logw >= 0")
        y_ref, g_ref = plain_vjp(torch, wk.wkv_reference, ins, dy)
        errs[0] = max(errs[0], check_pair(what, (y,),
                                          (y_ref.to(dt),), ("y",), tol))
        errs[1] = max(errs[1], check_pair(
            what, grads, [g.to(t.dtype) for g, t in zip(g_ref, ins)],
            names, tol))
        del y, grads, y_ref, g_ref
    # timing at the path's shape and dtype (the last case)
    torch.cuda.empty_cache()
    y, again = wk.wkv_fwd(*ins), wk.wkv_fwd(*ins)
    torch.cuda.synchronize()
    check(torch.equal(y, again),
          f"wkv forward b{b} l{l} h{h} d{d} run twice: bitwise equal")
    grads = wk.wkv_bwd(*ins, dy)
    again = wk.wkv_bwd(*ins, dy)
    torch.cuda.synchronize()
    check(all(torch.equal(a, r) for a, r in zip(again, grads)),
          f"wkv backward b{b} l{l} h{h} d{d} run twice: bitwise equal")
    del y, grads, again
    ms = time_ms(torch, lambda: wk.wkv_fwd(*ins), flush=flush)
    bwd_ms = time_ms(torch, lambda: wk.wkv_bwd(*ins, dy), flush=flush)
    fwd_split = kernel_split(torch, lambda: wk.wkv_fwd(*ins), ("wkv_fwd_",))
    fwd_host = host_us_per_call(torch, lambda: wk.wkv_fwd(*ins))
    split = kernel_split(torch, lambda: wk.wkv_bwd(*ins, dy), ("wkv_bwd_",))
    host = host_us_per_call(torch, lambda: wk.wkv_bwd(*ins, dy))
    xs = [t.float() for t in ins]
    with torch.no_grad():
        plain = time_ms(torch, lambda: wk.wkv_reference(*xs), reps=3)
    xg = [t.requires_grad_() for t in xs]
    plain_both = time_ms(torch, lambda: torch.autograd.grad(
        wk.wkv_reference(*xg), xg, dy.float()), reps=3)
    flops = 2 * b * h * l * (64 + 2 * d) * d
    act = b * l * h * d * 2                  # one bf16 [b, l, h, d] tensor
    for key, t, plain_t, ops, nbytes in (
            ("wkv", ms, plain, flops, 4 * act + 8 * h * d),
            ("wkv_bwd", bwd_ms, plain_both - plain, 3 * flops,
             7 * act + 16 * h * d)):
        b_ms, b_by = bound(ops, nbytes)
        print(f"  {key} (b{b} l{l} h{h} d{d}, bf16): {t:.4f} ms (bound "
              f"{b_ms:.4f} ms by {b_by}, {b_ms / t:.1%} of it), plain "
              f"{plain_t:.3f} ms, library: none")
        rows[key] = dict(ms=t, plain_ms=plain_t, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None)
    print(f"  wkv by kernel (ms a call): {fwd_split}; wrapper {fwd_host:.1f} "
          f"us a call on the host")
    print(f"  wkv_bwd by kernel (ms a call): {split}; wrapper {host:.1f} us "
          f"a call on the host")
    print(f"  (plain fwd + bwd {plain_both:.3f} ms; the backward's plain ms "
          f"is that minus the forward's)")
    rows["wkv"]["max_abs_err"] = errs[0]
    rows["wkv_bwd"]["max_abs_err"] = errs[1]
    return rows


MAMBA2_B, MAMBA2_L = 8, 1024     # phase 11: batch 8 x 1024 tokens


def mamba2_config():
    """``bench.py``'s Mamba-2 (``bench.py:370-372``)."""
    from paddle_tpu_torch.models import Mamba2Config

    return Mamba2Config(vocab_size=32000, hidden_size=768,
                        num_hidden_layers=24, state_size=64, head_dim=64,
                        ssd_chunk=128, dtype="bfloat16")


def ssd_inputs(torch, gen, b, l, h, dh, ds, dt_io, strong):
    """x, B and C as the model hands them over (strided views of one conv
    output ``[b, l, h dh + 2 ds]``), dt = softplus of normals, A from the
    model's init ``-linspace(1, 16, h)``, D and a cotangent dy. ``strong``:
    A = -16 on head 0 and dt = 10 on a quarter of the sequence, so that
    a_t = exp(A dt) is exactly 0 in f32."""
    import torch.nn.functional as F

    dev = "cuda"
    xc = torch.randn(b, l, h * dh + 2 * ds, generator=gen,
                     device=dev).to(dt_io)
    x = xc[..., :h * dh].unflatten(-1, (h, dh))
    B, C = xc[..., h * dh:h * dh + ds], xc[..., h * dh + ds:]
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device=dev))
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    if strong:
        A[0] = -16.0
        dt[:, l // 4:l // 2] = 10.0
    D = torch.randn(h, generator=gen, device=dev)
    dy = torch.randn(b, l, h, dh, generator=gen, device=dev).to(dt_io)
    return (x, dt.to(dt_io), A.to(dt_io), B, C, D.to(dt_io)), dy


SSD_CASES = (                    # b, l, h, dh, ds, I/O type, strong decay
    (2, 1, 3, 64, 64, "f32", False), (2, 63, 3, 64, 64, "f32", False),
    (1, 64, 7, 64, 64, "bf16", False), (2, 65, 4, 64, 64, "f32", False),
    (2, 65, 4, 64, 64, "bf16", True), (2, 150, 3, 64, 128, "f32", False),
    (2, 150, 3, 64, 128, "bf16", True), (1, 100, 2, 128, 64, "f32", False),
    (1, 77, 2, 128, 128, "f32", False), (1, 77, 2, 128, 128, "bf16", True),
    (2, 300, 4, 64, 64, "bf16", True), (1, 1001, 13, 64, 64, "f32", False),
    (1, 1001, 13, 64, 64, "bf16", True))
# A strong decay is held in bf16 only: there (log a = -160 a step) the f32
# plain version's own chunk cumsums lose ~1e-4 in exp(cum_j - cum_i), and
# its dA lies 2.6e-4 of max |dA| from a float64 evaluation.


def check_ssd(torch, gen, flush):
    """The SSD forward (y, the chunk states) and backward (dx, ddt, dA, dB,
    dC, dD) kernels against their plain version ``ssd_chunked_reference``
    at phase 11's shape (b8 l1024 h24 dh64 ds64, x, B and C strided as the
    model's), in f32 I/O within SSM_F32_RTOL of the plain version evaluated
    in float64 (its f32 evaluation's own dA lies up to 3.3e-4 of max |dA|
    from float64 at these edges: dA sums the chunks' reverse cumsums, which
    cancel) and in the path's bf16 within SSM_BF16_RTOL; and at the chunk-parallel kernels' edges (``SSD_CASES``):
    one step, a chunk less one, one, one more, lengths off every chunk (150,
    1001), head counts off the groups of 12, every (dh, ds) in {64, 128}^2
    (chunk 32 but at 64 x 64), a strong decay (a_t = 0 exactly, bf16).
    Every case checks all outputs for finite values. The forward and the
    backward twice at the path's shape, bitwise equal. Timed in bf16, each
    split by kernel, with the wrapper's host µs of the forward; the bound
    counts the bytes each input and output moves once, with the f32 chunk
    states at the reference route's chunk c = 128 whatever the kernel's own,
    against the JAX audit's 2 b h l (c + 2 ds) dh operations (x 3 for the
    backward) at 989 TFLOP/s."""
    from paddle_tpu_torch.ops.cuda import ssd

    names = ("dx", "ddt", "dA", "dB", "dC", "dD")
    rows, errs = {}, [0.0, 0.0]
    b, l, h, dh, ds = MAMBA2_B, MAMBA2_L, 24, 64, 64
    types = {"f32": torch.float32, "bf16": torch.bfloat16}
    cases = [(*c[:5], types[c[5]], c[6]) for c in SSD_CASES]
    cases += [(b, l, h, dh, ds, torch.float32, False),
              (b, l, h, dh, ds, torch.bfloat16, False)]
    for cb, cl, ch, cdh, cds, dt_io, strong in cases:
        tol = SSM_F32_RTOL if dt_io == torch.float32 else SSM_BF16_RTOL
        what = (f"ssd b{cb} l{cl} h{ch} dh{cdh} ds{cds} {str(dt_io)[6:]}"
                + (" strong decay" if strong else ""))
        ins, dy = ssd_inputs(torch, gen, cb, cl, ch, cdh, cds, dt_io, strong)
        y, states = ssd.ssd_fwd(*ins)
        grads = ssd.ssd_bwd(*ins, states, dy)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t.float()).all())
                  for t in (y, states, *grads)),
              f"{what}: y, the states and every gradient finite")
        chunk = ssd.kernel_chunk(cdh, cds)
        ref_dt = torch.float64 if dt_io == torch.float32 else torch.float32
        with torch.no_grad():
            y_ref, s_ref = ssd.ssd_chunked_reference(
                *(t.to(ref_dt) for t in ins), chunk, True)
        errs[0] = max(errs[0], check_pair(
            what, (y.float(), states), (y_ref.to(dt_io), s_ref),
            ("y", "chunk states"), tol))
        _, g_ref = plain_vjp(torch, lambda *a: ssd.ssd_chunked_reference(
            *a, chunk), ins, dy, ref_dt)
        errs[1] = max(errs[1], check_pair(
            what, grads, [g.to(t.dtype) for g, t in zip(g_ref, ins)],
            names, tol))
        del y, states, grads, y_ref, s_ref, g_ref
    # timing at the path's shape and dtype (the last case)
    torch.cuda.empty_cache()
    y, states = ssd.ssd_fwd(*ins)
    y2, states2 = ssd.ssd_fwd(*ins)
    torch.cuda.synchronize()
    check(torch.equal(y, y2) and torch.equal(states, states2),
          f"ssd forward b{b} l{l} h{h} run twice: y and states bitwise equal")
    del y, y2, states2
    ms = time_ms(torch, lambda: ssd.ssd_fwd(*ins), flush=flush)
    fwd_split = kernel_split(torch, lambda: ssd.ssd_fwd(*ins), ("ssd_fwd_",))
    host = host_us_per_call(torch, lambda: ssd.ssd_fwd(*ins))
    grads = ssd.ssd_bwd(*ins, states, dy)
    again = ssd.ssd_bwd(*ins, states, dy)
    torch.cuda.synchronize()
    check(all(torch.equal(a, r) for a, r in zip(again, grads)),
          f"ssd backward b{b} l{l} h{h} run twice: bitwise equal")
    del grads, again
    bwd_ms = time_ms(torch, lambda: ssd.ssd_bwd(*ins, states, dy),
                     flush=flush)
    split = kernel_split(torch, lambda: ssd.ssd_bwd(*ins, states, dy),
                         ("ssd_bwd_",))
    xs = [t.float() for t in ins]
    with torch.no_grad():
        plain = time_ms(torch, lambda: ssd.ssd_chunked_reference(*xs),
                        reps=3)
    xg = [t.requires_grad_() for t in xs]
    plain_both = time_ms(torch, lambda: torch.autograd.grad(
        ssd.ssd_chunked_reference(*xg), xg, dy.float()), reps=3)
    # the function's work, whatever the kernel's own chunk: the residual
    # and the products at the reference route's chunk (the model's
    # ssd_chunk, 128)
    chunk = mamba2_config().ssd_chunk
    nc = -(-l // chunk)
    io = 2                                   # bf16 bytes per element
    act = b * l * h * dh * io                # x, y, dy or dx
    seq = b * l * h * io + 2 * b * l * ds * io + 8 * h   # dt, B, C, A, D
    st = b * nc * h * dh * ds * 4            # the f32 chunk states
    flops = 2 * b * h * l * (chunk + 2 * ds) * dh
    for key, t, plain_t, ops, nbytes in (
            ("ssd", ms, plain, flops, 2 * act + seq + st),
            ("ssd_bwd", bwd_ms, plain_both - plain, 3 * flops,
             3 * act + 2 * seq + st)):
        b_ms, b_by = bound(ops, nbytes)
        print(f"  {key} (b{b} l{l} h{h} dh{dh} ds{ds}, bound at chunk "
              f"{chunk}, bf16): {t:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
              f"{b_ms / t:.1%} of it), plain {plain_t:.3f} ms, library: none")
        rows[key] = dict(ms=t, plain_ms=plain_t, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None)
    print(f"  ssd by kernel (ms a call): {fwd_split}; wrapper {host:.1f} us "
          f"a call on the host")
    print(f"  ssd_bwd by kernel (ms a call): {split}")
    print(f"  (plain fwd + bwd {plain_both:.3f} ms; the backward's plain ms "
          f"is that minus the forward's)")
    rows["ssd"]["max_abs_err"] = errs[0]
    rows["ssd_bwd"]["max_abs_err"] = errs[1]
    return rows


def swiglu_pair(h2, n):
    """``silu(gate) * up`` of ``h2 = [gate | up]``: the swiglu yardstick's
    activation after its product."""
    import torch.nn.functional as F

    return F.silu(h2[:, :n]) * h2[:, n:]


def phase_slice(torch, seed):
    print("== phase 4: Llama-3-8B through the serving engine")
    import numpy as np

    from paddle_tpu_torch.core.device import make_generator
    from paddle_tpu_torch.models import LLAMA_PRESETS, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = LLAMA_PRESETS["llama3-8b"]
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    print(f"  model: {cfg.num_params() / 1e9:.2f} B params, {L} layers, "
          f"built in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(model, ServingConfig(max_seq_len=2048))
    torch.cuda.synchronize()
    print(f"  engine: fused weights + pool {engine.pool.k_pages.shape} "
          f"x2; peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    reset_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, NEW_TOKENS) for p in prompts]
    engine.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    flash_n, paged_n = counts["flash_attention"], counts["paged_attention"]
    s = engine.stats()

    for r in reqs:
        check(r.status == "finished" and len(r.tokens) == NEW_TOKENS
              and all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"{r.rid} (prompt {r.prompt_len}) finished with "
              f"{len(r.tokens)} in-vocab tokens")
    check(flash_n > 0 and flash_n == L * s["prefill_chunks"],
          f"flash launches {flash_n} == L x prefill chunks "
          f"({L} x {s['prefill_chunks']})")
    check(paged_n > 0 and paged_n == L * s["decode_steps"],
          f"paged launches {paged_n} == L x decode steps "
          f"({L} x {s['decode_steps']})")
    drained = engine.drain()["pool"]
    check(drained["free_blocks"] == drained["num_blocks"],
          f"drain: pool free {drained['free_blocks']} == total "
          f"{drained['num_blocks']}")

    generated = sum(len(r.tokens) for r in reqs)
    ttft = [r.ttft_ms for r in reqs]
    tpot = [r.decode_ms_per_token for r in reqs]
    card = smi()
    print(f"  served {len(reqs)} requests, {sum(PROMPT_LENS)} prompt + "
          f"{generated} generated tokens in {wall:.3f} s "
          f"({s['iterations']} iterations, {s['prefill_chunks']} prefill "
          f"chunks, {s['decode_steps']} decode steps, {s['preemptions']} "
          f"preemptions) on {card}")
    print(f"  TTFT ms: mean {np.mean(ttft):.1f}, min {min(ttft):.1f}, max "
          f"{max(ttft):.1f}; decode ms/token: mean {np.mean(tpot):.2f}; "
          f"generated tokens/s: {generated / wall:.1f}")

    # teacher-forced agreement with the dense forward on two requests, and
    # the first token's logits through the engine's prefill step. Random
    # weights give near-flat logits over 128k tokens, so bf16 rounding
    # alone flips some argmaxes: the run measures that noise as the largest
    # logit change that moving every input embedding by one bf16 ulp causes
    # in the dense forward, and a mismatch whose logit deficit lies within
    # it counts as a bf16 tie.
    strict = ties = total = 0
    noise = 0.0
    gen = make_generator(seed, model.device)
    for r in (reqs[0], reqs[-1]):
        ids = torch.from_numpy(np.concatenate(
            [r.prompt, np.asarray(r.tokens, np.int32)])).long().cuda()[None]
        p = r.prompt_len
        logits, moved, moved_by = ulp_noise(torch, model, ids, gen,
                                            slice(p - 1, -1))
        noise = max(noise, moved_by)
        toks = torch.tensor(r.tokens, device=logits.device)
        best = logits.max(dim=-1)
        deficit = best.values - logits.gather(1, toks[:, None])[:, 0]
        match = best.indices == toks
        strict += int(match.sum())
        total += len(r.tokens)
        deficits = deficit[~match].tolist()
        ties += sum(d <= noise for d in deficits)
        print(f"  {r.rid}: {int(match.sum())}/{len(r.tokens)} argmax "
              f"matches; mismatch logit deficits "
              f"{[round(d, 4) for d in deficits]}")
        S = engine._bucket_for(p)
        padded = np.zeros((S,), np.int32)
        padded[:p] = r.prompt
        null_row = np.zeros_like(engine.pool.table[0])
        _, first = engine._prefill(padded, p, 0, null_row)
        dense = logits[0]
        rel = ((first[0] - dense).norm() / dense.norm()).item()
        rel_moved = ((moved[0] - dense).norm() / dense.norm()).item()
        check(rel <= LOGITS_REL_L2,
              f"{r.rid} first-token logits: ||engine - dense|| / ||dense|| "
              f"= {rel:.3e} <= {LOGITS_REL_L2} (dense with inputs moved one "
              f"ulp: {rel_moved:.3e}; max |engine - dense| "
              f"{(first[0] - dense).abs().max().item():.3e})")
    print(f"  bf16 noise: max |logit change| of the dense forward with its "
          f"inputs moved one ulp = {noise:.4f}; strict argmax agreement "
          f"{strict}/{total} "
          f"= {strict / total:.1%}")
    check((strict + ties) / total >= AGREE_MIN,
          f"teacher-forced greedy agreement (argmax, or a tie within the "
          f"bf16 noise) {strict + ties}/{total} = "
          f"{(strict + ties) / total:.1%} >= {AGREE_MIN:.0%}")
    profile_decode(torch, engine, cfg.vocab_size, seed,
                   launches={"paged_kernel": L})
    return {"flash_attention": flash_n, "paged_attention": paged_n}, noise


def device_kernels(prof, per=1):
    """Every kernel a ``torch.profiler`` run recorded on the device: ({name:
    device ms / ``per``}, {name: launches})."""
    kernels, calls = {}, {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if t > 0 and e.device_type.name == "CUDA":
            kernels[e.key] = kernels.get(e.key, 0.0) + t / 1e3 / per
            calls[e.key] = calls.get(e.key, 0) + e.count
    return kernels, calls


def decode_groups(kernels):
    """``kernels``' device ms summed by DECODE_GROUPS (the first group one
    of whose keys a name holds), the rest under "other"."""
    out = dict.fromkeys(list(DECODE_GROUPS) + ["other"], 0.0)
    for name, ms in kernels.items():
        low = name.lower()
        out[next((g for g, keys in DECODE_GROUPS.items()
                  if any(k in low for k in keys)), "other")] += ms
    return out


def profile_decode(torch, engine, vocab, seed, steps=8,
                   title="phase 5: where a decode step's time goes",
                   launches=None, absent=(), new=None, unit="decode step"):
    """Where a full decode step's time goes: ``steps`` decode iterations
    over ``max_batch`` rows timed on the host clock, then ``steps`` more
    under ``torch.profiler`` for the device time by kernel and the
    device's idle share. ``launches`` ({name part: kernels a step, at
    most}) and ``absent`` (name parts) are checked against the profiled
    kernels. ``new`` (default ``2 steps + 4``) is each request's token
    budget: a speculative engine commits up to k + 1 a step, so it needs
    more to keep every row busy through both windows."""
    print(f"== {title}")
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    new = 2 * steps + 4 if new is None else new
    rng = np.random.RandomState(seed + 1)
    reqs = [engine.submit(rng.randint(0, vocab, (64,)), new)
            for _ in range(engine.config.max_batch)]
    while engine.scheduler.has_queued() or engine.stats()["prefilling"]:
        engine.step()
    torch.cuda.synchronize()
    made = sum(len(r.tokens) for r in reqs)
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    per_row = (sum(len(r.tokens) for r in reqs) - made) / (steps * len(reqs))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / steps
    engine.run_until_complete()
    check(all(len(r.tokens) == new for r in reqs),
          f"profiled batch of {len(reqs)} finished")
    print(f"  {unit}s commit {per_row:.2f} tokens a row; host ms per row "
          f"token {step_ms / per_row:.2f}")
    kernels, calls = device_kernels(prof, steps)
    busy = sum(kernels.values())
    if busy == 0:
        print(f"  {unit}, batch {len(reqs)}: {step_ms:.2f} ms on the "
              f"host clock; the profiler recorded no device time (device "
              f"breakdown and kernel counts not measured)")
        return

    def launched(part):
        return sum(c for k, c in calls.items() if part in k.lower())

    # the profiler may drop activity records, never add any: the exact
    # launches are the wrappers' counts; the profile shows no more kernels
    # than products, and most of them
    for part, per_step in (launches or {}).items():
        check(0.9 * per_step * steps <= launched(part) <= per_step * steps,
              f"profiled decode steps: {launched(part)} {part} kernels "
              f"recorded, at most one a product ({per_step} a step x "
              f"{steps} steps) and at least 90% of them")
    for part in absent:
        check(launched(part) == 0,
              f"profiled decode steps: no {part} kernel ({launched(part)})")
    by_group = decode_groups(kernels)
    print(f"  {unit}, batch {len(reqs)}: {step_ms:.2f} ms on the host "
          f"clock ({prof_ms:.2f} ms under the profiler); device busy "
          f"{busy:.2f} ms per step: idle share {1 - busy / step_ms:.1%} of "
          f"the plain step ({1 - busy / prof_ms:.1%} of the profiled one)")
    print("  device ms per step by group: " + ", ".join(
        f"{g} {ms:.3f}" for g, ms in by_group.items()))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    for name, ms in top:
        print(f"    {ms:8.3f} ms  {name[:100]}")


def chunked_first_logits(engine, prompt):
    """The f32 logits ``[vocab]`` of the first token after ``prompt``
    through the engine's own prefill steps, in chunks of the prefill
    budget (chunk 2 onwards carries the prefix from the pool), in a slot it
    admits and releases. The engine must be idle."""
    import numpy as np

    pool, budget = engine.pool, engine.config.prefill_token_budget
    slot = pool.admit(len(prompt), 1)
    if slot is None:
        raise SmokeFailure("chunked_first_logits: the engine is not idle")
    offset = 0
    while offset < len(prompt):
        chunk = min(len(prompt) - offset, budget)
        ids = np.zeros((engine._bucket_for(chunk),), np.int32)
        ids[:chunk] = prompt[offset:offset + chunk]
        _, logits = engine._prefill(ids, chunk, offset, pool.table[slot])
        offset += chunk
    pool.release(slot)
    return logits[0]


def dequantize_into(torch, model, weights, int4):
    """Overwrite the model's decoder projections in place with the engine's
    dequantized weights, bf16(q x scale): the dense reference of a
    quantized run."""
    from paddle_tpu_torch.ops.cuda.int8_matmul import unpack_int4_packed
    from paddle_tpu_torch.ops.quant_ops import weight_dequantize

    with torch.no_grad():
        for i, layer in enumerate(model.model.layers):
            at, mlp = layer.self_attn, layer.mlp
            for stack, scale, projs in (
                    (weights.qkv_w, weights.qkv_scale,
                     (at.q_proj, at.k_proj, at.v_proj)),
                    (weights.out_w, weights.out_scale, (at.o_proj,)),
                    (weights.ffn1_w, weights.ffn1_scale,
                     (mlp.gate_proj, mlp.up_proj)),
                    (weights.ffn2_w, weights.ffn2_scale, (mlp.down_proj,))):
                q = unpack_int4_packed(stack[i]) if int4 else stack[i]
                full = weight_dequantize(q, scale[i], torch.bfloat16)
                col = 0
                for p in projs:
                    n = p.out_features
                    p.weight.copy_(full[:, col:col + n].t())
                    col += n
                del full


def dense_agreement(torch, model, reqs, firsts, noise, what):
    """First-token logits of the engine (``firsts[i]``) within
    LOGITS_REL_L2 of the dense forward, and teacher-forced agreement >=
    AGREE_MIN where a mismatch within ``noise`` counts as a tie, on the
    first and the last request."""
    import numpy as np

    strict = ties = total = 0
    for i in (0, len(reqs) - 1):
        r = reqs[i]
        ids = torch.from_numpy(np.concatenate(
            [r.prompt, np.asarray(r.tokens, np.int32)])).long().cuda()[None]
        p = r.prompt_len
        with torch.inference_mode():
            logits = model(ids)[0, p - 1:-1]
        toks = torch.tensor(r.tokens, device=logits.device)
        best = logits.max(dim=-1)
        deficit = best.values - logits.gather(1, toks[:, None])[:, 0]
        match = best.indices == toks
        strict += int(match.sum())
        total += len(r.tokens)
        deficits = deficit[~match].tolist()
        ties += sum(d <= noise for d in deficits)
        print(f"  {what} {r.rid}: {int(match.sum())}/{len(r.tokens)} argmax "
              f"matches; mismatch logit deficits "
              f"{[round(d, 4) for d in deficits]}")
        dense = logits[0]
        rel = ((firsts[i] - dense).norm() / dense.norm()).item()
        check(rel <= LOGITS_REL_L2,
              f"{what} {r.rid} first-token logits: ||engine - dense|| / "
              f"||dense|| = {rel:.3e} <= {LOGITS_REL_L2} (max |engine - "
              f"dense| {(firsts[i] - dense).abs().max().item():.3e})")
    print(f"  {what}: strict argmax agreement {strict}/{total} = "
          f"{strict / total:.1%}; ties counted within {noise:.4f}")
    check((strict + ties) / total >= AGREE_MIN,
          f"{what} teacher-forced greedy agreement (argmax, or a tie within "
          f"the noise) {strict + ties}/{total} = "
          f"{(strict + ties) / total:.1%} >= {AGREE_MIN:.0%}")


def serve_quantized(torch, model, prompts, quant, kv_dtype, chunked, seed):
    """One quantized run: an engine over ``model`` serves ``prompts`` with
    its launch counts, drain and timings checked, gives its first-token
    logits (``firsts``, by prompt index) and a profiled decode step, then
    writes its dequantized weights into ``model``. The engine is freed on
    return. Returns ``(reqs, firsts, launch counts)``."""
    import numpy as np

    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = model.config
    L = cfg.num_hidden_layers
    what = f"run {'A' if kv_dtype else 'B'} (quantize={quant!r}, " \
           f"kv_cache_dtype={kv_dtype!r})"
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(model, ServingConfig(
        max_seq_len=2048, quantize=quant, kv_cache_dtype=kv_dtype))
    torch.cuda.synchronize()
    w = engine.weights
    wbytes = sum(t.numel() * t.element_size()
                 for t in (w.qkv_w, w.out_w, w.ffn1_w, w.ffn2_w))
    print(f"  {what}: pool {tuple(engine.pool.k_pages.shape)} "
          f"{engine.pool.k_pages.dtype} x2, {engine.spec.bytes_per_block} "
          f"bytes per block; decoder weight stacks {wbytes / 1e9:.2f} GB")
    buckets = []
    prefill = engine._prefill

    def recorded(ids, *a):
        buckets.append(ids.shape[0])
        return prefill(ids, *a)

    engine._prefill = recorded
    reset_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, NEW_TOKENS) for p in prompts]
    engine.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = read_counts()
    del engine._prefill
    s = engine.stats()
    for r in reqs:
        check(r.status == "finished" and len(r.tokens) == NEW_TOKENS
              and all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"{what} {r.rid} (prompt {r.prompt_len}) finished with "
              f"{len(r.tokens)} in-vocab tokens")
    steps, chunks = s["decode_steps"], s["prefill_chunks"]
    small = sum(b <= 256 for b in buckets)
    paged, idle = (("paged_attention_int8", "paged_attention") if kv_dtype
                   else ("paged_attention", "paged_attention_int8"))
    gemm, other = (("int4_matmul", "int8_matmul") if quant == "int4"
                   else ("int8_matmul", "int4_matmul"))
    check(n[paged] == L * steps > 0 and n[idle] == 0,
          f"{what} {paged} launches {n[paged]} == L x decode steps "
          f"({L} x {steps}); {idle} {n[idle]} == 0")
    check(n[gemm] == 4 * L * (steps + small) and n[other] == 0,
          f"{what} {gemm} launches {n[gemm]} == 4 L x (decode steps + "
          f"chunks of bucket <= 256) = 4 x {L} x ({steps} + {small}); "
          f"{other} {n[other]} == 0 (chunk buckets {buckets})")
    check(n["flash_attention"] == L * chunks > 0,
          f"{what} flash launches {n['flash_attention']} == L x prefill "
          f"chunks ({L} x {chunks})")
    drained = engine.drain()["pool"]
    check(drained["free_blocks"] == drained["num_blocks"],
          f"{what} drain: pool free {drained['free_blocks']} == total "
          f"{drained['num_blocks']}")
    generated = sum(len(r.tokens) for r in reqs)
    ttft = [r.ttft_ms for r in reqs]
    tpot = [r.decode_ms_per_token for r in reqs]
    print(f"  {what}: {generated} tokens in {wall:.3f} s ({steps} decode "
          f"steps, {chunks} prefill chunks); TTFT ms mean "
          f"{np.mean(ttft):.1f}, min {min(ttft):.1f}, max {max(ttft):.1f}; "
          f"decode ms/token mean {np.mean(tpot):.2f}; generated tokens/s "
          f"{generated / wall:.1f}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB on {smi()}")
    firsts = {i: chunked_first_logits(engine, prompts[i])
              for i in sorted({0, len(prompts) - 1, *chunked})}
    # one weight-only kernel a product: 4 a layer, no second pass
    profile_decode(torch, engine, cfg.vocab_size, seed,
                   title=f"phase 5b: where a decode step of {what} goes",
                   launches={"wo_gemm": 4 * L, "paged_kernel": L})
    dequantize_into(torch, model, engine.weights, quant == "int4")
    return reqs, firsts, n


def phase_quant_serving(torch, seed, noise_bf16):
    """Runs A (int8 weights, int8 KV pool) and B (int4 weights, bf16 pool)
    of Llama-3-8B, one engine at a time, each held against a dense forward
    over its dequantized weights. Returns the int8 paged kernel's and the
    weight-only GEMMs' launches (run A's for the int8 kernels, run B's for
    the int4 GEMM) and the int8 pool's largest first-token logit change
    against a bf16 pool."""
    print("== phase 5b: quantized serving, Llama-3-8B")
    import numpy as np

    from paddle_tpu_torch.models import LLAMA_PRESETS, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = LLAMA_PRESETS["llama3-8b"]
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    budget = ServingConfig().resolve().prefill_token_budget
    chunked = [i for i, n in enumerate(PROMPT_LENS) if n > budget]
    launches, kv_noise = {}, 0.0
    for quant, kv_dtype in (("int8", "int8"), ("int4", "")):
        model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
        noise = noise_bf16
        if kv_dtype:
            # the int8 pool's own noise: the chunked prompts' first-token
            # logits over a bf16 pool with the same int8 weights
            aux = ServingEngine(model, ServingConfig(max_seq_len=2048,
                                                     quantize=quant))
            bf16_kv = {i: chunked_first_logits(aux, prompts[i])
                       for i in chunked}
            del aux
            free_cuda(torch)
        reqs, firsts, n = serve_quantized(torch, model, prompts, quant,
                                          kv_dtype, chunked, seed)
        free_cuda(torch)
        what = f"run {'A' if kv_dtype else 'B'}"
        if kv_dtype:
            kv_noise = max((firsts[i] - bf16_kv[i]).abs().max().item()
                           for i in chunked)
            # checked against a fixed bound before it may widen the window
            # that judges the same int8 scatter and carry
            check(kv_noise <= KV_NOISE_MAX,
                  f"{what}: largest first-token logit change, int8 vs bf16 "
                  f"pool, over the chunked prompts "
                  f"{[PROMPT_LENS[i] for i in chunked]}: {kv_noise:.4f} <= "
                  f"{KV_NOISE_MAX} (bf16 noise {noise_bf16:.4f})")
            noise = max(noise, kv_noise)
        dense_agreement(torch, model, reqs, firsts, noise, what)
        # run A's int8 paged and int8 GEMM counts, run B's int4 GEMM's
        launches.update({k: n[k] for k in (
            ("paged_attention_int8", "int8_matmul") if kv_dtype
            else ("int4_matmul",))})
        del model
        free_cuda(torch)
    return launches, kv_noise


def phase_paired_decode(torch, seed, rounds=5, steps=8):
    """Decode steps of three engines over one Llama-3-8B model (bf16, int8
    and int4 weights; bf16 pools, batch 8), alternated round by round in
    one process so that the host's drift falls on all three alike. Prints
    the host ms per step of each round."""
    print("== phase 5c: decode step host ms, bf16 vs int8 / int4 weights, "
          "paired")
    import numpy as np

    from paddle_tpu_torch.models import LLAMA_PRESETS, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = LLAMA_PRESETS["llama3-8b"]
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    rng = np.random.RandomState(seed + 2)
    prompts = [rng.randint(0, cfg.vocab_size, (64,)) for _ in range(8)]
    new = rounds * steps + 4
    engines = {}
    for quant in (False, "int8", "int4"):
        eng = ServingEngine(model, ServingConfig(max_seq_len=2048,
                                                 quantize=quant))
        reqs = [eng.submit(p, new) for p in prompts]
        while eng.scheduler.has_queued() or eng.stats()["prefilling"]:
            eng.step()
        engines[quant or "bf16"] = (eng, reqs)
    times = {k: [] for k in engines}
    for _ in range(rounds):
        for k, (eng, _) in engines.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3 / steps)
    for k, (eng, reqs) in engines.items():
        eng.run_until_complete()
        check(all(len(r.tokens) == new for r in reqs),
              f"paired {k}: {len(reqs)} requests finished with {new} tokens")
        drained = eng.drain()["pool"]
        check(drained["free_blocks"] == drained["num_blocks"],
              f"paired {k} drain: pool free {drained['free_blocks']} == "
              f"total {drained['num_blocks']}")
    for k, ts in times.items():
        print(f"  {k}: host ms per decode step by round {fmt_ms(ts)}, "
              f"median {statistics.median(ts):.2f}")
    print(f"  on {smi()}")
    del engines, model
    free_cuda(torch)


def stream_agreement(torch, model, triples, noise, what):
    """Each ``(prompt, tokens, reference tokens)``: the two streams are
    equal, or equal up to a first divergence where the dense forward puts
    both tokens within ``noise`` of its largest logit (a bf16 tie, past
    which the streams no longer share a context); and every stream,
    teacher-forced through the dense forward, is its argmax or a tie
    within ``noise`` on at least AGREE_MIN of its tokens (phase 4's
    rule). Returns the number of equal streams."""
    import numpy as np

    same = strict = ties = total = 0
    for prompt, toks, ref in triples:
        ids = torch.from_numpy(np.concatenate(
            [prompt, np.asarray(toks, np.int32)])).long().cuda()[None]
        p = len(prompt)
        with torch.inference_mode():
            logits = model(ids)[0, p - 1:-1].float()
        best = logits.max(dim=-1)
        tt = torch.tensor(toks, device=logits.device)
        deficit = best.values - logits.gather(1, tt[:, None])[:, 0]
        match = best.indices == tt
        strict += int(match.sum())
        ties += int((deficit[~match] <= noise).sum())
        total += len(toks)
        # both streams hold NEW_TOKENS tokens (checked by the caller)
        j = next((i for i, (a, b) in enumerate(zip(toks, ref)) if a != b),
                 None)
        if j is None:
            same += 1
            continue
        row = logits[j]
        gaps = [(row.max() - row[t]).item() for t in (toks[j], ref[j])]
        check(max(gaps) <= noise,
              f"{what} (prompt {p}): first divergence at token {j} "
              f"({toks[j]} vs {ref[j]}) is a tie: dense logit deficits "
              f"{gaps[0]:.4f} / {gaps[1]:.4f} <= {noise:.4f}")
    print(f"  {what}: {same}/{len(triples)} streams equal; teacher-forced "
          f"strict argmax {strict}/{total} = {strict / total:.1%}")
    check((strict + ties) / total >= AGREE_MIN,
          f"{what}: teacher-forced agreement (argmax, or a tie within "
          f"{noise:.4f}) {strict + ties}/{total} = "
          f"{(strict + ties) / total:.1%} >= {AGREE_MIN:.0%}")
    return same


def serve_prefix(torch, model, prompts, cache, kv_dtype):
    """Phase 5d's run of one engine: the first prompt alone (its prefill
    publishes the prefix's blocks), then the other seven. Returns the
    requests, the stats, the launch counts, the (offset, length) of every
    prefill chunk and the pool after drain."""
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    engine = ServingEngine(model, ServingConfig(
        max_seq_len=2048, prefix_cache=cache, kv_cache_dtype=kv_dtype))
    chunks = []
    prefill = engine._prefill

    def recorded(ids, chunk, offset, row):
        chunks.append((offset, chunk))
        return prefill(ids, chunk, offset, row)

    engine._prefill = recorded
    reset_counts()
    reqs = [engine.submit(prompts[0], NEW_TOKENS)]
    engine.run_until_complete()
    reqs += [engine.submit(p, NEW_TOKENS) for p in prompts[1:]]
    engine.run_until_complete()
    torch.cuda.synchronize()
    n = read_counts()
    del engine._prefill
    s = engine.stats()
    drained = engine.drain()["pool"]
    del engine
    free_cuda(torch)
    return reqs, s, n, chunks, drained


def phase_prefix_cache(torch, seed, noise_bf16, kv_noise):
    """Phase 5d: eight prompts sharing a 1024-token prefix through engines
    with the prefix cache on and off, on bf16 and int8 pools."""
    print("== phase 5d: shared-prefix cache, Llama-3-8B")
    import numpy as np

    from paddle_tpu_torch.models import LLAMA_PRESETS, LlamaForCausalLM

    from paddle_tpu_torch.serving import ServingConfig

    cfg = LLAMA_PRESETS["llama3-8b"]
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    rng = np.random.RandomState(seed + 3)
    prefix = rng.randint(0, V, (PREFIX_LEN,)).astype(np.int32)
    tails = [rng.randint(0, V, (n,)).astype(np.int32)
             for n in rng.randint(PREFIX_TAILS[0], PREFIX_TAILS[1] + 1, 8)]
    prompts = [np.concatenate([prefix, t]) for t in tails]
    blocks = PREFIX_LEN // ServingConfig().resolve().block_size
    print(f"  prompts: a {PREFIX_LEN}-token prefix ({blocks} blocks) + "
          f"tails of {[len(t) for t in tails]} tokens, {NEW_TOKENS} new "
          f"each; the first alone, then the other 7")
    for kv in ("", "int8"):
        what = f"5d {'int8' if kv else 'bf16'} pool"
        runs = {c: serve_prefix(torch, model, prompts, c, kv)
                for c in (True, False)}
        for cache, (reqs, s, n, chunks, drained) in runs.items():
            tag = f"{what}, cache {'on' if cache else 'off'}"
            check(all(r.status == "finished" and len(r.tokens) == NEW_TOKENS
                      and all(0 <= t < V for t in r.tokens) for r in reqs),
                  f"{tag}: 8 requests finished with {NEW_TOKENS} in-vocab "
                  f"tokens")
            paged, idle = (("paged_attention_int8", "paged_attention")
                           if kv else ("paged_attention",
                                       "paged_attention_int8"))
            check(n["flash_attention"] == L * s["prefill_chunks"] > 0,
                  f"{tag}: flash launches {n['flash_attention']} == L x "
                  f"prefill chunks ({L} x {s['prefill_chunks']})")
            check(n[paged] == L * s["decode_steps"] > 0 and n[idle] == 0,
                  f"{tag}: {paged} launches {n[paged]} == L x decode steps "
                  f"({L} x {s['decode_steps']}); {idle} {n[idle]} == 0")
            check(drained["free_blocks"] == drained["num_blocks"],
                  f"{tag}: drain: pool free {drained['free_blocks']} == "
                  f"total {drained['num_blocks']} ({drained['cached_blocks']}"
                  f" cached blocks among them)")
            p = s["pool"]
            firsts = sum(o == 0 for o, _ in chunks)
            prefilled = sum(c for _, c in chunks)
            if cache:
                check(p["prefix_hit_blocks"] == 7 * blocks
                      and p["prefix_saved_tokens"] == 7 * PREFIX_LEN,
                      f"{tag}: prefix hits {p['prefix_hit_blocks']} blocks "
                      f"== 7 x {blocks}, saved {p['prefix_saved_tokens']} "
                      f"tokens == 7 x {PREFIX_LEN}")
                check(firsts == 1 and s["prefill_carry_chunks"]
                      == s["prefill_chunks"] - 1
                      and prefilled == len(prompts[0])
                      + sum(len(t) for t in tails[1:]),
                      f"{tag}: every chunk but the first request's first "
                      f"ran at a carried offset ({s['prefill_carry_chunks']}"
                      f" of {s['prefill_chunks']}); {prefilled} tokens "
                      f"prefilled, the hits' tails only")
            else:
                check(p["prefix_hit_blocks"] == 0 and firsts == 8
                      and prefilled == sum(len(q) for q in prompts),
                      f"{tag}: no hit, {prefilled} tokens prefilled, 8 "
                      f"chunks at offset 0")
        on, off = runs[True][0], runs[False][0]
        ttft = [[r.ttft_ms for r in reqs[1:]] for reqs in (on, off)]
        print(f"  {what}: TTFT ms of the 7 hit requests, cache on / off: "
              f"mean {np.mean(ttft[0]):.1f} / {np.mean(ttft[1]):.1f}, max "
              f"{max(ttft[0]):.1f} / {max(ttft[1]):.1f}; prefill chunks "
              f"{runs[True][1]['prefill_chunks']} / "
              f"{runs[False][1]['prefill_chunks']}; the first request "
              f"{on[0].ttft_ms:.1f} / {off[0].ttft_ms:.1f} ms; on {smi()}")
        stream_agreement(torch, model, [
            (q, a.tokens, b.tokens) for q, a, b in zip(prompts, on, off)],
            max(noise_bf16, kv_noise) if kv else noise_bf16,
            f"{what}, cache on vs off")
    del model
    free_cuda(torch)


def serve_spec(torch, model, prompts, kv_dtype, what, draft=None,
               profile_seed=None):
    """Phase 5e's run ``what`` of one engine over ``prompts``, speculative
    when ``draft`` is given, then (``profile_seed`` given) a profiled
    window of its iterations. Returns the requests, the stats, the launch
    counts and the wall seconds; the pool must drain."""
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    engine = ServingEngine(model, ServingConfig(
        max_seq_len=2048, kv_cache_dtype=kv_dtype,
        speculative=None if draft is None else (draft, SPEC_K)))
    reset_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, NEW_TOKENS) for p in prompts]
    engine.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = read_counts()
    s = engine.stats()
    if profile_seed is not None:
        per_iter = model.config.num_hidden_layers \
            + (SPEC_K + 1) * draft.config.num_hidden_layers
        # 4 + 4 iterations of at most k + 1 tokens after the first
        profile_decode(torch, engine, model.config.vocab_size, profile_seed,
                       steps=4, new=8 * (SPEC_K + 1) + 8,
                       title=f"phase 5e: where an iteration of {what} "
                             f"goes", launches={"paged_kernel": per_iter},
                       unit="speculative iteration")
    drained = engine.drain()["pool"]
    check(drained["free_blocks"] == drained["num_blocks"],
          f"{what} drain: pool free {drained['free_blocks']} == total "
          f"{drained['num_blocks']}")
    del engine
    free_cuda(torch)
    return reqs, s, n, wall


def phase_speculative(torch, seed, noise_bf16, kv_noise):
    """Phase 5e: phase 4's 8 prompts through a speculative Llama-3-8B
    engine (k = 4): run A with an independent 2-layer drafter (bf16 and
    int8 pools), run B drafting with the verifier itself; each against
    plain decoding on the same settings."""
    print(f"== phase 5e: speculative decoding, Llama-3-8B verifier, "
          f"k = {SPEC_K}")
    import dataclasses

    import numpy as np

    from paddle_tpu_torch.models import LLAMA_PRESETS, LlamaForCausalLM

    cfg = LLAMA_PRESETS["llama3-8b"]
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    draft = LlamaForCausalLM(dataclasses.replace(
        cfg, num_hidden_layers=DRAFT_LAYERS), device="cuda", seed=seed + 1)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, V, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    plain = {}
    for run, kv, dm in (("A", "", draft), ("A", "int8", draft),
                        ("B", "", model)):
        drafter = ("self-draft" if dm is model
                   else f"a drafter of {DRAFT_LAYERS} layers")
        what = f"5e run {run} ({drafter}, {'int8' if kv else 'bf16'} pool)"
        if kv not in plain:
            plain[kv] = serve_spec(torch, model, prompts, kv,
                                   f"5e plain decode, {kv or 'bf16'} pool")
        p_reqs, p_s, _, p_wall = plain[kv]
        reqs, s, n, wall = serve_spec(torch, model, prompts, kv, what, dm,
                                      None if kv else seed)
        sp, Ld = s["speculative"], dm.config.num_hidden_layers
        check(all(r.status == "finished" and len(r.tokens) == NEW_TOKENS
                  and all(0 <= t < V for t in r.tokens) for r in reqs),
              f"{what}: 8 requests finished with {NEW_TOKENS} in-vocab "
              f"tokens")
        paged, idle = (("paged_attention_int8", "paged_attention") if kv
                       else ("paged_attention", "paged_attention_int8"))
        verify, drafts = sp["verify_steps"], sp["draft_steps"]
        check(verify > 0 and drafts == (SPEC_K + 1) * verify
              and s["decode_steps"] == 0
              and n[paged] == L * verify + Ld * drafts and n[idle] == 0,
              f"{what}: {paged} launches {n[paged]} == L_v x verify steps "
              f"+ L_d x draft steps = {L} x {verify} + {Ld} x {drafts} "
              f"(draft steps == (k + 1) x verify steps, no plain decode "
              f"step); {idle} {n[idle]} == 0")
        check(n["flash_attention"] == (L + Ld) * s["prefill_chunks"] > 0,
              f"{what}: flash launches {n['flash_attention']} == (L_v + "
              f"L_d) x prefill chunks = ({L} + {Ld}) x "
              f"{s['prefill_chunks']}")
        rows = sp["drafted_tokens"] // SPEC_K
        tpot = np.mean([r.decode_ms_per_token for r in reqs])
        p_tpot = np.mean([r.decode_ms_per_token for r in p_reqs])
        print(f"  {what}: acceptance {sp['accepted_tokens']}/"
              f"{sp['drafted_tokens']} = {sp['accept_rate']:.3f}; "
              f"{sp['committed_tokens']} tokens committed in {verify} verify "
              f"steps ({sp['committed_tokens'] / verify:.2f} a step, "
              f"{sp['committed_tokens'] / rows:.2f} a row and step); decode "
              f"ms/token mean {tpot:.2f} against plain {p_tpot:.2f} "
              f"({p_s['decode_steps']} plain decode steps); wall "
              f"{wall:.3f} s against {p_wall:.3f} s; on {smi()}")
        if run == "B":
            check(sp["accept_rate"] >= 0.5,
                  f"{what}: self-draft acceptance {sp['accept_rate']:.3f} "
                  f">= 0.5")
        stream_agreement(torch, model, [
            (q, a.tokens, b.tokens) for q, a, b in zip(prompts, reqs,
                                                       p_reqs)],
            max(noise_bf16, kv_noise) if kv else noise_bf16,
            f"{what} vs plain decode")
    del model, draft
    free_cuda(torch)


def fleet_prompts(seed, vocab):
    """Phase 5f's 16 prompts in submission order: two groups of 8, each on
    its own seeded PREFIX_LEN-token prefix with tails of PREFIX_TAILS
    tokens; the first of each group (A0, B0), then the rest interleaved
    (A1, B1, ...) so that no replica runs ahead of the other by more than
    the affinity router's spill. Returns ``[(rid, prompt), ...]``."""
    import numpy as np

    rng = np.random.RandomState(seed + 5)
    prefixes = [rng.randint(0, vocab, (PREFIX_LEN,)).astype(np.int32)
                for _ in range(2)]
    tails = rng.randint(PREFIX_TAILS[0], PREFIX_TAILS[1] + 1, (2, 8))
    return [(f"{g}{i}", np.concatenate([
        prefixes[j], rng.randint(0, vocab, (tails[j, i],)).astype(np.int32)]))
        for i in range(8) for j, g in enumerate("AB")]


def run_fleet(torch, model, prompts, root):
    """Phase 5f's fleet run: two replicas behind the affinity router, the
    first prompt of each group alone, then the other 14; after
    FLEET_KILL_STEP fleet steps the replica holding group B dies through
    ``fleet.replica_die``. Checks the routing, the failover, the launch
    counts, the drain, the scrape surface; writes the Chrome trace.
    Returns the requests by rid. Keeps no reference to the fleet."""
    import urllib.request

    import paddle_tpu_torch.serving.fleet as fleet_mod
    from paddle_tpu_torch.core import faults, metrics
    from paddle_tpu_torch.serving import Fleet, ServingConfig
    from paddle_tpu_torch.tools.trace_requests import export_chrome_trace

    L = model.config.num_hidden_layers
    built, real = [], fleet_mod.ServingEngine

    def recorded(*a, **kw):
        eng = real(*a, **kw)
        torch.cuda.synchronize()
        built.append(torch.cuda.memory_allocated())
        return eng

    before = torch.cuda.memory_allocated()
    fleet_mod.ServingEngine = recorded
    try:
        fleet = Fleet(model, ServingConfig(max_seq_len=2048), replicas=2,
                      router="affinity")
    finally:
        fleet_mod.ServingEngine = real
    reps = fleet.replicas
    print(f"  card memory: {before / 2**30:.2f} GiB with the model, "
          f"{built[0] / 2**30:.2f} after replica 0 (fused weights, f32 head,"
          f" pool {reps[0].engine.pool.k_pages.shape} x2), "
          f"{built[1] / 2**30:.2f} after replica 1")
    check(built[1] - built[0] < REPLICA_MEM_MAX,
          f"the second replica adds {(built[1] - built[0]) / 2**30:.2f} GiB "
          f"< {REPLICA_MEM_MAX / 2**30:.0f} GiB (one stack of weights)")
    check(reps[1].engine.weights.qkv_w.data_ptr()
          == reps[0].engine.weights.qkv_w.data_ptr(),
          "the replicas read one stack of fused weights")

    reset_counts()
    t0 = time.perf_counter()
    reqs = {rid: fleet.submit(p, NEW_TOKENS, rid=rid)
            for rid, p in prompts[:2]}
    fleet.run_until_complete()
    home = {g: fleet.placement(f"{g}0") for g in "AB"}
    check(home["A"] != home["B"], f"A0 and B0 on replicas {home['A']} and "
          f"{home['B']}")
    reqs.update({rid: fleet.submit(p, NEW_TOKENS, rid=rid)
                 for rid, p in prompts[2:]})
    placed = {rid: fleet.placement(rid) for rid in reqs}
    hits = metrics.snapshot()["counters"]["fleet.affinity_hits"][
        metrics.label_key(**fleet.metrics_labels)]
    check(all(placed[rid] == home[rid[0]] for rid in reqs) and hits >= 14,
          f"each group on the replica holding its prefix ({placed}); "
          f"fleet.affinity_hits {hits:g} >= 14")
    for _ in range(FLEET_KILL_STEP):
        fleet.step()
    health = [rep.engine.health() for rep in reps]
    check(all(h["active"] + h["prefilling"] and h["queued"] for h in health),
          f"before the kill both replicas hold in-flight and queued work "
          f"({[(h['active'], h['prefilling'], h['queued']) for h in health]}"
          f" active, prefilling, queued)")
    dead = reps[home["B"]]
    h = health[home["B"]]
    live = h["active"] + h["prefilling"] + h["queued"]
    with faults.inject("fleet.replica_die", at=1, replica=home["B"]):
        fleet.step()
    fleet.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = read_counts()
    check(dead.dead and fleet.failovers == 1
          and fleet.rerouted + fleet.queue_transfers == live,
          f"failovers {fleet.failovers} == 1; rerouted {fleet.rerouted} + "
          f"queue transfers {fleet.queue_transfers} == the dead replica's "
          f"live requests {live}")
    pms = [pm for pm in dead.engine.flight_recorder.postmortems
           if pm["reason"] == "replica_die"]
    check(len(pms) == 1 and pms[0]["records"],
          f"the dead replica's postmortem: reason replica_die, "
          f"{len(pms[0]['records']) if pms else 0} ring records, context "
          f"{pms[0]['context'] if pms else None}")
    check(all(r.status == "finished" and len(r.tokens) == NEW_TOKENS
              for r in reqs.values()),
          f"all 16 requests finished with {NEW_TOKENS} tokens")
    stats = fleet.stats()
    chunks = sum(s["prefill_chunks"] for s in stats.values())
    steps = sum(s["decode_steps"] for s in stats.values())
    recomputes = sum(e["event"] == "recompute" for r in reqs.values()
                     for e in r.trace_events)
    check(n["flash_attention"] == L * chunks > 0
          and n["paged_attention"] == L * steps > 0,
          f"launches over both replicas: flash {n['flash_attention']} == L x "
          f"prefill chunks ({L} x {chunks}, {recomputes} recomputed "
          f"requests among them), paged {n['paged_attention']} == L x "
          f"decode steps ({L} x {steps})")
    print(f"  served 16 requests in {wall:.3f} s ({fleet.health()['steps']} "
          f"fleet steps); on {smi()}")

    snap = metrics.snapshot()
    for rep in reps:
        lk = metrics.label_key(**rep.engine.metrics_labels)
        q = {name: snap["histograms"][f"serving.{name}_ms"][lk]
             for name in ("ttft", "tpot", "step")}
        print(f"  replica {rep.index} ({rep.state}): " + "; ".join(
            f"{name} p50 {q[name]['p50']:.1f} / p99 {q[name]['p99']:.1f} ms "
            f"({q[name]['count']})" for name in q))
    with metrics.serve() as srv:
        text = urllib.request.urlopen(srv.url + "/metrics",
                                      timeout=30).read().decode()
        doc = json.loads(urllib.request.urlopen(srv.url + "/healthz",
                                                timeout=30).read().decode())
    families = {line.split()[2] for line in text.splitlines()
                if line.startswith("# TYPE ")}
    want = ("serving_ttft_ms", "serving_step_ms", "serving_finished",
            "serving_pool_free_blocks", "serving_pool_prefix_hit_blocks",
            "fleet_failovers", "fleet_affinity_hits", "fleet_replicas")
    mine = [f for f in doc["fleet"]["fleets"]
            if f["fleet"] == fleet.metrics_labels["fleet"]]
    states = sorted(r["state"] for r in mine[0]["replicas"]) if mine else []
    check(all(w in families for w in want) and states == ["dead", "live"],
          f"/metrics ({len(text)} bytes, {len(families)} families) has "
          f"{want}; /healthz ({doc['status']}) lists the fleet's replicas "
          f"{states}")
    path = os.path.join(root, "build", "phase5f_requests.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    survivor = reps[home["A"]].engine
    trace = export_chrome_trace(
        list(reqs.values()), path,
        step_records=survivor.flight_recorder.records())
    print(f"  Chrome trace of the 16 requests and the survivor's steps: "
          f"{path} ({len(trace['traceEvents'])} events)")
    drained = fleet.drain()
    check(list(drained) == [home["A"]] and drained[home["A"]]["pool"][
        "free_blocks"] == drained[home["A"]]["pool"]["num_blocks"],
          f"the survivor drains clean ({drained[home['A']]['pool']['free_blocks']}"
          f" free of {drained[home['A']]['pool']['num_blocks']}); the dead "
          f"pool is left with {dead.engine.pool.free_blocks} free")
    return reqs


def telemetry_rounds(torch, model, seed, rounds=10, steps=8):
    """Decode steps of two engines over one stack (8 rows each), rounds
    alternated, each engine with telemetry on in every other round, after
    one round each untimed: host ms a decode step with telemetry on and
    off, paired. Returns the two engines' streams and the times."""
    import numpy as np

    from paddle_tpu_torch.core import metrics
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    rng = np.random.RandomState(seed + 2)
    prompts = [rng.randint(0, model.config.vocab_size, (64,))
               for _ in range(8)]
    new = (rounds + 1) * steps + 4
    first = ServingEngine(model, ServingConfig(max_seq_len=2048))
    engines = [first, ServingEngine(model, ServingConfig(max_seq_len=2048),
                                    share_weights_with=first)]
    runs = []
    for eng in engines:
        reqs = [eng.submit(p, new) for p in prompts]
        while eng.scheduler.has_queued() or eng.health()["prefilling"]:
            eng.step()
        runs.append(reqs)
    times = {True: [], False: []}
    try:
        for r in range(-1, rounds):
            for i, eng in enumerate(engines):
                on = (r + i) % 2 == 0
                metrics.set_enabled(on)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(steps):
                    eng.step()
                torch.cuda.synchronize()
                if r >= 0:
                    times[on].append(
                        (time.perf_counter() - t0) * 1e3 / steps)
    finally:
        metrics.set_enabled(True)
    # the telemetry a decode step of 8 rows adds on the host, alone: the
    # step's record and histogram and 8 requests' decode events
    eng, reqs, n = engines[0], runs[0], 2000
    t0 = time.perf_counter()
    for _ in range(n):
        eng._record_step(time.perf_counter(), eng.quarantined_requests,
                         eng._contained())
        for r in reqs:
            r._trace("decode", iteration=0)
    own_us = (time.perf_counter() - t0) * 1e6 / n
    for eng in engines:
        eng.run_until_complete()
        drained = eng.drain()["pool"]
        check(drained["free_blocks"] == drained["num_blocks"],
              f"telemetry pair drain: pool free {drained['free_blocks']} "
              f"== total {drained['num_blocks']}")
    return [[r.tokens for r in reqs] for reqs in runs], times, own_us


def phase_fleet(torch, seed, noise_bf16):
    """Phase 5f: a fleet of two Llama-3-8B replicas on one card, affinity
    routing, a checked failover; the streams against one engine's; the
    host ms of a decode step with telemetry on and off; the memory back
    once the fleet is dropped."""
    print("== phase 5f: a fleet of two Llama-3-8B replicas, affinity "
          "routing, a checked failover")
    from paddle_tpu_torch.models import LLAMA_PRESETS, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = LLAMA_PRESETS["llama3-8b"]
    root = os.path.dirname(os.path.abspath(__file__))
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    prompts = fleet_prompts(seed, cfg.vocab_size)
    with torch.inference_mode():           # cuBLAS's workspace, once
        model(torch.zeros((1, 16), dtype=torch.long, device="cuda"))
    free_cuda(torch)
    base = torch.cuda.memory_allocated()
    reqs = run_fleet(torch, model, prompts, root)
    free_cuda(torch)
    back = torch.cuda.memory_allocated()
    check(back - base <= FLEET_MEM_SLACK,
          f"the fleet dropped: card memory {back / 2**30:.3f} GiB, "
          f"{(back - base) / 2**20:+.1f} MiB from before it (<= "
          f"{FLEET_MEM_SLACK / 2**20:.0f} MiB)")

    engine = ServingEngine(model, ServingConfig(max_seq_len=2048))
    single = {rid: engine.submit(p, NEW_TOKENS, rid=f"single-{rid}")
              for rid, p in prompts[:2]}
    engine.run_until_complete()
    single.update({rid: engine.submit(p, NEW_TOKENS, rid=f"single-{rid}")
                   for rid, p in prompts[2:]})
    engine.run_until_complete()
    engine.drain()
    del engine
    stream_agreement(torch, model, [
        (p, reqs[rid].tokens, single[rid].tokens) for rid, p in prompts],
        noise_bf16, "5f fleet with a failover vs one engine")

    streams, times, own_us = telemetry_rounds(torch, model, seed)
    med = {on: statistics.median(ts) for on, ts in times.items()}
    diff = statistics.median(a - b for a, b in zip(times[True],
                                                   times[False]))
    print(f"  host ms a decode step, telemetry on: {fmt_ms(times[True])} "
          f"(median {med[True]:.2f}); off: {fmt_ms(times[False])} (median "
          f"{med[False]:.2f}); median of the rounds' on - off {diff:+.3f} "
          f"ms; the step's record, histogram and 8 decode events alone "
          f"{own_us:.1f} us; on {smi()}")
    check(streams[0] == streams[1],
          "8 streams identical with telemetry on and off")
    del model
    free_cuda(torch)
    end = torch.cuda.memory_allocated()
    print(f"  card memory after the phase: {end / 2**30:.3f} GiB")


def profiled(torch, fn):
    """``fn()`` under ``torch.profiler`` (device activity only: the host's
    operator events are not read, and recording them slows the host loop):
    host ms (synchronised), device busy ms and device ms by DECODE_GROUPS
    (+ "other")."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups = decode_groups(device_kernels(prof)[0])
    return wall, sum(groups.values()), groups


def decode_step_profile(torch, what, run, steps=8):
    """One decode step of ``run(n)`` (a decoder making n new tokens): the
    profiled difference between ``steps + 1`` new tokens and 1 (the
    prefill alone), over ``steps``: host ms, device busy ms, idle share and
    device ms by group."""
    t0 = time.perf_counter()
    w1, b1, g1 = profiled(torch, lambda: run(1))
    wn, bn, gn = profiled(torch, lambda: run(steps + 1))
    wall, busy = (wn - w1) / steps, (bn - b1) / steps
    took = f"the two profiled runs {time.perf_counter() - t0:.1f} s"
    if bn == 0:
        print(f"  {what}: a decode step {wall:.2f} ms on the host clock "
              f"under the profiler; the profiler recorded no device time "
              f"(busy and idle share not measured); {took}")
        return wall, None
    by = ", ".join(f"{g} {(gn[g] - g1[g]) / steps:.3f}" for g in gn)
    print(f"  {what}: a decode step {wall:.2f} ms host under the profiler, "
          f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.1%}; "
          f"device ms by group: {by}; {took}; on {smi()}")
    return wall, busy


def run_decoder(torch, what, fn, n_new, expect):
    """``fn()`` timed on the host clock with the launch counts set to 0
    before and read after; ``expect`` ({count: launches}) must match
    exactly. Returns the tokens, the counts, host ms per new token and
    the peak memory (GiB)."""
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name, want in expect.items():
        check(counts[name] == want,
              f"{what}: {name} launches {counts[name]} == {want}")
    print(f"  {what}: {wall:.1f} ms for {n_new} new tokens a row "
          f"({wall / n_new:.2f} ms a token), peak {peak:.2f} GiB, on "
          f"{smi()}")
    return out, counts, wall / n_new, peak


def step_decoder(torch, decoder, ids, n_new, ck, cv, pack=None,
                 paged_decoder=None):
    """Greedy tokens ``[B, P + n_new]`` from ``decoder`` stepped by hand: a
    prefill span at index 0, then ``n_new - 1`` decode steps (through
    ``paged_decoder`` over ``pack(ck, cv)``'s pages when given)."""
    P = ids.shape[1]
    logits, ck, cv = decoder(ids, ck, cv, 0)
    toks = [logits.argmax(dim=-1)]
    step = decoder
    if paged_decoder is not None:
        ck, cv = pack(ck, cv)
        step = paged_decoder
    for i in range(n_new - 1):
        logits, ck, cv = step(toks[-1][:, None], ck, cv, P + i)
        toks.append(logits.argmax(dim=-1))
    return torch.cat([ids, torch.stack(toks, dim=1)], dim=1)


def phase_decoding(torch, seed, noise_bf16):
    """Phase 5g: the static-batch decoders (``generate``, ``fused_generate``
    dense and paged, ``ServingDecoder``) on Llama-3-8B, then bench.py's
    bench_decode workload on llama-350m. Returns the launch counts."""
    print("== phase 5g: decoding: generate, fused_generate and "
          "ServingDecoder")
    import numpy as np

    from paddle_tpu_torch.core.device import make_generator
    from paddle_tpu_torch.incubate.nn.functional import (
        fused_weights_from_llama, paged_cache_from_dense)
    from paddle_tpu_torch.models import (LLAMA_PRESETS, KVCacheSpec,
                                         LlamaForCausalLM, ServingDecoder,
                                         fused_generate, generate)
    from paddle_tpu_torch.models.generation import release_fused_weights

    free_cuda(torch)
    base = torch.cuda.memory_allocated()
    t_phase = time.perf_counter()
    launches = {}
    # (a) Llama-3-8B, full width and depth, four decoders
    cfg = LLAMA_PRESETS["llama3-8b"]
    L, B, P, N = cfg.num_hidden_layers, DECODE_BATCH, DECODE_PROMPT, NEW_TOKENS
    T = P + N
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    rng = np.random.RandomState(seed + 9)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, P))).cuda()
    runs = {
        "generate": (lambda n: generate(model, ids, max_new_tokens=n),
                     {"flash_attention": L * N, "paged_attention": 0}),
        "fused_generate dense": (
            lambda n: fused_generate(model, ids, max_new_tokens=n),
            {"flash_attention": L, "paged_attention": 0}),
        "fused_generate paged": (
            lambda n: fused_generate(model, ids, max_new_tokens=n,
                                     paged=True),
            {"flash_attention": L, "paged_attention": L * (N - 1)}),
    }
    streams, per_token, peaks, steps = {}, {}, {}, {}
    for what, (fn, expect) in runs.items():
        expect = dict(expect, int8_matmul=0, int4_matmul=0, flash_dense=0)
        if what == "fused_generate dense":
            fn(1)                 # stacks the weights (cached on the model)
        out, counts, per_token[what], peaks[what] = run_decoder(
            torch, f"5g {what}", lambda: fn(N), N, expect)
        launches[what] = {k: counts[k] for k in expect}
        check(tuple(out.shape) == (B, T) and bool(torch.equal(out[:, :P], ids))
              and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              f"5g {what}: [{B}, {T}] in-vocab ids, the prompt kept")
        streams[what] = out[:, P:].tolist()
        steps[what] = decode_step_profile(torch, f"5g {what}", fn)
    release_fused_weights(model)
    free_cuda(torch)
    # what fused_generate's cached stack saves a call: one stacking each
    stack_ms = {}
    for q in (False, "int8", "int4"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w = fused_weights_from_llama(model, quantize=q)
        torch.cuda.synchronize()
        stack_ms[q or "bf16"] = (time.perf_counter() - t0) * 1e3
        del w
        free_cuda(torch)
    call_ms = per_token["fused_generate dense"] * N
    shares = ", ".join(f"{q} {ms:.1f} ms ({ms / call_ms:.1%})"
                       for q, ms in stack_ms.items())
    print(f"  5g stacking Llama-3-8B's fused weights, one call each: "
          f"{shares} of a {N}-token fused_generate dense call "
          f"({call_ms:.1f} ms); on {smi()}")
    torch.cuda.reset_peak_memory_stats()
    dec = ServingDecoder(model, max_len=T)
    spec = KVCacheSpec.from_config(cfg)
    out, counts, per_token["ServingDecoder"], peaks["ServingDecoder"] = \
        run_decoder(torch, "5g ServingDecoder (a prefill span, then "
                    f"{N - 1} steps)", lambda: step_decoder(
                        torch, dec, ids, N, *spec.alloc_dense(B, T, "cuda")),
                    N, {"flash_attention": L, "paged_attention": 0})
    launches["ServingDecoder"] = {k: counts[k] for k in (
        "flash_attention", "paged_attention")}
    check(out[:, P:].tolist() == streams["fused_generate dense"],
          "5g ServingDecoder stepped by hand == fused_generate dense, bit "
          "for bit (every token of the 4 streams)")
    ck, cv = spec.alloc_dense(B, T, "cuda")
    dec(ids, ck, cv, 0)
    tok = out[:, P:P + 1]

    def dec_steps(n):
        for i in range(n - 1):
            dec(tok, ck, cv, P + i)
    steps["ServingDecoder"] = decode_step_profile(
        torch, "5g ServingDecoder", dec_steps)
    del dec, ck, cv
    free_cuda(torch)
    print(f"  [5g (a), the decoders: {time.perf_counter() - t_phase:.0f} s]")
    prompts = [r.cpu().numpy().astype(np.int32) for r in ids]
    ref = streams["fused_generate dense"]
    for what in ("generate", "fused_generate paged"):
        stream_agreement(torch, model, [
            (p, streams[what][i], ref[i]) for i, p in enumerate(prompts)],
            noise_bf16, f"5g {what} vs fused_generate dense")
    del model
    free_cuda(torch)

    print(f"  [5g (a): {time.perf_counter() - t_phase:.0f} s]")
    # (b) bench_decode's workload on llama-350m
    cfg = LLAMA_PRESETS["llama-350m"]
    L, B, P = cfg.num_hidden_layers, BENCH_BATCH, BENCH_PROMPT
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    ids = torch.from_numpy(np.random.RandomState(seed + 10).randint(
        0, cfg.vocab_size, (B, P))).cuda()
    variants = {"bf16": dict(), "int8": dict(quantize="int8"),
                "int4": dict(quantize="int4"), "bf16 paged": dict(paged=True)}
    from paddle_tpu_torch.ops.cuda.int8_matmul import MAX_ROWS

    # the weight-only kernel takes the decode steps' products (m = B), and
    # the prefill's only at m = B * P <= 256 (above, its dequantize-then-
    # matmul route)
    hi_steps = BENCH_HI - 1
    wo_calls = 4 * L * (hi_steps + (B * P <= MAX_ROWS))
    expects = {"bf16": {"int8_matmul": 0, "int4_matmul": 0,
                        "paged_attention": 0},
               "int8": {"int8_matmul": wo_calls, "int4_matmul": 0,
                        "paged_attention": 0},
               "int4": {"int8_matmul": 0, "int4_matmul": wo_calls,
                        "paged_attention": 0},
               "bf16 paged": {"int8_matmul": 0, "int4_matmul": 0,
                              "paged_attention": L * hi_steps}}

    def one(n, kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fused_generate(model, ids, max_new_tokens=n, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    for kw in variants.values():
        one(2, kw)            # stacks the weights, warms the decode path
    # round 0's 128-token runs carry the launch counts and the streams
    outs, slopes = {}, {name: [] for name in variants}
    for r in range(BENCH_PAIRS):
        for name, kw in variants.items():
            reset_counts()
            hi, out = one(BENCH_HI, kw)
            if r == 0:
                counts = read_counts()
                expect = dict(expects[name], flash_attention=L)
                for key, want in expect.items():
                    check(counts[key] == want,
                          f"5g llama-350m {name} n={BENCH_HI}: {key} "
                          f"launches {counts[key]} == {want}")
                launches[f"llama-350m {name}"] = {k: counts[k]
                                                  for k in expect}
                outs[name] = out
            lo = one(BENCH_LO, kw)[0]
            slopes[name].append((hi - lo) / (BENCH_HI - BENCH_LO))
    card = smi()
    for name, ss in slopes.items():
        ms = statistics.median(ss) * 1e3
        print(f"  5g llama-350m {name}: slope {ms:.3f} ms a token (pairs "
              f"{fmt_ms([x * 1e3 for x in ss])}), {B / ms * 1e3:.1f} "
              f"tokens/s at batch {B}; on {card}")
    check(all(statistics.median(ss) > 0 for ss in slopes.values()),
          "5g llama-350m: every slope positive")
    gen = make_generator(seed, "cuda")
    noise = max(ulp_noise(torch, model, r[None], gen)[2]
                for r in outs["bf16"][:2])
    print(f"  bf16 noise of llama-350m (phase 4's rule, on 2 rows): "
          f"{noise:.4f}")
    stream_agreement(torch, model, [
        (p.cpu().numpy(), outs["bf16 paged"][i, P:].tolist(),
         outs["bf16"][i, P:].tolist()) for i, p in enumerate(ids[:2])],
        noise, "5g llama-350m bf16 paged vs dense")
    T = P + BENCH_LO
    dense = ServingDecoder(model, quantize="int8", max_len=T)
    paged = ServingDecoder(model, quantize="int8", paged=True, max_len=T)
    spec = KVCacheSpec.from_config(cfg)
    pps = spec.pages_per_seq(T)
    reset_counts()
    got = step_decoder(
        torch, dense, ids, BENCH_LO, *spec.alloc_dense(B, T, "cuda"),
        pack=lambda k, v: paged_cache_from_dense(k, v, spec.page_size, pps),
        paged_decoder=paged)
    counts = read_counts()
    lo_calls = 4 * L * (BENCH_LO - 1 + (B * P <= MAX_ROWS))
    check(counts["paged_attention"] == L * (BENCH_LO - 1)
          and counts["int8_matmul"] == lo_calls,
          f"5g llama-350m ServingDecoder(paged=True, quantize='int8'): paged "
          f"{counts['paged_attention']}, int8 GEMM {counts['int8_matmul']} "
          f"launches == {L} x {BENCH_LO - 1}, {lo_calls}")
    want = fused_generate(model, ids, max_new_tokens=BENCH_LO,
                          quantize="int8", paged=True)
    check(bool(torch.equal(got, want)),
          "5g llama-350m ServingDecoder(paged=True, quantize='int8') == "
          "fused_generate(paged=True, quantize='int8'), bit for bit")
    del model, dense, paged, got, want, outs
    free_cuda(torch)
    back = torch.cuda.memory_allocated()
    check(back - base <= DECODE_MEM_SLACK,
          f"5g: card memory {back / 2**30:.3f} GiB, "
          f"{(back - base) / 2**20:+.1f} MiB from before the phase (<= "
          f"{DECODE_MEM_SLACK / 2**20:.0f} MiB)")
    print("  5g per token (host ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in per_token.items())
        + "; peak GiB: " + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items())
        + f"; on {smi()}")
    print("  5g decoding launches: " + json.dumps(launches))
    print(f"  [5g: {time.perf_counter() - t_phase:.0f} s]")
    return launches


def train_config(layers, **over):
    """``bench.py``'s Llama-2-7B proxy widths at ``layers`` layers
    (``over``: other fields, such as the recompute policy)."""
    from paddle_tpu_torch.models import LlamaConfig

    return LlamaConfig(vocab_size=32000, hidden_size=4096,
                       intermediate_size=11008, num_hidden_layers=layers,
                       num_attention_heads=32, num_key_value_heads=32,
                       max_position_embeddings=TRAIN_SEQ, dtype="bfloat16",
                       fused_loss=True, **over)


def save_dots(layers):
    """The 7B proxy as ``bench.py:132-140`` trains it: per-layer recompute
    with the ``save_dots`` policy."""
    return train_config(layers, recompute=True, recompute_policy="save_dots")


def llama_flops_per_token(cfg, seq):
    """``bench.py:56-59``: 6 N plus the causal attention term, per token
    (recomputed operations are not counted)."""
    return 6 * cfg.num_params() \
        + 12 * cfg.num_hidden_layers * seq * cfg.hidden_size * 0.5


def train_tokens(torch, seed, shape=(TRAIN_BATCH, TRAIN_SEQ)):
    import numpy as np

    ids = np.random.RandomState(seed).randint(0, 32000, shape)
    return torch.from_numpy(ids).cuda()


def reset_counts():
    from paddle_tpu_torch.ops.cuda import fused_adamw as fw
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import grouped_gemm as gg
    from paddle_tpu_torch.ops.cuda import int8_matmul as wo
    from paddle_tpu_torch.ops.cuda import paged_attention as pa
    from paddle_tpu_torch.ops.cuda import selective_scan as ss
    from paddle_tpu_torch.ops.cuda import ssd
    from paddle_tpu_torch.ops.cuda import wkv as wk
    from paddle_tpu_torch.ops.fused import flash_attention as fd

    fa.launches = fa.bwd_launches = pa.launches = fw.launches = 0
    fa.mma_launches = fa.mma_bwd_launches = 0
    fd.dense_calls = 0
    pa.int8_launches = wo.launches = wo.int4_launches = 0
    gg.launches = gg.tgmm_launches = gg.swiglu_launches = 0
    ss.launches = ss.bwd_launches = wk.launches = wk.bwd_launches = 0
    ss.logdepth_launches = ss.logdepth_bwd_launches = 0
    ssd.launches = ssd.bwd_launches = 0


def read_counts():
    from paddle_tpu_torch.ops.cuda import fused_adamw as fw
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import grouped_gemm as gg
    from paddle_tpu_torch.ops.cuda import int8_matmul as wo
    from paddle_tpu_torch.ops.cuda import paged_attention as pa
    from paddle_tpu_torch.ops.cuda import selective_scan as ss
    from paddle_tpu_torch.ops.cuda import ssd
    from paddle_tpu_torch.ops.cuda import wkv as wk
    from paddle_tpu_torch.ops.fused import flash_attention as fd

    return {"flash_dense": fd.dense_calls,
            "selective_scan": ss.launches,
            "selective_scan_bwd": ss.bwd_launches,
            "selective_scan_logdepth": ss.logdepth_launches,
            "selective_scan_logdepth_bwd": ss.logdepth_bwd_launches,
            "ssd": ssd.launches, "ssd_bwd": ssd.bwd_launches,
            "wkv": wk.launches, "wkv_bwd": wk.bwd_launches,
            "flash_attention": fa.launches,
            "flash_attention_bwd": fa.bwd_launches,
            "flash_attention_mma": fa.mma_launches,
            "flash_attention_mma_bwd": fa.mma_bwd_launches,
            "paged_attention": pa.launches,
            "paged_attention_int8": pa.int8_launches,
            "int8_matmul": wo.launches, "int4_matmul": wo.int4_launches,
            "fused_adamw": fw.launches, "grouped_gemm": gg.launches,
            "grouped_gemm_tgmm": gg.tgmm_launches,
            "grouped_gemm_swiglu": gg.swiglu_launches}


def check_losses(losses, what):
    print(f"  {what} losses: {[round(x, 4) for x in losses]}")
    check(all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0] - 0.1,
          f"{what}: losses finite, last {losses[-1]:.4f} < first "
          f"{losses[0]:.4f} - 0.1")


def free_cuda(torch):
    gc.collect()
    torch.cuda.empty_cache()


def run_train_steps(torch, cfg, steps, seed, batch=None, weight_decay=0.1):
    """A fresh model of config ``cfg`` and ``steps`` TrainStep calls (AdamW
    lr 3e-4, bf16 moments, clip 1.0) on ``batch`` (default: the seeded
    tokens as ids and labels); returns the model, the step, the ids, the
    losses and each step's host ms."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    model = LlamaForCausalLM(cfg, seed=seed)
    step = TrainStep(model, None, AdamW(
        learning_rate=3e-4, weight_decay=weight_decay,
        moment_dtype="bfloat16", parameters=model.parameters()),
        clip_norm=1.0)
    if batch is None:
        ids = train_tokens(torch, seed)
        batch = (ids, ids)
    torch.cuda.synchronize()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step(*batch).item())
        times.append((time.perf_counter() - t0) * 1e3)
    return model, step, batch[0], losses, times


def phase_train(torch, seed):
    print("== phase 6: training the Llama-2-7B widths with TrainStep + AdamW")
    L = 4
    cfg = train_config(L)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    model, step, ids, losses, times = run_train_steps(
        torch, train_config(L), TRAIN_STEPS, seed)
    n = read_counts()
    print(f"  model: {cfg.num_params() / 1e9:.3f} B params, {L} layers, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}; step host ms "
          f"{[round(t, 1) for t in times]}")
    check_losses(losses, f"TrainStep x {TRAIN_STEPS}")
    # a fixed batch is memorised within a few steps; a fresh batch must
    # stay near ln(vocab), or attention saw the tokens it predicts
    with torch.no_grad():
        fresh = train_tokens(torch, seed + 1)
        held = model(fresh, labels=fresh)[0].item()
    check(math.isfinite(held) and held > 0.5 * math.log(cfg.vocab_size),
          f"loss on a fresh batch {held:.3f} > ln(vocab) / 2 = "
          f"{0.5 * math.log(cfg.vocab_size):.3f} (no causal leak)")
    check(n["flash_attention"] == L * TRAIN_STEPS
          and n["flash_attention_bwd"] == L * TRAIN_STEPS
          and n["paged_attention"] == 0 and n["fused_adamw"] == 0,
          f"launches over {TRAIN_STEPS} steps: flash fwd "
          f"{n['flash_attention']}, flash bwd {n['flash_attention_bwd']} "
          f"(L x steps = {L * TRAIN_STEPS} each), paged "
          f"{n['paged_attention']}, fused_adamw {n['fused_adamw']} (0 each)")
    step_ms4 = sum(times[2:]) / len(times[2:])
    # the parameters after TRAIN_STEPS steps, for phase 16 (a)
    params = {k: p.detach().cpu() for k, p in model.named_parameters()}
    profile_train_step(torch, step, ids, step_ms4)
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak device memory {peak / 2**30:.1f} GiB")
    n = dict(n, losses=losses, step_ms=step_ms4, params=params, peak=peak)
    del model, step
    free_cuda(torch)
    _, _, _, _, times2 = run_train_steps(torch, train_config(2), 4, seed)
    free_cuda(torch)
    step_ms2 = sum(times2[2:]) / len(times2[2:])
    per_layer = (step_ms4 - step_ms2) / 2
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tps = tokens / (step_ms4 / 1e3)
    # bench.py:56-59: 6 N + the causal attention term, per token
    flops_tok = 6 * cfg.num_params() + 12 * L * TRAIN_SEQ \
        * cfg.hidden_size * 0.5
    mfu = flops_tok * tps / BF16_FLOP_PER_S
    print(f"  step host ms: {step_ms4:.1f} at 4 layers, {step_ms2:.1f} at 2 "
          f"layers: {per_layer:.1f} ms per layer, "
          f"{step_ms2 - 2 * per_layer:.1f} ms of embedding, head, loss and "
          f"update; {tps:.0f} tokens/s, model-FLOP share {mfu:.1%} of "
          f"989 TFLOP/s at 4 layers on {smi()}")
    return n


TRAIN_GROUPS = {"flash fwd": ("flash_fwd",), "flash bwd": ("flash_bwd",),
                "matmul": ("gemm", "gemv", "nvjet", "cutlass", "xmma")}


def profile_train_step(torch, step, ids, step_ms, groups=None, top=8,
                       batch=None):
    """One TrainStep under ``torch.profiler`` (on ``batch``, default ``(ids,
    ids)``): device ms by group (kernel names containing a group's keys;
    the first group that matches takes it) and the device's idle share of
    the unprofiled step."""
    from torch.profiler import ProfilerActivity, profile, record_function

    opt = step._opt
    apply = opt.apply_gradients_

    def traced(*args, **kw):
        with record_function("ptt::apply_gradients"):
            return apply(*args, **kw)

    opt.apply_gradients_ = traced
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(*(batch or (ids, ids))).item()
    del opt.apply_gradients_
    # the annotation shows up as a device range too: its span is the
    # optimizer's device time, and it is no kernel
    kernels, adamw = {}, 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if e.key == "ptt::apply_gradients":
            adamw = max(adamw, t / 1e3)
        elif t > 0 and e.device_type.name == "CUDA":
            kernels[e.key] = kernels.get(e.key, 0.0) + t / 1e3
    busy = sum(kernels.values())
    if busy == 0:
        print(f"  train step {step_ms:.1f} ms on the host clock; the profiler "
              f"recorded no device time (device breakdown not measured)")
        return
    groups = groups or TRAIN_GROUPS
    by_group = dict.fromkeys(groups, 0.0)
    rest = 0.0
    for name, ms in kernels.items():
        low = name.lower()
        group = next((g for g, keys in groups.items()
                      if any(k in low for k in keys)), None)
        if group is None:
            rest += ms
        else:
            by_group[group] += ms
    if 0 < adamw <= rest:
        by_group["AdamW elementwise (its device span)"] = adamw
        by_group["other"] = rest - adamw
    elif adamw > 0:
        # the span outlasts the ungrouped kernels: it holds gaps, and is not
        # taken out of them
        by_group["AdamW span (gaps included)"] = adamw
        by_group["other (AdamW's kernels included)"] = rest
    else:
        by_group["AdamW elementwise"] = "not measured"
        by_group["other"] = rest
    print(f"  train step: {step_ms:.1f} ms on the host clock, device busy "
          f"{busy:.1f} ms: idle share {1 - busy / step_ms:.1%}")
    print("  device ms per step by group: " + ", ".join(
        f"{g} {ms:.2f}" if isinstance(ms, float) else f"{g} {ms}"
        for g, ms in by_group.items()))
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {ms:8.3f} ms  {name[:100]}")


def check_flash_counts(n, layers, steps, what, fwd_per_layer=1):
    check(n["flash_attention"] == fwd_per_layer * layers * steps
          and n["flash_attention_bwd"] == layers * steps
          and n["flash_dense"] == 0 and n["paged_attention"] == 0
          and n["fused_adamw"] == 0,
          f"{what}: launches over {steps} steps: flash fwd "
          f"{n['flash_attention']} ({fwd_per_layer} x L x steps = "
          f"{fwd_per_layer * layers * steps}), flash bwd "
          f"{n['flash_attention_bwd']} (L x steps = {layers * steps}), "
          f"plain-route flash calls {n['flash_dense']}, paged "
          f"{n['paged_attention']}, fused_adamw {n['fused_adamw']} (0 each)")


def phase_train_32(torch, seed):
    L, steps = 32, 6
    print(f"== phase 6b: the 7B proxy at its {L} layers (save_dots "
          f"recompute), TrainStep + AdamW")
    cfg = save_dots(L)
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    model, step, ids, losses, times = run_train_steps(torch, cfg, steps, seed)
    n = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  model: {cfg.num_params() / 1e9:.3f} B params, {L} layers, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, {steps} steps in "
          f"{time.perf_counter() - t0:.1f} s (build included); step host ms "
          f"{[round(t, 1) for t in times]}")
    check_losses(losses, f"{L}-layer TrainStep x {steps}")
    check_flash_counts(n, L, steps, "save_dots keeps flash's out and lse")
    step_ms = sum(times[2:]) / len(times[2:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tps = tokens / (step_ms / 1e3)
    flops_tok = llama_flops_per_token(cfg, TRAIN_SEQ)
    print(f"  step host ms {step_ms:.1f} (mean of steps 3-{steps}), "
          f"{tps:.0f} tokens/s, model-FLOP share "
          f"{flops_tok * tps / BF16_FLOP_PER_S:.1%} of 989 TFLOP/s at "
          f"{L} layers (no extrapolation; {flops_tok * tokens / 1e12:.1f} "
          f"TFLOP a step), peak device memory {peak:.1f} GiB "
          f"({torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}"
          f" GiB on the card) on {smi()}")
    profile_train_step(torch, step, ids, step_ms, top=12)
    del model, step
    free_cuda(torch)
    return n


def phase_recompute_full(torch, seed):
    L, steps = 4, 4
    print(f"== phase 6c: the full recompute policy at {L} layers")
    from paddle_tpu_torch.models import LlamaForCausalLM

    ids = train_tokens(torch, seed)
    first = {}
    for policy in (None, "full"):
        over = {} if policy is None else dict(recompute=True,
                                              recompute_policy=policy)
        model = LlamaForCausalLM(train_config(L, **over), seed=seed)
        loss, _ = model(ids, labels=ids)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads)).item()
        first[policy] = (loss.detach().float().cpu(), norm)
        del model, loss, grads
        free_cuda(torch)
    (l0, n0), (l1, n1) = first[None], first["full"]
    check(torch.equal(l0, l1),
          f"full recompute: first-step loss {l1.item():.6f} equals the "
          f"loss without recompute {l0.item():.6f} bit for bit")
    check(abs(n1 - n0) <= 1e-3 * n0,
          f"full recompute: gradient global norm {n1:.6f} within 1e-3 "
          f"relative of {n0:.6f} without recompute")
    peaks, above, step_ms = {}, {}, {}
    for policy in (None, "full", "save_dots"):
        over = {} if policy is None else dict(recompute=True,
                                              recompute_policy=policy)
        free_cuda(torch)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        model, step, _, losses, times = run_train_steps(
            torch, train_config(L, **over), steps, seed)
        n = read_counts()
        peaks[policy] = torch.cuda.max_memory_allocated() / 2**30
        step_ms[policy] = sum(times[2:]) / len(times[2:])
        # the forward and backward alone, above the weights and moments:
        # the activations a policy keeps (and the gradients as they land);
        # the whole step's peak is the update's at this depth
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        loss, _ = model(ids, labels=ids)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        above[policy] = (torch.cuda.max_memory_allocated() - resident) / 2**30
        del loss, grads
        name = policy or "none"
        check(all(math.isfinite(x) for x in losses),
              f"{name}: losses finite {[round(x, 4) for x in losses]}")
        check_flash_counts(n, L, steps, f"recompute {name}",
                           fwd_per_layer=2 if policy == "full" else 1)
        del model, step
        free_cuda(torch)
    print(f"  {L} layers, batch {TRAIN_BATCH} x {TRAIN_SEQ}: peak device "
          f"memory of a step " + ", ".join(f"{p or 'none'} {peaks[p]:.2f} GiB"
                                           for p in peaks)
          + "; forward and backward above the weights and moments "
          + ", ".join(f"{p or 'none'} {above[p]:.2f} GiB" for p in above)
          + "; step host ms (mean of steps 3-4) " + ", ".join(
              f"{p or 'none'} {step_ms[p]:.1f}" for p in step_ms)
          + f" on {smi()}")


def phase_packed(torch, seed):
    L, steps = 4, 6
    print(f"== phase 6d: packed sequences (segment ids, positions restarting"
          f" per segment) at the 7B widths, {L} layers")
    from paddle_tpu_torch.core.device import make_generator

    gen = make_generator(seed + 2, "cuda")
    seg, pos = packed_segments(torch, gen, TRAIN_BATCH, TRAIN_SEQ)
    ids = train_tokens(torch, seed)
    labels = ids.clone()
    # a segment's first token is no target of the previous segment
    labels[:, 1:][seg[:, 1:] != seg[:, :-1]] = -100
    print(f"  segments a row: {[int(r.max()) + 1 for r in seg]}")
    free_cuda(torch)
    reset_counts()
    model, step, _, losses, times = run_train_steps(
        torch, train_config(L), steps, seed,
        batch=(ids, labels, None, seg, pos))
    n = read_counts()
    print(f"  step host ms {[round(t, 1) for t in times]}")
    check_losses(losses, f"packed TrainStep x {steps}")
    check_flash_counts(n, L, steps, "packed")
    with torch.no_grad():
        full = model(ids[:1], segment_ids=seg[:1], position_ids=pos[:1])[0]
        worst = 0.0
        for sid in range(int(seg[0].max()) + 1):
            cols = (seg[0] == sid).nonzero().squeeze(1)
            alone = model(ids[:1, cols])[0]
            rel = ((full[cols] - alone).norm() / alone.norm()).item()
            worst = max(worst, rel)
        check(math.isfinite(worst) and worst <= LOGITS_REL_L2,
              f"packed row 0: each segment's logits against the segment "
              f"run alone, worst relative L2 {worst:.3e} <= {LOGITS_REL_L2}")
    del model, step, full
    free_cuda(torch)


def longctx_config():
    """``bench.py:325-342``'s long-context Llama: 24 layers, hidden 1024, 8
    heads of 128, sequences of 16384, ``save_dots`` recompute."""
    from paddle_tpu_torch.models import LlamaConfig

    return LlamaConfig(vocab_size=32000, hidden_size=1024,
                       intermediate_size=2816, num_hidden_layers=24,
                       num_attention_heads=8, num_key_value_heads=8,
                       max_position_embeddings=LONG_SEQ, dtype="bfloat16",
                       recompute=True, recompute_policy="save_dots",
                       fused_loss=True)


def phase_longctx(torch, seed):
    cfg = longctx_config()
    L, steps = cfg.num_hidden_layers, LONG_STEPS
    print(f"== phase 6e: long context, b1 x {LONG_SEQ}, {L} layers, "
          f"save_dots")
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ids = train_tokens(torch, seed, (1, LONG_SEQ))
    # bench.py's AdamW: lr 3e-4, the default weight decay, bf16 moments
    model, step, _, losses, times = run_train_steps(
        torch, cfg, steps, seed, batch=(ids, ids), weight_decay=0.01)
    n = read_counts()
    check(all(math.isfinite(x) for x in losses),
          f"long context: losses finite {[round(x, 4) for x in losses]}")
    check_flash_counts(n, L, steps, "long context")
    step_ms = sum(times[1:]) / len(times[1:])
    tps = LONG_SEQ / (step_ms / 1e3)
    flops_tok = llama_flops_per_token(cfg, LONG_SEQ)
    print(f"  {cfg.num_params() / 1e6:.1f} M params; step host ms "
          f"{[round(t, 1) for t in times]}, {step_ms:.1f} (mean of steps "
          f"2-{steps}), {tps:.0f} tokens/s, model-FLOP share "
          f"{flops_tok * tps / BF16_FLOP_PER_S:.1%}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB on {smi()}")
    del model, step
    free_cuda(torch)


def phase_eager(torch, seed):
    print("== phase 7: the eager loop with FusedAdamW")
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import FusedAdamW

    L = 4
    model = LlamaForCausalLM(train_config(L), seed=seed)
    opt = FusedAdamW(learning_rate=3e-4, weight_decay=0.1,
                     parameters=model.parameters())
    ids = train_tokens(torch, seed)
    torch.cuda.synchronize()
    reset_counts()
    losses, times = [], []
    for _ in range(EAGER_STEPS):
        t0 = time.perf_counter()
        loss, _ = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
        times.append((time.perf_counter() - t0) * 1e3)
    n = read_counts()
    check_losses(losses, f"FusedAdamW x {EAGER_STEPS}")
    check(n["fused_adamw"] == EAGER_STEPS
          and n["flash_attention"] == n["flash_attention_bwd"]
          == L * EAGER_STEPS,
          f"launches over {EAGER_STEPS} steps: fused_adamw "
          f"{n['fused_adamw']} (1 per step), flash fwd "
          f"{n['flash_attention']} and bwd {n['flash_attention_bwd']} "
          f"({L * EAGER_STEPS} each)")
    print(f"  eager step host ms {[round(t, 1) for t in times]}; flat "
          f"master + moments {3 * opt._flat.numel() * 4 / 2**30:.1f} GiB")
    del model, opt
    free_cuda(torch)
    return n


# gmm_kernel: the fused swiglu; gmm_wgmma_kernel: gmm and tgmm_wgmma_kernel
MOE_GROUPS = {"grouped GEMM": ("swiglu_wgmma_kernel", "gmm_wgmma_kernel"),
              **TRAIN_GROUPS}


def phase_moe_train(torch, seed):
    print("== phase 8: MoE-Llama training (8 experts, top-2) with TrainStep "
          "+ AdamW")
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import MoELlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = moe_config()
    L = cfg.num_hidden_layers
    n_moe = L // cfg.moe_every
    total, activated = cfg.param_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = MoELlamaForCausalLM(cfg, seed=seed)
    step = TrainStep(model, None, AdamW(
        learning_rate=3e-4, moment_dtype="bfloat16",
        parameters=model.parameters()), clip_norm=1.0)
    ids = train_tokens(torch, seed, (MOE_BATCH, MOE_SEQ))
    torch.cuda.synchronize()
    print(f"  model: {total / 1e6:.1f} M params ({activated / 1e6:.1f} M "
          f"activated per token), {L} layers ({n_moe} MoE), built in "
          f"{time.perf_counter() - t0:.1f} s; batch {MOE_BATCH} x {MOE_SEQ}")
    reset_counts()
    losses, times = [], []
    for _ in range(MOE_STEPS):
        t0 = time.perf_counter()
        losses.append(step(ids, ids).item())
        times.append((time.perf_counter() - t0) * 1e3)
    n = read_counts()
    print(f"  step host ms {[round(t, 1) for t in times]}")
    check_losses(losses, f"MoE TrainStep x {MOE_STEPS}")
    routed = cfg.moe_topk * MOE_BATCH * MOE_SEQ
    for i, moe in enumerate(model.moe_layers()):
        load = moe.expert_load.tolist()
        print(f"  MoE layer {2 * i + 1}: kept rows per expert {load}, drop "
              f"share {1 - sum(load) / routed:.2%} (last step)")
    steps = MOE_STEPS
    check(n["grouped_gemm_swiglu"] == n_moe * steps
          and n["grouped_gemm"] == 3 * n_moe * steps
          and n["grouped_gemm_tgmm"] == 2 * n_moe * steps
          and n["flash_attention"] == L * steps
          and n["flash_attention_bwd"] == L * steps
          and n["fused_adamw"] == 0 and n["paged_attention"] == 0
          and n["paged_attention_int8"] == 0,
          f"launches over {steps} steps: swiglu "
          f"{n['grouped_gemm_swiglu']} ({n_moe} x steps), gmm "
          f"{n['grouped_gemm']} (3 x {n_moe} x steps), tgmm "
          f"{n['grouped_gemm_tgmm']} (2 x {n_moe} x steps), flash fwd "
          f"{n['flash_attention']} and bwd {n['flash_attention_bwd']} "
          f"({L} x steps), fused_adamw {n['fused_adamw']}, paged "
          f"{n['paged_attention'] + n['paged_attention_int8']} (0 each)")
    with torch.no_grad():
        fresh = train_tokens(torch, seed + 1, (MOE_BATCH, MOE_SEQ))
        held = model(fresh, labels=fresh)[0].item()
    check(math.isfinite(held) and held > 0.5 * math.log(cfg.vocab_size),
          f"MoE loss on a fresh batch {held:.3f} > ln(vocab) / 2 = "
          f"{0.5 * math.log(cfg.vocab_size):.3f} (no causal leak)")
    step_ms = sum(times[2:]) / len(times[2:])
    tokens = MOE_BATCH * MOE_SEQ
    tps = tokens / (step_ms / 1e3)
    # bench.py:244: 6 x activated params + the causal attention term
    flops_tok = 6 * activated + 12 * L * MOE_SEQ * cfg.hidden_size * 0.5
    print(f"  step host ms {step_ms:.1f} (mean of steps 3-{steps}): "
          f"{tps:.0f} tokens/s, model-FLOP share "
          f"{flops_tok * tps / BF16_FLOP_PER_S:.1%} of 989 TFLOP/s "
          f"({flops_tok * tokens / 1e12:.1f} TFLOP per step, bound "
          f"{flops_tok * tokens / BF16_FLOP_PER_S * 1e3:.1f} ms); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
          f"GiB on {smi()}")
    profile_train_step(torch, step, ids, step_ms, MOE_GROUPS, top=16)
    del model, step
    free_cuda(torch)
    return n


SSM_GROUPS = {
    "selective scan fwd": ("scan_fwd_",),
    "selective scan bwd": ("scan_bwd_",),
    "wkv fwd": ("wkv_fwd_",), "wkv bwd": ("wkv_bwd_",),
    **TRAIN_GROUPS}
# the conv group first: cuDNN's implicit-GEMM convolutions are xmma kernels;
# "copies": PyTorch's same-dtype copies (layout changes and .contiguous())
MAMBA2_GROUPS = {
    "SSD fwd": ("ssd_fwd_",), "SSD bwd": ("ssd_bwd_",),
    "conv": ("conv", "fprop", "dgrad", "wgrad"),
    "cuBLAS": TRAIN_GROUPS["matmul"], "copies": ("direct_copy",)}


def phase_ssm_train(torch, seed, family):
    """Phase 9 (``family="mamba"``), 10 (``"rwkv"``) or 11 (``"mamba2"``):
    the model at ``bench.py``'s full width and depth and batch (16 x 1024
    seeded tokens; Mamba-2 8 x 1024), ``SSM_STEPS`` TrainStep steps with
    AdamW (lr 3e-4, bf16 moments) and clip 1.0 as ``bench.py`` trains it.
    Checks finite, falling losses, a fresh-batch loss above ln(vocab) / 2,
    and one forward and one backward launch of the family's kernel per
    layer and step and no other kernel of the port; prints the step time,
    tokens/s, the model-FLOP share by ``bench.py``'s ``6 N`` (the
    recurrence's operations excluded, as there), peak memory and a profiled
    step. Returns the launch counts."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (Mamba2ForCausalLM,
                                         MambaForCausalLM, RwkvForCausalLM)
    from paddle_tpu_torch.optimizer import AdamW

    shape, groups = (SSM_B, SSM_L), SSM_GROUPS
    if family == "mamba":
        phase, title, cfg, cls = 9, "Mamba-130m", mamba_config(), \
            MambaForCausalLM
        fwd, bwd = "selective_scan", "selective_scan_bwd"
    elif family == "rwkv":
        phase, title, cfg, cls = 10, "RWKV-169m", rwkv_config(), \
            RwkvForCausalLM
        fwd, bwd = "wkv", "wkv_bwd"
    else:
        phase, title, cfg, cls = 11, "Mamba-2", mamba2_config(), \
            Mamba2ForCausalLM
        fwd, bwd = "ssd", "ssd_bwd"
        shape, groups = (MAMBA2_B, MAMBA2_L), MAMBA2_GROUPS
    print(f"== phase {phase}: {title} training with TrainStep + AdamW")
    L = cfg.num_hidden_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = cls(cfg, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    step = TrainStep(model, None, AdamW(
        learning_rate=3e-4, moment_dtype="bfloat16",
        parameters=model.parameters()), clip_norm=1.0)
    ids = train_tokens(torch, seed, shape)
    torch.cuda.synchronize()
    print(f"  model: {n_params / 1e6:.1f} M params, {L} layers, hidden "
          f"{cfg.hidden_size}, built in {time.perf_counter() - t0:.1f} s; "
          f"batch {shape[0]} x {shape[1]}")
    reset_counts()
    losses, times = [], []
    for _ in range(SSM_STEPS):
        t0 = time.perf_counter()
        losses.append(step(ids, ids).item())
        times.append((time.perf_counter() - t0) * 1e3)
    n = read_counts()
    print(f"  step host ms {[round(t, 1) for t in times]}")
    check_losses(losses, f"{title} TrainStep x {SSM_STEPS}")
    others = {k: v for k, v in n.items() if k not in (fwd, bwd) and v}
    check(n[fwd] == L * SSM_STEPS and n[bwd] == L * SSM_STEPS
          and not others,
          f"launches over {SSM_STEPS} steps: {fwd} {n[fwd]}, {bwd} "
          f"{n[bwd]} ({L} x steps each), other kernels {others or 0}")
    with torch.no_grad():
        fresh = train_tokens(torch, seed + 1, shape)
        held = model(fresh, labels=fresh)[0].item()
    check(math.isfinite(held) and held > 0.5 * math.log(cfg.vocab_size),
          f"{title} loss on a fresh batch {held:.3f} > ln(vocab) / 2 = "
          f"{0.5 * math.log(cfg.vocab_size):.3f} (no causal leak)")
    step_ms = sum(times[2:]) / len(times[2:])
    tokens = shape[0] * shape[1]
    tps = tokens / (step_ms / 1e3)
    flops_tok = 6 * n_params             # bench.py:313, :384, :415
    print(f"  step host ms {step_ms:.1f} (mean of steps 3-{SSM_STEPS}): "
          f"{tps:.0f} tokens/s, model-FLOP share "
          f"{flops_tok * tps / BF16_FLOP_PER_S:.1%} of 989 TFLOP/s "
          f"({flops_tok * tokens / 1e12:.1f} TFLOP per step, bound "
          f"{flops_tok * tokens / BF16_FLOP_PER_S * 1e3:.1f} ms); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
          f"GiB on {smi()}")
    profile_train_step(torch, step, ids, step_ms, groups, top=12)
    del model, step
    free_cuda(torch)
    return dict(n, losses=losses, step_ms=step_ms)


# phase 12: the Paddle training loop
LOOP_ROWS = 8                    # dataset rows: 4 batches an epoch
LOOP_O1_STEPS, LOOP_O2_STEPS, LOOP_SKIP_STEPS = 10, 20, 6
LOOP_RESUME_AT, LOOP_INF_STEP = 10, 3
LOOP_LAYERS = 2                  # cut from 4 to keep the run within its time


class LoopRows:
    """Seeded token rows of TRAIN_SEQ, a map-style numpy dataset (the
    DataLoader's process workers read it in forked children)."""

    def __init__(self, seed):
        import numpy as np

        self.rows = np.random.RandomState(seed).randint(
            0, 32000, (LOOP_ROWS, TRAIN_SEQ))

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


def loop_batches(seed):
    """Batches of TRAIN_BATCH rows from a shuffled DataLoader with two
    process workers, moved to the card (``places``), epoch after epoch,
    from ``np.random.seed(seed)``."""
    import numpy as np

    from paddle_tpu_torch.io import DataLoader

    loader = DataLoader(LoopRows(seed), batch_size=TRAIN_BATCH,
                        shuffle=True, num_workers=2, drop_last=True,
                        places="cuda")
    np.random.seed(seed)
    while True:
        yield from loader


def loop_step(torch, model, opt, ids, level, scaler=None, sched=None,
              span=None):
    """One step of the Paddle loop: the forward under ``auto_cast(level)``,
    the (scaled) backward, the (scaler's) optimizer step inside ``span``,
    the scaler's update, ``clear_grad`` and the scheduler's step. Returns
    the loss (a device scalar)."""
    import contextlib

    from paddle_tpu_torch import amp

    with amp.auto_cast(level=level, dtype="bfloat16"):
        loss, _ = model(ids, labels=ids)
    (loss if scaler is None else scaler.scale(loss)).backward()
    with span or contextlib.nullcontext():
        if scaler is None:
            opt.step()
        else:
            scaler.step(opt)
    if scaler is not None:
        scaler.update()
    opt.clear_grad()
    if sched is not None:
        sched.step()
    return loss.detach()


def profile_loop_step(torch, run, what):
    """One loop step under ``torch.profiler``: the device's busy ms, the
    optimizer's kernel ms (the device activity inside the device span of
    ``ptt::optimizer``: unscale, clip and update) and its share of the
    busy time, and the span itself (gaps included: the eager optimizer
    launches one parameter at a time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(record_function("ptt::optimizer")).item()
        host = (time.perf_counter() - t0) * 1e3
    span, device = None, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        r = e.time_range
        if e.name == "ptt::optimizer":
            if span is None or r.end - r.start > span[1] - span[0]:
                span = (r.start, r.end)
        else:
            device.append((r.start, r.end))
    busy = sum(b - a for a, b in device) / 1e3
    if busy == 0 or span is None:
        print(f"  {what}: profiled step {host:.1f} ms on the host clock; no "
              f"device time recorded (optimizer share not measured)")
        return
    opt_ms = sum(b - a for a, b in device
                 if a >= span[0] and b <= span[1]) / 1e3
    print(f"  {what}: profiled step {host:.1f} ms on the host clock, device "
          f"busy {busy:.1f} ms; the optimizer's kernels {opt_ms:.2f} ms = "
          f"{opt_ms / busy:.1%} of it, in a device span of "
          f"{(span[1] - span[0]) / 1e3:.2f} ms")


def loop_report(torch, times, what):
    steady = times[2:] or times
    print(f"  {what}: host ms per step {[round(t, 1) for t in times]} "
          f"(mean after 2: {sum(steady) / len(steady):.1f}); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")


def loop_o1(torch, seed):
    """(a) An f32 model under auto_cast O1 with AdamW."""
    import dataclasses

    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    L = LOOP_LAYERS
    cfg = dataclasses.replace(train_config(L), dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    model = LlamaForCausalLM(cfg, seed=seed)
    opt = AdamW(learning_rate=3e-4, weight_decay=0.1,
                parameters=model.parameters())
    data = loop_batches(seed)
    torch.cuda.synchronize()
    reset_counts()
    losses, times = [], []
    for _ in range(LOOP_O1_STEPS):
        t0 = time.perf_counter()
        losses.append(loop_step(torch, model, opt, next(data), "O1").item())
        times.append((time.perf_counter() - t0) * 1e3)
    n = read_counts()
    check_losses(losses, f"(a) O1, f32 model, AdamW x {LOOP_O1_STEPS}")
    check_flash_counts(n, L, LOOP_O1_STEPS, "(a) O1")
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          "(a) O1: the parameters stay f32 (the white-listed cast fed the "
          "bf16 flash kernels)")
    loop_report(torch, times, "(a) O1")
    profile_loop_step(torch, lambda span: loop_step(
        torch, model, opt, next(data), "O1", span=span), "(a) O1")
    del model, opt, data
    free_cuda(torch)


def o2_setup(torch, seed):
    """A model, AdamW with master weights, a clip object and a warmup over
    a cosine decay, through ``amp.decorate`` at O2, and a GradScaler."""
    import dataclasses

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)

    cfg = dataclasses.replace(train_config(LOOP_LAYERS), dtype="float32")
    model = LlamaForCausalLM(cfg, seed=seed)
    sched = LinearWarmup(CosineAnnealingDecay(3e-4, 20), 5, 0, 3e-4)
    opt = AdamW(learning_rate=sched, multi_precision=True, weight_decay=0.1,
                grad_clip=ClipGradByGlobalNorm(1.0),
                parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2")
    return model, opt, sched, amp.GradScaler(init_loss_scaling=2.0 ** 15)


def to_cpu(x):
    if hasattr(x, "detach"):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    return x


def loop_o2(torch, seed):
    """(b) O2 for LOOP_O2_STEPS, its state saved after LOOP_RESUME_AT;
    (d) a fresh model, optimizer, scheduler and scaler loaded from it run
    the rest on the same batches."""
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)

    L = LOOP_LAYERS
    torch.cuda.reset_peak_memory_stats()
    model, opt, sched, scaler = o2_setup(torch, seed)
    start = [p.detach().float() for p in model.parameters()]
    data = loop_batches(seed + 1)
    torch.cuda.synchronize()
    reset_counts()
    losses, times, lrs, saved = [], [], [], None
    for i in range(LOOP_O2_STEPS):
        lrs.append(opt.get_lr())
        t0 = time.perf_counter()
        losses.append(loop_step(torch, model, opt, next(data), "O2", scaler,
                                sched).item())
        times.append((time.perf_counter() - t0) * 1e3)
        if i + 1 == LOOP_RESUME_AT:
            t0 = time.perf_counter()
            saved = (to_cpu(model.state_dict()), to_cpu(opt.state_dict()),
                     scaler.state_dict())
            save_s = time.perf_counter() - t0
    n = read_counts()
    check_losses(losses, f"(b) O2, AdamW(multi_precision) + clip + "
                         f"LinearWarmup(cosine) + GradScaler x "
                         f"{LOOP_O2_STEPS}")
    check_flash_counts(n, L, LOOP_O2_STEPS, "(b) O2")
    ref = LinearWarmup(CosineAnnealingDecay(3e-4, 20), 5, 0, 3e-4)
    want = []
    for _ in range(LOOP_O2_STEPS):
        want.append(ref())
        ref.step()
    check(lrs == want, f"(b) the learning rates are the scheduler's own: "
                       f"{[f'{x:.3e}' for x in lrs[:7]]} ...")
    sd = opt.state_dict()
    params = list(model.parameters())
    masters = [sd[f"p{i}.master"] for i in range(len(params))]
    check(all(p.dtype == torch.bfloat16 for p in params)
          and all(m.dtype == torch.float32 for m in masters)
          and all(torch.equal(p.detach(), m.to(torch.bfloat16))
                  for p, m in zip(params, masters)),
          f"(b) {len(params)} bf16 parameters, each the cast of its f32 "
          f"master")
    moved = sum(not torch.equal(m, s) for m, s in zip(masters, start))
    check(moved == len(masters), f"(b) masters that moved: {moved} of "
                                 f"{len(masters)}")
    check(scaler.get_loss_scaling() == 2.0 ** 15,
          f"(b) no inf in {LOOP_O2_STEPS} steps: the scale stays "
          f"{scaler.get_loss_scaling():.0f}")
    loop_report(torch, times, "(b) O2")
    print(f"  (b) state after step {LOOP_RESUME_AT} copied to the host in "
          f"{save_s:.2f} s")
    final = [p.detach().clone() for p in model.parameters()]
    profile_loop_step(torch, lambda span: loop_step(
        torch, model, opt, next(data), "O2", scaler, sched, span=span),
        "(b) O2")
    del model, opt, sched, scaler, data, start, masters, sd, params
    free_cuda(torch)

    # (d) resume
    model, opt, sched, scaler = o2_setup(torch, seed + 7)
    model.load_state_dict(saved[0])
    opt.set_state_dict(saved[1])
    scaler.load_state_dict(saved[2])
    del saved
    data = loop_batches(seed + 1)
    for _ in range(LOOP_RESUME_AT):
        next(data)
    reset_counts()
    resumed = []
    for _ in range(LOOP_RESUME_AT, LOOP_O2_STEPS):
        resumed.append(loop_step(torch, model, opt, next(data), "O2",
                                 scaler, sched).item())
    n = read_counts()
    check_flash_counts(n, L, LOOP_O2_STEPS - LOOP_RESUME_AT, "(d) resume")
    same = [torch.equal(p.detach(), q)
            for p, q in zip(model.parameters(), final)]
    print(f"  (d) resumed losses {[round(x, 4) for x in resumed]}")
    check(resumed == losses[LOOP_RESUME_AT:] and all(same),
          f"(d) resumed at step {LOOP_RESUME_AT}: steps "
          f"{LOOP_RESUME_AT + 1}-{LOOP_O2_STEPS} give the same losses "
          f"({sum(a == b for a, b in zip(resumed, losses[LOOP_RESUME_AT:]))}"
          f" of {len(resumed)}) and final parameters ({sum(same)} of "
          f"{len(same)}) bit for bit")
    del model, opt, sched, scaler, data, final
    free_cuda(torch)


def loop_fused_skip(torch, seed):
    """(c) FusedAdamW under the scaler: one gradient set to inf at step
    LOOP_INF_STEP; the kernel skips on the device."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import FusedAdamW

    torch.cuda.reset_peak_memory_stats()
    model = LlamaForCausalLM(train_config(LOOP_LAYERS), seed=seed)
    opt = FusedAdamW(learning_rate=3e-4, weight_decay=0.1,
                     parameters=model.parameters())
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    data = loop_batches(seed + 2)
    torch.cuda.synchronize()
    reset_counts()
    losses, times, scales, before = [], [], [], None
    for i in range(1, LOOP_SKIP_STEPS + 1):
        ids = next(data)
        t0 = time.perf_counter()
        with amp.auto_cast(level="O2"):
            loss, _ = model(ids, labels=ids)
        scaler.scale(loss).backward()
        if i == LOOP_INF_STEP:
            with torch.no_grad():
                model.lm_head.weight.grad[7, 11] = float("inf")
            before = [t.clone() for t in (opt._flat, opt._m, opt._v)]
        elif i == LOOP_INF_STEP + 1:
            before = [opt._flat.clone()]
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        losses.append(loss.item())
        times.append((time.perf_counter() - t0) * 1e3)
        scales.append(scaler.get_loss_scaling())
        if i == LOOP_INF_STEP:
            same = [torch.equal(a, b)
                    for a, b in zip(before, (opt._flat, opt._m, opt._v))]
            check(all(same), f"(c) step {i} with an inf gradient: the flat "
                             f"master, m and v bit for bit as before "
                             f"({sum(same)} of 3)")
            check(scales[-1] == scales[-2] / 2,
                  f"(c) the scale halves: {scales[-2]:.0f} -> "
                  f"{scales[-1]:.0f}")
        elif i == LOOP_INF_STEP + 1:
            check(not torch.equal(before[0], opt._flat),
                  f"(c) step {i} updates the flat master again")
        before = None
    n = read_counts()
    print(f"  (c) losses {[round(x, 4) for x in losses]}, scales {scales}")
    check(n["fused_adamw"] == LOOP_SKIP_STEPS
          and n["flash_attention"] == LOOP_LAYERS * LOOP_SKIP_STEPS
          and n["flash_attention_bwd"] == LOOP_LAYERS * LOOP_SKIP_STEPS,
          f"(c) launches over {LOOP_SKIP_STEPS} steps: fused_adamw "
          f"{n['fused_adamw']} (one a step, the skipped one included), "
          f"flash fwd {n['flash_attention']} and bwd "
          f"{n['flash_attention_bwd']} ({LOOP_LAYERS * LOOP_SKIP_STEPS} each)")
    loop_report(torch, times, "(c) FusedAdamW + GradScaler")

    def step(span):
        ids = next(data)
        with amp.auto_cast(level="O2"):
            loss, _ = model(ids, labels=ids)
        scaler.scale(loss).backward()
        with span:
            scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss.detach()

    profile_loop_step(torch, step, "(c) FusedAdamW")
    del model, opt, scaler, data
    free_cuda(torch)


def phase_paddle_loop(torch, seed):
    print(f"== phase 12: the Paddle training loop on the Llama-2-7B widths "
          f"({LOOP_LAYERS} layers): DataLoader -> auto_cast -> GradScaler -> "
          f"optimizer")
    loop_o1(torch, seed)
    loop_o2(torch, seed)
    loop_fused_skip(torch, seed)


# ------------------------------------------------------------- phase 13
VIT_PRESET = "vit-l16"           # bench.py:258-290's bench_vit, bf16
VIT_BATCH, VIT_TRAIN_BATCHES, VIT_EVAL_BATCHES, VIT_EPOCHS = 64, 4, 1, 2
VIT_LR = 3e-4
VIT_NOISE = 0.5                  # image = its class prototype + noise
VIT_MOE_TOL = 2e-2               # (e): max |diff| / max |reference|, bf16


class VitImages:
    """Seeded f32 images ``[3, size, size]``, each its class's prototype (10
    seeded prototypes) plus Gaussian noise: the label is decided by the
    image. A map-style numpy dataset, made in bulk."""

    def __init__(self, n, size, seed):
        import numpy as np

        rng = np.random.RandomState(seed)
        protos = rng.standard_normal((10, 3, size, size)).astype(np.float32)
        self.y = rng.randint(0, 10, n).astype(np.int64)
        self.x = protos[self.y]
        self.x += VIT_NOISE * rng.standard_normal(self.x.shape).astype(
            np.float32)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


def vit_config():
    import dataclasses

    from paddle_tpu_torch.models import VIT_PRESETS

    return dataclasses.replace(VIT_PRESETS[VIT_PRESET], dtype="bfloat16")


def vit_model(torch, seed):
    """The bf16 ViT, an AdamW with a global-norm clip, the loss and top-1 /
    top-5 accuracy through ``Model.prepare``."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.models import VisionTransformer
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm, CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW

    net = VisionTransformer(vit_config(), seed=seed)
    model = ptt.Model(net)
    model.prepare(AdamW(learning_rate=VIT_LR, parameters=net.parameters(),
                        grad_clip=ClipGradByGlobalNorm(1.0)),
                  CrossEntropyLoss(), Accuracy(topk=(1, 5)))
    return model


def vit_recorder(torch):
    """A callback recording each train step's logs and host ms (the step
    ends in ``float(loss)``, a synchronisation) and numpy's RNG state at
    each epoch's start (the sampler draws the epoch's order from it)."""
    import numpy as np

    from paddle_tpu_torch.hapi import Callback

    class Record(Callback):
        def __init__(self):
            super().__init__()
            self.logs, self.ms, self.evals, self.rng = [], [], [], {}

        def on_epoch_begin(self, epoch, logs=None):
            self.rng[epoch] = np.random.get_state()

        def on_train_batch_begin(self, step, logs=None):
            self.t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.ms.append((time.perf_counter() - self.t0) * 1e3)
            self.logs.append(dict(logs))

        def on_eval_end(self, logs=None):
            self.evals.append(dict(logs))

    return Record()


def vit_flops_per_image(cfg, n_params):
    """``bench.py:278-280``: 6 N per token plus the attention term."""
    tokens = cfg.num_patches + 1
    return 6 * n_params * tokens \
        + 12 * cfg.num_hidden_layers * tokens * tokens * cfg.hidden_size


def vit_fit(torch, seed, save_dir):
    """(a) ``Model.fit`` under ``auto_cast(level="O2")``: 2 epochs of 4
    batches, an eval batch after each, ``EarlyStopping`` and the
    checkpoints. Returns the model, the recorder and the datasets."""
    import numpy as np

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.hapi import EarlyStopping

    cfg = vit_config()
    L = cfg.num_hidden_layers
    train = VitImages(VIT_BATCH * VIT_TRAIN_BATCHES, cfg.image_size, seed)
    held = VitImages(VIT_BATCH * VIT_EVAL_BATCHES, cfg.image_size, seed + 1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = vit_model(torch, seed)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.num_params(),
          f"{VIT_PRESET}: {n_params / 1e6:.1f} M parameters, as the config "
          f"counts them")
    torch.cuda.synchronize()
    print(f"  {VIT_PRESET} bf16: image {cfg.image_size}, patch "
          f"{cfg.patch_size}, hidden {cfg.hidden_size}, {L} layers, "
          f"{cfg.num_attention_heads} heads, {cfg.num_classes} classes; "
          f"built in {time.perf_counter() - t0:.1f} s; {len(train)} training "
          f"and {len(held)} held-out images")
    rec = vit_recorder(torch)
    stop = EarlyStopping("eval_loss", patience=1, verbose=0)
    np.random.seed(seed)
    reset_counts()
    t0 = time.perf_counter()
    with amp.auto_cast(level="O2"):
        history = model.fit(train, held, batch_size=VIT_BATCH,
                            epochs=VIT_EPOCHS, save_dir=save_dir, verbose=0,
                            callbacks=[rec, stop])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = read_counts()
    steps = VIT_TRAIN_BATCHES * VIT_EPOCHS
    losses = [s["loss"] for s in rec.logs]
    top1 = [s["acc_top1"] for s in rec.logs]
    print(f"  losses {[round(x, 4) for x in losses]}; [top-1, top-5] "
          f"(running over each epoch) "
          f"{[[round(v, 3) for v in x] for x in top1]}; history "
          f"{json.dumps(history)}")
    check(len(losses) == steps and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0] - 0.5,
          f"(a) {steps} steps, losses finite, last {losses[-1]:.4f} < first "
          f"{losses[0]:.4f} - 0.5")
    # Accuracy(topk=(1, 5)) logs [top-1, top-5], running over the epoch
    first_epoch, last_epoch = top1[VIT_TRAIN_BATCHES - 1][0], top1[-1][0]
    check(last_epoch > first_epoch,
          f"(a) top-1 rises: epoch 2 {last_epoch:.3f} > epoch 1 "
          f"{first_epoch:.3f}; held-out [top-1, top-5] by epoch "
          f"{history['eval_acc_top1']}")
    evals = VIT_EVAL_BATCHES * VIT_EPOCHS
    check(n["flash_attention"] == L * (steps + evals)
          and n["flash_attention_bwd"] == L * steps
          and n["flash_dense"] == 0 and n["fused_adamw"] == 0
          and n["paged_attention"] == 0 and n["grouped_gemm"] == 0,
          f"(a) launches: flash fwd {n['flash_attention']} = {L} x ({steps} "
          f"steps + {evals} eval batches), flash bwd "
          f"{n['flash_attention_bwd']} = {L} x {steps}, plain-route flash "
          f"{n['flash_dense']}, no other kernel of the port")
    files = sorted(os.listdir(save_dir))
    want = sorted(f"{s}.{e}" for s in ("0", "1", "final", "best_model")
                  for e in ("pdparams", "pdopt"))
    check(files == want, f"(a) checkpoints {files}")
    step_ms = statistics.mean(rec.ms[2:])
    ips = VIT_BATCH / (step_ms / 1e3)
    flops = vit_flops_per_image(cfg, n_params)
    print(f"  (a) step host ms {[round(t, 1) for t in rec.ms]} (mean of "
          f"steps 3-{steps}: {step_ms:.1f}): {ips:.0f} images/s, model-FLOP "
          f"share {flops * ips / BF16_FLOP_PER_S:.1%} of 989 TFLOP/s "
          f"({flops * VIT_BATCH / 1e12:.1f} TFLOP a step, bound "
          f"{flops * VIT_BATCH / BF16_FLOP_PER_S * 1e3:.1f} ms); fit "
          f"{wall:.1f} s with evaluation and checkpoints; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB on "
          f"{smi()}")
    return model, rec, train, held, step_ms


VIT_GROUPS = {"conv": ("conv", "fprop", "dgrad", "wgrad"), **TRAIN_GROUPS}


def vit_profile(torch, model, train, step_ms):
    """One ``Model.train_batch`` under ``torch.profiler``, the optimizer's
    ``step`` (clip and AdamW) inside a ``ptt::optimizer`` span: device ms
    by kernel group, the optimizer's kernels and span, the idle share of
    the unprofiled step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch import amp

    x, y = train.x[:VIT_BATCH], train.y[:VIT_BATCH]
    opt = model._optimizer
    plain_step = opt.step

    def traced():
        with record_function("ptt::optimizer"):
            plain_step()

    opt.step = traced
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with amp.auto_cast(level="O2"):
                model.train_batch(x, y)
            host = (time.perf_counter() - t0) * 1e3
    finally:
        del opt.step
    span, kernels = None, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        r = e.time_range
        if e.name == "ptt::optimizer":
            if span is None or r.end - r.start > span[1] - span[0]:
                span = (r.start, r.end)
        else:
            kernels.append((e.name, r.start, r.end))
    busy = sum(b - a for _, a, b in kernels) / 1e3
    if busy == 0:
        print(f"  (a) profiled step {host:.1f} ms on the host clock; no "
              f"device time recorded (breakdown not measured)")
        return
    by_group = dict.fromkeys(VIT_GROUPS, 0.0)
    by_group["other"] = 0.0
    for name, a, b in kernels:
        low = name.lower()
        group = next((g for g, keys in VIT_GROUPS.items()
                      if any(k in low for k in keys)), "other")
        by_group[group] += (b - a) / 1e3
    opt_ms = 0.0 if span is None else sum(
        b - a for _, a, b in kernels if a >= span[0] and b <= span[1]) / 1e3
    span_ms = 0.0 if span is None else (span[1] - span[0]) / 1e3
    print(f"  (a) profiled step {host:.1f} ms on the host clock, device busy "
          f"{busy:.1f} ms: idle share {1 - busy / step_ms:.1%} of the "
          f"{step_ms:.1f} ms unprofiled step; the optimizer's kernels "
          f"{opt_ms:.2f} ms ({opt_ms / busy:.1%} of busy) in a device span of "
          f"{span_ms:.2f} ms; by group: " + ", ".join(
              f"{g} {ms:.2f}" for g, ms in by_group.items()))


def vit_evaluate(torch, model, held):
    """(b) ``evaluate`` and ``predict(stack_outputs=True)``."""
    import numpy as np

    from paddle_tpu_torch import amp

    cfg = vit_config()
    with amp.auto_cast(level="O2"):
        ev = model.evaluate(held, batch_size=VIT_BATCH, verbose=0)
        out = model.predict(held, batch_size=VIT_BATCH, stack_outputs=True)
    check(set(ev) == {"eval_loss", "eval_acc_top1"}
          and math.isfinite(ev["eval_loss"]),
          f"(b) evaluate: {json.dumps(ev)}")
    check(len(out) == 1 and out[0].shape == (len(held), cfg.num_classes)
          and out[0].dtype == np.float32 and bool(np.isfinite(out[0]).all()),
          f"(b) predict: one output {out[0].shape} {out[0].dtype}, finite")
    return out[0]


def vit_resume(torch, seed, model, rec, train, held, save_dir, preds):
    """(c) ``save`` -> ``load`` into a fresh Model: the same predictions bit
    for bit; epoch 2 from the epoch-1 checkpoint: the unbroken run's
    losses and parameters bit for bit."""
    import numpy as np

    from paddle_tpu_torch import amp

    path = os.path.join(save_dir, "saved")
    model.save(path)
    fresh = vit_model(torch, seed + 7)
    fresh.load(path)
    with amp.auto_cast(level="O2"):
        again = fresh.predict(held, batch_size=VIT_BATCH,
                              stack_outputs=True)[0]
    check(np.array_equal(again, preds),
          "(c) save -> load into a fresh Model: predictions bit for bit")
    del fresh
    free_cuda(torch)
    resumed = vit_model(torch, seed + 8)
    resumed.load(os.path.join(save_dir, "0"))
    check(resumed._optimizer._step_count == VIT_TRAIN_BATCHES,
          f"(c) the epoch-1 checkpoint's optimizer resumes at step "
          f"{resumed._optimizer._step_count}")
    rec2 = vit_recorder(torch)
    np.random.set_state(rec.rng[1])
    with amp.auto_cast(level="O2"):
        resumed.fit(train, batch_size=VIT_BATCH, epochs=1, verbose=0,
                    callbacks=[rec2])
    got = [s["loss"] for s in rec2.logs]
    want = [s["loss"] for s in rec.logs[VIT_TRAIN_BATCHES:]]
    check(got == want, f"(c) epoch 2 resumed: losses {got} bit for bit")
    same = all(torch.equal(a, b) for a, b in zip(
        model.network.parameters(), resumed.network.parameters()))
    check(same, "(c) epoch 2 resumed: every parameter bit for bit")
    del resumed
    free_cuda(torch)


def vit_debugging(torch, model, held):
    """(d) Operator statistics over one eval batch, the tensor checker on
    an injected inf (abort, then continue), ``check_numerics``."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.amp import debugging as dbg

    cfg = vit_config()
    L = cfg.num_hidden_layers
    x, y = held.x[:VIT_BATCH], held.y[:VIT_BATCH]
    t0 = time.perf_counter()
    dbg.enable_operator_stats_collection()
    try:
        with amp.auto_cast(level="O2"):
            model.eval_batch(x, y)
    finally:
        stats = dbg.disable_operator_stats_collection(print_table=False)
    torch.cuda.synchronize()
    stats_ms = (time.perf_counter() - t0) * 1e3
    want = {"conv2d": 1, "linear": 6 * L + 1, "flash_attention": L,
            "layer_norm": 2 * L + 1}
    calls = {k: stats.get(k, {}).get("calls") for k in want}
    bad = {k: (r["nan"], r["inf"]) for k, r in stats.items()
           if r["nan"] or r["inf"]}
    check(calls == want and not bad,
          f"(d) stats over one eval batch: calls {calls}, NaN / Inf in "
          f"none of {len(stats)} ops ({sum(r['calls'] for r in stats.values())}"
          f" calls, {stats_ms:.0f} ms with a host sync an op)")
    t0 = time.perf_counter()
    with amp.auto_cast(level="O2"):
        model.eval_batch(x, y)
    torch.cuda.synchronize()
    print(f"  (d) the same eval batch without the stats: "
          f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
    bias = model.network.patch_embed.proj.bias
    keep = bias.detach().clone()
    with torch.no_grad():
        bias[0] = float("inf")
    try:
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(enable=True))
        try:
            with amp.auto_cast(level="O2"):
                model.eval_batch(x, y)
            raised = None
        except FloatingPointError as e:
            raised = str(e)
        finally:
            dbg.disable_tensor_checker()
        check(raised is not None and "Operator conv2d " in raised,
              f"(d) checker, abort mode, inf in the patch bias: raises "
              f"{raised!r}")
        # continue mode, checking conv2d only (one report, not one an op)
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
            enable=True, debug_mode=dbg.DebugMode.CHECK_NAN_INF,
            checked_op_list=["conv2d"]))
        try:
            with amp.auto_cast(level="O2"):
                out = model.predict_batch(x)[0]
        finally:
            dbg.disable_tensor_checker()
        check(out.shape == (VIT_BATCH, cfg.num_classes),
              "(d) checker, CHECK_NAN_INF: the forward runs through")
    finally:
        with torch.no_grad():
            bias.copy_(keep)
    t = torch.tensor([0.0, 1.0, float("nan"), float("inf"), 0.0, 2.0],
                     device="cuda")
    counts = [int(c) for c in dbg.check_numerics(
        t, "vit", "t", debug_mode=dbg.DebugMode.CHECK_NAN_INF)]
    check(counts == [1, 1, 2], f"(d) check_numerics: NaN, Inf, zeros "
                               f"{counts}")
    check(torch._C._len_torch_function_stack() == 0,
          "(d) no mode left on torch's stack")


def swiglu_expert(torch, w1, b1, w2, b2):
    """A module for one expert of a swiglu ``MLPExperts``: its slot's w1,
    b1, w2 and b2 as parameters of its own."""
    class Expert(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w1, self.b1 = torch.nn.Parameter(w1), torch.nn.Parameter(b1)
            self.w2, self.b2 = torch.nn.Parameter(w2), torch.nn.Parameter(b2)

        def forward(self, x):
            g, u = (x @ self.w1 + self.b1).chunk(2, dim=-1)
            return (torch.nn.functional.silu(g) * u) @ self.w2 + self.b2

    return Expert()


def vit_moe_list(torch, seed):
    """(e) ``MoELayer(gate, [8 expert modules])`` at the MoE-Llama's widths,
    one forward and backward, against ``MLPExperts`` with the same weights
    on the capacity route."""
    from paddle_tpu_torch.parallel import GShardGate, MLPExperts, MoELayer

    cfg = moe_config()
    d, h, E = cfg.hidden_size, cfg.intermediate_size, cfg.moe_num_experts
    gate = GShardGate(d, E, capacity_factor=cfg.moe_capacity_factor,
                      dtype=torch.bfloat16, seed=seed)
    experts = MLPExperts(E, d, h, activation="swiglu", dtype=torch.bfloat16,
                         seed=seed + 1)
    dense = MoELayer(gate, experts, dispatch="capacity")
    listed = MoELayer(gate, [swiglu_expert(torch, *(
        getattr(experts, n)[e].detach().clone()
        for n in ("w1", "b1", "w2", "b2"))) for e in range(E)])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(MOE_BATCH, MOE_SEQ, d, generator=gen,
                    device="cuda").bfloat16()
    dy = torch.randn(x.shape, generator=gen, device="cuda").bfloat16()
    results = []
    reset_counts()
    # each layer twice, the second timed: the first call of each warms
    # cuBLAS; the gradients of the second are kept
    for layer in (dense, listed):
        for _ in range(2):
            for p in layer.parameters():
                p.grad = None
            xi = x.detach().requires_grad_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = layer(xi)
            y.backward(dy)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        results.append((y.detach(), xi.grad, gate.weight.grad.clone(), ms))
    n = read_counts()
    (y0, dx0, dg0, ms0), (y1, dx1, dg1, ms1) = results
    errs = {}
    for name, a, b in (("out", y1, y0), ("dx", dx1, dx0),
                       ("dgate", dg1, dg0)):
        errs[name] = ((a.float() - b.float()).abs().max()
                      / b.float().abs().max()).item()
    for e, mod in enumerate(listed.experts.children()):
        for name in ("w1", "b2"):
            g, ref = getattr(mod, name).grad, getattr(experts, name).grad[e]
            errs[f"d{name}[{e}]"] = ((g.float() - ref.float()).abs().max()
                                     / ref.float().abs().max()).item()
    worst = max(errs, key=errs.get)
    check(all(math.isfinite(v) and v <= VIT_MOE_TOL for v in errs.values())
          and sum(n.values()) == 0,
          f"(e) list of {E} experts vs MLPExperts (capacity route), "
          f"{MOE_BATCH} x {MOE_SEQ} tokens at d {d}, h {h}: worst "
          f"{worst} {errs[worst]:.2e} of max |reference| <= {VIT_MOE_TOL} "
          f"(out {errs['out']:.2e}, dx {errs['dx']:.2e}); no kernel of the "
          f"port launched; forward + backward {ms1:.0f} ms (stacked "
          f"{ms0:.0f} ms)")
    del dense, listed, experts, gate, x, dy, results
    free_cuda(torch)


VIT_H14_BATCH, VIT_H14_STEPS = 32, 6


def vit_h14_train(torch, seed):
    """(f) ViT-H14 (image 224, patch 14, hidden 1280, 32 layers, 16 heads
    of 80, 1000 classes, bf16) at full width and depth through
    ``TrainStep`` with AdamW (lr 3e-4) and clip 1.0 as ``bench.py:258-290``
    trains ViT-L16, batch 32 of seeded images and labels: finite losses,
    32 x steps forward and backward launches of the head-dim flash kernels
    (head dim 80) and no other kernel of the port; the step's host ms,
    images/s and model-FLOP share (``bench.py:278-280``'s formula)."""
    import dataclasses

    from paddle_tpu_torch.core.device import make_generator
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import VIT_PRESETS, VisionTransformer
    from paddle_tpu_torch.optimizer import AdamW

    cfg = dataclasses.replace(VIT_PRESETS["vit-h14"], dtype="bfloat16")
    L, b = cfg.num_hidden_layers, VIT_H14_BATCH
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net = VisionTransformer(cfg, seed=seed)
    n_params = sum(p.numel() for p in net.parameters())
    step = TrainStep(net, None, AdamW(learning_rate=VIT_LR,
                                      parameters=net.parameters()),
                     clip_norm=1.0)
    gen = make_generator(seed + 13, "cuda")
    x = torch.randn(b, 3, cfg.image_size, cfg.image_size, generator=gen,
                    device="cuda").bfloat16()
    y = torch.randint(0, cfg.num_classes, (b,), generator=gen, device="cuda")
    torch.cuda.synchronize()
    d = cfg.hidden_size // cfg.num_attention_heads
    print(f"  (f) ViT-H14: {n_params / 1e6:.1f} M params, {L} layers, "
          f"{cfg.num_patches + 1} tokens, heads of {d}, built in "
          f"{time.perf_counter() - t0:.1f} s; batch {b}")
    reset_counts()
    losses, times = [], []
    for _ in range(VIT_H14_STEPS):
        t0 = time.perf_counter()
        losses.append(step(x, y).item())
        times.append((time.perf_counter() - t0) * 1e3)
    n = read_counts()
    print(f"  (f) losses {[round(v, 4) for v in losses]}, step host ms "
          f"{[round(t, 1) for t in times]}")
    check(all(math.isfinite(v) for v in losses),
          f"(f) ViT-H14 TrainStep x {VIT_H14_STEPS}: losses finite")
    others = {k: v for k, v in n.items() if v and k not in (
        "flash_attention_mma", "flash_attention_mma_bwd")}
    check(n["flash_attention_mma"] == L * VIT_H14_STEPS
          and n["flash_attention_mma_bwd"] == L * VIT_H14_STEPS
          and not others,
          f"(f) launches: head-dim flash fwd {n['flash_attention_mma']}, bwd "
          f"{n['flash_attention_mma_bwd']} ({L} x {VIT_H14_STEPS} each), "
          f"other kernels of the port {others or 0}")
    step_ms = statistics.mean(times[2:])
    ips = b / (step_ms / 1e3)
    flops = vit_flops_per_image(cfg, n_params)
    print(f"  (f) step host ms {step_ms:.1f} (mean of steps 3-"
          f"{VIT_H14_STEPS}): {ips:.1f} images/s, model-FLOP share "
          f"{flops * ips / BF16_FLOP_PER_S:.1%} of 989 TFLOP/s; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB on "
          f"{smi()}")
    del net, step, x, y
    free_cuda(torch)


def phase_vit(torch, seed):
    print("== phase 13: VisionTransformer ViT-L16 through Model.fit "
          "(hapi, metrics, callbacks, save / load, amp.debugging) and the "
          "MoE list of experts")
    import shutil
    import tempfile

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    save_dir = tempfile.mkdtemp(prefix="phase13_", dir=root)
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    # the resume in (c) is checked bit for bit: the patch conv's backward
    # takes cuDNN's deterministic algorithms
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        model, rec, train, held, step_ms = vit_fit(torch, seed, save_dir)
        preds = vit_evaluate(torch, model, held)
        vit_resume(torch, seed, model, rec, train, held, save_dir, preds)
        vit_debugging(torch, model, held)
        vit_profile(torch, model, train, step_ms)
        del model
        free_cuda(torch)
        vit_moe_list(torch, seed)
        free_cuda(torch)
        vit_h14_train(torch, seed)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
        shutil.rmtree(save_dir, ignore_errors=True)


# ------------------------------------------------------------- phase 14
# bench.py:424-446's bench_unet: sdxl-small, bf16, batch 32, 4 x 32 x 32
# latents, t in [0, 1000), a 77 x 768 text context, AdamW lr 1e-4, the MSE
# to a fixed noise
UNET_PRESET, UNET_BATCH, UNET_CTX, UNET_STEPS = "sdxl-small", 32, 77, 8
UNET_PARAMS = 275_657_476        # UNET_PRESETS["sdxl-small"] in JAX
# per step: 22 transformer blocks x 2 attentions, 20 at level 1 (d 32, the
# head-dim kernels) and 24 at level 2 and the middle (d 64, the 64 / 128
# kernels)
UNET_MMA_PER_STEP, UNET_WGMMA_PER_STEP = 20, 24
UNET_GROUPS = {"conv": ("conv", "fprop", "dgrad", "wgrad"),
               "flash": ("flash_",), "matmul": TRAIN_GROUPS["matmul"]}


def unet_forward_flops(torch, model, batch):
    """Operations of one forward at ``batch``'s shapes, counted from the
    layers' shapes (forward hooks on one no-grad pass): each convolution 2
    b H_out W_out c_out (c_in / groups) kh kw, each linear 2 rows in out,
    each transformer block's two attentions 4 b s (s + T) C (4 sq sk d a
    head, C = heads d, T the context's tokens). Norms and elementwise work
    are not counted."""
    from paddle_tpu_torch.models.unet import CrossAttnBlock
    from paddle_tpu_torch.nn import Conv2D

    total = [0]

    def conv(mod, inp, out):
        total[0] += 2 * out.numel() * mod.weight[0].numel()

    def linear(mod, inp, out):
        total[0] += 2 * out.numel() * mod.in_features

    def attn(mod, inp, out):
        x, ctx = inp
        b, s, c = x.shape
        total[0] += 4 * b * s * (s + ctx.shape[1]) * c

    hooks = []
    for mod in model.modules():
        if isinstance(mod, Conv2D):
            hooks.append(mod.register_forward_hook(conv))
        elif isinstance(mod, torch.nn.Linear):
            hooks.append(mod.register_forward_hook(linear))
        elif isinstance(mod, CrossAttnBlock):
            hooks.append(mod.register_forward_hook(attn))
    try:
        with torch.no_grad():
            model(*batch)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def phase_unet(torch, seed):
    """Phase 14: ``bench_unet`` as written, on the port: sdxl-small at full
    width and depth (275,657,476 parameters), bf16, through ``TrainStep(
    model, loss_fn, AdamW(lr=1e-4))`` with the fixed-noise MSE loss, batch
    32. Checks the parameter count, finite losses, and per step 44 flash
    forward and 44 backward launches: 20 on the head-dim kernels (level 1,
    d 32) and 24 on the wgmma ones (d 64), no plain-route flash call and no
    other kernel of the port. Prints the step's host ms (mean of steps 3
    on), images/s, the losses, peak memory, the model-FLOP share of 989
    TFLOP/s (3 x the forward's counted operations,
    :func:`unet_forward_flops`) and a profiled step (idle share, device ms
    by group: conv, flash, matmul, the AdamW span, the rest). Returns the
    launch counts."""
    import dataclasses

    from paddle_tpu_torch.core.device import make_generator
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import UNET_PRESETS, UNet2DConditionModel
    from paddle_tpu_torch.optimizer import AdamW

    print(f"== phase 14: the SDXL-style UNet ({UNET_PRESET}) trained as "
          f"bench_unet trains it, TrainStep + AdamW")
    cfg = dataclasses.replace(UNET_PRESETS[UNET_PRESET], dtype="bfloat16")
    b, hw = UNET_BATCH, cfg.sample_size
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = UNet2DConditionModel(cfg, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    gen = make_generator(seed + 14, "cuda")
    noise = torch.randn(b, cfg.in_channels, hw, hw, generator=gen,
                        device="cuda").bfloat16()

    def loss_fn(pred, sample, t, ctx):
        # the fixed noise target, closed over (bench.py:436-441)
        return ((pred.float() - noise.float()) ** 2).mean()

    step = TrainStep(model, loss_fn, AdamW(learning_rate=1e-4,
                                           parameters=model.parameters()))
    x = torch.randn(b, cfg.in_channels, hw, hw, generator=gen,
                    device="cuda").bfloat16()
    t = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
    ctx = torch.randn(b, UNET_CTX, cfg.cross_attention_dim, generator=gen,
                      device="cuda").bfloat16()
    torch.cuda.synchronize()
    print(f"  model: {n_params:,} params in "
          f"{len(list(model.parameters()))} tensors, channels "
          f"{cfg.block_out_channels}, {cfg.num_attention_heads} heads, "
          f"built in {time.perf_counter() - t0:.1f} s; batch {b} x "
          f"{cfg.in_channels} x {hw} x {hw}, context {UNET_CTX} x "
          f"{cfg.cross_attention_dim}")
    check(n_params == UNET_PARAMS,
          f"parameters {n_params:,} == {UNET_PARAMS:,} (the JAX model's)")
    flops = 3 * unet_forward_flops(torch, model, (x, t, ctx))
    reset_counts()
    losses, times = [], []
    for _ in range(UNET_STEPS):
        t0 = time.perf_counter()
        losses.append(step(x, t, ctx).item())
        times.append((time.perf_counter() - t0) * 1e3)
    n = read_counts()
    print(f"  losses {[round(v, 5) for v in losses]}, step host ms "
          f"{[round(v, 1) for v in times]}")
    check(all(math.isfinite(v) for v in losses),
          f"TrainStep x {UNET_STEPS}: losses finite")
    flash = ("flash_attention", "flash_attention_bwd", "flash_attention_mma",
             "flash_attention_mma_bwd")
    others = {k: v for k, v in n.items() if v and k not in flash}
    check(n["flash_attention_mma"] == UNET_MMA_PER_STEP * UNET_STEPS
          and n["flash_attention_mma_bwd"] == UNET_MMA_PER_STEP * UNET_STEPS
          and n["flash_attention"] == UNET_WGMMA_PER_STEP * UNET_STEPS
          and n["flash_attention_bwd"] == UNET_WGMMA_PER_STEP * UNET_STEPS
          and not others,
          f"launches over {UNET_STEPS} steps: flash fwd "
          f"{n['flash_attention_mma']} head-dim (d 32) + "
          f"{n['flash_attention']} wgmma (d 64), bwd "
          f"{n['flash_attention_mma_bwd']} + {n['flash_attention_bwd']} "
          f"({UNET_MMA_PER_STEP} + {UNET_WGMMA_PER_STEP} = 44 a step each), "
          f"plain-route flash and other kernels of the port {others or 0}")
    step_ms = statistics.mean(times[2:])
    ips = b / (step_ms / 1e3)
    print(f"  step host ms {step_ms:.1f} (mean of steps 3-{UNET_STEPS}): "
          f"{ips:.1f} images/s, model-FLOP share "
          f"{flops / (step_ms / 1e3) / BF16_FLOP_PER_S:.1%} of 989 TFLOP/s "
          f"({flops / 1e12:.2f} TFLOP a step counted, bound "
          f"{flops / BF16_FLOP_PER_S * 1e3:.1f} ms); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB on {smi()}")
    profile_train_step(torch, step, None, step_ms, UNET_GROUPS, top=12,
                       batch=(x, t, ctx))
    del model, step
    free_cuda(torch)
    return n


# ------------------------------------------------------------- phase 15
BLOCK_PROJS = (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
               ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj"),
               ("gate", "mlp.gate_proj"), ("up", "mlp.up_proj"),
               ("down", "mlp.down_proj"))


def block_weights(torch, model, kind):
    """Each layer's seven projections for :func:`block_decode`: bf16
    ``[in, out]`` views, or ``(q, scale)`` in JAX's ``quant_weights``
    layouts (int8 ``[K, N]``; int4 two rows a byte, 2r and 2r + 1) of the
    values the fused route quantizes (``weight_quantize`` a column)."""
    from paddle_tpu_torch.incubate.nn.functional import _pack_nibbles
    from paddle_tpu_torch.ops.quant_ops import weight_quantize

    out = []
    with torch.no_grad():
        for layer in model.model.layers:
            ws = {}
            for name, path in BLOCK_PROJS:
                w = layer.get_submodule(path).weight.detach().t()
                if kind == "bf16":
                    ws[name] = w
                    continue
                q, sc = weight_quantize(w, f"weight_only_{kind}")
                q = q.contiguous()
                ws[name] = (_pack_nibbles(q[0::2], q[1::2])
                            if kind == "int4" else q, sc)
            out.append(ws)
    return out


def block_decode(torch, model, weights, kind, ids, n_new):
    """Greedy tokens ``[B, P + n_new]`` from Llama layers composed of the
    incubate names over a ``PagedKVCache`` a layer: a prefill at T = P,
    then ``n_new - 1`` steps at T = 1."""
    import paddle_tpu_torch.incubate.nn.functional as IF
    from paddle_tpu_torch.models import lm_head_tail
    from paddle_tpu_torch.ops.fused.block_attention import (
        PagedKVCache, block_multihead_attention)

    cfg, m = model.config, model.model
    B, P = ids.shape
    eps, hd = cfg.rms_norm_eps, cfg.head_dim

    def lin(x, w):
        if kind == "bf16":
            return IF.fused_linear(x, w)
        return IF.weight_only_linear(x, w[0], weight_scale=w[1],
                                     weight_dtype=kind)

    caches = [PagedKVCache(B, cfg.num_key_value_heads, hd, P + n_new,
                           device=ids.device)
              for _ in range(cfg.num_hidden_layers)]
    toks, x_ids, pos = [], ids, 0
    with torch.inference_mode():
        for _ in range(n_new):
            T = x_ids.shape[1]
            hidden, residual = m.embed_tokens(x_ids), None
            cos = m.rope_cos[pos:pos + T][None, :, None, :]
            sin = m.rope_sin[pos:pos + T][None, :, None, :]
            for layer, w, cache in zip(m.layers, weights, caches):
                if residual is None:
                    x, residual = IF.fused_rms_norm(
                        hidden, layer.input_layernorm.weight, epsilon=eps), \
                        hidden
                else:
                    x, residual = IF.fused_rms_norm(
                        hidden, layer.input_layernorm.weight, epsilon=eps,
                        residual=residual)
                q = lin(x, w["q"]).view(B, T, -1, hd)
                k = lin(x, w["k"]).view(B, T, -1, hd)
                v = lin(x, w["v"]).view(B, T, -1, hd)
                q, k = IF.fused_rotary_position_embedding(q, k, sin=sin,
                                                          cos=cos)
                a, _ = block_multihead_attention(q, k, v, cache)
                x, residual = IF.fused_rms_norm(
                    lin(a.reshape(B, T, -1), w["o"]),
                    layer.post_attention_layernorm.weight, epsilon=eps,
                    residual=residual)
                hidden = lin(IF.swiglu(lin(x, w["gate"]), lin(x, w["up"])),
                             w["down"])
            last = (hidden + residual)[:, -1]
            logits = lm_head_tail(last, m.norm.weight,
                                  model.lm_head.weight.t(), eps)
            toks.append(logits.argmax(dim=-1))
            x_ids, pos = toks[-1][:, None], pos + T
    return torch.cat([ids, torch.stack(toks, dim=1)], dim=1), caches


def block_kernel_times(torch, caches, gen, flush):
    """The paged kernel at the last decode step's shape of phase 15 and the
    weight-only kernels at its four product shapes (m = 4), each timed
    beside its bound."""
    import paddle_tpu_torch.incubate.nn.functional as IF
    from paddle_tpu_torch.ops.cuda.int8_matmul import (int4_weight_matmul,
                                                       int8_weight_matmul)
    from paddle_tpu_torch.ops.cuda.paged_attention import paged_attention

    c = caches[0]
    kvh, _, page, d = c.k_pages.shape
    B, h = c.seq_lens.shape[0], 32
    lens = c.seq_lens
    q = torch.randn((B, h, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    tokens = int(lens.sum().item())
    ms = time_ms(torch, lambda: paged_attention(
        q, c.k_pages, c.v_pages, c.page_table, lens), flush=flush)
    # q k and p v for every query head over its rows' tokens; each kv
    # head's K and V rows read once
    b_ms, by = bound(4 * h * d * tokens,
                     2 * 2 * kvh * d * tokens + 2 * 2 * B * h * d)
    rows = [("paged_attention", f"b {B}, {h}/{kvh} heads, d {d}, "
             f"{tokens // B} tokens a row", ms, b_ms, by)]
    for K, N in ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)):
        w = torch.randn((K, N), generator=gen, device="cuda") * 0.02
        x = torch.randn((B, K), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        for kind, fn in (("int8", int8_weight_matmul),
                         ("int4", int4_weight_matmul)):
            qw, sc = IF.quant_weights(w, algo=f"weight_only_{kind}")
            if kind == "int4":      # as weight_only_linear launches it
                xk = torch.cat([x[:, 0::2], x[:, 1::2]], dim=1)
            else:
                xk = x
            ms = time_ms(torch, lambda: fn(xk, qw, sc), flush=flush)
            wbytes = K * N // (2 if kind == "int4" else 1)
            b_ms, by = bound(2 * B * K * N, wbytes + 4 * N + 2 * B * (K + N))
            rows.append((f"{kind}_matmul", f"m {B}, K {K}, N {N}", ms, b_ms,
                         by))
    card = smi()
    for name, shape, ms, b_ms, by in rows:
        print(f"  15 {name} at {shape}: {ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({by}), {b_ms / ms:.1%} of it; on {card}")


def phase_block_attention(torch, seed, noise_bf16):
    """Phase 15: Llama-3-8B decoded through the Paddle inference surface
    (bf16, int8, int4), held to generate / fused_generate."""
    print("== phase 15: Paddle-style block-attention decode, Llama-3-8B")
    import numpy as np

    from paddle_tpu_torch.core.device import make_generator
    from paddle_tpu_torch.models import (LLAMA_PRESETS, LlamaForCausalLM,
                                         fused_generate, generate)
    from paddle_tpu_torch.models.generation import (fused_weights_cached,
                                                    release_fused_weights)
    from paddle_tpu_torch.ops.fused.block_attention import (
        block_multihead_attention, masked_multihead_attention)

    t_phase = time.perf_counter()
    free_cuda(torch)
    cfg = LLAMA_PRESETS["llama3-8b"]
    L, B, P, N = cfg.num_hidden_layers, DECODE_BATCH, DECODE_PROMPT, \
        NEW_TOKENS
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    model.eval()
    ids = torch.from_numpy(np.random.RandomState(seed + 9).randint(
        0, cfg.vocab_size, (B, P))).cuda()
    prompts = [r.cpu().numpy().astype(np.int32) for r in ids]
    streams, refs, per_token, peaks = {}, {}, {}, {}
    from paddle_tpu_torch.ops.cuda.int8_matmul import kernel_takes

    H, I, KV = cfg.hidden_size, cfg.intermediate_size, \
        cfg.num_key_value_heads * cfg.head_dim
    shapes = ((H, H), (H, KV), (H, KV), (H, H), (H, I), (H, I), (I, H))

    def wo_calls(int4):
        """Launches of one quantized run: every product of every layer at
        each decode step (m = B) and at the prefill (m = B P) where
        ``kernel_takes`` lets the kernel take it."""
        return L * sum((N - 1) * kernel_takes(B, K, n, int4)
                       + kernel_takes(B * P, K, n, int4) for K, n in shapes)
    expects = {"bf16": {"paged_attention": L * (N - 1), "int8_matmul": 0,
                        "int4_matmul": 0, "flash_attention": 0},
               "int8": {"paged_attention": L * (N - 1),
                        "int8_matmul": wo_calls(False), "int4_matmul": 0,
                        "flash_attention": 0},
               "int4": {"paged_attention": L * (N - 1), "int8_matmul": 0,
                        "int4_matmul": wo_calls(True),
                        "flash_attention": 0}}
    print(f"  15 expected weight-only launches a quantized run: int8 "
          f"{wo_calls(False)}, int4 {wo_calls(True)} (7 products x {L} "
          f"layers x {N - 1} decode steps at m = {B} = {7 * L * (N - 1)}, "
          f"less what kernel_takes routes away, plus the prefill's at m = "
          f"{B * P} where it takes them)")
    caches = None
    for kind, expect in expects.items():
        weights = block_weights(torch, model, kind)
        out, counts, per_token[kind], peaks[kind] = run_decoder(
            torch, f"15 block decode {kind}",
            lambda: block_decode(torch, model, weights, kind, ids, N), N,
            expect)
        out, caches = out
        check(tuple(out.shape) == (B, P + N)
              and bool(torch.equal(out[:, :P], ids)),
              f"15 {kind}: [{B}, {P + N}] ids, the prompt kept")
        streams[kind] = out[:, P:].tolist()
        del weights
        if kind == "bf16":
            with torch.inference_mode():
                refs[kind] = generate(model, ids, max_new_tokens=N)[
                    :, P:].tolist()
            # one more decode step of layer 0: the block route against
            # masked_multihead_attention over the dense cache
            c0 = caches[0]
            gen = make_generator(seed + 15, "cuda")
            q, k, v = (torch.randn((B, 1, n, cfg.head_dim), generator=gen,
                                   device="cuda", dtype=torch.bfloat16)
                       for n in (32, 8, 8))
            with torch.inference_mode():
                got, _ = block_multihead_attention(q, k, v, c0)
                S = c0.pages_per_seq * c0.page_size
                table = c0.page_table.long()
                dense = lambda pages: pages[:, table].transpose(0, 1) \
                    .reshape(B, 8, S, cfg.head_dim) \
                    .repeat_interleave(4, dim=1)  # noqa: E731
                want = masked_multihead_attention(
                    q[:, 0], dense(c0.k_pages), dense(c0.v_pages),
                    c0.seq_lens)
            err = (got[:, 0].float() - want.float()).abs().max().item()
            check(err <= OUT_ATOL,
                  f"15 masked_multihead_attention vs block_multihead_"
                  f"attention, one decode step at {P + N} tokens: max "
                  f"|diff| {err:.2e} <= {OUT_ATOL}")
            block_kernel_times(torch, caches, gen, None)
        else:
            refs[kind] = fused_generate(model, ids, max_new_tokens=N,
                                        quantize=kind)[:, P:].tolist()
        del caches
        free_cuda(torch)
    stream_agreement(torch, model, [(p, streams["bf16"][i], refs["bf16"][i])
                                    for i, p in enumerate(prompts)],
                     noise_bf16, "15 block decode bf16 vs generate")
    fused = {k: fused_weights_cached(model, k) for k in ("int8", "int4")}
    for kind in ("int8", "int4"):
        dequantize_into(torch, model, fused[kind], kind == "int4")
        stream_agreement(torch, model, [
            (p, streams[kind][i], refs[kind][i])
            for i, p in enumerate(prompts)], noise_bf16,
            f"15 block decode {kind} vs fused_generate {kind} (dense "
            f"reference: the dequantized weights)")
    release_fused_weights(model)
    del model, fused
    free_cuda(torch)
    print("  15 per token (host ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in per_token.items()) + "; peak GiB: "
        + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items())
        + f"; on {smi()}")
    print(f"  [15: {time.perf_counter() - t_phase:.0f} s]")


# ------------------------------------------------------------- phase 16
# 16 (a) against phase 6 (the same kernels, the update summed in another
# order): each loss within 1e-3 relative (+ 1e-6), each gathered bf16
# parameter within one bf16 step (2^-7 relative, + 1e-6) of phase 6's
HYBRID_LOSS_RTOL, HYBRID_PARAM_RTOL, HYBRID_ATOL = 1e-3, 2.0 ** -7, 1e-6
RING_N = 4                       # 16 (b): ranks of the in-process ring


def phase_hybrid(torch, seed, train):
    """Phase 16: (a) the hybrid-parallel step over NCCL at world size 1,
    (b) the ring and Ulysses schedules with 4 ranks in one process."""
    print("== phase 16: hybrid parallel on one card")
    import torch.distributed as dist

    from paddle_tpu_torch import parallel as Pl
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    t_phase = time.perf_counter()
    train_ms = train["step_ms"]
    free_cuda(torch)
    Pl.init_parallel_env()
    check(dist.get_backend() == "nccl" and Pl.get_world_size() == 1,
          f"16 (a): process group {dist.get_backend()}, world size "
          f"{Pl.get_world_size()}")
    strategy = Pl.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "sep_degree": 1,
                               "sharding_degree": 1, "mp_degree": 1}
    strategy.sharding = True
    strategy.sharding_configs = {"stage": 3}
    fl = Pl.fleet.init(is_collective=True, strategy=strategy)
    L = 4
    cfg = train_config(L, context_parallel=True)
    model = LlamaForCausalLM(cfg, seed=seed)
    step = Pl.ShardedTrainStep(model, None, AdamW(
        learning_rate=3e-4, weight_decay=0.1, moment_dtype="bfloat16",
        parameters=model.parameters()), fl.mesh,
        stage=Pl.ShardingStage.P_G_OS, clip_norm=1.0)
    ids = train_tokens(torch, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step(ids, ids).item())
        times.append((time.perf_counter() - t0) * 1e3)
    n = read_counts()
    check_losses(losses, f"16 (a) ShardedTrainStep x {TRAIN_STEPS}")
    ref = train["losses"]
    rel = max(abs(a - b) / (abs(b) + HYBRID_ATOL / HYBRID_LOSS_RTOL)
              for a, b in zip(losses, ref))
    check(len(ref) == len(losses) and rel <= HYBRID_LOSS_RTOL,
          f"16 (a): losses {[f'{x:.6g}' for x in losses]} against phase "
          f"6's TrainStep {[f'{x:.6g}' for x in ref]}: max |diff| / (|ref| "
          f"+ {HYBRID_ATOL / HYBRID_LOSS_RTOL:g}) {rel:.2e} <= "
          f"{HYBRID_LOSS_RTOL}")
    check_flash_counts(n, L, TRAIN_STEPS, "16 (a) ShardedTrainStep")
    step_ms = sum(times[2:]) / len(times[2:])
    print(f"  16 (a) ShardedTrainStep (fleet, stage 3, world size 1, "
          f"context_parallel): step host ms {step_ms:.1f} (mean of steps "
          f"3-{TRAIN_STEPS}) against phase 6's TrainStep {train_ms:.1f}; "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB on "
          f"{smi()}")
    step.gather_params_to_model()
    worst, differ, total = 0.0, 0, 0
    with torch.no_grad():
        for k, p in model.named_parameters():
            a, b = p.float(), train["params"][k].to(p.device).float()
            d = (a - b).abs()
            worst = max(worst, (d / (b.abs() + HYBRID_ATOL
                                     / HYBRID_PARAM_RTOL)).max().item())
            differ += int((d > 0).sum())
            total += d.numel()
    check(worst <= HYBRID_PARAM_RTOL,
          f"16 (a): the {total} gathered parameters against phase 6's after "
          f"{TRAIN_STEPS} steps: {differ} differ, max |diff| / (|ref| + "
          f"{HYBRID_ATOL / HYBRID_PARAM_RTOL:g}) {worst:.2e} <= "
          f"{HYBRID_PARAM_RTOL:.2e}")
    del model, step
    dist.destroy_process_group()
    free_cuda(torch)
    phase_ring(torch, seed)
    print(f"  [16: {time.perf_counter() - t_phase:.0f} s]")


def phase_ring(torch, seed):
    """Phase 16 (b): the ring schedule and Ulysses with RING_N ranks in
    one process at the long-context shape, against one flash call."""
    from paddle_tpu_torch.core.device import make_generator
    from paddle_tpu_torch.ops.fused.flash_attention import (_backward,
                                                            _forward)
    from paddle_tpu_torch.ops.fused.ring_attention import (ring_flash_bwd,
                                                           ring_flash_fwd,
                                                           rotate)
    from paddle_tpu_torch.parallel.sequence_parallel import (
        local_all_to_all, ulysses_flash)

    n, S, h, d = RING_N, LONG_SEQ, 32, 128
    gen = make_generator(seed + 16, "cuda")
    q, k, v, dout = (torch.randn((1, S, h, d), generator=gen, device="cuda",
                                 dtype=torch.bfloat16) for _ in range(4))
    sc = 1.0 / math.sqrt(d)
    ref_out, ref_lse = _forward(q, k, v, True, sc, S, 0, True, None, None,
                                None)
    ref_grads = _backward(q, k, v, ref_out, ref_lse, dout, True, sc, S, 0,
                          None, None, None)
    split = lambda t: list(t.chunk(n, dim=1))  # noqa: E731
    qs, ks, vs, ds = split(q), split(k), split(v), split(dout)
    ranks = list(range(n))
    reset_counts()
    outs, lses = ring_flash_fwd(qs, ks, vs, ranks, n, rotate, True)
    fwd = read_counts()
    grads = ring_flash_bwd(qs, ks, vs, outs, lses, ds, ranks, n, rotate, True)
    bwd = read_counts()
    hops = n * (n + 1) // 2
    check(fwd["flash_attention"] == hops and fwd["flash_attention_bwd"] == 0
          and bwd["flash_attention_bwd"] == hops
          and bwd["flash_attention"] == hops and bwd["flash_dense"] == 0,
          f"16 (b) ring of {n}: flash forward launches {fwd['flash_attention']}"
          f", backward {bwd['flash_attention_bwd']} (n (n + 1) / 2 = {hops} "
          f"each; the {n * (n - 1) // 2} strictly later blocks skipped)")
    out = torch.cat(outs, 1)
    lse = torch.cat(lses, 2)
    err = (out.float() - ref_out.float()).abs().max().item()
    lerr = ((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1)).max().item()
    check(err <= OUT_ATOL and lerr <= STATS_RTOL,
          f"16 (b) ring out vs one flash call over S {S}: max |diff| "
          f"{err:.2e} <= {OUT_ATOL}; lse {lerr:.2e} <= {STATS_RTOL}")
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        g = torch.cat(g, 1)
        rel = ((g.float() - r.float()).abs().max()
               / r.float().abs().max()).item()
        check(rel <= BWD_RTOL, f"16 (b) ring {name}: max |diff| / max |ref| "
              f"{rel:.2e} <= {BWD_RTOL}")
    ms = {"one flash call fwd": time_ms(torch, lambda: _forward(
        q, k, v, True, sc, S, 0, True, None, None, None), reps=3),
        "ring fwd": time_ms(torch, lambda: ring_flash_fwd(
            qs, ks, vs, ranks, n, rotate, True), reps=3),
        "one flash call bwd": time_ms(torch, lambda: _backward(
            q, k, v, ref_out, ref_lse, dout, True, sc, S, 0, None, None,
            None), reps=3),
        "ring bwd": time_ms(torch, lambda: ring_flash_bwd(
            qs, ks, vs, outs, lses, ds, ranks, n, rotate, True), reps=3)}
    # Ulysses: the sequence shards to head shards and back, autograd on
    ts = [t.detach().requires_grad_() for t in (q, k, v)]
    reset_counts()
    uo = torch.cat(ulysses_flash(*[split(t) for t in ts], n,
                                 local_all_to_all), 1)
    uf = read_counts()
    uo.backward(dout)
    ub = read_counts()
    check(uf["flash_attention"] == n and ub["flash_attention_bwd"] == n
          and ub["flash_dense"] == 0,
          f"16 (b) Ulysses of {n}: flash forward launches "
          f"{uf['flash_attention']}, backward {ub['flash_attention_bwd']} "
          f"({n} each)")
    err = (uo.detach().float() - ref_out.float()).abs().max().item()
    check(err <= OUT_ATOL, f"16 (b) Ulysses out: max |diff| {err:.2e} <= "
          f"{OUT_ATOL}")
    for name, t, r in zip(("dq", "dk", "dv"), ts, ref_grads):
        rel = ((t.grad.float() - r.float()).abs().max()
               / r.float().abs().max()).item()
        check(rel <= BWD_RTOL, f"16 (b) Ulysses {name}: max |diff| / max "
              f"|ref| {rel:.2e} <= {BWD_RTOL}")

    def uly():
        with torch.no_grad():
            ulysses_flash(*[split(t) for t in (q, k, v)], n,
                          local_all_to_all)
    ms["Ulysses fwd"] = time_ms(torch, uly, reps=3)
    print(f"  16 (b) device ms at S {S}, {h} heads of {d}, causal: "
          + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
          + f"; on {smi()}")
    del q, k, v, dout, ts, outs, grads, ref_grads
    free_cuda(torch)


# phase 9 (b): Mamba-130m on the log-depth kernels, against phase 9
LOGDEPTH_LOSS_RTOL = 1e-3


def phase_mamba_logdepth(torch, seed, mamba):
    """Phase 9 (b): phase 9's Mamba-130m, seed and batch with
    ``FLAGS_mamba_logdepth_scan`` set, ``SSM_STEPS`` TrainStep steps (AdamW
    lr 3e-4, bf16 moments, clip 1.0): every loss within 1e-3 relative of
    phase 9's, L x steps log-depth forward and backward launches and no
    launch of the sequential kernels or any other; the step time beside
    phase 9's."""
    print("== phase 9 (b): Mamba-130m on the log-depth scan kernels")
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import MambaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = mamba_config()
    L = cfg.num_hidden_layers
    set_flags({"mamba_logdepth_scan": True})
    try:
        torch.cuda.reset_peak_memory_stats()
        model = MambaForCausalLM(cfg, seed=seed)
        step = TrainStep(model, None, AdamW(
            learning_rate=3e-4, moment_dtype="bfloat16",
            parameters=model.parameters()), clip_norm=1.0)
        ids = train_tokens(torch, seed, (SSM_B, SSM_L))
        torch.cuda.synchronize()
        reset_counts()
        losses, times = [], []
        for _ in range(SSM_STEPS):
            t0 = time.perf_counter()
            losses.append(step(ids, ids).item())
            times.append((time.perf_counter() - t0) * 1e3)
        n = read_counts()
    finally:
        set_flags({"mamba_logdepth_scan": False})
    ref = mamba["losses"]
    rel = max(abs(a - b) / (abs(b) + 1e-6 / LOGDEPTH_LOSS_RTOL)
              for a, b in zip(losses, ref))
    check(len(ref) == len(losses) and rel <= LOGDEPTH_LOSS_RTOL,
          f"9 (b): losses {[f'{x:.6g}' for x in losses]} against phase 9's "
          f"{[f'{x:.6g}' for x in ref]}: max |diff| / (|ref| + "
          f"{1e-6 / LOGDEPTH_LOSS_RTOL:g}) {rel:.2e} <= {LOGDEPTH_LOSS_RTOL}")
    fwd, bwd = "selective_scan_logdepth", "selective_scan_logdepth_bwd"
    others = {k: v for k, v in n.items() if k not in (fwd, bwd) and v}
    check(n[fwd] == L * SSM_STEPS and n[bwd] == L * SSM_STEPS
          and not others,
          f"9 (b) launches over {SSM_STEPS} steps: {fwd} {n[fwd]}, {bwd} "
          f"{n[bwd]} ({L} x steps each), other kernels (the sequential scan "
          f"among them) {others or 0}")
    step_ms = sum(times[2:]) / len(times[2:])
    print(f"  9 (b) step host ms {step_ms:.1f} (mean of steps 3-{SSM_STEPS}) "
          f"against phase 9's {mamba['step_ms']:.1f} on the sequential "
          f"kernels ({step_ms / mamba['step_ms']:.2f}x); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB on {smi()}")
    del model, step
    free_cuda(torch)
    return n


# phase 17 (a): the pipeline schedules with their stages in one process
PP_LAYERS, PP_BATCH, PP_MICRO, PP_STAGES, PP_STEPS = 8, 8, 8, 4, 6
PP_SCHEDULES = (("1f1b", 1), ("vpp", 2), ("zb", 1))
# against TrainStep the parameters cannot all stay within one bf16 step:
# the pipeline sums 8 micro-batch gradients each rounded to bf16 where
# TrainStep rounds one product over the whole batch, and every update of
# a bf16 parameter (about 2.5 of its ulps at lr 3e-4 and |p| ~ 0.02) then
# rounds to a neighbouring value here and there; over 6 steps 22.5% of
# all elements drift beyond one step (H100 80GB HBM3, 700 W). So each
# tensor is held on its own: at most PP_PARAM_SHARE of its elements
# beyond one bf16 step of TrainStep's, and its distance from TrainStep's
# at most PP_UPDATE_ERR of TrainStep's own update |p_ref - p0| (a tensor
# TrainStep leaves unmoved must be equal; so the norm of its update lies
# within PP_UPDATE_ERR of TrainStep's, and a tensor left unmoved, whose
# distance is TrainStep's whole update, fails). Read on the card (H100
# 80GB HBM3, 700 W, every schedule alike): the largest share 0.4403
# (layers 1-3's o_proj), the largest distance 0.1261 of the update (the
# embedding); the limits sit above them. Against the same micro-batch
# sums without a schedule (one stage), every element must lie within one
# bf16 step
PP_PARAM_SHARE, PP_UPDATE_ERR = 0.5, 0.25


def compare_updates(torch, params, ref, init, what):
    """Each tensor of ``params`` against ``ref``, both trained from
    ``init`` (each name: tensor): its share of elements farther than one
    bf16 step (2^-7 relative, + 1e-6) from ``ref`` at most
    ``PP_PARAM_SHARE``, its distance ``|p - p_ref|`` at most
    ``PP_UPDATE_ERR`` of ``|p_ref - p0|`` and its update's norm ``|p -
    p0|`` within ``PP_UPDATE_ERR`` of ``|p_ref - p0|``; prints the three
    tensors that come nearest each limit."""
    rows = []
    with torch.no_grad():
        for k, p in params.items():
            a, b = p.float(), ref[k].to(p.device).float()
            c = init[k].to(p.device).float()
            r = (a - b).abs() / (b.abs() + HYBRID_ATOL / HYBRID_PARAM_RTOL)
            share = (r > HYBRID_PARAM_RTOL).float().mean().item()
            moved = (b - c).norm().item()
            dist = (a - b).norm().item()
            mine = (a - c).norm().item()
            err = dist / moved if moved else (0.0 if dist == 0 else math.inf)
            ratio = mine / moved if moved else (1.0 if mine == 0 else math.inf)
            rows.append((k, share, err, ratio, moved))
            del a, b, c, r
    for i, name in ((1, "share beyond one bf16 step"),
                    (2, "|p - p_ref| / |p_ref - p0|")):
        top = sorted(rows, key=lambda t: -t[i])[:3]
        print(f"  {what}: largest {name}: "
              + "; ".join(f"{t[0]} {t[i]:.4g}" for t in top))
    unmoved = sum(1 for t in rows if t[4] == 0)
    bad = [t for t in rows if t[1] > PP_PARAM_SHARE or t[2] > PP_UPDATE_ERR
           or abs(t[3] - 1) > PP_UPDATE_ERR]
    check(not bad,
          f"{what}: each of the {len(rows)} tensors against TrainStep's "
          f"(share beyond one bf16 step <= {PP_PARAM_SHARE:g}, |p - p_ref| "
          f"<= {PP_UPDATE_ERR:g} |p_ref - p0|, | |p - p0| / |p_ref - p0| - "
          f"1 | <= {PP_UPDATE_ERR:g}; {unmoved} tensors TrainStep left "
          f"unmoved, held equal): "
          + ("all within" if not bad else "; ".join(
              f"{k} share {sh:.4g} err {e:.4g} ratio {ra:.4g}"
              for k, sh, e, ra, _ in bad[:8])))


def compare_params(torch, params, ref, what, against="TrainStep"):
    """Every element of ``params`` against ``ref`` (both name: tensor):
    none farther than one bf16 step (2^-7 relative, + 1e-6); prints the
    count beyond and the largest such distance."""
    worst, beyond, total = 0.0, 0, 0
    with torch.no_grad():
        for k, p in params.items():
            a, b = p.float(), ref[k].to(p.device).float()
            r = (a - b).abs() / (b.abs() + HYBRID_ATOL / HYBRID_PARAM_RTOL)
            worst = max(worst, r.max().item())
            beyond += int((r > HYBRID_PARAM_RTOL).sum())
            total += r.numel()
    check(beyond == 0,
          f"{what}: the {total} parameters against {against}'s: {beyond} "
          f"({beyond / total:.3%}) beyond one bf16 step (2^-7 relative + "
          f"1e-6), none allowed; the largest |diff| / (|ref| + "
          f"{HYBRID_ATOL / HYBRID_PARAM_RTOL:g}) {worst:.2e}")


def phase_pipeline(torch, seed):
    """Phase 17 (a): the 7B widths at ``PP_LAYERS`` layers in bf16, batch
    8 x 2048, through ``PipelineTrainStep`` with its ``PP_STAGES`` stages in
    this process and 8 micro-batches: ``1f1b``, ``vpp`` (2 groups of layers
    a stage) and ``zb``, ``PP_STEPS`` steps each on the same seeded
    batches (a fresh one a step), against ``TrainStep`` on the same model,
    batches and AdamW (lr 3e-4, weight decay 0.1, bf16 moments; no clip,
    as the pipelined step has none): every loss within 1e-3 relative and
    each parameter tensor by ``compare_updates`` against TrainStep's from
    the same initial weights, and every parameter within one bf16 step of
    the same micro-batches' sums run as one stage
    (``PipelineTrainStep(model, opt, 1, 8)``: the schedule alone moves
    nothing); the flash launches (L x micro-batches forward and backward
    a step, ``zb`` included: its B and W are one backward), and each run's
    step ms and peak memory."""
    print("== phase 17 (a): pipeline schedules, 4 stages in one process")
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import PipelineTrainStep

    L, M, S = PP_LAYERS, PP_MICRO, PP_STAGES
    cfg = train_config(L)
    # a fresh seeded batch a step, the same for every run: on one batch
    # repeated the loss falls to ~0.01 by step 3, where rounding alone
    # moves it by more than 1e-3 of itself
    batches = [train_tokens(torch, seed + 1 + i, (PP_BATCH, TRAIN_SEQ))
               for i in range(PP_STEPS)]

    def opt(model):
        return AdamW(learning_rate=3e-4, weight_decay=0.1,
                     moment_dtype="bfloat16", parameters=model.parameters())

    def run(make_step, what):
        free_cuda(torch)
        model = LlamaForCausalLM(cfg, seed=seed)
        step = make_step(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, times = [], []
        for ids in batches:
            t0 = time.perf_counter()
            losses.append(step(ids, ids).item())
            times.append((time.perf_counter() - t0) * 1e3)
        n = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = sum(times[1:]) / len(times[1:])
        print(f"  {what}: losses {[round(x, 4) for x in losses]}; step host "
              f"ms {ms:.1f} (mean of steps 2-{PP_STEPS}), peak device memory "
              f"{peak:.1f} GiB")
        check(all(math.isfinite(x) for x in losses),
              f"{what}: losses finite (fresh uniform tokens: the loss stays "
              f"near its start)")
        params = {k: p.detach().clone() for k, p in model.named_parameters()}
        del model, step
        return params, losses, ms, peak, n

    def on_host(params):
        return {k: p.detach().cpu() for k, p in params.items()}

    # the references wait on the host, out of the later runs' peaks
    init = on_host(dict(LlamaForCausalLM(cfg, seed=seed).named_parameters()))
    ref_params, ref, ref_ms, ref_peak, _ = run(
        lambda m: TrainStep(m, None, opt(m)), "17 (a) TrainStep")
    ref_params = on_host(ref_params)
    one_params = on_host(run(lambda m: PipelineTrainStep(
        m, opt(m), 1, num_microbatches=M, remat=False),
        "17 (a) one stage")[0])
    out = {}
    for sched, R in PP_SCHEDULES:
        what = f"17 (a) {sched}" + (f" (R {R})" if R > 1 else "")
        params, losses, ms, peak, n = run(
            lambda m: PipelineTrainStep(m, opt(m), S, num_microbatches=M,
                                        schedule=sched, num_virtual_stages=R,
                                        remat=False), what)
        rel = max(abs(a - b) / (abs(b) + HYBRID_ATOL / HYBRID_LOSS_RTOL)
                  for a, b in zip(losses, ref))
        check(rel <= HYBRID_LOSS_RTOL,
              f"{what}: losses against TrainStep's: max |diff| / (|ref| + "
              f"{HYBRID_ATOL / HYBRID_LOSS_RTOL:g}) {rel:.2e} <= "
              f"{HYBRID_LOSS_RTOL}")
        compare_updates(torch, params, ref_params, init, what)
        compare_params(torch, params, one_params, what,
                       against="the one-stage run")
        bwd = L * M
        check(n["flash_attention"] == L * M * PP_STEPS
              and n["flash_attention_bwd"] == bwd * PP_STEPS
              and n["flash_dense"] == 0,
              f"{what} launches over {PP_STEPS} steps: flash fwd "
              f"{n['flash_attention']} (L x M x steps = "
              f"{L * M * PP_STEPS}), flash bwd {n['flash_attention_bwd']} "
              f"({bwd * PP_STEPS}), plain route {n['flash_dense']}")
        print(f"  {what}: step host ms {ms:.1f} against TrainStep's "
              f"{ref_ms:.1f} ({ms / ref_ms:.2f}x), peak {peak:.1f} GiB "
              f"against {ref_peak:.1f} GiB on {smi()}")
        out[sched] = dict(step_ms=ms, peak=peak)
        del params
    free_cuda(torch)
    return out


def phase_offload(torch, seed, train):
    """Phase 17 (b): phase 6's configuration (the 7B widths at 4 layers,
    batch 2 x 2048, AdamW lr 3e-4, weight decay 0.1, bf16 moments, clip
    1.0, 10 steps, phase 6's seed) through ``OffloadedTrainStep`` (NCCL,
    world size 1): every loss within 1e-3 relative of phase 6's, every
    parameter within one bf16 step of phase 6's, the peak device memory
    below phase 6's (printed beside the optimizer-state bytes it no longer
    holds), the step ms and the side stream's host-to-card and card-to-host
    ms a step (CUDA events)."""
    print("== phase 17 (b): the offloaded step against phase 6")
    import torch.distributed as dist

    from paddle_tpu_torch import parallel as Pl
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    free_cuda(torch)
    Pl.init_parallel_env()
    L = 4
    model = LlamaForCausalLM(train_config(L), seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    state_bytes = 2 * 2 * n_params           # two bf16 moments a parameter
    biggest = max(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = Pl.OffloadedTrainStep(model, None, AdamW(
        learning_rate=3e-4, weight_decay=0.1, moment_dtype="bfloat16",
        parameters=model.parameters()), Pl.HybridMesh(), clip_norm=1.0,
        timing=True)
    ids = train_tokens(torch, seed)
    reset_counts()
    losses, times, copies = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step(ids, ids).item())
        times.append((time.perf_counter() - t0) * 1e3)
        copies.append(step.loader.transfer_ms())
    torch.cuda.synchronize()
    n = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check_losses(losses, f"17 (b) OffloadedTrainStep x {TRAIN_STEPS}")
    ref = train["losses"]
    rel = max(abs(a - b) / (abs(b) + HYBRID_ATOL / HYBRID_LOSS_RTOL)
              for a, b in zip(losses, ref))
    check(rel <= HYBRID_LOSS_RTOL,
          f"17 (b): losses {[f'{x:.6g}' for x in losses]} against phase 6's "
          f"{[f'{x:.6g}' for x in ref]}: max |diff| / (|ref| + "
          f"{HYBRID_ATOL / HYBRID_LOSS_RTOL:g}) {rel:.2e} <= "
          f"{HYBRID_LOSS_RTOL}")
    check_flash_counts(n, L, TRAIN_STEPS, "17 (b) OffloadedTrainStep")
    step.gather_params_to_model()
    compare_params(torch, dict(model.named_parameters()), train["params"],
                   "17 (b)", against="phase 6")
    host = sum(t.numel() * t.element_size() for st in step._host_state
               for t in st.values())
    on_card = all(t.device.type == "cpu" and t.is_pinned()
                  for st in step._host_state for t in st.values())
    check(on_card and host == state_bytes,
          f"17 (b): the optimizer state on the host, pinned: {host} bytes "
          f"(predicted 2 bf16 moments x {n_params} parameters = "
          f"{state_bytes})")
    check(peak < train["peak"],
          f"17 (b): peak device memory {peak / 2**30:.2f} GiB < phase 6's "
          f"{train['peak'] / 2**30:.2f} GiB (predicted about phase 6's less "
          f"the state's {state_bytes / 2**30:.2f} GiB plus two parameters' "
          f"{4 * 2 * biggest / 2**30:.2f} GiB: "
          f"{(train['peak'] - state_bytes + 8 * biggest) / 2**30:.2f} GiB)")
    step_ms = sum(times[2:]) / len(times[2:])
    h2d = sum(c["h2d"] for c in copies[2:]) / len(copies[2:])
    d2h = sum(c["d2h"] for c in copies[2:]) / len(copies[2:])
    rate = lambda ms: (f"{state_bytes / (ms / 1e3) / 1e9:.1f} GB/s"  # noqa: E731
                       if ms > 0 else "not measured")
    print(f"  17 (b) step host ms {step_ms:.1f} (mean of steps "
          f"3-{TRAIN_STEPS}) against phase 6's {train['step_ms']:.1f}; side "
          f"stream a step: host to card {h2d:.1f} ms ({rate(h2d)}), card to "
          f"host {d2h:.1f} ms ({rate(d2h)}), {state_bytes / 2**30:.2f} GiB "
          f"each way, on {smi()}")
    del model, step
    dist.destroy_process_group()
    free_cuda(torch)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "paddle_tpu_torch", "csrc")):
        print("chip_smoke: paddle_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import torch

    t_start = time.perf_counter()

    def lap():
        print(f"  [{time.perf_counter() - t_start:.0f} s since the start]")

    try:
        phase_environment(torch)
        lap()
        phase_build()
        lap()
        from paddle_tpu_torch.core.device import make_generator

        gen = make_generator(args.seed, "cuda")
        flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
        rows = phase_kernels(torch, gen, flush)
        lap()
        del flush
        free_cuda(torch)
        launches, noise = phase_slice(torch, args.seed)
        lap()
        free_cuda(torch)
        quant, kv_noise = phase_quant_serving(torch, args.seed, noise)
        lap()
        launches.update(quant)
        free_cuda(torch)
        phase_paired_decode(torch, args.seed)
        lap()
        phase_prefix_cache(torch, args.seed, noise, kv_noise)
        lap()
        phase_speculative(torch, args.seed, noise, kv_noise)
        lap()
        phase_fleet(torch, args.seed, noise)
        lap()
        phase_decoding(torch, args.seed, noise)
        lap()
        train = phase_train(torch, args.seed)
        launches["flash_attention_bwd"] = train["flash_attention_bwd"]
        lap()
        phase_train_32(torch, args.seed)
        lap()
        phase_recompute_full(torch, args.seed)
        lap()
        phase_packed(torch, args.seed)
        lap()
        phase_longctx(torch, args.seed)
        lap()
        launches["fused_adamw"] = phase_eager(torch, args.seed)["fused_adamw"]
        lap()
        moe = phase_moe_train(torch, args.seed)
        lap()
        launches.update({k: moe[k] for k in (
            "grouped_gemm", "grouped_gemm_tgmm", "grouped_gemm_swiglu")})
        mamba = phase_ssm_train(torch, args.seed, "mamba")
        lap()
        mamba_ld = phase_mamba_logdepth(torch, args.seed, mamba)
        lap()
        rwkv = phase_ssm_train(torch, args.seed, "rwkv")
        lap()
        mamba2 = phase_ssm_train(torch, args.seed, "mamba2")
        lap()
        launches.update({k: mamba[k] for k in ("selective_scan",
                                               "selective_scan_bwd")})
        launches.update({k: mamba_ld[k] for k in (
            "selective_scan_logdepth", "selective_scan_logdepth_bwd")})
        launches.update({k: rwkv[k] for k in ("wkv", "wkv_bwd")})
        launches.update({k: mamba2[k] for k in ("ssd", "ssd_bwd")})
        phase_paddle_loop(torch, args.seed)
        lap()
        phase_vit(torch, args.seed)
        lap()
        unet = phase_unet(torch, args.seed)
        lap()
        launches.update({k: unet[k] for k in ("flash_attention_mma",
                                              "flash_attention_mma_bwd")})
        phase_block_attention(torch, args.seed, noise)
        lap()
        phase_hybrid(torch, args.seed, train)
        lap()
        phase_pipeline(torch, args.seed)
        lap()
        phase_offload(torch, args.seed, train)
        lap()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # launches: the serving kernels' counts on the serving run, the int8
    # paged and int8 GEMM's on quantized run A, the int4 GEMM's on run B,
    # the flash backward's on the TrainStep run, fused AdamW's on the eager
    # run, the grouped GEMMs' on the MoE TrainStep run, the scan's on the
    # Mamba run, the log-depth scan's on the Mamba run of 9 (b), the WKV's
    # on the RWKV run, the SSD's on the Mamba-2 run and the head-dim flash
    # kernels' on the UNet TrainStep run
    meta = {
        "flash_attention": ("paddle_tpu_torch/csrc/flash_attention.cu",
                            "paddle_tpu/ops/pallas/flash_attention.py:266"),
        "flash_attention_bwd": (
            "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            "paddle_tpu/ops/pallas/flash_attention.py:453"),
        "flash_attention_mma": (
            "paddle_tpu_torch/csrc/flash_attention_mma.cu",
            "paddle_tpu/ops/pallas/flash_attention.py:266"),
        "flash_attention_mma_bwd": (
            "paddle_tpu_torch/csrc/flash_attention_mma.cu",
            "paddle_tpu/ops/pallas/flash_attention.py:453"),
        "paged_attention": ("paddle_tpu_torch/csrc/paged_attention.cu",
                            "paddle_tpu/ops/pallas/paged_attention.py:580"),
        "paged_attention_int8": (
            "paddle_tpu_torch/csrc/paged_attention.cu",
            "paddle_tpu/ops/pallas/paged_attention.py:580"),
        "int8_matmul": ("paddle_tpu_torch/csrc/int8_matmul.cu",
                        "paddle_tpu/ops/pallas/int8_matmul.py:143"),
        "int4_matmul": ("paddle_tpu_torch/csrc/int8_matmul.cu",
                        "paddle_tpu/ops/pallas/int8_matmul.py:197"),
        "fused_adamw": ("paddle_tpu_torch/csrc/fused_adamw.cu",
                        "paddle_tpu/ops/pallas/fused_adamw.py:100"),
        "grouped_gemm": ("paddle_tpu_torch/csrc/grouped_gemm.cu",
                         "paddle_tpu/ops/pallas/grouped_gemm.py:236"),
        "grouped_gemm_tgmm": ("paddle_tpu_torch/csrc/grouped_gemm.cu",
                              "paddle_tpu/ops/pallas/grouped_gemm.py:290"),
        "grouped_gemm_swiglu": ("paddle_tpu_torch/csrc/grouped_gemm.cu",
                                "paddle_tpu/ops/pallas/grouped_gemm.py:487"),
        "selective_scan": ("paddle_tpu_torch/csrc/selective_scan.cu",
                           "paddle_tpu/ops/pallas/selective_scan.py:217"),
        "selective_scan_bwd": ("paddle_tpu_torch/csrc/selective_scan.cu",
                               "paddle_tpu/ops/pallas/selective_scan.py:284"),
        "selective_scan_logdepth": (
            "paddle_tpu_torch/csrc/selective_scan.cu",
            "paddle_tpu/ops/pallas/selective_scan.py:217"),
        "selective_scan_logdepth_bwd": (
            "paddle_tpu_torch/csrc/selective_scan.cu",
            "paddle_tpu/ops/pallas/selective_scan.py:284"),
        "wkv": ("paddle_tpu_torch/csrc/wkv.cu",
                "paddle_tpu/ops/pallas/wkv.py:301"),
        "wkv_bwd": ("paddle_tpu_torch/csrc/wkv.cu",
                    "paddle_tpu/ops/pallas/wkv.py:350"),
        "ssd": ("paddle_tpu_torch/csrc/ssd.cu",
                "paddle_tpu/ops/pallas/ssd.py:198"),
        "ssd_bwd": ("paddle_tpu_torch/csrc/ssd.cu",
                    "paddle_tpu/ops/pallas/ssd.py:243"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
