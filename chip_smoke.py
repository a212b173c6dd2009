#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases 1,11    # the build and phase 11 only
    python3 chip_smoke.py --phases 12      # the build and the fleet
    python3 chip_smoke.py --phases 13      # the build and data parallelism
    python3 chip_smoke.py --phases 14      # the build, beam translation, dygraph
    python3 chip_smoke.py --phases 15      # the build, the data plane, the PS
    python3 chip_smoke.py --phases 16      # the build, hybrid parallelism

``--phases`` takes the phases' top-level numbers (2 runs 2-2f, 3 runs
3-3d, 5 runs 5-5c, 9 runs 9a-9d; 10 runs 9a first, whose programs it
exports); the build (1) always runs. The ``kernels`` line then carries
the launches of the selected phases and null for the numbers of a
kernel whose parity phase (2) was not selected.

It builds every CUDA kernel from the sources in the checkout, holds each
kernel against its plain PyTorch version at the shapes its path gives
it, then serves requests through the port's entry points at the full
width of the decoder and checks the tokens against the port's offline
reference, trains full-size BERT-base with dropout (the flash recipe and
the unfused default, and the flash recipe under bf16 AMP) against the
same steps with the kernels off, and trains the two
CTR configurations (Wide&Deep over the two-tier embedding engine, and CTR
with on-device tables and sparse SGD) against the same steps with the
kernels off, and trains the conv nets (the two book programs, and
ResNet-50 at full width and depth against the same step on the host's
CPU, in float32 and under bf16 AMP), and saves, restores and exports
those models through ``io`` and ``incubate.checkpoint``, bit for bit,
and serves an exported BERT-base and ResNet-50 through the predictor
and the batching ServingEngine, and serves the decoder through a fleet
router over worker processes, one of them killed mid-flight, and trains
BERT-base data-parallel on 2 ranks of the card through the collective
fleet against one rank on the whole batch, and translates with beam
search at Transformer-big width and trains in dygraph (imperative) mode,
and feeds Wide&Deep through the DataLoader and the dense CTR through a
Dataset on the native feed and ``train_from_dataset``, and trains the
CTR model against the port's native parameter server.
Any failure
exits non-zero. It
imports nothing of JAX or of the JAX package, and it refuses to run
without a CUDA device (or outside a checkout of the repository).

Phases:

1. build — one ``nvcc`` per kernel source and one ``g++`` per native host
   component (phase 15's feed and PS), all started together, then load
   the kernels. Each phase's seconds follow it on a ``[time]`` line.
2. parity — each kernel against its plain version on the same inputs
   (S=8 slots, L=1024 positions, H=768, R=8192 arena rows, random block
   row maps with rows shared between slots, random cursors, one retired
   slot), timed on the device (``device_ms``: median of 5 windows of 10
   passes over 12 layers' arenas) beside the plain version, one PyTorch
   library call (``scaled_dot_product_attention`` on the gathered views,
   a yardstick the port never calls), the card's bound (the rows this
   run's data needs) and, in the log, the floor for reading every
   position's K and V rows once, as the composite does; each call makes
   one kernel launch (a profiler trace; the arrival counters' memset
   beside it is no kernel).
3. engine — ``GenerationEngine()`` on the default place serving 16
   requests of 8-512 prompt tokens (4 share a 256-token prefix), 32 new
   tokens each, at the GPT-base width (vocab 32000, hidden 768, 12
   layers, FFN 3072, 8 slots, context 1024, blocks of 16). Launch
   counters are zeroed just before and read just after; 4 requests are
   checked against ``offline_decode`` on the card.
3b. decode modes — the engine's other modes on one ``GenerationEngine()``
   at the same width: a target built with a chunk budget of 128 tokens,
   a draft "same" holding the target's weights (``convert.load_params``,
   checked equal) and a draft "small" of 2 layers; the target's brownout
   ladder is pinned at L0 here and in 3c (3d drives it). Leg A hand-steps the
   scheduler (the loop thread's body, one iteration at a time): 4 short
   prompts decode while 8 long ones (129-960 tokens, two sharing a
   256-token prefix) stream through the chunk program; every request
   completes, 4 hold against ``offline_decode`` under phase 3's near-tie
   rule (the 960-token one among them), the chunk count equals what the
   prompt lengths and the radix-shared chunks predict, and no iteration
   runs more than one chunk while a decode slot is live. Leg B (the loop
   threads) runs spec_k=4 speculation: 4 requests on "same" with
   draft-KV proposals, 1 with replay proposals and 2 plain greedy
   requests, then 2 on "small"; every speculative stream equals
   ``offline_decode`` bit for bit, "same" is accepted every time at no
   more than 0.7 target steps a token, no draft-KV proposal falls back to
   replay, and K3 launches at least (draft layers x draft-KV steps) times.
   Leg C samples (temperature 0.8, top-k 50, top-p 0.95): 4 plain requests
   hold under the near-tie rule on the Gumbel-perturbed scores, 1
   speculative one on "same" bit for bit. Launch counters are zeroed
   before each leg and read after; the ``paged_attention`` row of the
   kernels line adds these launches to phase 3's.
3c. beam search and grammars (8 new tokens a request) — one
   ``GenerationEngine()`` at the same
   width hosting a target with ``eos_id=95``, ``logits_mask=True`` (the
   ``DEC_MASK`` feed) and the chunk budget of 128, beside the 2-layer
   draft "small". The grammars' vocabulary is made from the seed: ids
   0-94 the printable ASCII characters, 95 the stop token, the rest
   strings of 2-8 of them. Leg A hand-steps the scheduler with block
   conservation checked after every iteration: 4 beams of width 4 (16-300
   prompt tokens, two sharing the 256-token prefix; two groups fill the
   8 slots and two wait on the row budget), then one of a 300-token
   prompt (its beam begins after the chunks), then one with a JSON-schema
   grammar; each result holds against ``offline_beam`` (the prefill
   program): equal hypotheses, or, where they part, the engine's
   re-scored by the prefill forward within 1e-3 of the reference's at the
   same rank; K3 launches 12 times a decode step. Leg B (the loop
   threads) runs 9 requests side by side: 3 greedy on the schema, 2 on a
   regex, 2 unconstrained, 1 sampled on the schema, 1 speculative on the
   schema through "small". Every constrained stream walks its grammar
   with no banned token (a stream ending at EOS in an accepting state,
   and its text parses as JSON); the speculative stream is bit-equal to
   ``offline_decode(grammar=)``, the others pass the near-tie rule on the
   masked scores. Prints forks, prunes, finished hypotheses, the decode
   step's p50, the selection rule's host time, the mask builds' host
   time a state and their count, tokens/s beside phase 3's, and the K3
   launches, which the kernels line adds to phase 3's.
3d. overload — one ``GenerationEngine(host_tier_mb=1024)`` at the same
   width hosting "cut" (a chunk budget of 128 and a pool of 96 blocks,
   1536 rows, a 113 MB arena), "uncut" (the same with 512 blocks) and the
   draft "same", all three with cut's weights (``convert.load_params``).
   A burst of 12 requests (96-384 prompt tokens, 3 sharing a 128-token
   prefix, 16 new tokens each: a beam of width 4, a speculative one on
   "same" with draft-KV, a sampled one and 9 greedy ones; every prompt
   over 128 tokens streams through the chunk program) is submitted at
   once and hand-stepped to the end, first on "uncut", then on "cut",
   whose 8 live slots need about twice its blocks, so sessions park to
   the host tier and resume. Launch counters are zeroed before the cut
   burst and read after (the kernels line adds them). Checks: parked ==
   resumed >= 1, nothing failed, no walk-back, the pool conserved and
   empty; the beam against ``offline_beam`` and the 11 other streams
   against ``offline_decode`` by phase 3's rule; the sampled stream
   bit-equal to the uncut pool's (the log counts the streams that are).
   Prints the spill's ms a park and the resume's a row run (p50, max) with
   bytes and GB/s, the 12 requests' latency p50/p99 on both pools,
   tokens/s on both, the brownout transitions with their triggers and the
   host tier's counters. Legs: corruption (5 prompts of 300 tokens, 32
   new tokens each; the
   first parked session's tier entry gets a byte flipped: quarantined,
   one walk-back, its tokens held by phase 3's rule, the rows that differ
   from the spilled ones counted, every other resume bit-exact, and K3
   held against its plain version over every resumed slot's rows),
   tenants (weights 3:1, 16 queued on "uncut": 6 of the first 8
   dispatches go to the heavier one), breaker (``decode.step`` fails 3
   times through ``resilience.faults``: the breaker opens, half-opens
   after its cooldown, relaunches once, and the next request gives the
   tokens it gave before the fault).
2b. flash parity — the flash-attention forward (K1), dK/dV (K2a) and dQ
   (K2b) kernels against their plain versions on the same inputs, and two
   launches of each giving the same bits: at BERT-base's training shape
   (B=32, H=12, S=128, D=64, padding-mask bias, not causal), timed on the
   device (``device_ms``) beside the plain version, the bound of the
   kernel's route (3xTF32 tensor-core products; the FFMA bound printed
   beside) and one PyTorch library call
   (``scaled_dot_product_attention`` with its backend pinned to memory-
   efficient attention: forward; its backward for dq + dk + dv together),
   and the whole backward as BERT's training step runs it (delta, K2a
   with no dbias, K2b: ``FlashAttention.backward``'s kernels) held
   against that sdpa backward, with the factor printed; and at S=512
   (BERT's longest position), causal, with padding, for parity only.
2f. flash, 16-bit — the bf16 and float16 builds of K1, K2a and K2b
   against their plain versions in the same type (which round P and dS to
   the operand type where the Pallas kernel does), and two launches of
   each giving the same bits: bf16 at BERT-base's shape (padding-mask
   bias; timed beside the bound, bytes with 16-bit operands and float32
   LSE, delta, bias and dbias, and sdpa in bf16 with the memory-efficient
   backend pinned), causal, with a dead batch row (every key masked), and
   at S=512 causal; float16 at BERT-base's shape (timed). Each output
   within 1e-2 of its largest magnitude (``FLASH16_TOL``), the LSE within
   1e-5.
4. dense — a program with one fused ``cached_attention`` op (the dense
   slotted-cache form, served by ``decode_attention``) through
   ``Executor.run``, counters zeroed before and read after.
5. train — ``build_bert_pretrain(BertConfig.base())`` with flash
   attention, hidden dropout 0.1 (the JAX bench recipe), seq 128, P=20,
   float32, run by ``Executor()`` on the default place, the programs'
   ``random_seed`` set: launch counters zeroed, startup (its truncated
   normals draw through K8's ``random_bits``), the step counter set to the
   end of the lr warmup (so every step applies the full lr of 1e-4), then
   4 steps at batch 32 on one synthetic batch, counters read after (K1 at
   least 24 launches a step, K2a and K2b 12, K8's dropout 25); the loss
   finite and the parameters changed. Then, on a fresh executor (so the
   run keys repeat), startup and 2 steps from the same starting state (a
   snapshot, in its own scope) with the kernels off: the dropout masks
   bit-equal (a fingerprint of each, kept on the card), the loss streams,
   every ``param@GRAD`` of the first step and the whole training state
   after 2 steps (parameters, Adam moments and beta powers, the step
   counter) within the stated tolerances. Prints the step time (p50 of
   the steps after the first), device memory peak, tokens/s, the
   parameter count, and the step p50 of the same model without dropout.
5b. train, unfused — the JAX package's default BERT-base (unfused
   attention, hidden and attention-prob dropout 0.1: 37 sites), batch
   32, seq 128, P=20: 3 steps with the kernels on, 2 off on fresh
   executors; masks bit-equal, losses within phase 5's bars, K8 launched
   once a site a step. Prints step p50, tokens/s and the memory peak.
5c. train, bf16 AMP — ``build_bert_pretrain(BertConfig.base(),
   use_amp=True)`` as ``bench.py:106-133`` runs it (flash, hidden dropout
   0.1, seq 128, P = 20, Adam with the warm-up schedule, batch 32): counters
   zeroed before the startup, 6 steps, counters read after: the bf16 builds
   of K1/K2a/K2b launched (K1 at least 24 a step, K2a and K2b 12), no
   float32 or float16 flash launch, K8 once a site a step and fed float32
   only; host syncs of one step (sync debug mode); 2 steps under
   ``torch.profiler`` (device busy, idle share, top ops and kernels); then
   2 steps with the kernels off on a fresh executor: masks bit-equal,
   losses within ``AMP_TRAIN_LOSS_TOL``. Then float16 with dynamic loss
   scaling from 2^15 (``amp.decorate(dest_dtype="float16",
   use_dynamic_loss_scaling=True)``), 3 steps: the float16 builds launched,
   the loss finite, the scale state on the card, host syncs of a step.
   Prints step p50 and p90, tokens/s, the memory peak.
2e. random — K8 (``kernels/csrc/threefry.cu``) against its plain version,
   bit for bit: ``random_bits`` at n = 1,000,003 and BERT-base's
   word_embedding size, each also equal to the host numpy copy of
   ``jax.random.bits`` (``core/prng.py``, which the CPU tests hold equal
   to JAX), so JAX's bytes reach the card; the fused dropout at
   ``[32, 128, 768]`` p = 0.1 in both implementations, ``[32, 12, 128,
   128]`` and an odd n. Timed on the device (``device_ms``) at the hidden
   site and the word_embedding draw beside the plain version, the bound
   (bytes, or 73 integer operations a draw at the SM's dispatch rate) and
   ``torch.nn.functional.dropout`` (Philox: another stream, a yardstick
   only); prints the compiled SASS's instructions by opcode. Both entry
   points at the counter bases a data-parallel rank draws at (rank 1's
   block of a [16, 128, 768] site, and two that carry into the counter's
   high word, one a multiple of 4 and one not) against the plain version
   and the host copy,
   and a rank's half site timed at base 0 and at rank 1's base.

2c. ctr kernels — the embedding admission kernel (K5) and the sparse row
   update kernel (K6) against their plain versions, bit for bit, rows the
   call does not name untouched: K5 at slab [4096, 16] and [4096, 1] with
   buckets of 256 and 1024 (pad slots included) and at [1048576, 16] with
   4096 rows, through the wrapper's upload and through ``admit_rows`` over
   the real rows only; K6 at [1048576, 16] and [1048576, 1] with the unique
   ids of 12288 draws, as int32 and as int64 ids, and with id 0 among the
   ids and fill rows past the unique count. Timed (``ctr_costs``) beside
   the plain version, the card's bound and one PyTorch library call
   (``index_copy_`` for K5, ``index_add_`` for K6), each in device ms per
   call (``device_ms``: the calls queued behind a sleep, so the events see
   only the device) and host µs per call (``host_us``: a host clock around
   many calls, no sync), with the launch floor beside them: an empty
   kernel launched through the same ctypes route with K6's eleven
   arguments, timed on the host with them declared one by one (as every
   kernel takes them) and packed into one block (``launch_floors``).
   ``admit_rows`` makes no host sync and no staging wait, through a fresh
   staging, a reused one and the card's own.
6. wide&deep — ``models/wide_deep.py`` (the JAX example's widths: 4 slots
   x 5 ids, wide dim 1 and deep dim 16 tables, MLP 64-32-1, Adam on the
   dense half, row-sparse SGD on the slabs, capacity 4096, ep 2) at batch
   4096 for 24 click-log steps through ``Executor()`` and
   ``EmbeddingEngine``: K5 launched once per table on every step with
   misses, evictions and writebacks, no whole-slab copy to the host; then
   the same steps with the kernels off and at capacity 65536 give the
   same losses, host tier and persistables bit for bit. Prints step time,
   the host time of ``engine.prepare_feed`` alone, examples/s, device
   memory peak, host syncs of one step and the engine's stats; no
   admission waits for the upload before it (``staging_waits``).
7. dense ctr — ``build_ctr_train(ps_mode=False, vocab_size=2**20, SGD)``
   with ``FLAGS_pallas_sparse_update`` on, 8 steps at batch 4096: K6
   launched 16 times a step; the same steps with the kernels off give the
   same losses and tables bit for bit; every table changed and the
   untouched rows keep their values. One ``sgd_sparse`` makes exactly one
   host sync (``torch.unique``'s), a step exactly 26; an id outside a
   table raises by the end of the ``Executor.run`` that launched it (an
   ``EnforceError`` naming ``sgd_sparse``, caused by a ``ValueError``
   naming the id, as on the CPU), with a fetch copy and with no fetches,
   with every row outside the update unchanged.
2d. topk kernel — the blocked top-k of |x| (K7) against its plain
   version, bit for bit (the per-block stage's values and indices, the
   final top-k's, and |x[idx]| == vals): at word_emb's size [37000, 512]
   with k = 75,776 (DGC's k at sparsity 0.996, the path's) and 18,944
   (0.999), an FFN weight's [512, 2048] at 1,049 and at the path's 4,194,
   an attention projection's [512, 512] at 1,049, planted ties, n not a
   multiple of the block, k > block, and a sweep of the block: 1000 (one
   CTA), 4099 (a cluster of 5 whose last slice is shorter), 10^6 (past
   what a cluster keeps in shared memory), and an all-equal |x| whose tie
   cut falls inside a middle CTA of the cluster. Timed on the device at
   the path's word_emb shape beside the plain stage, the card's bound and
   ``torch.topk(|x|, k)`` (a yardstick the port never calls); then at
   each (numel, k) pair of a sparse Transformer-base step (phase 8's 97
   launches) the stage, the whole ``blocked_topk_abs`` and
   ``torch.topk(|x|, k)`` in device ms (summed weighted by launches), the
   whole function's and ``torch.topk``'s host µs a call (``host_us``) and
   their CUDA launches a call (``cuda_launches``, a profiler trace).
8. dgc — Transformer-base (``build_wmt_train(TransformerConfig.base()``,
   dropout 0.1, seq 64, DGC momentum with warm-up at step 0, sparsity
   0.996 then 0.999) trained data-parallel on 2 ranks of
   ``paddle_tpu_torch.distributed.launch`` sharing the card over gloo,
   ``CompiledProgram.with_parallel``, global batch 128, 3 steps with
   ``FLAGS_pallas_dgc_topk`` on; then the same 3 steps with the kernels
   off (a fresh executor, so the run keys repeat). Each rank runs this
   script with ``--dgc-rank``. Checks: K7
   launched 97 times a rank on each sparse step (the parameters over one
   block) and never on the dense one; K8 once a dropout site a step; both
   ranks hold bit-identical parameters after every step; the ranks'
   dropout masks at the first site differ (each folds its rank into the
   run key); kernels on and off give the same losses, dropout masks,
   parameters and per-rank U/V bit for bit (both runs deterministic:
   ``torch.use_deterministic_algorithms``); the loss is finite and falls.
   Prints step time, target tokens/s, memory peak per rank, the K7
   launches and the bytes each rank sent per step beside the dense
   gradient's.

9. conv nets — through ``Executor()`` on the default place, counters
   zeroed before each path and read after. 9a: ``examples/
   fit_a_line.py``'s program (fc, square_error_cost, mean, SGD 0.01),
   built with the port's layers, 50 steps of 20 seeded rows: its loss
   falls (the last five steps' mean below half the first five's);
   ``examples/recognize_digits.py``'s (conv/pool twice, reshape, fc with
   softmax, cross_entropy, accuracy, Adam 1e-3), 6 epochs of its 512
   synthetic digits at batch 64: the last epoch's accuracy above 0.9, the
   example's assertion; both startups draw through K8. 9b:
   ``build_resnet_train(depth=50, class_dim=1000, image_shape=(3, 224,
   224), lr=0.1)`` (momentum 0.9, L2Decay 1e-4), float32, its startup
   drawn through K8 on the card; one step at batch 8 on the card and the
   same step on the host's CPU from the startup's weights read back, in
   float32 and in float64 (``RESNET_F32_TOLS``, ``RESNET_F64_TOLS``:
   float32 grads in norm, since ReLU masks flip at inputs within rounding
   of 0; float64 everything elementwise within 1e-8; the card's float32
   grads no further from its float64 ones than twice the CPU's); prints
   the largest error by layer. A failure here is raised at the end of the
   phase, after 9c has printed its numbers. 9c: from the same weights,
   bench.py's batch of 128 (one seeded batch fed every step), 3 warm-up
   steps and 5 timed: step p50
   and p90 (host clock ending in the loss's copy), images/s, the device
   memory peak, the conv and fc work a step; 2 steps under
   ``torch.profiler``: device busy a step, the idle share, the top ops by
   device time and the top kernels; the loss stays finite and ends below
   its peak (lr 0.1 with no warm-up overshoots on one batch first); then
   ``build_resnet_infer`` (``clone(for_test=True)``) on the trained scope:
   16 softmax rows that sum to 1.

9d. ResNet-50 under bf16 AMP — ``build_resnet_train(depth=50, ...,
   use_amp=True)`` as ``bench.py:344-367`` runs it (BASELINE workload 2).
   One step at batch 8 on the card and on the host's CPU from the same
   weights, both bf16 AMP: the loss within 2e-2 relative, the grads of the
   layers nearest the loss (fc, the last BN) in norm and every parameter's
   L2 decay term within their bars, and planted faults (grads zeroed,
   doubled or scrambled, the decay dropped or doubled) each caught. Then
   the bench's batch of 128, 3 warm-up steps and 5 timed (p50, p90, images/s,
   memory peak), 2 under ``torch.profiler`` (device busy, idle share, top
   ops and kernels); the loss finite and ending below its peak.

10. checkpoints and model io — through ``Executor()`` on the default
   place. 10a: BERT-base as phase 5 runs it (flash, hidden dropout 0.1,
   seq 128, Adam, batch 32, float32): 2 steps, a blocking
   ``AutoCheckpoint.save``; a fresh scope with no startup run restored by
   ``resume()`` onto the card, every persistable ``torch.equal`` to the
   saved scope's; then one step by a fresh executor (its run counter, and
   so its dropout masks, start where every fresh executor's do) on the
   saved scope, on a copy of it on the card (run to run) and on the
   restored scope, under torch's deterministic algorithms: the restored
   continuation's loss and persistables bit-equal to the in-memory one's
   when the two in-memory ones agree (else within twice their gap, the
   ops without a deterministic path named); an async save while 2 steps
   run. Prints the save split (snapshot to pinned memory, serialize, CRC,
   write, fsync) and the restore split (read, file CRC, parse, array CRC,
   upload) with bytes and GB/s, the training-thread stall and the writer's
   time. 10b: Wide&Deep as phase 6 runs it with the engine as extra state,
   saving at steps 11 and 23 of 24 (format 2: each store array in 2 CRC'd
   shards); a fresh engine and scope ``resume()``, a probe batch's
   predictions bit-equal to the trained engine's, K5 launched once per
   table re-admitting the restored rows. 10c: 9a's trained programs
   through ``io.save_inference_model`` / ``load_inference_model`` into a
   fresh scope on the card, predicting bit-equal to ``clone(for_test=
   True)``; ``save_persistables`` and ``save`` round trips bit-equal. 10d:
   fit_a_line checkpointed three times with ``max_to_keep=2``: a corrupt
   newest ``state.npz`` walked past and quarantined, ``checkpoint.io``
   raising twice retried to a commit, a pinned corrupt step refused.
   Counters are zeroed before 10a and 10b and read after; the kernels line
   adds their launches.

11. inference and serving — through ``inference.create_predictor`` and
   ``serving.ServingEngine`` on the default place. 11a: BERT-base's
   encoder (``BertConfig.base()``, the JAX default: unfused attention,
   dropouts 0.1) at seq 128, its startup on the card, exported with
   ``io.save_inference_model`` as [sequence_output, pooled] and loaded
   with ``Config(dir)`` and the default passes: ``fc_fuse`` 73 and
   ``multihead_matmul_fuse`` 12, K1 launched 12 times a call and nothing
   else of the flash family; at batch 32 (real lengths 16-128, two rows
   all padding) the outputs against the exported program run by
   ``Executor()`` with the kernels off (``INFER_TOL``), every row finite;
   warmup seconds a bucket; p50 / p90 a call at batches 1, 8 and 32 (host
   clock from the inputs' copy in to ``copy_to_cpu``), sequences/s, the
   memory peak, device busy and idle share of a batch-32 call (5 calls
   under ``torch.profiler``). 11b: the same export with ``enable_bf16()``:
   146 weights folded to bf16, ``flash_attention_fwd_bf16`` 12 times a
   call, outputs within the bf16 bars of 11a's; p50 at batch 32 and its
   device busy. 11c: ``ServingEngine`` over 11a's config (lattice 1-32, 2
   replicas, queue 256, 5 ms max wait), 4 client threads x 32 requests of
   1-4 rows (real lengths 16-128), one a poison that its replica's
   ``run_batch`` refuses: every other request within ``SERVED_TOL`` of a
   separate single-request predictor (the bit-equal count printed), no
   bucket missed after ``start()``, the poison alone failed, a submit
   after the drain refused; req/s, rows/s, latency p50/p99, rows and
   occupancy a batch, K1 launches; then the burst without the poison on
   one replica. 11d: ResNet-50 (``depth=50, class_dim=1000``, its batch
   norms given seeded statistics) exported as [logits, softmax] and
   served at batch 32: ``conv_bn_fuse`` 53 (the JAX pass's count on the
   same builder call, ``tests/test_torch_passes.py``), no batch_norm
   left, logits within ``RESNET_FOLD_TOL`` of the unfused clone's;
   images/s. The ``kernels`` line adds the phase's K1 and K1-bf16
   launches.

12. fleet — ``serving.fleet.FleetRouter`` over ``SubprocessReplica``
   workers (``python -m paddle_tpu_torch.serving.fleet.worker --device
   cuda``), each a process of its own on the card hosting the decoder at
   phase 3's width (affinity keyed on the first 16-token block); first
   the µs of a named lock's acquire and release with the witness off
   beside a plain lock's, then ``offline_decode`` of phase 3's burst by
   an in-process entry built from the same spec. 12a: 2
   workers (each one's spawn-to-ready seconds printed), phase 3's burst
   of 16 (16 new tokens each) submitted at once: every stream against the
   offline reference
   by phase 3's near-tie rule, the 4 shared-prefix requests routed to
   one worker; tokens/s and latency p50/p99; then the burst again on the
   warm workers, the same checks and numbers; each worker's ``stats`` RPC
   counting K3 launches (12 a decode step, more than 0) and K8
   ``random_bits`` from its startup. 12b: a fresh router (autoscale, 2 to
   3 workers) over 2 new workers (spawned beside 12a's), worker 1 with a
   ``replica.kill`` schedule that exits it at its 6th RPC while it holds
   accepted work: the victim exits with 43 and is latched dead, 1 death
   and at least 1 re-dispatch, accepted == completed == 16 (the
   zero-loss identity), every stream by the same rule, and the autoscale
   replacement serves a request routed to it by the same rule; prints
   the replacement's spawn-to-ready seconds, the victim's exit to the
   DEAD latch, and p99 beside 12a's. Every worker is closed in a
   ``finally``; the ``kernels`` line adds the live workers' K3 and K8
   launches (the killed worker's die with it).

13. data parallelism — BERT-base in phase 5's recipe (flash, hidden
   dropout 0.1, seq 128, P 20, Adam past its warm-up, float32), first
   on one rank here on the whole batch of 32, then on 2 ranks of
   ``paddle_tpu_torch.distributed.launch`` sharing the card over gloo
   (each runs this script with ``--dp-rank``; 16 rows a rank), through
   ``fleet.distributed_optimizer(...).minimize`` and
   ``exe.run(fleet.main_program)``, 4 steps on one seeded batch whose
   rank-1 rows keep 9 of their 18 masked tokens. Checks: gloo; the
   ranks' parameters bit-equal after every step (a digest a rank a
   step) and their losses equal; the losses within ``DP_LOSS_TOL`` of
   the one-rank run's; the first dropout site's Mask, fetched (gathered)
   at the first step, bit-equal to the one-rank run's; K1/K2a/K2b/K8
   launches a rank equal to the prediction from the program (K1 twice a
   flash op a step, K2a and K2b once, K8 once a dropout site); one fused
   grad all-reduce of 4 bytes a parameter value a step, 3 scalar
   all-reduces (the loss's batch sums; their grads' reruns send none),
   rank 0's broadcast at the first run only; the MLM loss the
   global ratio and each token's loss weighed 1 / (all masked tokens)
   (the per-rank average, in the log beside it, would not). Prints step
   p50 a rank against the one-rank run's, the fused all-reduce's D2H,
   gloo and H2D ms and share of the step, device busy and idle share a
   rank (one more step under ``torch.profiler``), the memory peaks and
   the card's name and power limit. The ``kernels`` line adds both
   ranks' launches and the one-rank run's.

14. beam translation and dygraph. 14a: ``TransformerConfig.big()``
   (vocab 37000, d_model 1024, 16 heads, FFN 4096, 6+6 layers, pre-LN)
   initialised by the startup of ``build_wmt_train(big, src_len=64,
   tgt_len=64)`` from the seed (K8 draws the Xavier bits),
   ``params_from_scope``, ``BucketedBeamTranslator(beam_size=4,
   src_buckets=(16, 32, 64), max_len=64, length_penalty=0.6).warmup(8)``,
   8 sources of each of the lengths 11, 27 and 50. Checks: (i) each
   bucketed result against ``make_beam_decoder`` on the unpadded batch:
   equal hypotheses or, where a row's differ, the step at which the two
   runs part and the gap between their selected scores there, under
   ``BEAM_PART_GAP``; scores within ``BEAM_SCORE_TOL`` relative, the bit-equal
   ones counted; (ii) every hypothesis rescored by the cacheless forward
   (``decode_logits``): its length-penalised log-prob within
   ``BEAM_RESCORE_RTOL`` of the returned score; (iii) beam 1's tokens are
   the cacheless forward's greedy path (its argmax at every position up
   to the EOS, a flip allowed only at a gap under ``BEAM_PART_GAP``);
   (iv) K8 launched by the startup and none of K1-K7 during the
   translation. Prints tokens/s, ms a decode step, host syncs a step and
   the device's idle share (one translate under ``torch.profiler``).
   14b: ``models.transformer.copy_task_recipe`` (the tiny copy task of
   ``examples/machine_translation.py``: src and tgt 12, batch 32, Adam
   2e-3, 300 steps, seed 0, then buckets (12, 16) at beam 4; under torch's
   deterministic algorithms, so a run repeats): at least 6
   of 8 copied, and the bucket-padded tokens equal the exact-length
   run's. 14c: ``models.mnist.dygraph_mnist_recipe`` (BASELINE workload
   1: 784-64-10, batch 32, SGD 0.1, 8 steps, seed 0) under
   ``dygraph.guard()`` on the card: eager losses bit-equal to each
   step's ``to_static`` capture, within 1e-5 of the same run on the CPU,
   and falling; prints the step's ms. 14d: the dygraph conv stack of the
   reference's test_imperative_mnist (Conv2D 1->20 5x5, Pool2D 2,
   BatchNorm, Conv2D 20->50 5x5, Pool2D 2, Dropout 0.5
   upscale_in_train, Linear 800->10), batch 64, Adam, 4 steps, with the
   kernels on and off under torch's deterministic algorithms: losses and
   parameters bit-equal, K8 launched once a Dropout call plus once an
   initial draw. 14e: 14c's MLP under ``DataParallel`` on 2 ranks of
   ``paddle_tpu_torch.distributed.launch`` sharing the card over gloo
   (this script with ``--dygraph-rank``, 16 rows a rank) against one rank
   on the whole batch: losses within ``DYGRAPH_DP_TOL``, the ranks'
   parameters bit-equal after every step (the ranks start after 14a, so
   their start-up overlaps 14b-14d). The ``kernels`` line adds the
   K8 launches of 14a's startup, 14b, 14c, 14d's kernels-on run and 14e
   (both ranks and the one-rank run).
15. the data plane and the parameter server. The native feed and the
   native PS build in phase 1 from the port's copies (one ``g++`` each,
   beside the ``nvcc`` builds; a failed build fails the script: no
   fallback). 15a: phase 6's
   24 x 4096 click-log records through ``wide_deep.make_loader``
   (``DataLoader.from_generator(feed_list, capacity=8, num_workers=2)
   .set_sample_generator(..., 4096, sample_transform=...)``) into
   ``engine.prepare_feed`` and ``exe.run``: every batch (2 workers, and
   the first 8 with none) bit-equal to ``make_batch``'s, the ids numpy on the host and the
   dense feeds CUDA tensors; the 24 losses, the persistables, the host
   tier and the K5 launches bit-equal to the directly-fed run's. Prints
   the loader's batches/s alone (its first 8 batches), step p50 against
   the directly-fed p50,
   the consumer's wait share and the idle share (the loaded run's last 4
   steps under ``torch.profiler``). 15b: phase 7's 8 batches written as MultiSlot
   files by the port's ``MultiSlotDataGenerator``, an ``InMemoryDataset``
   on the native feed (its batches equal ``_PyFeed``'s and the rows'),
   ``exe.train_from_dataset(main, dataset, fetch_list=[loss])`` (Hogwild
   behind the prefetcher) against ``exe.run`` over the same batches:
   losses and tables bit-equal, K6 16 a step, ``exe.run``'s host syncs
   phase 7's 26 a step and the training thread's those less the feed
   uploads' (the prefetcher stages the feeds). Prints records/s parsed and the
   step p50 against ``exe.run``'s. 15c: ``build_ctr_train()`` at its own
   width (8 slots x 3 ids, deep 16, MLP 64-32, Adam), batch 4096, 8 steps
   a leg against an in-process native ``PSServer``: (i)
   ``ps_mode=True``, ids over 2^40, through ``fleet.worker(exe).run``;
   (ii) ``ps_mode="remote"``, ids under 2^31, ``prefetch_for_program``
   one batch ahead; (iii) leg (i)'s program and batches as MultiSlot
   files through ``train_from_dataset`` (DownpourSGD). Checks: (iii)
   equal to (i) bit for bit, the server's rows equal to the unique ids
   pulled, prefetch hits in (ii), and a parity leg (SGD 0.3, zero init,
   ids under 2^20, 4 steps) within rtol 2e-3 / atol 2e-4 of the dense
   tables' losses. Prints per leg the step p50, the pull and push ms a step and
   their share, the host syncs of one step and the idle share of one
   step. The ``kernels`` line adds 15a's K5, 15b's K6 and the startups'
   K8 launches.
16. hybrid parallelism on the IR path — ``models/gpt_ir.py`` at the JAX
   package's GPT-base width (vocab 32000, hidden 768, 12 layers, 12
   heads, context 1024) with Megatron tp 2, on 4 gloo ranks of the card
   relaunched as ``chip_smoke.py --hybrid-rank DIR``, mesh (data, stage,
   model) = (1, 2, 2) through ``CompiledProgram.with_parallel(param_specs=
   stack.param_spec_overrides())``: GPipe over 2 stages of 6 layers, 4
   microbatches of 2 x 1024 tokens, 3 Adam steps; causal attention on
   K1/K2a/K2b. Against one rank of the same global weights at tp 1 (this
   process, the plain executor): losses within rtol 5e-4, every grad of
   step 1 (gathered from the shards) within 1e-3 of its largest, every
   parameter after the steps within 2 lr a step and 1e-6 on average;
   replicas of a shard bit-equal; the same startup weights on every rank;
   K1, K2a and K2b once a layer a microbatch on every rank; each step's
   model all-reduces, stage sends, receives and broadcasts as planned.
   Prints step p50 a rank, the collectives' calls, MB and ms by axis, the
   receive-wait share beside the predicted bubble, and the idle share.

The last lines are the card's name and power limit, one JSON line of
per-kernel results, and ``{"ok": true, "device": {...}}``.
"""

import contextlib
import hashlib
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 20261016
S, L, H, R, BLOCK = 8, 1024, 768, 8192, 16
LAYERS = 12
MODEL = dict(vocab_size=32000, hidden=768, num_layers=12, ffn_dim=3072,
             slots=8, max_len=1024, block_size=16)
N_REQUESTS, SHARED_PREFIX, MAX_NEW = 16, 256, 32
PROMPT_LEN = (8, 512)
# Phase 3b, the engine's other modes on the same target: a chunk budget of
# 128 tokens; leg A's 4 short prompts (whole-prompt prefill) and 8 long
# ones (129-960 tokens: two share the 256-token prefix, `first` and
# `second`); legs B and C at spec_k 4, prompts of 16-300 tokens, a draft of
# 2 layers beside the one holding the target's weights
CHUNK_TOKENS, SPEC_K, SMALL_LAYERS = 128, 4, 2
SHORT_LENS = (16, 40, 72, 100)
FIRST_SHARED_TAIL, SECOND_SHARED_TAIL = 150, 300
LONG_LENS = (960, 129, 300, 517, 700, 850)
SPEC_PROMPT_LEN = (16, 301)
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)
# Phase 3c, beam search and grammars on a target with an eos_id and the
# DEC_MASK feed: beams of width 4 (one a 300-token prompt, past the chunk
# budget); the grammar vocabulary's stop token; the leg-B grammars
EOS, BEAM_WIDTH, BEAM_CHUNKED_LEN = 95, 4, 300
# new tokens of each 3c request (both legs; MAX_NEW until the whole script
# neared its time limit)
BEAM_MAX_NEW = 8
GRAMMAR_SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string"}, "age": {"type": "integer"},
    "tags": {"type": "array", "items": {"enum": ["a", "b", "c"]}},
    "ok": {"type": "boolean"}}}
GRAMMAR_REGEX = "[A-Z][a-z]+( [A-Z][a-z]+)*"
# The beam bar: the engine's hypotheses come from K3 steps, the reference's
# from the [1, L] prefill program; their float32 logits differ in the last
# bits (about 1e-6 relative), so their float64 log-prob sums over 32
# tokens differ by about 1e-5. 1e-3 leaves two orders of margin and still
# fails any hypothesis that a real selection error would change.
BEAM_TOL = 1e-3
# Phase 3d, the engine under overload: a pool of 96 blocks (1536 rows)
# for a burst of 12 requests of 96-384 prompt tokens (3 share a 128-token
# prefix) and 16 new tokens each (16 requests of 64 until the whole script
# neared its time limit; the first 12 of the same prompts; the first 8
# slots still need 123 blocks of the 96), beside the same burst on
# an uncut pool of 512; a 1 GiB host tier; the breaker opens after 3 failed steps and
# half-opens after 0.5 s; the corruption leg's 5 prompts of 300 tokens
OV_REQUESTS, OV_SHARED, OV_PROMPT_LEN, OV_MAX_NEW = 12, 128, (96, 384), 16
OV_BLOCKS, OV_UNCUT_BLOCKS, OV_TIER_MB = 96, 512, 1024
OV_BREAKER, OV_COOLDOWN_S, OV_CORRUPT_LEN = 3, 0.5, 300
# the corruption leg's new tokens: its 5 prompts of 300 tokens hold 95 of
# the 96 blocks after prefill and park once they decode past 304
OV_CORRUPT_NEW = 32
NEG_INF = -1e9
# The kernel and its plain version both produce convex combinations of
# N(0, 1) value rows, summed in float32 over 1024 positions in different
# orders (chunked online softmax vs one softmax + matmul). Rounding of
# such sums stays near 1e-6; 1e-4 leaves two orders of margin and still
# catches any wrong row, weight or mask.
PARITY_ATOL = 1e-4
# Flash attention: the plain versions compute the same float32 function
# with cuBLAS products and one softmax, the kernels over tiles in another
# order (with 3xTF32 tensor-core products, which keep float32 accuracy),
# so both sit within float32 rounding of each
# other (about 1e-6 relative). The bars are the CPU tests' (O and LSE
# rtol = atol = 1e-5, the JAX test's; grads rtol 1e-4, atol 1e-5),
# applied elementwise.
FLASH_SHAPES = (dict(B=32, H=12, S=128, D=64, causal=False, timed=True),
                dict(B=32, H=12, S=512, D=64, causal=True, timed=False),
                # phase 16's attention on a rank: 2 sequences a microbatch,
                # 6 of the 12 heads (tp 2), 1024 tokens, causal, no key
                # bias; timed beside the BERT row (``causal_*`` keys)
                dict(B=2, H=6, S=1024, D=64, causal=True, timed=True,
                     bias=False, row="causal"))
FWD_TOL, BWD_TOL = (1e-5, 1e-5), (1e-4, 1e-5)
# Phase 2f, the 16-bit builds against their plain versions in the same
# type: at BERT-base's shape (timed), causal and not, with a dead batch
# row (every key masked), and S=512 causal; float16 at BERT-base's shape.
# Both sides round P and dS to the operand type before their products and
# O, dQ, dK, dV at the end, but the kernel rounds P against the running
# maximum of 32-key tiles where the plain version uses the row's final one,
# and sums in another order, so an element may land one bf16 step (2^-8
# relative) away; summed over 128 keys such steps stay near 1e-3 of the
# output's largest magnitude. The bar: each output within 1e-2 of its
# largest magnitude (the CPU tests' bar against the Pallas kernel). The
# LSE comes from the same f32 scores (exact products of 16-bit values):
# rtol = atol = 1e-5.
FLASH16_SHAPES = (
    ("bf16", (dict(B=32, H=12, S=128, D=64, causal=False, timed=True),
              dict(B=32, H=12, S=128, D=64, causal=True, timed=False),
              dict(B=4, H=12, S=128, D=64, causal=False, timed=False,
                   dead_row=True),
              dict(B=32, H=12, S=512, D=64, causal=True, timed=False))),
    ("f16", (dict(B=32, H=12, S=128, D=64, causal=False, timed=True),)))
FLASH16_TOL, FLASH16_LSE_TOL = 1e-2, (1e-5, 1e-5)
# Training: BERT-base pretraining as the JAX package's benchmark runs it
# (bench.py:106-133), float32.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_P, TRAIN_STEPS, OFF_STEPS = 32, 128, 20, 4, 2
# hidden dropout as the JAX bench recipe keeps it (bench.py:106-116); the
# unfused default config (phase 5b) runs 3 steps on, OFF_STEPS off
TRAIN_DROPOUT, UNFUSED_STEPS = 0.1, 3
# Phase 5c, BERT-base under bf16 AMP (bench.py:126-132 turns it on): 6
# steps (p50 and p90 of the last 5), 2 more profiled, OFF_STEPS with the
# kernels off; then float16 with dynamic loss scaling from 2^15, 3 steps.
# Kernels on vs off: the 16-bit flash builds and their plain versions
# round P against other maxima (phase 2f), so attention outputs differ by
# a bf16 step here and there, and 12 layers of bf16 products carry that
# into the loss at about 1e-4 relative; the bar, rtol 2e-3, leaves a wide
# margin and still catches a wrong head, mask or row, which moves the
# loss by 1e-2 or more.
AMP_TRAIN_STEPS, AMP_PROFILED, AMP_F16_STEPS = 6, 2, 3
AMP_F16_SCALE = 2.0 ** 15
AMP_TRAIN_LOSS_TOL = (2e-3, 1e-5)
# build_bert_pretrain warms the learning rate up from 0 over 10000 steps.
# Both runs start with the step counter there, so every step applies the
# full rate and the comparison below sees real updates.
TRAIN_LR, WARMED_UP = 1e-4, 10000.0
COUNTER = "@LR_DECAY_COUNTER@"
# kernels on vs off over BERT-base: every step sums float32 over 4096
# tokens and 12 layers in another order, so losses agree to about 1e-6
# relative; a grad agrees to about 1e-5 of its own largest value. The bars
# (loss rtol 1e-4, atol 1e-5, the CPU test's; each grad within 1e-3 of its
# largest value, plus 1e-6 of the largest value of any grad for the grads
# that are zero in exact arithmetic and hold rounding noise alone, such as
# the key projection's bias, which softmax ignores) keep a wide margin and
# still catch a wrong head, row or mask, which moves a grad by the order
# of the grad itself.
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = (1e-4, 1e-5), (1e-3, 1e-6)
# The whole training state after OFF_STEPS steps, kernels on vs off. Adam
# divides each element by its own running grad size, so an element whose
# grad sits at rounding level can move by a different step in the two
# runs; such elements are few. So each parameter's update and each Adam
# moment is compared in norm: ||on - off|| within 1e-2 of ||off update||
# (moments: of ||off||), where a wrong update differs by the order of the
# update itself. The parameters whose grads are rounding noise alone (below
# the grad floor above) have updates of noise and are left out, counted in
# the log. Beta powers and the step counter must be equal.
TRAIN_STATE_TOL = 1e-2
# CTR: Wide&Deep at the JAX example's widths (examples/wide_deep.py), the
# batch raised from its CPU demo's 32; dense CTR at models/ctr.py's widths
# over 2^20-row tables
WD_BATCH, WD_STEPS, WD_CAPACITY, WD_BIG_CAPACITY = 4096, 24, 4096, 65536
CTR_VOCAB, CTR_BATCH, CTR_STEPS = 2 ** 20, 4096, 8
# Phase 10, checkpoints: BERT-base (phase 5's config) trains CKPT_STEPS
# steps before the blocking save and CKPT_ASYNC_STEPS while the async one
# writes; Wide&Deep (phase 6's) saves every WD_CKPT_INTERVAL steps of its
# WD_STEPS (at steps 11 and 23) and restores the newest; the recovery leg
# keeps CKPT_KEEP entries.
CKPT_STEPS, CKPT_ASYNC_STEPS, WD_CKPT_INTERVAL, CKPT_KEEP = 2, 2, 12, 2
# host syncs of one dense CTR step with K6: 16 torch.unique calls (one an
# sgd_sparse) and 10 more (the feed uploads, the loss's copy)
CTR_STEP_SYNCS = 26
# dense CTR, kernels on vs off: K6 equals its plain version bit for bit,
# and every other op is the same deterministic call in both runs, so the
# loss streams and every table must agree bit for bit (a looser bar, such
# as the JAX package's rtol 1e-5 / atol 1e-6 against its own kernel, is as
# large as a deep-table row's whole update over the run and would let a
# wrong K6 through)
# DGC top-k (K7) parity shapes: (label, n, k, block, kind); the first is
# timed, word_emb [37000, 512] at the path's k (sparsity 0.996). The last
# four sweep the block: one CTA (1000), a cluster of 5 whose last slice is
# shorter (4099), a block past what a cluster keeps in shared memory, and
# an all-equal |x| whose tie cut falls inside a middle CTA (53248 = 6.5
# slices of 8192 in a cluster of 16, 3.25 of 16384 in one of 8)
TOPK_BLOCK = 131072
TOPK_CASES = (("word_emb k=75776", 37000 * 512, 75776, TOPK_BLOCK, "normal"),
              ("word_emb k=18944", 37000 * 512, 18944, TOPK_BLOCK, "normal"),
              ("ffn k=1049", 512 * 2048, 1049, TOPK_BLOCK, "normal"),
              ("ffn k=4194", 512 * 2048, 4194, TOPK_BLOCK, "normal"),
              ("attn k=1049", 512 * 512, 1049, TOPK_BLOCK, "normal"),
              ("ties", 3 * TOPK_BLOCK + 5, 4000, TOPK_BLOCK, "ties"),
              ("ragged", 2 * TOPK_BLOCK + 777, 600, TOPK_BLOCK, "normal"),
              ("k > block", 300000, 140000, TOPK_BLOCK, "ties"),
              ("block 1000", 10 * 1000 + 7, 40, 1000, "normal"),
              ("block 4099", 5 * 4099 + 100, 300, 4099, "ties"),
              ("block 1000000", 1300000, 3000, 1000000, "normal"),
              ("all equal, cut inside a middle CTA", 2 * TOPK_BLOCK, 53248,
               TOPK_BLOCK, "equal"))
# Transformer-base data-parallel DGC training: 2 ranks on the one card,
# global batch 128 (64 sentences, 4096 target tokens a rank), seq 64, 3
# steps: step 0 dense (rampup_begin_step 1), step 1 sparse at 0.996,
# step 2 at 0.999 (rampup_step 2), where the keep mask cuts k (6 steps
# until the whole script neared its time limit)
DGC_RANKS, DGC_BATCH, DGC_SEQ, DGC_STEPS = 2, 128, 64, 3
# steps of the same model without dropout (the first dense, then one
# sparse), timed for the cost of dropout on the same host clock (5 until
# then)
DGC_NODROP_STEPS = 2
DGC_OPT = dict(learning_rate=0.01, momentum=0.9, rampup_begin_step=1,
               rampup_step=2, sparsity=[0.996, 0.999])
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores, and f32 work on the TF32 tensor cores in the
# 3xTF32 split (495 TFLOP/s of TF32, three products for each f32 one)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_3XTF32_FLOPS = 495e12 / 3
# dense bf16 and float16 tensor-core FLOP/s (the 16-bit flash builds)
PEAK_BF16_FLOPS = 989e12
# the empty kernel that gives the launch floor (not a port of a TPU kernel)
FLOOR_SOURCE = "launch_floor.cu"
# K8 (threefry bits, fused dropout): the random_bits sizes checked against
# the host copy of jax.random (an odd n, BERT-base's largest startup draw,
# word_embedding [30522, 768]); the dropout sites of the training paths
# (BERT-base's hidden [32, 128, 768] at 0.1 in both implementations, the
# unfused attention probabilities [32, 12, 128, 128]); a draw's integer
# work: one threefry2x32 is 73 32-bit operations at least (2 adds in, 20
# rounds of add, rotate and xor, 10 key-injection adds, the output xor;
# the SASS the compiler makes, printed, holds about 104 a draw), over the
# most integer work an SM can dispatch: one warp instruction a scheduler a
# cycle, 4 x 32 = 128 an SM a cycle (the 64 INT32 lanes plus the FMA
# lanes that run IMAD; the 64-lane rate alone is beaten on the card), 132
# SMs at 1.98 GHz
K8_SOURCE = "threefry.cu"
K8_TIMED_BITS = 30522 * 768
K8_BITS_SHAPES = (1_000_003, K8_TIMED_BITS)
K8_DROPOUT_CASES = (((32, 128, 768), 0.1, True, True),
                    ((32, 128, 768), 0.1, False, False),
                    ((32, 12, 128, 128), 0.1, True, False),
                    ((1_000_003,), 0.5, True, False))
K8_OPS_PER_DRAW = 73
PEAK_INT32_OPS = 128 * 132 * 1.98e9
# counter bases a dense data-parallel rank draws at: rank 1's block of a
# [16, 128, 768] dropout site (phase 13's), and two whose draws carry into
# the counter's high word, on the vector path (a multiple of 4) and off it
K8_BASES = (16 * 128 * 768, 2 ** 32 - 8, 2 ** 32 - 5)

# Phase 9, the conv-net training path. 9a: fit_a_line (examples/
# fit_a_line.py's program: fc, square_error_cost, mean, SGD 0.01) for 50
# steps of 20 rows of 13 features, and recognize_digits (examples/
# recognize_digits.py's: conv/pool twice, reshape, fc with softmax,
# cross_entropy, accuracy, Adam 1e-3) for 6 epochs of its 512 synthetic
# digits at batch 64, where the example asserts accuracy above 0.9.
# 9b and 9c: ResNet-50 as bench.py:344-367 trains it (ImageNet widths,
# class_dim 1000, lr 0.1, momentum 0.9, L2Decay 1e-4, batch 128, one
# seeded batch fed every step, 3 warm-up steps), in float32; 9d runs the
# bench's own recipe, bf16 AMP
LINE_BATCH, LINE_STEPS = 20, 50
DIGITS, DIGITS_BATCH, DIGITS_EPOCHS, DIGITS_ACC = 512, 64, 6, 0.9
RESNET_IMAGE, RESNET_CHECK_BATCH, RESNET_BATCH = (3, 224, 224), 8, 128
RESNET_WARMUP, RESNET_STEPS, RESNET_PROFILED = 3, 5, 2
# 9b, one ResNet-50 step at batch 8 on the card against the same step on
# the host's CPU from the same weights, in float32 (the path) and in
# float64 (the same program fed float64 weights and images). Bars as
# (loss rtol, moving statistics, grads). Float32: cuDNN and the CPU sum
# in other orders, so the forward (the loss, the moving statistics) agrees
# to about 1e-5; a grad does not agree elementwise, because a ReLU whose
# input lies within rounding of 0 keeps its grad on one side and drops it
# on the other, and BN's backward spreads each flip over its channel
# (each device's float32 grads stand about as far from its own float64
# ones, which the phase prints): grads are held in norm, ||card - CPU||
# within 0.1 of ||CPU|| (0.042 at worst on an H100, 700 W). Float64:
# rounding sits near 1e-13 and no mask flips, so every grad and statistic
# must agree within 1e-8 of its largest value, the loss within 1e-10: any
# difference between the card's and the CPU's computation that is not
# rounding breaks it. And the card's float32 grads may stray from its
# float64 ones (in norm over all grads) at most twice as far as the CPU's
# do: TF32 convolutions, or any other loss of float32 accuracy on the
# card, would stray further.
RESNET_F32_TOLS = (1e-4, 1e-4, 1e-1)
RESNET_F64_TOLS = (1e-10, 1e-8, 1e-8)
RESNET_F32_ACCURACY = 2.0
# 9d, ResNet-50 under bf16 AMP (bench.py:356-359 turns it on): the same
# batch-8 step on the card and on the host's CPU, both bf16. Their bf16
# convolutions sum in other orders and round to bf16 at their ends, so
# ReLU masks flip and BN spreads each flip (9b's float32 effect, at bf16's
# step): the loss agrees within 2e-2 relative, but the grads below the
# last block stand about as far apart as unrelated ones (0.98-1.40 in
# norm on an H100, 700 W; printed, not held: tests/test_torch_amp.py
# holds bf16 conv grads in value against the JAX package on a net where
# nothing amplifies the gap). Held, card against CPU: the grads nearest
# the loss in norm, each bar about 2.5x or more its reading on an H100
# (fc_0.w 0.104, fc_0.b_0 0.028, the last BN's offset 0.028; its scale,
# 0.49, is printed and not held). Held on each device: every parameter's
# L2 decay term (its velocity after one step from zero, less its grad)
# equals RESNET_L2 x its float32 master weight within float32's rounding
# of the velocity and of the product (the card's and the CPU's grads
# part, so the terms are held to their definition, not to each other).
# The phase plants faults in the card's step (grads zeroed, doubled or
# scrambled, the decay dropped or doubled) and fails if the check passes
# any of them.
RESNET_AMP_LOSS_TOL, RESNET_L2 = 2e-2, 1e-4
RESNET_AMP_GRAD_TOLS = {"fc_0.w": 0.25, "fc_0.b_0": 0.1,
                        "res5c_branch2c_bn_offset": 0.1}
RESNET_AMP_NEAR_LOSS = ("fc_0.w", "fc_0.b_0", "res5c_branch2c_bn_scale",
                        "res5c_branch2c_bn_offset")
# Phase 11, inference and serving: BERT-base (the JAX default: unfused
# attention, dropouts 0.1) exported at seq 128 and served through the
# predictor (latency at batches 1, 8 and 32, INFER_REPS calls each) and
# the ServingEngine (lattice INFER_LATTICE, 2 replicas, queue 256, 5 ms
# max wait; 4 client threads x 32 requests of 1-4 rows, real lengths
# 16-128 inside the mask; request POISON_AT of client 0 is the poison);
# ResNet-50 (depth 50, 1000 classes) exported and served at batch 32.
INFER_SEQ, INFER_BATCHES, INFER_REPS = 128, (1, 8, 32), 20
INFER_LATTICE = (1, 2, 4, 8, 16, 32)
ENGINE_CLIENTS, ENGINE_PER_CLIENT, ENGINE_ROWS = 4, 32, (1, 4)
ENGINE_LENS, POISON_AT, POISON_ID = (16, 128), 5, 4242
INFER_RESNET_BATCH = 32
# BERT-base's encoder: 6 fc a layer (q, k, v, out, ffn1, ffn2) + the
# pooler; one attention core a layer. ResNet-50's 53 conv + batch_norm
# pairs (the stem, 3 a bottleneck block x 16, 4 projection shortcuts):
# the JAX pass folds as many on the same builder call
# (tests/test_torch_passes.py counts both on the CPU).
BERT_FC_FUSED, RESNET50_BN_FOLDS = 73, 53
# Bars. 11a: the predictor (fc ops, K1) against the exported program
# through the executor with the kernels off (mul + add, the composite
# attention): float32 sums in another order through 12 layer norms, near
# 1e-6 of outputs of magnitude 1-4 at each layer; 1e-3 leaves margin and
# still catches a wrong head, mask or weight. 11b: bf16 products (8-bit
# mantissa) against 11a: the RMS of the difference within 3e-2 of the
# float32 outputs' RMS and no element more than 0.5 away (the same bf16
# rounding on a single layer moves an output by about 1e-2 of its scale).
# 11c: served (padded, batched) against single-request float32: cuBLAS
# picks its GEMM by the row count, so the bits may differ (a fault the
# reference shares, ROADMAP C); 11a's bar. 11d: folded conv-bn against the
# unfused clone, 1e-4 of the largest logit.
INFER_TOL, INFER_BF16_RMS, INFER_BF16_MAX = 1e-3, 3e-2, 0.5
SERVED_TOL, RESNET_FOLD_TOL = 1e-3, 1e-4


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check_environment():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch")):
        raise SystemExit("chip_smoke: run it from a checkout of the "
                         "repository (paddle_tpu_torch/ is missing)")
    sys.path.insert(0, here)
    # full float32 matrix products and convolutions: the references here
    # compare float32 sums, which TF32's 10-bit mantissa would blur
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)


# -- phase 1 ----------------------------------------------------------------
def phase_build():
    from paddle_tpu_torch import native
    from paddle_tpu_torch.kernels import KERNELS, build

    sources = sorted({os.path.basename(k.source) for k in KERNELS.values()}
                     | {FLOOR_SOURCE})
    t0 = time.perf_counter()
    # one nvcc per source and one g++ per native host component (phase
    # 15's), all started together
    with ThreadPoolExecutor(len(sources) + len(NATIVE)) as pool:
        kernel_outputs = pool.map(build.build, sources)
        native_outputs = pool.map(native.build_native, NATIVE)
        outputs = dict(zip(sources, kernel_outputs))
        list(native_outputs)
    for source in sources:
        build.load(source)
    log(f"[build] {', '.join(sources)}, and the native "
        f"{' and '.join(NATIVE)}: {time.perf_counter() - t0:.2f}s")
    for source, out in outputs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build]   {source}: {line.strip()}")


# -- phase 2 ----------------------------------------------------------------
def make_inputs(gen, device):
    """Random slice-shaped inputs: per-layer arenas, q, a block row map
    whose slots share some blocks, random cursors and one retired slot."""
    import torch

    rng = np.random.RandomState(SEED)
    n_blocks = R // BLOCK
    per_slot = L // BLOCK
    tables = [rng.choice(n_blocks, per_slot, replace=False) for _ in range(S)]
    tables[1][:per_slot // 4] = tables[0][:per_slot // 4]   # shared prefix
    rows = np.concatenate([
        (t[:, None] * BLOCK + np.arange(BLOCK)[None]).reshape(-1)
        for t in tables]).astype(np.int64)
    cursors = rng.randint(0, L, size=S)
    bias = np.full((S, 1, L), NEG_INF, np.float32)
    for s in range(S - 1):                 # the last slot is retired
        bias[s, 0, :cursors[s] + 1] = 0.0

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    return {
        "q": randn(S, H),
        "k": [randn(R, H) for _ in range(LAYERS)],
        "v": [randn(R, H) for _ in range(LAYERS)],
        "rows": torch.from_numpy(rows).to(device),
        "bias": torch.from_numpy(bias).to(device),
        "rows_np": rows,
        "bias_np": bias,
    }


def needed_positions(bias_np):
    """Per slot, the positions this run's data needs: the unmasked ones,
    or all of them for a fully masked slot (its output is the uniform
    average of every row)."""
    out = []
    for s in range(bias_np.shape[0]):
        live = np.nonzero(bias_np[s, 0] > NEG_INF / 2)[0]
        out.append(live if live.size else np.arange(bias_np.shape[-1]))
    return out


def bound(n_rows_read, positions, extra_bytes):
    """Least time for the work: rows read once, inputs and outputs moved
    once, two multiply-adds per element of each needed row."""
    bytes_ = n_rows_read * H * 4 * 2 + extra_bytes
    flops = positions * H * 4
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps, windows=5):
    """Milliseconds per call of ``fn``: CUDA events around ``reps`` calls,
    the median of ``windows`` such windows, after three warm-up calls
    (clocks ramp up from idle)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return float(np.median(times))


def device_ms(fn, reps=20, windows=5):
    """Device milliseconds per call of ``fn``, without the host's cost of
    issuing it: each window's ``reps`` calls are queued behind
    ``torch.cuda._sleep``, long enough that the host has issued them all
    before the start event fires, so the events time only the device (the
    median of ``windows``, after three warm-up calls). A window whose start
    event had already fired when the host finished issuing is run again
    with a sleep twice as long; ``fn`` must not sync with the card."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # _sleep spins for a count of SM clocks; 2e9 a second is above the
    # H100's highest clock, so the sleep lasts at least the time asked
    cycles = int((4 * issue_s + 2e-4) * 2e9)
    times = []
    for _ in range(windows):
        for _attempt in range(5):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            for _ in range(reps):
                fn()
            stop.record()
            late = start.query()
            torch.cuda.synchronize()
            if not late:
                break
            cycles *= 2
        else:
            raise AssertionError("device_ms: the sleep ended before the host "
                                 "had issued the window (does fn sync?)")
        times.append(start.elapsed_time(stop) / reps)
    return float(np.median(times))


def host_us(fn, reps=200, windows=5):
    """Host microseconds per call of ``fn``: a host clock around ``reps``
    calls with no sync among them (the median of ``windows``, after three
    warm-up calls); the card runs behind and is drained between windows."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times))


def launch_floors():
    """Two zero-argument calls that launch the empty kernel of
    ``csrc/launch_floor.cu`` on card 0's current stream with K6's eleven
    arguments, through the same ctypes route as K5 and K6: declared one by
    one (as every kernel takes them), and packed by ``struct`` into one
    block of int64 words behind one pointer. Their device time is the
    least a launch costs the card, their host times the least a call costs
    Python by either binding."""
    import ctypes
    import struct

    from paddle_tpu_torch.kernels import build

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    typed = build.function(FLOOR_SOURCE, "launch_floor",
                           [i, p, p, i, p, ll, ll, ll, p, p, p])
    block = build.function(FLOOR_SOURCE, "launch_floor_block", [p])
    buf = ctypes.create_string_buffer(8 * 11)
    addr, pack = ctypes.addressof(buf), struct.Struct("11q").pack_into
    stream = build.raw_stream_getter()
    ptr = 1 << 47          # a device address's size; never dereferenced

    def checked(err):
        if err:
            raise RuntimeError(f"the empty kernel did not launch ({err})")

    def go_typed():
        checked(typed(0, ptr, ptr, 1, ptr, 12288, CTR_VOCAB, 16, stream(0),
                      ptr, ptr))

    def go_block():
        pack(buf, 0, 0, ptr, ptr, 1, ptr, 12288, CTR_VOCAB, 16, stream(0),
             ptr, ptr)
        checked(block(addr))
    return go_typed, go_block


def phase_parity():
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import attention as A

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = make_inputs(gen, dev)
    q, rows, bias = x["q"], x["rows"], x["bias"]
    scale = 1.0 / float(np.sqrt(H))
    need = needed_positions(x["bias_np"])
    n_pos = sum(len(p) for p in need)
    results = {}

    # paged: 12 layers' arenas, so one layer's 50 MB of rows is not all
    # sitting in the 50 MB L2 when the next launch reads it
    errs = []
    for i in range(LAYERS):
        got = A.paged_attention(q, x["k"][i], x["v"][i], rows, bias, S, L,
                                scale)
        ref = A.paged_attention_composite(q, x["k"][i], x["v"][i], rows,
                                          bias, S, L, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError("paged_attention kernel: non-finite output")
        errs.append(float((got - ref).abs().max()))
    err = max(errs)
    log(f"[parity] paged_attention max_abs_err={err:.3e} (atol {PARITY_ATOL})")
    if not err <= PARITY_ATOL:
        raise AssertionError(f"paged_attention kernel disagrees: {err}")

    def run_layers(fn):
        def go():
            for i in range(LAYERS):
                fn(i)
        return go

    # device time (the wrappers make no host sync), over 12 layers' arenas
    kernel_ms = device_ms(run_layers(lambda i: A.paged_attention(
        q, x["k"][i], x["v"][i], rows, bias, S, L, scale)), 10) / LAYERS
    plain_ms = device_ms(run_layers(lambda i: A.paged_attention_composite(
        q, x["k"][i], x["v"][i], rows, bias, S, L, scale)), 10) / LAYERS
    gk = [x["k"][i].index_select(0, rows).reshape(S, 1, L, H)
          for i in range(LAYERS)]
    gv = [x["v"][i].index_select(0, rows).reshape(S, 1, L, H)
          for i in range(LAYERS)]
    q4, mask4 = q.reshape(S, 1, 1, H), bias.reshape(S, 1, 1, L)
    lib_ms = device_ms(run_layers(lambda i: F.scaled_dot_product_attention(
        q4, gk[i], gv[i], attn_mask=mask4, scale=scale)), 10) / LAYERS
    rows_needed = np.unique(np.concatenate(
        [x["rows_np"][s * L + p] for s, p in enumerate(need)])).size
    b_ms, b_by = bound(rows_needed, n_pos,
                       S * H * 4 * 2 + S * L * (8 + 4))
    results["paged_attention"] = dict(max_abs_err=err, ms=kernel_ms,
                                      plain_ms=plain_ms, bound_ms=b_ms,
                                      bound_by=b_by, library_ms=lib_ms)
    # the floor of reading every position's K and V rows once, as the
    # composite does and the kernel must (log only)
    every_row = {"paged_attention": bound(S * L, S * L,
                                          S * H * 4 * 2 + S * L * (8 + 4))[0]}
    del gk, gv

    # dense: the same kernel over [S, L, H] caches
    kc = [x["k"][i][:S * L].reshape(S, L, H) for i in range(LAYERS)]
    vc = [x["v"][i][:S * L].reshape(S, L, H) for i in range(LAYERS)]
    errs = []
    for i in range(LAYERS):
        got = A.decode_attention(q, kc[i], vc[i], bias, scale)
        ref = A.cached_attention_composite(q, kc[i], vc[i], bias, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError("decode_attention kernel: non-finite output")
        errs.append(float((got - ref).abs().max()))
    err = max(errs)
    log(f"[parity] decode_attention max_abs_err={err:.3e} (atol {PARITY_ATOL})")
    if not err <= PARITY_ATOL:
        raise AssertionError(f"decode_attention kernel disagrees: {err}")
    kernel_ms = device_ms(run_layers(lambda i: A.decode_attention(
        q, kc[i], vc[i], bias, scale)), 10) / LAYERS
    plain_ms = device_ms(run_layers(lambda i: A.cached_attention_composite(
        q, kc[i], vc[i], bias, scale)), 10) / LAYERS
    lib_ms = device_ms(run_layers(lambda i: F.scaled_dot_product_attention(
        q4, kc[i].unsqueeze(1), vc[i].unsqueeze(1), attn_mask=mask4,
        scale=scale)), 10) / LAYERS
    b_ms, b_by = bound(n_pos, n_pos, S * H * 4 * 2 + S * L * 4)
    results["decode_attention"] = dict(max_abs_err=err, ms=kernel_ms,
                                       plain_ms=plain_ms, bound_ms=b_ms,
                                       bound_by=b_by, library_ms=lib_ms)
    every_row["decode_attention"] = bound(S * L, S * L,
                                          S * H * 4 * 2 + S * L * 4)[0]
    # one kernel launch a call: the slot's combine runs inside it
    calls = {"paged_attention": lambda: A.paged_attention(
                 q, x["k"][0], x["v"][0], rows, bias, S, L, scale),
             "decode_attention": lambda: A.decode_attention(
                 q, kc[0], vc[0], bias, scale)}
    for name, fn in calls.items():
        kernels, ops = cuda_launches(fn, kernels_only=True), cuda_launches(fn)
        log(f"[parity] {name}: {kernels} kernel launches a call ({ops} "
            "device operations with the counters' memset; profiler trace)")
        if kernels != 1:
            raise AssertionError(f"{name}: {kernels} kernel launches a call, "
                                 "expected one")
    for name, r in results.items():
        log(f"[parity] {name}: kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}; reading every "
            f"position's K and V rows once: {every_row[name]:.4f})")
    return results


# -- phase 2b ---------------------------------------------------------------
def _check_close(name, got, want, tol):
    """Max abs error of ``got`` against ``want``; raises past
    |got - want| <= atol + rtol * |want| anywhere."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    rtol, atol = tol
    diff = (got - want).abs()
    if not bool((diff <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"max abs err {float(diff.max()):.3e}")
    return float(diff.max())


def flash_inputs(gen, dev, B, H, S, D):
    """q, k, v, dO ~ N(0, 1) and a padding-mask bias: batch row b keeps
    its first n_b keys (n_b random in [S/2, S]) and gives the rest
    BERT's -10000."""
    import torch

    def randn():
        return torch.randn(B, H, S, D, generator=gen, device=dev)

    q, k, v, dout = randn(), randn(), randn(), randn()
    keep = torch.randint(S // 2, S + 1, (B, 1), generator=gen, device=dev)
    cols = torch.arange(S, device=dev)[None, :]
    bias = torch.where(cols < keep, 0.0, -10000.0).contiguous()
    return q, k, v, dout, bias


# the rate of each flash kernel's route: all three 3xTF32
FLASH_RATES = {"flash_attention_fwd": PEAK_3XTF32_FLOPS,
               "flash_attention_bwd_dkdv": PEAK_3XTF32_FLOPS,
               "flash_attention_bwd_dq": PEAK_3XTF32_FLOPS}


def flash_bounds(B, H, S, D, rates=FLASH_RATES, elem=4, causal=False,
                 bias=True):
    """(bound_ms, bound_by) of K1, K2a and K2b: the larger of each input
    read once and each output written once at the card's memory rate, and
    its multiply-adds (two FLOPs each) at ``rates[name]``, the FLOP/s of
    the kernel's route (K2a's bytes include the dbias it writes, with a
    ``bias``). Causal attention needs the ``S (S + 1) / 2`` query-key
    pairs on or below the diagonal. q, k, v, O, dO, dQ, dK and dV take
    ``elem`` bytes a value; the LSE, delta, bias and dbias are float32."""
    tensor = B * H * S * D * elem
    row = B * H * S * 4
    bias = B * S * 4 if bias else 0
    dbias = row if bias else 0
    pairs = S * (S + 1) // 2 if causal else S * S
    work = {"flash_attention_fwd": (4, 3 * tensor + bias + tensor + row),
            "flash_attention_bwd_dkdv": (8, 4 * tensor + 2 * row + bias
                                         + 2 * tensor + dbias),
            "flash_attention_bwd_dq": (6, 4 * tensor + 2 * row + bias + tensor)}
    out = {}
    for name, (mults, bytes_) in work.items():
        t_ops = mults * B * H * pairs * D / rates[name] * 1e3
        t_bytes = bytes_ / PEAK_BYTES_S * 1e3
        out[name] = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return out


def _same_bits(name, fn):
    """Raises unless two calls of ``fn`` (a tuple of tensors or Nones)
    give the same bits."""
    import torch

    first, second = fn(), fn()
    for a, b in zip(first, second):
        if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
            raise AssertionError(f"{name}: two launches on the same inputs differ")


def _flash_parity(FA, names, inputs, causal, tag, checks, errs):
    """K1, K2a and K2b (launch-count ``names``) against their plain
    versions on ``inputs`` (q, k, v, dO, bias), two launches of each giving
    the same bits. ``checks`` = (out, lse, grad): each ``check(name, got,
    want)`` raises past its bar and returns the max abs error, which goes
    into ``errs``. Returns the backward's arguments (with the plain LSE
    and delta) and the plain O."""
    import torch

    q, k, v, dout, bias = inputs
    out_check, lse_check, grad_check = checks
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    o, lse = FA.flash_attention_fwd(q, k, v, bias, causal, scale)
    o_p, lse_p = FA.flash_attention_composite(q, k, v, bias, causal, scale)
    torch.cuda.synchronize()
    errs[names[0]] = max(errs[names[0]], out_check(f"K1 O {tag}", o, o_p),
                         lse_check(f"K1 LSE {tag}", lse, lse_p))
    delta = (dout.float() * o_p.float()).sum(-1)
    args = (q, k, v, bias, dout, lse_p, delta, causal, scale)
    dk, dv, db = FA.flash_attention_bwd_dkdv(*args)
    dk_p, dv_p, db_p = FA.flash_attention_bwd_dkdv_composite(*args)
    dq = FA.flash_attention_bwd_dq(*args)
    dq_p = FA.flash_attention_bwd_dq_composite(*args)
    torch.cuda.synchronize()
    for got, want in ((o, o_p), (dk, dk_p), (dv, dv_p), (dq, dq_p)):
        if got.dtype != q.dtype or want.dtype != q.dtype:
            raise AssertionError(f"{tag}: outputs in {got.dtype} / "
                                 f"{want.dtype}, expected {q.dtype}")
    errs[names[1]] = max(errs[names[1]], grad_check(f"K2a dK {tag}", dk, dk_p),
                         grad_check(f"K2a dV {tag}", dv, dv_p),
                         grad_check(f"K2a dbias {tag}", db, db_p)
                         if bias is not None else 0.0)
    errs[names[2]] = max(errs[names[2]], grad_check(f"K2b dQ {tag}", dq, dq_p))
    _same_bits(f"K1 {tag}", lambda: FA.flash_attention_fwd(
        q, k, v, bias, causal, scale))
    _same_bits(f"K2a {tag}", lambda: FA.flash_attention_bwd_dkdv(*args))
    _same_bits(f"K2b {tag}", lambda: (FA.flash_attention_bwd_dq(*args),))
    return args, o_p


def _flash_times(FA, names, args, bounds):
    """Device ms of K1, K2a and K2b at ``args`` (the backward's arguments)
    beside their plain versions' time, ``bounds[name]`` and one PyTorch
    library call: ``scaled_dot_product_attention`` with its backend pinned
    to memory-efficient attention (its default choice moved the backward's
    time 2.5x between runs; flash takes no additive mask), the forward,
    and its backward for dq + dk + dv together (the backward runs on the
    backend of the forward that built its graph). Returns the rows and the
    library backward's ms."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v, bias, dout, _, _, causal, scale = args
    # a key bias rides as sdpa's additive mask; without one, causality is
    # sdpa's own (it takes one or the other)
    mask4 = bias[:, None, None, :].to(q.dtype) if bias is not None else None
    lib_causal = causal and mask4 is None
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        lib_out = F.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=mask4, is_causal=lib_causal, scale=scale)
        lib_fwd = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask4, is_causal=lib_causal, scale=scale), 10)
    lib_bwd = device_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), dout, retain_graph=True), 10)
    timed = {
        names[0]: (lambda: FA.flash_attention_fwd(q, k, v, bias, causal, scale),
                   lambda: FA.flash_attention_composite(q, k, v, bias, causal,
                                                        scale),
                   lib_fwd),
        names[1]: (lambda: FA.flash_attention_bwd_dkdv(*args),
                   lambda: FA.flash_attention_bwd_dkdv_composite(*args),
                   lib_bwd),
        names[2]: (lambda: FA.flash_attention_bwd_dq(*args),
                   lambda: FA.flash_attention_bwd_dq_composite(*args),
                   lib_bwd),
    }
    results = {}
    for (name, (kernel, plain, lib_ms)), (bound, bound_by) in zip(
            timed.items(), bounds):
        results[name] = dict(ms=device_ms(kernel, 10),
                             plain_ms=time_ms(plain, 10),
                             bound_ms=bound, bound_by=bound_by,
                             library_ms=lib_ms)
    return results, lib_bwd


def phase_flash():
    import torch

    from paddle_tpu_torch.kernels import flash_attention as FA

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    names = ("flash_attention_fwd", "flash_attention_bwd_dkdv",
             "flash_attention_bwd_dq")
    errs = {n: 0.0 for n in names}
    checks = (lambda n, g, w: _check_close(n, g, w, FWD_TOL),
              lambda n, g, w: _check_close(n, g, w, FWD_TOL),
              lambda n, g, w: _check_close(n, g, w, BWD_TOL))
    results, extra = {}, {n: {} for n in names}
    for shape in FLASH_SHAPES:
        B, H, S, D, causal = (shape[k] for k in ("B", "H", "S", "D", "causal"))
        inputs = flash_inputs(gen, dev, B, H, S, D)
        with_bias = shape.get("bias", True)
        if not with_bias:
            inputs = inputs[:4] + (None,)
        tag = f"S={S}{' causal' if causal else ''}"
        if "row" in shape:
            tag = f"[{B}, {H}, {S}, {D}]{' causal' if causal else ''}" + (
                "" if with_bias else " no bias")
        shape_errs = {n: 0.0 for n in names}
        args, o_p = _flash_parity(FA, names, inputs, causal, tag, checks,
                                  shape_errs)
        for n in names:
            errs[n] = max(errs[n], shape_errs[n])
        log(f"[flash] {tag}: max abs err K1 {shape_errs[names[0]]:.3e} "
            f"K2a {shape_errs[names[1]]:.3e} K2b {shape_errs[names[2]]:.3e}; "
            "two launches of each give the same bits")
        if not shape["timed"]:
            continue
        if "row" in shape:
            # a second timed row, beside the first's numbers in the
            # kernels line
            bounds = flash_bounds(B, H, S, D, causal=causal, bias=with_bias)
            row, _ = _flash_times(FA, names, args, [bounds[n] for n in names])
            for n in names:
                r = dict(row[n], max_abs_err=shape_errs[n],
                         shape=[B, H, S, D])
                extra[n].update({f"{shape['row']}_{k}": v
                                 for k, v in r.items()})
                log(f"[flash] {tag} {n}: kernel_ms={r['ms']:.4f} "
                    f"plain_ms={r['plain_ms']:.4f} library_ms="
                    f"{r['library_ms']:.4f} (sdpa, is_causal, memory-"
                    f"efficient pinned{'; its backward: dq+dk+dv' if n != names[0] else ''}) "
                    f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}, the "
                    f"{S * (S + 1) // 2} causal pairs a head) max_abs_err="
                    f"{r['max_abs_err']:.3e}")
            continue
        bounds = flash_bounds(B, H, S, D)
        results, lib_bwd = _flash_times(FA, names, args,
                                        [bounds[n] for n in names])
        # the FFMA route's bounds, for the log only (the kernels line
        # carries the route's bound)
        ffma = flash_bounds(B, H, S, D, dict.fromkeys(names, PEAK_F32_FLOPS))
        # the whole backward as BERT's step runs it, through autograd like
        # sdpa's: FlashAttention.backward (delta, K2a with no dbias, since
        # BERT's padding mask takes no grad, so no head-sum either, and K2b)
        q, k, v, bias, dout, _, _, _, scale = args
        qf, kf, vf = (t.detach().clone().requires_grad_() for t in (q, k, v))
        ours = FA.flash_attention(qf, kf, vf, bias=bias, causal=causal,
                                  sm_scale=scale)
        whole = device_ms(lambda: torch.autograd.grad(
            ours, (qf, kf, vf), dout, retain_graph=True), 10)
        delta_ms = device_ms(lambda: (dout * o_p).sum(-1), 10)
        k2a_ms = device_ms(lambda: FA.flash_attention_bwd_dkdv(
            *args, want_dbias=False), 10)
        for name in names[1:]:
            results[name].update(backward_ms=whole, backward_library_ms=lib_bwd)
        k2 = results[names[1]]["ms"] + results[names[2]]["ms"]
        lib_fwd = results[names[0]]["library_ms"]
        log(f"[flash] backward as BERT runs it: {whole:.4f} ms (delta "
            f"{delta_ms:.4f}, K2a without dbias {k2a_ms:.4f}, K2b "
            f"{results[names[2]]['ms']:.4f}, each alone) against sdpa "
            f"backward (memory-efficient, pinned) {lib_bwd:.4f} ms: "
            f"{whole / lib_bwd:.2f}x its time; K2a (with dbias) + K2b "
            f"{k2:.4f} ms ({k2 / lib_bwd:.2f}x); forward K1 "
            f"{results[names[0]]['ms']:.4f} ms against {lib_fwd:.4f} ms "
            f"({results[names[0]]['ms'] / lib_fwd:.2f}x)")
        del ours, qf, kf, vf
    for name in names:
        r = results[name]
        r["max_abs_err"] = errs[name]
        r.update(extra[name])
        log(f"[flash] {name}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f}"
            f"{' (sdpa backward, dq+dk+dv together)' if name != names[0] else ''}"
            " (device times) "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}; at the f32 FFMA "
            f"rate {ffma[name][0]:.4f})")
    return results


# -- phase 2f ---------------------------------------------------------------
def _check_frac(name, got, want, frac):
    """Max abs error of ``got`` against ``want``; raises past ``frac`` of
    ``want``'s largest magnitude anywhere."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = float((got.float() - want.float()).abs().max())
    bar = frac * float(want.float().abs().max())
    if diff > bar:
        raise AssertionError(f"{name} disagrees with its plain version: max "
                             f"abs err {diff:.3e} past {bar:.3e}")
    return diff


def phase_flash16():
    """Phase 2f: the bf16 and float16 builds of K1, K2a and K2b against
    their plain versions in the same type on the card."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as FA

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bases = ("flash_attention_fwd", "flash_attention_bwd_dkdv",
             "flash_attention_bwd_dq")
    def frac(name, got, want):
        return _check_frac(name, got, want, FLASH16_TOL)

    checks = (frac, lambda n, g, w: _check_close(n, g, w, FLASH16_LSE_TOL), frac)
    results = {}
    for dname, shapes in FLASH16_SHAPES:
        dtype = {"bf16": torch.bfloat16, "f16": torch.float16}[dname]
        names = [FA.kernel_name(b, dtype) for b in bases]
        errs = dict.fromkeys(names, 0.0)
        for shape in shapes:
            B, H, S, D, causal = (shape[k] for k in ("B", "H", "S", "D", "causal"))
            q, k, v, dout, bias = flash_inputs(gen, dev, B, H, S, D)
            if shape.get("dead_row"):
                bias[0] = -1e30    # batch row 0: every key masked
            inputs = (*(t.to(dtype) for t in (q, k, v, dout)), bias)
            tag = f"{dname} S={S}{' causal' if causal else ''}"
            args, _ = _flash_parity(FA, names, inputs, causal, tag, checks, errs)
            log(f"[flash16] {tag}{' dead row' if shape.get('dead_row') else ''}: "
                f"max abs err K1 {errs[names[0]]:.3e} K2a {errs[names[1]]:.3e} "
                f"K2b {errs[names[2]]:.3e}; two launches of each give the same bits")
            if shape["timed"]:
                bounds = flash_bounds(
                    B, H, S, D, dict.fromkeys(bases, PEAK_BF16_FLOPS), elem=2)
                results.update(_flash_times(FA, names, args,
                                            [bounds[b] for b in bases])[0])
        for name in names:
            r = results[name]
            r["max_abs_err"] = errs[name]
            log(f"[flash16] {name}: kernel_ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f}"
                f"{' (sdpa backward, dq+dk+dv together)' if 'bwd' in name else ''}"
                f" (device times) bound_ms={r['bound_ms']:.4f} ({r['bound_by']})")
    return results


# -- phase 3 ----------------------------------------------------------------
def make_prompts(vocab):
    rng = np.random.RandomState(SEED)
    prefix = rng.randint(0, vocab, SHARED_PREFIX).tolist()
    prompts = []
    for i in range(N_REQUESTS):
        if i % 4 == 0:          # 4 requests share the 256-token prefix
            extra = int(rng.randint(PROMPT_LEN[0],
                                    PROMPT_LEN[1] - SHARED_PREFIX + 1))
            prompts.append(prefix + rng.randint(0, vocab, extra).tolist())
        else:
            n = int(rng.randint(PROMPT_LEN[0], PROMPT_LEN[1] + 1))
            prompts.append(rng.randint(0, vocab, n).tolist())
    return prompts


def check_against_offline(entry, prompt, got, want, sampling=None,
                          tag="engine", grammar=None):
    """Equal tokens, or a first divergence where the offline top-2 gap
    is below 1e-4 of the largest |logit| (a near-tie that float32 sums in
    another order may break either way). For a sampled stream the scores
    are the offline row's Gumbel-perturbed ``z + g`` (``z`` the filtered
    logits over the temperature, ``g`` the request's committed noise at
    that token), and the bar is 1e-4 of the largest |logit| over the
    temperature, the scale of ``z``. With a ``grammar`` the scores are
    the masked ones (the grammar's state after ``want[:t]``), the bar
    the unmasked row's."""
    import torch

    from paddle_tpu_torch.serving.decode.generate import GrammarConstraint
    from paddle_tpu_torch.serving.decode.generate import sampling as smp

    for t, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        toks = list(prompt) + list(want[:t])
        row = entry.prefill_logits(toks)[len(toks) - 1]
        mask = 0.0
        if grammar is not None:
            c = GrammarConstraint(grammar)
            for tok in want[:t]:
                c.advance(tok)
            mask = torch.from_numpy(c.mask()).to(row.device)
        if sampling is None:
            top2 = torch.topk(row + mask, 2).values
            gap = float(top2[0] - top2[1])
            tol = 1e-4 * float(row.abs().max())
        else:
            x = row.cpu().numpy().astype(np.float32)
            masked = (row + mask).cpu().numpy().astype(np.float32)
            scores = (smp.filtered_scores(masked, sampling)
                      + smp.gumbel_vector(sampling.seed, t, x.size))
            top2 = np.sort(scores[np.isfinite(scores)])[-2:]
            gap = float(top2[1] - top2[0])
            tol = 1e-4 * float(np.abs(x).max()) / sampling.temperature
        log(f"[{tag}] divergence at step {t}: engine {a} offline {b}, "
            f"offline top-2 gap {gap:.3e} (tolerated below {tol:.3e})")
        if gap >= tol:
            raise AssertionError(
                f"{tag}: tokens diverge from offline_decode at step {t} "
                f"with a clear top-2 gap {gap}")
        return "near-tie"
    if len(got) != len(want):
        raise AssertionError(f"{tag}: engine produced {len(got)} tokens, "
                             f"offline {len(want)}")
    return "equal"


def phase_engine():
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import GenerationEngine, build_decoder_model

    t0 = time.perf_counter()
    engine = GenerationEngine(seed=SEED)          # CUDAPlace(0) by default
    entry = engine.register_model(build_decoder_model(**MODEL))
    torch.cuda.synchronize()
    log(f"[engine] place={engine.place} startup {time.perf_counter() - t0:.2f}s "
        f"arena {entry.model.arena_bytes() / 2**20:.0f} MiB")
    prompts = make_prompts(MODEL["vocab_size"])
    engine.start()
    kernels.reset_launches()
    t0 = time.perf_counter()
    resps = [engine.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    outs = [[int(t) for t in r.result(timeout=600)["tokens"]] for r in resps]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    engine.shutdown()
    st = entry.stats()
    steps = st["steps"]
    log(f"[engine] {len(outs)} requests in {wall:.2f}s, {steps} decode steps, "
        f"launches {launches}")
    if st.get("completed", 0) != N_REQUESTS or len(outs) != N_REQUESTS:
        raise AssertionError(f"not every request completed: {st}")
    for o in outs:
        if len(o) != MAX_NEW or not all(0 <= t < MODEL["vocab_size"] for t in o):
            raise AssertionError(f"bad token stream {o[:8]}...")
    if launches["paged_attention"] < MODEL["num_layers"] * steps or steps == 0:
        raise AssertionError(
            f"paged_attention launched {launches['paged_attention']} times "
            f"over {steps} decode steps of {MODEL['num_layers']} layers")
    verdicts = []
    for i in (0, 1, 4, 7):                      # two of them share the prefix
        want = entry.offline_decode(prompts[i], MAX_NEW)
        verdicts.append(check_against_offline(entry, prompts[i], outs[i], want))
    log(f"[engine] offline_decode checks: {verdicts}")
    row = entry.prefill_logits(prompts[2])
    if tuple(row.shape) != (MODEL["max_len"], MODEL["vocab_size"]) or \
            not bool(torch.isfinite(row).all()):
        raise AssertionError("prefill logits are not finite [L, V]")
    step_ms = np.asarray(st["step_seconds"]) * 1e3
    prefill_ms = np.asarray(st["prefill_seconds"]) * 1e3
    generated = sum(len(o) for o in outs)
    log(f"[engine] decode step p50 {np.median(step_ms):.3f} ms "
        f"(p90 {np.percentile(step_ms, 90):.3f}), prefill p50 "
        f"{np.median(prefill_ms):.3f} ms over {len(prefill_ms)}, "
        f"{generated / wall:.1f} tokens/s, radix hits "
        f"{st['block_pool']['radix_hits']}")
    return launches, generated / wall, float(np.median(step_ms))


# -- phase 3b ---------------------------------------------------------------
def _mode_of(entry, resp):
    """The scheduling mode of the slot serving ``resp``, or None when no
    slot serves it (queued, or finished)."""
    for st in entry._slots:
        if st is not None and st.request.response is resp:
            return st.mode
    return None


def _leg_chunked(engine, target):
    """Leg A: long prompts through the chunk program, admitted while 4
    short prompts decode, hand-stepped one scheduler iteration at a time
    (the loop thread's body) so each iteration's chunks, steps and time
    are on record."""
    from paddle_tpu_torch import kernels

    C = CHUNK_TOKENS
    rng = np.random.RandomState(SEED + 3)
    vocab = MODEL["vocab_size"]

    def toks(n):
        return rng.randint(0, vocab, n).tolist()

    prefix = toks(SHARED_PREFIX)
    shorts = [toks(n) for n in SHORT_LENS]
    first = prefix + toks(FIRST_SHARED_TAIL)     # shares with `second`
    second = prefix + toks(SECOND_SHARED_TAIL)
    longs = [toks(n) for n in LONG_LENS]         # 960 first
    # chunks each long prompt needs: all of its positions, but `second`
    # starts past the 256 positions the radix holds from `first`
    predicted = (sum(-(-len(p) // C) for p in [first] + longs)
                 + -(-(len(second) - SHARED_PREFIX) // C))
    kernels.reset_launches()
    runs0 = target.metrics.count("chunk_runs")
    record = []                 # (decoding before, chunks, seconds)

    def iterate():
        decoding = sum(1 for st in target._slots
                       if st is not None and st.mode == "decode")
        runs = target.metrics.count("chunk_runs")
        t0 = time.perf_counter()
        if target._iterate():
            raise AssertionError("the scheduler loop asked to exit")
        record.append((decoding, target.metrics.count("chunk_runs") - runs,
                       time.perf_counter() - t0))
        if len(record) > 5000:
            raise AssertionError("leg A did not finish in 5000 iterations")

    resps = [engine.submit(p, model="target", max_new_tokens=MAX_NEW)
             for p in shorts + [first]]
    # `second` comes once `first` has landed its last chunk (its blocks are
    # then in the radix), the other long prompts with it
    while _mode_of(target, resps[-1]) != "decode" and not resps[-1].done():
        iterate()
    resps += [engine.submit(p, model="target", max_new_tokens=MAX_NEW)
              for p in [second] + longs]
    while not all(r.done() for r in resps):
        iterate()
    launches = kernels.launches("paged_attention")
    outs = [[int(t) for t in r.result(timeout=60)["tokens"]] for r in resps]
    chunks = target.metrics.count("chunk_runs") - runs0
    st = target.stats()
    if any(len(o) != MAX_NEW for o in outs) or st["completed"] != len(resps):
        raise AssertionError(f"leg A: not every request completed: {st}")
    if chunks != predicted:
        raise AssertionError(f"leg A: {chunks} chunks, the prompt lengths "
                             f"and the shared prefix predict {predicted}")
    busy = [r for r in record if r[0]]
    if any(r[1] > 1 for r in busy):
        raise AssertionError("leg A: an iteration ran more than one chunk "
                             "while a decode slot was live")
    chunked_busy = sum(1 for r in busy if r[1])
    if launches != MODEL["num_layers"] * st["steps"] or not st["steps"]:
        raise AssertionError(f"leg A: paged_attention launched {launches} "
                             f"times over {st['steps']} decode steps")
    prompts = shorts + [first, second] + longs
    verdicts = []
    for i in (len(shorts) + 2, len(shorts) + 1, len(shorts),
              len(shorts) + 3):           # 960, second, first, 129
        want = target.offline_decode(prompts[i], MAX_NEW)
        verdicts.append(check_against_offline(target, prompts[i], outs[i],
                                              want, tag="modes A"))
    chunk_ms = np.asarray(st["chunk_seconds"]) * 1e3
    prefill_ms = np.asarray(st["prefill_seconds"]) * 1e3
    step_ms = np.asarray(st["step_seconds"]) * 1e3
    gap_ms = max(r[2] for r in busy) * 1e3
    log(f"[modes A] {len(resps)} requests (prompts {sorted(map(len, prompts))}"
        f"), {len(record)} iterations, {chunks} chunks (predicted "
        f"{predicted}; {chunked_busy} beside a live decode slot, at most one "
        f"an iteration), {st['steps']} decode steps, paged_attention "
        f"launches {launches}")
    log(f"[modes A] offline_decode checks (960, shared, first, 129 tokens): "
        f"{verdicts}")
    log(f"[modes A] chunk p50 {np.median(chunk_ms):.3f} ms over "
        f"{len(chunk_ms)} (C={C}), unchunked prefill p50 "
        f"{np.median(prefill_ms):.3f} ms over {len(prefill_ms)}, decode step "
        f"p50 {np.median(step_ms):.3f} ms (p90 "
        f"{np.percentile(step_ms, 90):.3f}), longest gap between decode "
        f"steps of an in-flight request {gap_ms:.3f} ms")
    return launches


SPEC_KEYS = ("spec_target_steps", "spec_emitted_tokens", "spec_proposed_tokens",
             "spec_accepted_tokens", "spec_draft_kv_steps",
             "spec_draft_kv_fallbacks", "spec_draft_steps", "steps",
             "sampled_tokens")


def _spec_wave(engine, target, label, requests, greedy_tps=None):
    """Submit ``requests`` ([(prompt, submit options)]) together, wait for
    all, and check each against ``offline_decode``: speculative streams
    bit for bit, the others under the near-tie rule. Returns the wave's
    counter deltas, its paged_attention launches and its tokens/s."""
    import torch

    from paddle_tpu_torch import kernels

    before = target.stats()
    verify0 = len(before["verify_seconds"])
    kernels.reset_launches()
    t0 = time.perf_counter()
    resps = [engine.submit(p, model="target", max_new_tokens=MAX_NEW, **kw)
             for p, kw in requests]
    outs = [[int(t) for t in r.result(timeout=600)["tokens"]] for r in resps]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches("paged_attention")
    after = target.stats()
    d = {k: after.get(k, 0) - before.get(k, 0) for k in SPEC_KEYS}
    verify_ms = np.asarray(after["verify_seconds"][verify0:]) * 1e3
    verdicts = []
    for (p, kw), got in zip(requests, outs):
        if len(got) != MAX_NEW:
            raise AssertionError(f"{label}: {len(got)} tokens, not {MAX_NEW}")
        sampling = kw.get("sampling")
        want = target.offline_decode(p, MAX_NEW, sampling=sampling)
        if "draft_model" in kw:
            if got != want:
                raise AssertionError(
                    f"{label}: a speculative stream differs from "
                    f"offline_decode: {got} != {want}")
            verdicts.append("bit-equal")
        else:
            verdicts.append(check_against_offline(
                target, p, got, want, sampling=sampling, tag=label))
    if d["spec_draft_kv_fallbacks"]:
        raise AssertionError(f"{label}: {d['spec_draft_kv_fallbacks']} "
                             "draft-KV fallbacks")
    emitted = sum(len(o) for o in outs)
    log(f"[{label}] {len(requests)} requests in {wall:.2f}s: "
        f"{emitted / wall:.1f} tokens/s"
        + (f" (phase 3 greedy: {greedy_tps:.1f})" if greedy_tps else "")
        + f", offline_decode checks {verdicts}")
    if d["spec_emitted_tokens"]:
        log(f"[{label}] acceptance {d['spec_accepted_tokens']}/"
            f"{d['spec_proposed_tokens']}, target steps per token "
            f"{d['spec_target_steps'] / d['spec_emitted_tokens']:.4f}, "
            f"draft-KV steps per token "
            f"{d['spec_draft_kv_steps'] / d['spec_emitted_tokens']:.4f}, "
            f"replay draft forwards {d['spec_draft_steps']}, verify p50 "
            f"{np.median(verify_ms):.3f} ms over {len(verify_ms)}, target "
            f"decode steps {d['steps']}, paged_attention launches {launches}")
    return d, launches


def _steady_ladder(entry):
    """Pin ``entry``'s brownout ladder at L0. Its queue signal (queued
    rows over the drain rate the previous leg measured) takes the next
    burst to L2-L4, which serves speculative requests as plain decode and
    halves the chunk budget: output-invisible, but phases 3b and 3c check
    those routes. Phase 3d drives the ladder."""
    from paddle_tpu_torch.serving.brownout import BrownoutController

    entry._brownout = BrownoutController(enter=(1.1,) * 4, exit=(1.0,) * 4)


def _draft_entries(engine, target):
    """Draft "same": the target's geometry and weights (loaded through
    ``convert.load_params`` and checked equal); draft "small": the same
    widths at 2 layers with the weights its own startup drew."""
    import torch

    from paddle_tpu_torch.convert import load_params, persistables_to_numpy
    from paddle_tpu_torch.serving import build_decoder_model

    same = engine.register_model(build_decoder_model(**MODEL, name="same"))
    small = engine.register_model(build_decoder_model(
        **dict(MODEL, num_layers=SMALL_LAYERS), name="small"))
    arenas = {n for kv in target.model.state_names for n in kv}
    weights = {n: a for n, a in persistables_to_numpy(
        target.scope, target.model.startup_program).items()
        if n not in arenas}
    src, dst = "target_v1.", "same_v1."
    load_params(same.scope, {dst + n[len(src):]: a
                             for n, a in weights.items()})
    for n in weights:
        if not torch.equal(same.scope.find_var(dst + n[len(src):]),
                           target.scope.find_var(n)):
            raise AssertionError(f"draft 'same' does not hold {n}")
    log(f"[modes] draft 'same' holds the target's {len(weights)} weight "
        f"tensors; draft 'small' {SMALL_LAYERS} layers of its own")
    return same, small


def phase_decode_modes(greedy_tps):
    """Phase 3b: chunked prefill (leg A), speculative decoding with
    draft-KV and replay proposals (leg B) and committed-stream sampling
    (leg C) through ``GenerationEngine()`` at the decoder's full width.
    Returns the paged_attention launches of the three legs."""
    import torch

    from paddle_tpu_torch.serving import GenerationEngine, build_decoder_model
    from paddle_tpu_torch.serving.decode import SamplingParams

    t0 = time.perf_counter()
    engine = GenerationEngine(seed=SEED)          # CUDAPlace(0) by default
    target = engine.register_model(build_decoder_model(
        **MODEL, chunk_tokens=CHUNK_TOKENS, name="target"))
    _steady_ladder(target)
    same, small = _draft_entries(engine, target)
    torch.cuda.synchronize()
    log(f"[modes] place={engine.place} startup {time.perf_counter() - t0:.2f}s")
    launches = {"A": _leg_chunked(engine, target)}
    engine.start()
    rng = np.random.RandomState(SEED + 4)
    vocab = MODEL["vocab_size"]

    def prompt():
        return rng.randint(0, vocab, int(rng.randint(*SPEC_PROMPT_LEN))
                           ).tolist()

    spec = dict(draft_model="same", spec_k=SPEC_K)
    wave_same = ([(prompt(), spec) for _ in range(4)]
                 + [(prompt(), dict(spec, draft_kv=False))]
                 + [(prompt(), {}) for _ in range(2)])
    d, launches["B same"] = _spec_wave(engine, target, "modes B same",
                                       wave_same, greedy_tps)
    if d["spec_accepted_tokens"] != d["spec_proposed_tokens"]:
        raise AssertionError(
            f"modes B: draft 'same' accepted {d['spec_accepted_tokens']} of "
            f"{d['spec_proposed_tokens']} proposals, not all")
    steps_per_token = d["spec_target_steps"] / d["spec_emitted_tokens"]
    if not steps_per_token <= 0.7:
        raise AssertionError(f"modes B: {steps_per_token} target steps a "
                             "token with draft 'same' (bar 0.7)")
    if not d["spec_draft_steps"] or not d["spec_draft_kv_steps"]:
        raise AssertionError("modes B: replay or draft-KV proposals missing")
    if launches["B same"] < MODEL["num_layers"] * d["spec_draft_kv_steps"]:
        raise AssertionError("modes B: fewer paged_attention launches than "
                             "draft layers x draft-KV steps")
    wave_small = [(prompt(), dict(draft_model="small", spec_k=SPEC_K))
                  for _ in range(2)]
    d, launches["B small"] = _spec_wave(engine, target, "modes B small",
                                        wave_small)
    if launches["B small"] < SMALL_LAYERS * d["spec_draft_kv_steps"] or \
            not d["spec_draft_kv_steps"]:
        raise AssertionError("modes B: fewer paged_attention launches than "
                             "draft layers x draft-KV steps")
    sampled = [SamplingParams(**SAMPLING, seed=i) for i in range(5)]
    wave_sampled = ([(prompt(), dict(sampling=sp)) for sp in sampled[:4]]
                    + [(prompt(), dict(spec, sampling=sampled[4]))])
    d, launches["C"] = _spec_wave(engine, target, "modes C", wave_sampled)
    if d["sampled_tokens"] < 5 * MAX_NEW:
        raise AssertionError(f"modes C: {d['sampled_tokens']} sampled "
                             "tokens")
    engine.shutdown()
    for entry, name in ((target, "target"), (same, "same"), (small, "small")):
        st = entry.stats()
        if st["active_slots"] or st["spec_draft_kv_fallbacks"]:
            raise AssertionError(f"modes: {name} ends with {st}")
    if not same.stats()["draft_pinned"] or not small.stats()["draft_pinned"]:
        raise AssertionError("modes: a draft-KV draft was not pinned")
    log(f"[modes] paged_attention launches by leg {launches}")
    return sum(launches.values())


# -- phase 3c ---------------------------------------------------------------
def grammar_vocab():
    """The grammar's vocabulary, from ``SEED``: ids 0-94 the printable
    ASCII characters, ``EOS`` (95) the stop token, every other id a
    string of 2-8 of those characters. Every character a grammar needs
    can be emitted."""
    chars = [chr(c) for c in range(32, 127)]
    rng = np.random.default_rng(SEED)
    vocab = chars + ["<eos>"]
    for k in rng.integers(2, 9, MODEL["vocab_size"] - len(vocab)):
        vocab.append("".join(rng.choice(chars, int(k))))
    assert len(vocab) == MODEL["vocab_size"] and vocab[EOS] == "<eos>"
    return vocab


def walk_grammar(grammar, toks, build_ms, tag):
    """Walk ``toks`` through ``grammar`` (a freshly compiled one, so each
    state's first mask is built here and timed into ``build_ms``):
    every token allowed by its state's mask, and a stream that ends in
    EOS ends in an accepting state."""
    from paddle_tpu_torch.serving.decode.generate import GrammarConstraint

    c = GrammarConstraint(grammar)
    for i, t in enumerate(toks):
        if c.state not in build_ms:
            t0 = time.perf_counter()
            c.mask()
            build_ms[c.state] = (time.perf_counter() - t0) * 1e3
        if c.mask()[t] != 0.0:
            raise AssertionError(f"{tag}: token {t} at {i} is banned by "
                                 "the grammar")
        c.advance(t)
    if toks and toks[-1] == EOS and not c.accepting():
        raise AssertionError(f"{tag}: EOS in a non-accepting state")
    return c


def rescore(entry, prompt, toks, grammar=None):
    """A hypothesis's score by the reference's prefill forward: the
    float64 sum of its tokens' log-probs, masked as the beam's rows
    were."""
    from paddle_tpu_torch.serving.decode.generate import GrammarConstraint
    from paddle_tpu_torch.serving.decode.generate.beam import log_softmax64

    c = GrammarConstraint(grammar) if grammar is not None else None
    seq = list(prompt)
    total = 0.0
    for t in toks:
        row = entry.prefill_logits(seq)[len(seq) - 1].cpu().numpy()
        if c is not None:
            row = row + c.mask()
            c.advance(t)
        total += float(log_softmax64(row)[t])
        seq.append(t)
    return total


def check_beams(entry, prompt, out, want, grammar=None):
    """The beam bar: the ranked hypotheses equal ``offline_beam``'s; where
    they part, each of the engine's, re-scored by the prefill forward, is
    within ``BEAM_TOL`` of the reference's at the same rank. Returns
    (partings, largest gap)."""
    got = [([int(t) for t in h["tokens"]], h["score"]) for h in out["beams"]]
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} hypotheses, offline_beam "
                             f"{len(want)}")
    partings, worst = 0, 0.0
    for (toks, score), (rtoks, rscore) in zip(got, want):
        if toks == list(rtoks):
            gap = abs(score - rscore)
        else:
            partings += 1
            gap = abs(rescore(entry, prompt, toks, grammar) - rscore)
        worst = max(worst, gap)
        if gap > BEAM_TOL:
            raise AssertionError(
                f"a beam hypothesis scores {gap} away from offline_beam's "
                f"at its rank (bar {BEAM_TOL}): {toks[:8]}... against "
                f"{list(rtoks)[:8]}...")
    return partings, worst


def _leg_beam(engine, target, schema, greedy_tps):
    """Leg A: beams of width 4, hand-stepped one scheduler iteration at a
    time with block conservation checked after each. Four together (two
    groups fill the 8 slots, two wait on the row budget), then one whose
    prompt streams through the chunk program first, then one with a
    JSON-schema grammar. Each against ``offline_beam``."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving.decode import BeamParams

    rng = np.random.RandomState(SEED + 5)
    vocab = MODEL["vocab_size"]

    def toks(n):
        return rng.randint(0, vocab, n).tolist()

    prefix = toks(SHARED_PREFIX)
    first = [toks(16), toks(100), prefix + toks(20), prefix + toks(44)]
    waves = [[(p, None) for p in first], [(toks(BEAM_CHUNKED_LEN), None)],
             [(toks(40), schema)]]
    before = target.stats()
    steps0 = len(before["step_seconds"])
    rank0 = len(before["beam_rank_seconds"])
    kernels.reset_launches()
    t0 = time.perf_counter()
    results = []
    for w, wave in enumerate(waves):
        resps = [engine.submit(p, model="gen", max_new_tokens=BEAM_MAX_NEW,
                               beam_width=BEAM_WIDTH, grammar=g)
                 for p, g in wave]
        for it in range(5000):
            if all(r.done() for r in resps):
                break
            if target._iterate():
                raise AssertionError("the scheduler loop asked to exit")
            target.block_pool.check_conservation()
            if w == 0 and it == 0:
                waiting = target._queue.depth()
                if waiting != 2 * BEAM_WIDTH:
                    raise AssertionError(
                        f"beam A: {waiting} rows wait after the first "
                        f"admission round, not {2 * BEAM_WIDTH}")
        else:
            raise AssertionError("beam A did not finish in 5000 iterations")
        results += [(p, g, r.result(timeout=60)) for (p, g), r in
                    zip(wave, resps)]
    wall = time.perf_counter() - t0
    launches = kernels.launches("paged_attention")
    st = target.stats()
    d = {k: st.get(k, 0) - before.get(k, 0) for k in (
        "beam_requests", "beam_forks", "beam_prunes", "beam_finished",
        "steps", "generated_tokens", "chunk_runs")}
    d["pool_forks"] = (st["block_pool"]["forks"]
                       - before["block_pool"]["forks"])
    if d["beam_requests"] != len(results) or not d["beam_forks"]:
        raise AssertionError(f"beam A: counters {d}")
    if d["pool_forks"] != d["beam_forks"] or not d["chunk_runs"]:
        raise AssertionError(f"beam A: counters {d}")
    if st["active_slots"] or st["block_pool"]["blocks_live"]:
        raise AssertionError(f"beam A: the groups left {st['block_pool']}")
    if launches != MODEL["num_layers"] * d["steps"] or not d["steps"]:
        raise AssertionError(f"beam A: paged_attention launched {launches} "
                             f"times over {d['steps']} decode steps")
    partings, worst = 0, 0.0
    for p, g, out in results:
        # a grammar may thin a beam below its width (offline_beam too)
        if len(out["beams"]) != BEAM_WIDTH and g is None:
            raise AssertionError(f"beam A: {len(out['beams'])} hypotheses")
        if g is not None:
            for h in out["beams"]:
                walk_grammar(g, [int(t) for t in h["tokens"]], {}, "beam A")
        want = target.offline_beam(p, BEAM_MAX_NEW, BeamParams(BEAM_WIDTH),
                                   grammar=g)
        n, gap = check_beams(target, p, out, want, g)
        partings += n
        worst = max(worst, gap)
    step_ms = np.asarray(st["step_seconds"][steps0:]) * 1e3
    rank_ms = np.asarray(st["beam_rank_seconds"][rank0:]) * 1e3
    log(f"[beam A] {len(results)} requests of width {BEAM_WIDTH} (prompts "
        f"{[len(p) for p, _g, _o in results]}) in {wall:.2f}s: forks "
        f"{d['beam_forks']}, prunes {d['beam_prunes']}, finished "
        f"{d['beam_finished']}, {d['steps']} decode steps, {d['chunk_runs']}"
        f" chunks, paged_attention launches {launches}")
    log(f"[beam A] offline_beam: {partings} partings, largest score gap "
        f"{worst:.3e} (bar {BEAM_TOL})")
    log(f"[beam A] decode step p50 {np.median(step_ms):.3f} ms (p90 "
        f"{np.percentile(step_ms, 90):.3f}), rank_candidates + split p50 "
        f"{np.median(rank_ms):.3f} ms a group (p90 "
        f"{np.percentile(rank_ms, 90):.3f}, {len(rank_ms)} selections), "
        f"{d['generated_tokens'] / wall:.1f} hypothesis tokens/s (phase 3 "
        f"greedy: {greedy_tps:.1f})")
    return launches


def _leg_grammar(engine, target, schema, regex, greedy_tps, greedy_step):
    """Leg B: 3 greedy schema requests, 2 greedy regex ones, 2
    unconstrained, 1 sampled schema one and 1 speculative schema one on
    the draft "small", side by side through the loop threads."""
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving.decode import SamplingParams

    rng = np.random.RandomState(SEED + 6)
    vocab = MODEL["vocab_size"]
    sampled = SamplingParams(**SAMPLING, seed=SEED % 1000)
    kinds = ([("schema", schema, {})] * 3 + [("regex", regex, {})] * 2
             + [("free", None, {})] * 2
             + [("sampled", schema, dict(sampling=sampled)),
                ("spec", schema, dict(draft_model="small", spec_k=SPEC_K))])
    requests = [(rng.randint(0, vocab, int(rng.randint(16, 200))).tolist(),
                 kind, g, kw) for kind, g, kw in kinds]
    before = target.stats()
    steps0 = len(before["step_seconds"])
    mask0 = len(before["mask_seconds"])
    kernels.reset_launches()
    t0 = time.perf_counter()
    resps = [engine.submit(p, model="gen", max_new_tokens=BEAM_MAX_NEW,
                           grammar=g, **kw) for p, _k, g, kw in requests]
    outs = [[int(t) for t in r.result(timeout=600)["tokens"]] for r in resps]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches("paged_attention")
    st = target.stats()
    d = {k: st.get(k, 0) - before.get(k, 0) for k in (
        "steps", "grammar_steps", "spec_draft_kv_steps", "spec_target_steps")}
    if launches != (MODEL["num_layers"] * d["steps"]
                    + SMALL_LAYERS * d["spec_draft_kv_steps"]):
        raise AssertionError(f"grammar B: paged_attention launched "
                             f"{launches} times over {d}")
    constrained = sum(len(o) for o, (_p, _k, g, _kw) in zip(outs, requests)
                      if g is not None)
    if d["grammar_steps"] != constrained:
        raise AssertionError(f"grammar B: {d['grammar_steps']} grammar "
                             f"steps for {constrained} constrained tokens")
    # conformance on freshly compiled grammars: each state's first mask
    # is built (and timed) here
    fresh = {"schema": type(schema).from_json_schema(
                 GRAMMAR_SCHEMA, schema.vocab, EOS),
             "regex": type(regex).from_regex(GRAMMAR_REGEX, regex.vocab, EOS)}
    build_ms = {"schema": {}, "regex": {}}
    verdicts = []
    for (p, kind, g, kw), got in zip(requests, outs):
        tag = f"grammar B {kind}"
        if g is not None:
            key = "regex" if kind == "regex" else "schema"
            walk_grammar(fresh[key], got, build_ms[key], tag)
        want = target.offline_decode(p, BEAM_MAX_NEW,
                                     sampling=kw.get("sampling"), grammar=g)
        if kind == "spec":
            if got != want:
                raise AssertionError(f"{tag}: the speculative stream differs "
                                     f"from offline_decode: {got} != {want}")
            verdicts.append("bit-equal")
        else:
            verdicts.append(check_against_offline(
                target, p, got, want, sampling=kw.get("sampling"), tag=tag,
                grammar=g))
    texts = ["".join(schema.vocab[t] for t in o if t != EOS)
             for o, (_p, k, _g, _kw) in zip(outs, requests) if k == "schema"]
    for o, (_p, k, _g, _kw) in zip(outs, requests):
        if k == "schema" and o[-1] == EOS:
            json.loads("".join(schema.vocab[t] for t in o[:-1]))
    step_ms = np.asarray(st["step_seconds"][steps0:]) * 1e3
    mask_ms = np.asarray(st["mask_seconds"][mask0:]) * 1e3
    ms = [v for b in build_ms.values() for v in b.values()]
    log(f"[grammar B] {len(requests)} requests in {wall:.2f}s: "
        f"{sum(len(o) for o in outs) / wall:.1f} tokens/s (phase 3 greedy: "
        f"{greedy_tps:.1f}), {d['grammar_steps']} grammar steps, "
        f"offline_decode checks {verdicts}")
    log(f"[grammar B] decode step p50 with the mask feed "
        f"{np.median(step_ms):.3f} ms (p90 {np.percentile(step_ms, 90):.3f};"
        f" phase 3: {greedy_step:.3f}), {d['steps']} steps, paged_attention "
        f"launches {launches}; the feed's host time before a step p50 "
        f"{np.median(mask_ms):.3f} ms (p90 {np.percentile(mask_ms, 90):.3f},"
        f" max {mask_ms.max():.3f}; first-visit mask builds)")
    log(f"[grammar B] mask builds: {len(build_ms['schema'])} schema and "
        f"{len(build_ms['regex'])} regex states, p50 "
        f"{np.median(ms):.3f} ms a state (max {max(ms):.3f}) over "
        f"{MODEL['vocab_size']} tokens")
    log(f"[grammar B] a schema stream: {texts[0][:120]!r}")
    return launches


def phase_beam_grammar(greedy_tps, greedy_step):
    """Phase 3c: beam search (leg A) and grammar-constrained decode in
    every composition (leg B) through ``GenerationEngine()`` at the
    decoder's full width. Returns the paged_attention launches of both
    legs."""
    import torch

    from paddle_tpu_torch.serving import GenerationEngine, build_decoder_model
    from paddle_tpu_torch.serving.decode import CompiledGrammar

    t0 = time.perf_counter()
    engine = GenerationEngine(seed=SEED)          # CUDAPlace(0) by default
    target = engine.register_model(build_decoder_model(
        **MODEL, eos_id=EOS, logits_mask=True, chunk_tokens=CHUNK_TOKENS,
        name="gen"))
    _steady_ladder(target)
    small = engine.register_model(build_decoder_model(
        **dict(MODEL, num_layers=SMALL_LAYERS), name="small"))
    torch.cuda.synchronize()
    vocab = grammar_vocab()
    t1 = time.perf_counter()
    schema = CompiledGrammar.from_json_schema(GRAMMAR_SCHEMA, vocab, EOS)
    regex = CompiledGrammar.from_regex(GRAMMAR_REGEX, vocab, EOS)
    log(f"[beam] startup {t1 - t0:.2f}s; grammars compiled in "
        f"{(time.perf_counter() - t1) * 1e3:.1f} ms ({len(schema.dfa.table)}"
        f" and {len(regex.dfa.table)} DFA states over {len(vocab)} tokens)")
    launches = {"A": _leg_beam(engine, target, schema, greedy_tps)}
    engine.start()
    launches["B"] = _leg_grammar(engine, target, schema, regex, greedy_tps,
                                 greedy_step)
    engine.shutdown()
    for entry, name in ((target, "gen"), (small, "small")):
        st = entry.stats()
        if st["active_slots"] or st["spec_draft_kv_fallbacks"]:
            raise AssertionError(f"beam/grammar: {name} ends with {st}")
        entry.block_pool.check_conservation()
    log(f"[beam] paged_attention launches by leg {launches}")
    return sum(launches.values())


# -- phase 3d ---------------------------------------------------------------
def overload_prompts(vocab):
    """Phase 3d's burst: OV_REQUESTS prompts of 96-384 tokens (every
    fourth shares a 128-token prefix), from the seed."""
    rng = np.random.RandomState(SEED + 3)
    prefix = rng.randint(0, vocab, OV_SHARED).tolist()
    prompts = []
    for i in range(OV_REQUESTS):
        n = int(rng.randint(OV_PROMPT_LEN[0], OV_PROMPT_LEN[1] + 1))
        if i % 4 == 3:
            prompts.append(prefix + rng.randint(
                0, vocab, max(n - OV_SHARED, 1)).tolist())
        else:
            prompts.append(rng.randint(0, vocab, n).tolist())
    return prompts


def _ov_submit(engine, model, prompts):
    """The burst's requests, in this order: a beam of width 4, a
    speculative one on the draft "same" (draft-KV), a sampled one, then
    plain greedy ones (every prompt over 128 tokens streams through the
    chunk program)."""
    from paddle_tpu_torch.serving.decode import SamplingParams

    kinds = ["beam", "spec", "sampled"] + ["greedy"] * (len(prompts) - 3)
    resps = []
    for p, kind in zip(prompts, kinds):
        kw = dict(model=model, max_new_tokens=OV_MAX_NEW)
        if kind == "beam":
            kw["beam_width"] = BEAM_WIDTH
        elif kind == "spec":
            kw.update(draft_model="same", spec_k=SPEC_K)
        elif kind == "sampled":
            kw["sampling"] = SamplingParams(seed=SEED, **SAMPLING)
        resps.append(engine.submit(p, **kw))
    return kinds, resps


def _hand_step(entry, resps, hook=None, limit=20000):
    """Run the entry's scheduler loop body until every response is done
    (the loop thread's work, on this thread)."""
    for _ in range(limit):
        if all(r.done() for r in resps):
            return
        if hook is not None:
            hook()
        entry._iterate()
    raise AssertionError(f"{entry.model.label} did not drain")


def _ov_burst(engine, entry, prompts, timed_resume=False):
    """One burst through ``entry``: submit all at once, hand-step to
    the end. Returns (kinds, outputs, per-request latency s, wall s,
    resume ms by session)."""
    import torch

    resume_ms = []
    if timed_resume:
        orig = entry._inject_rows

        def inject(st, key):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ok = orig(st, key)
            torch.cuda.synchronize()
            resume_ms.append((time.perf_counter() - t) * 1e3)
            return ok

        entry._inject_rows = inject
    t0 = time.perf_counter()
    kinds, resps = _ov_submit(engine, entry.model.name, prompts)
    _hand_step(entry, resps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if timed_resume:
        del entry._inject_rows
    outs = [r.result(timeout=60) for r in resps]
    lat = np.asarray([r.finish_time - t0 for r in resps])
    return kinds, outs, lat, wall, resume_ms


def _ov_corruption(engine, entry, prompts):
    """Corruption leg: hand-stepped requests on the cut pool; the first
    parked session's tier entry gets a byte flipped. The CRC quarantines
    it, its rows are recomputed from the committed tokens by the prefill
    program, and the other resumes come back bit-exact. After every
    resume K3 is held against its plain version over the rows that came
    back, in every layer. Returns (the corrupted request's prompt,
    tokens), rows that differ and their largest difference, the intact
    resumes checked, and K3's largest error."""
    import torch

    from paddle_tpu_torch.kernels import attention as A

    m = entry.model
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state = {"key": None, "spilled": None, "diff": None, "intact": 0,
             "k3": 0.0}

    def k3_check(st):
        rows = torch.from_numpy(np.tile(st.row_map, m.slots)).cuda()
        bias = torch.full((m.slots, 1, m.max_len), NEG_INF, device="cuda")
        bias[:, 0, :st.cursor] = 0.0
        q = torch.randn(m.slots, m.hidden, generator=gen, device="cuda")
        for kn, vn in m.state_names:
            k, v = entry.scope.find_var(kn), entry.scope.find_var(vn)
            args = (q, k, v, rows, bias, m.slots, m.max_len,
                    m.hidden ** -0.5)
            err = float((A.paged_attention(*args)
                         - A.paged_attention_composite(*args)).abs().max())
            state["k3"] = max(state["k3"], err)
        if not state["k3"] <= PARITY_ATOL:
            raise AssertionError(f"K3 over resumed rows: {state['k3']}")

    orig = entry._inject_rows

    def inject(st, key):
        ent = entry._tier._entries.get(key)
        spilled = (None if ent is None or key == state["key"]
                   else [(k.copy(), v.copy()) for k, v in ent.kv_rows])
        ok = orig(st, key)
        k3_check(st)
        back = entry._read_rows(st.row_map, st.cursor)
        if key == state["key"]:
            ref = state["spilled"]
            diff = [np.abs(a - b) for (k, v), (k2, v2) in zip(ref, back)
                    for a, b in ((k, k2), (v, v2))]
            state["diff"] = (sum(int((d.max(axis=1) > 0).sum())
                                 for d in diff),
                             max(float(d.max()) for d in diff))
        elif spilled is not None:
            for (k, v), (k2, v2) in zip(spilled, back):
                if not (np.array_equal(k.view(np.uint32), k2.view(np.uint32))
                        and np.array_equal(v.view(np.uint32),
                                           v2.view(np.uint32))):
                    raise AssertionError(
                        f"corruption leg: intact entry {key} came back "
                        "with other bits")
            state["intact"] += 1
        return ok

    def corrupt():
        if state["key"] is None and entry._parked:
            ps = entry._parked[0]
            if ps.mode == "decode":
                key = ps.keys[0]
                state["spilled"] = [(k.copy(), v.copy()) for k, v in
                                    entry._tier._entries[key].kv_rows]
                state["key"] = key
                state["req"] = ps.request
                entry._tier.corrupt_entry(key)

    entry._inject_rows = inject
    before = entry.stats()
    resps = [engine.submit(p, model=entry.model.name,
                           max_new_tokens=OV_CORRUPT_NEW) for p in prompts]
    try:
        _hand_step(entry, resps, hook=corrupt)
    finally:
        del entry._inject_rows
    torch.cuda.synchronize()
    after = entry.stats()
    replays = after["resume_replays"] - before["resume_replays"]
    dropped = (after["host_tier"]["corrupt_dropped"]
               - before["host_tier"]["corrupt_dropped"])
    if state["key"] is None or replays != 1 or dropped != 1:
        raise AssertionError(f"corruption leg: key {state['key']}, "
                             f"{replays} replays, {dropped} quarantined")
    req = state["req"]
    out = [int(t) for t in req.response.result(timeout=60)["tokens"]]
    return (req.prompt, out), state["diff"], state["intact"], state["k3"]


def _ov_tenants(engine, entry):
    """Tenant leg: tenants "gold" (weight 3) and "free" (weight 1), 8
    requests each queued behind a full engine; the dispatch order."""
    engine.set_tenant("gold", weight=3.0)
    engine.set_tenant("free", weight=1.0)
    rng = np.random.RandomState(SEED + 4)
    order = []
    orig = engine._pick

    def spy(queue, **kw):
        req = orig(queue, **kw)
        if req is not None:
            order.append(req.tenant)
        return req

    engine._pick = spy
    try:
        resps = [engine.submit(rng.randint(0, MODEL["vocab_size"],
                                           32).tolist(),
                               model=entry.model.name, max_new_tokens=8,
                               tenant="gold" if i % 2 == 0 else "free")
                 for i in range(16)]
        _hand_step(entry, resps)
    finally:
        del engine._pick
    for r in resps:
        r.result(timeout=60)
    return order


def _ov_breaker(engine, entry):
    """Breaker leg: a request's tokens; then ``decode.step`` fails
    ``breaker_threshold`` times (each failing its request loudly), the
    breaker opens, and after its cooldown it half-opens, relaunches once
    and the same request gives the same tokens."""
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving.request import ReplicaLostError

    prompt = list(range(100, 100 + 64))
    first = engine.submit(prompt, model=entry.model.name, max_new_tokens=16)
    _hand_step(entry, [first])
    want = [int(t) for t in first.result(timeout=60)["tokens"]]
    before = entry.stats()
    faults.configure([{"site": "decode.step", "action": "raise",
                       "times": OV_BREAKER}])
    try:
        for i in range(OV_BREAKER):
            r = engine.submit([7 + i] * 40, model=entry.model.name,
                              max_new_tokens=4)
            _hand_step(entry, [r])
            if not isinstance(r.error(), ReplicaLostError):
                raise AssertionError(f"breaker leg: fault {i} gave "
                                     f"{r.error()!r}")
    finally:
        faults.reset()
    if entry.stats()["breaker_state"] != "open":
        raise AssertionError("breaker leg: the breaker did not open")
    t0 = time.perf_counter()
    again = engine.submit(prompt, model=entry.model.name, max_new_tokens=16)
    _hand_step(entry, [again])
    got = [int(t) for t in again.result(timeout=60)["tokens"]]
    after = entry.stats()
    d = {k: after[k] - before[k] for k in (
        "breaker_opened", "breaker_probes", "breaker_closed", "relaunches",
        "step_failures")}
    if d != {"breaker_opened": 1, "breaker_probes": 1, "breaker_closed": 1,
             "relaunches": 1, "step_failures": OV_BREAKER}:
        raise AssertionError(f"breaker leg: {d}")
    if got != want or after["breaker_state"] != "closed":
        raise AssertionError(f"breaker leg: after the relaunch {got[:8]}, "
                             f"before the fault {want[:8]}")
    return d, time.perf_counter() - t0


def _pcts(ms):
    ms = np.asarray(ms, dtype=np.float64)
    if not ms.size:
        return "none"
    return (f"p50 {np.median(ms):.3f} ms, max {ms.max():.3f} ms over "
            f"{ms.size}")


def phase_overload(greedy_tps):
    """Phase 3d: the engine under overload at the decoder's full width.
    Returns the paged_attention launches of the burst on the cut pool."""
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.convert import load_params, persistables_to_numpy
    from paddle_tpu_torch.serving import GenerationEngine, build_decoder_model
    from paddle_tpu_torch.serving.decode import BeamParams, SamplingParams

    t_phase = time.perf_counter()
    engine = GenerationEngine(seed=SEED, host_tier_mb=OV_TIER_MB,
                              breaker_threshold=OV_BREAKER,
                              breaker_cooldown_s=OV_COOLDOWN_S)
    geom = dict(MODEL, chunk_tokens=CHUNK_TOKENS)
    cut = engine.register_model(build_decoder_model(
        **geom, num_blocks=OV_BLOCKS, name="cut"))
    uncut = engine.register_model(build_decoder_model(
        **geom, num_blocks=OV_UNCUT_BLOCKS, name="uncut"))
    same = engine.register_model(build_decoder_model(**MODEL, name="same"))
    arenas = {n for kv in cut.model.state_names for n in kv}
    weights = {n: a for n, a in persistables_to_numpy(
        cut.scope, cut.model.startup_program).items() if n not in arenas}
    for entry in (uncut, same):
        dst = entry.model.name + "_v1."
        load_params(entry.scope, {dst + n[len("cut_v1."):]: a
                                  for n, a in weights.items()})
    torch.cuda.synchronize()
    prompts = overload_prompts(MODEL["vocab_size"])
    per_token = MODEL["num_layers"] * 2 * MODEL["hidden"] * 4

    def blocks(p):
        return (len(p) + OV_MAX_NEW + BLOCK - 1) // BLOCK

    # the first 8 slots: the beam's 4 hypotheses, the speculative request
    # (no target blocks) and the next three
    demand = BEAM_WIDTH * blocks(prompts[0]) + sum(
        blocks(p) for p in prompts[2:5])
    log(f"[overload] pool {OV_BLOCKS} blocks ({OV_BLOCKS * BLOCK} rows, "
        f"arena {cut.model.arena_bytes() / 1e6:.1f} MB), uncut "
        f"{OV_UNCUT_BLOCKS}; {per_token} KV bytes a token; the first 8 "
        f"slots need up to {demand} blocks, the {OV_REQUESTS} requests "
        f"{sum(blocks(p) for p in prompts) + 3 * blocks(prompts[0])}; "
        f"prompts {min(map(len, prompts))}-{max(map(len, prompts))} "
        f"tokens; startup {time.perf_counter() - t_phase:.2f}s")

    # the same burst on the uncut pool, then on the cut one (counted)
    _k, uouts, ulat, uwall, _r = _ov_burst(engine, uncut, prompts)
    ust = uncut.stats()
    before = cut.stats()
    kernels.reset_launches()
    kinds, outs, lat, wall, resume_ms = _ov_burst(engine, cut, prompts,
                                                  timed_resume=True)
    launches = kernels.launches()
    st = cut.stats()
    d = {k: st[k] - before[k] for k in (
        "sessions_parked", "sessions_resumed", "resume_replays",
        "tier_hits", "failed", "completed", "decode_steps",
        "admissions_deferred", "blocks_parked_total", "spec_emitted_tokens",
        "beam_requests", "chunk_runs", "sampled_tokens")}
    d["tier_writebacks"] = (st["block_pool"]["tier_writebacks"]
                            - before["block_pool"]["tier_writebacks"])
    log(f"[overload] cut pool: {d}; uncut pool: parked "
        f"{ust['sessions_parked']}, failed {ust['failed']}")
    if not (d["sessions_parked"] == d["sessions_resumed"] >= 1
            and d["failed"] == 0 and d["completed"] == OV_REQUESTS
            and d["resume_replays"] == 0 and ust["failed"] == 0
            and d["spec_emitted_tokens"] and d["beam_requests"] == 1
            and d["chunk_runs"] and d["sampled_tokens"]):
        raise AssertionError(f"overload: {d}")
    cut.block_pool.check_conservation()
    pool = cut.block_pool.stats()
    if pool["blocks_live"] or st["active_slots"] or st["parked_sessions"]:
        raise AssertionError(f"overload: the pool ends with {pool}")
    k3 = launches["paged_attention"]
    if k3 < MODEL["num_layers"] * d["decode_steps"] or not d["decode_steps"]:
        raise AssertionError(f"overload: paged_attention launched {k3} "
                             f"times over {d['decode_steps']} steps")
    log(f"[overload] paged_attention launches {k3} ({MODEL['num_layers']} a "
        f"step over {d['decode_steps']} target steps, and the draft's "
        f"draft-KV steps)")

    # every stream: bit-equal to the uncut pool's where the rows came back
    # byte for byte, and held against the offline reference
    def same(a, b):
        hyps = [(h["tokens"].tolist(), h["score"])
                for o in (a, b) for h in o.get("beams", ())]
        return (a["tokens"].tolist() == b["tokens"].tolist()
                and hyps[:len(hyps) // 2] == hyps[len(hyps) // 2:])

    equal = [same(a, b) for a, b in zip(outs, uouts)]
    log(f"[overload] streams bit-equal to the uncut pool's: "
        f"{sum(equal)}/{len(equal)}")
    verdicts = {}
    t_off = time.perf_counter()
    for i, (p, kind, out) in enumerate(zip(prompts, kinds, outs)):
        toks = [int(t) for t in out["tokens"]]
        if kind == "beam":
            want = cut.offline_beam(p, OV_MAX_NEW, BeamParams(BEAM_WIDTH))
            verdicts[i] = check_beams(cut, p, out, want)
            continue
        sp = SamplingParams(seed=SEED, **SAMPLING) if kind == "sampled" \
            else None
        want = cut.offline_decode(p, OV_MAX_NEW, sampling=sp)
        verdicts[i] = check_against_offline(cut, p, toks, want, sampling=sp,
                                            tag=f"overload {kind} {i}")
    if not equal[kinds.index("sampled")]:
        raise AssertionError("overload: the sampled stream differs from "
                             "the uncut pool's")
    log(f"[overload] offline checks ({time.perf_counter() - t_off:.1f}s): "
        f"{verdicts}")

    # times
    sp_ms = np.asarray(st["spill_seconds"][len(before["spill_seconds"]):]) \
        * 1e3
    sp_b = np.asarray(st["spill_bytes"][len(before["spill_bytes"]):])
    rs_b = np.asarray(st["resume_bytes"][len(before["resume_bytes"]):])
    gen = sum(len(o["tokens"]) for o in outs)
    ugen = sum(len(o["tokens"]) for o in uouts)
    log(f"[overload] spill a park (a session, or a beam group's "
        f"hypotheses: gather, one copy to pinned memory, CRC): "
        f"{_pcts(sp_ms)}, {sp_b.sum() / sp_ms.size / 1e6:.2f} MB a park on "
        f"average (largest row run {sp_b.max() / 1e6:.2f} MB), "
        f"{sp_b.sum() / sp_ms.sum() / 1e6:.3f} GB/s")
    log(f"[overload] resume a row run (a session, or one beam hypothesis: "
        f"CRC, one upload, the inject program, synchronised): "
        f"{_pcts(resume_ms)}, {rs_b.mean() / 1e6:.2f} MB a run on average, "
        f"{rs_b.sum() / sum(resume_ms) / 1e6:.3f} GB/s")
    log(f"[overload] latency of the {OV_REQUESTS}: cut pool p50 "
        f"{np.median(lat):.3f} s p99 {np.percentile(lat, 99):.3f} s; uncut "
        f"p50 {np.median(ulat):.3f} s p99 {np.percentile(ulat, 99):.3f} s "
        f"(engine histogram, cut: p50 {st['latency_p50_s']:.3f} p99 "
        f"{st['latency_p99_s']:.3f})")
    log(f"[overload] tokens/s cut {gen / wall:.1f} ({wall:.2f}s), uncut "
        f"{ugen / uwall:.1f} ({uwall:.2f}s), phase 3 {greedy_tps:.1f}; "
        f"decode step p50 "
        f"{np.median(st['step_seconds'][len(before['step_seconds']):]) * 1e3:.3f}"
        f" ms")
    log(f"[overload] brownout transitions "
        f"{[(t['from'], t['to'], t['trigger'], t['value']) for t in st['brownout']['transitions']]}"
        f"; host tier {st['host_tier']}")

    # the legs
    rng = np.random.RandomState(SEED + 5)
    cprompts = [rng.randint(0, MODEL["vocab_size"], OV_CORRUPT_LEN).tolist()
                for _ in range(5)]
    t_leg = time.perf_counter()
    (cp, ctoks), diff, intact, k3_err = _ov_corruption(engine, cut, cprompts)
    verdict = check_against_offline(cut, cp, ctoks,
                                    cut.offline_decode(cp, OV_CORRUPT_NEW),
                                    tag="overload corruption")
    log(f"[overload] corruption: quarantined, recomputed rows differ from "
        f"the spilled ones in {diff[0]} of {len(cp) + OV_CORRUPT_NEW} x "
        f"{2 * MODEL['num_layers']} rows by at most {diff[1]:.3e}; "
        f"{intact} intact resumes bit-exact; tokens {verdict}; K3 over "
        f"every resumed slot's rows within {k3_err:.3e} of its plain "
        f"version (atol {PARITY_ATOL}); {time.perf_counter() - t_leg:.1f}s")
    order = _ov_tenants(engine, uncut)
    first = order[:8]
    log(f"[overload] tenants 3:1: first 8 dispatches gold "
        f"{first.count('gold')} free {first.count('free')}; all 16 "
        f"{''.join(t[0] for t in order)}")
    if first.count("gold") != 6:
        raise AssertionError(f"tenant leg: {order}")
    bd, bsec = _ov_breaker(engine, cut)
    log(f"[overload] breaker: {bd}, the relaunch and the request after it "
        f"{bsec:.2f}s")
    engine.shutdown()
    log(f"[overload] phase {time.perf_counter() - t_phase:.1f}s")
    return k3


# -- phase 4 ----------------------------------------------------------------
def phase_dense():
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        q = fluid.data("q", [S, H], dtype="float32")
        kc = fluid.data("kc", [S, L, H], dtype="float32")
        vc = fluid.data("vc", [S, L, H], dtype="float32")
        bias = fluid.data("bias", [S, 1, L], dtype="float32")
        out = fluid.layers.cached_attention(q, kc, vc, bias,
                                            sm_scale=1.0 / np.sqrt(H),
                                            fused=True)
    exe = fluid.Executor()                        # CUDAPlace(0) by default
    dev = exe.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    feeds = {
        "q": torch.randn(S, H, generator=gen, device=dev),
        "kc": torch.randn(S, L, H, generator=gen, device=dev),
        "vc": torch.randn(S, L, H, generator=gen, device=dev),
        "bias": torch.zeros(S, 1, L, device=dev),
    }
    kernels.reset_launches()
    for _ in range(LAYERS):
        res = exe.run(main, feed=feeds, fetch_list=[out])[0]
    torch.cuda.synchronize()
    launches = kernels.launches()
    if res.shape != (S, H) or not np.isfinite(res).all():
        raise AssertionError("dense path output is not finite [S, H]")
    log(f"[dense] launches {launches}")
    if launches["decode_attention"] < LAYERS:
        raise AssertionError("decode_attention was not launched")
    return launches


# -- phase 5 ----------------------------------------------------------------
def _train_steps(exe, main, scope, batch, loss, grads, steps):
    """``steps`` steps on ``batch``: the losses, the first step's grads (on
    the card), each step's host time, which ends in the loss's copy to the
    host, and the whole training state after OFF_STEPS steps."""
    import torch

    from paddle_tpu_torch.convert import persistables_to_numpy

    losses, first_grads, seconds, state = [], None, [], None
    for step in range(steps):
        t0 = time.perf_counter()
        out = exe.run(main, feed=batch, fetch_list=[loss] + (grads if step == 0
                                                             else []),
                      scope=scope, return_numpy=False)
        losses.append(float(out[0].reshape(-1)[0]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if step == 0:
            first_grads = out[1:]
        if step + 1 == OFF_STEPS:
            state = persistables_to_numpy(scope, main)
    return losses, first_grads, seconds, state


def phase_train():
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.convert import load_params, persistables_to_numpy
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base()
    cfg.use_flash_attention = True
    cfg.hidden_dropout_prob = TRAIN_DROPOUT     # the JAX bench recipe
    cfg.attention_probs_dropout_prob = 0.0      # the flash path refuses it
    main, startup, _, fetches = bert.build_bert_pretrain(
        cfg, seq_len=TRAIN_SEQ, lr=TRAIN_LR, max_predictions_per_seq=TRAIN_P)
    startup.random_seed = main.random_seed = SEED
    loss = fetches[0]
    params = main.all_parameters()
    grads = [p.name + "@GRAD" for p in params]
    n_params = sum(int(np.prod(p.shape)) for p in params)
    sites = sum(op.type == "dropout" for op in main.global_block().ops)
    batch = bert.synthetic_batch(np.random.RandomState(SEED), TRAIN_BATCH,
                                 TRAIN_SEQ, cfg, TRAIN_P)
    exe = fluid.Executor()                        # CUDAPlace(0) by default
    scope = fluid.Scope()
    t0 = time.perf_counter()
    # the startup is the path's first run: its truncated normals draw
    # their bits through K8's random_bits
    kernels.reset_launches()
    exe.run(startup, scope=scope)
    load_params(scope, {COUNTER: np.full([1], WARMED_UP, np.float32)})
    torch.cuda.synchronize()
    snapshot = persistables_to_numpy(scope, main)
    log(f"[train] place={exe.place} {len(main.global_block().ops)} ops, "
        f"{len(params)} parameters ({n_params} values), startup "
        f"{time.perf_counter() - t0:.2f}s")

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()          # weights, Adam state, ...
    with _MaskTap() as tap_on:
        losses, grads_on, seconds, state_on = _train_steps(
            exe, main, scope, batch, loss, grads, TRAIN_STEPS)
    launches = kernels.launches()
    peak = torch.cuda.max_memory_allocated()
    per_step = {n: launches[n] / TRAIN_STEPS for n in
                ("flash_attention_fwd", "flash_attention_bwd_dkdv",
                 "flash_attention_bwd_dq")}
    log(f"[train] losses {losses}, launches {launches}")
    layers = cfg.num_hidden_layers
    if (launches["threefry_dropout"] != sites * TRAIN_STEPS
            or not launches["threefry_random_bits"]):
        raise AssertionError(f"K8 launches {launches}: want "
                             f"{sites} dropout sites x {TRAIN_STEPS} steps "
                             "and the startup's random_bits")
    if (launches["flash_attention_fwd"] < 2 * layers * TRAIN_STEPS
            or launches["flash_attention_bwd_dkdv"] < layers * TRAIN_STEPS
            or launches["flash_attention_bwd_dq"] < layers * TRAIN_STEPS):
        raise AssertionError(f"flash kernels under-launched over {TRAIN_STEPS} "
                             f"steps of {layers} layers: {launches}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    changed = {p.name: not torch.equal(scope.find_var(p.name).cpu(),
                                       torch.from_numpy(snapshot[p.name]))
               for p in params}
    still = [p.name for p in params if len(p.shape) == 2 and not changed[p.name]]
    if still:
        raise AssertionError(f"weight matrices unchanged by training: {still}")
    step_ms = float(np.median(seconds[1:])) * 1e3
    log(f"[train] step p50 {step_ms:.2f} ms (first {seconds[0] * 1e3:.2f} ms, "
        f"all {[round(x * 1e3, 2) for x in seconds]}), "
        f"{TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.1f} tokens/s, device "
        f"memory peak {peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB held "
        f"before the steps), {sum(changed.values())} of "
        f"{len(params)} "
        f"parameters changed, launches per step {per_step}")

    # a fresh executor: its run counter, and so its keys, repeat the first
    # run's (startup, then the steps)
    off_exe, off_scope = fluid.Executor(), fluid.Scope()
    with kernels.scoped_mode("off"):
        kernels.reset_launches()
        off_exe.run(startup, scope=off_scope)
        load_params(off_scope, snapshot)
        with _MaskTap() as tap_off:
            off_losses, grads_off, off_seconds, state_off = _train_steps(
                off_exe, main, off_scope, batch, loss, grads, OFF_STEPS)
        if any(kernels.launches().values()):
            raise AssertionError("a kernel launched with the kernels off")
    masks_equal = tap_on.digests[:len(tap_off.digests)] == tap_off.digests
    if not masks_equal or len(tap_off.digests) != sites * OFF_STEPS:
        raise AssertionError(f"dropout masks differ between kernels on and "
                             f"off ({len(tap_off.digests)} masks off)")
    rtol, atol = TRAIN_LOSS_TOL
    loss_err = max(abs(a - b) for a, b in zip(losses, off_losses))
    if not all(abs(a - b) <= atol + rtol * abs(b)
               for a, b in zip(losses, off_losses)):
        raise AssertionError(f"loss streams disagree, kernels on {losses[:OFF_STEPS]}"
                             f" off {off_losses}")
    worst = 0.0
    rel, floor = TRAIN_GRAD_TOL
    floor *= max(float(g.abs().max()) for g in grads_off)
    for name, g_on, g_off in zip(grads, grads_on, grads_off):
        scale = float(g_off.abs().max())
        err = float((g_on - g_off).abs().max())
        if not err <= rel * scale + floor:
            raise AssertionError(f"{name}: kernels on/off differ by {err:.3e} "
                                 f"(largest value {scale:.3e})")
        worst = max(worst, err / (rel * scale + floor))
    noise = {p.name for p, g in zip(params, grads_off)
             if float(g.abs().max()) <= floor}
    worst_state = _compare_states(state_on, state_off, snapshot,
                                  {p.name for p in params}, noise)
    log(f"[train] dropout: {sites} sites at p={TRAIN_DROPOUT}, "
        f"{len(tap_off.digests)} masks of {OFF_STEPS} steps bit-equal "
        f"between kernels on and off, kept share {tap_on.kept:.5f}")
    log(f"[train] kernels off: losses {off_losses} (max diff {loss_err:.3e}), "
        f"step p50 {float(np.median(off_seconds[1:])) * 1e3:.2f} ms; "
        f"{len(grads)} grads agree, worst error {worst:.3e} of its bar; "
        f"{len(state_off)} persistables after {OFF_STEPS} steps agree, worst "
        f"{worst_state:.3e} of its bar ({len(noise)} parameters with grads "
        f"of rounding noise left out: {sorted(noise)})")
    del scope, off_scope, grads_on, grads_off
    nodrop_ms, nodrop_peak = _bert_nodropout_steps(fluid, bert, batch)
    log(f"[train] the same steps without dropout, same call: step p50 "
        f"{nodrop_ms:.2f} ms against {step_ms:.2f} with it "
        f"({step_ms / nodrop_ms:.4f}x); device memory peak "
        f"{nodrop_peak / 2**30:.3f} GiB against {peak / 2**30:.3f}")
    return launches


def _bert_nodropout_steps(fluid, bert, batch):
    """Step p50 (ms) and device memory peak of phase 5's BERT-base without
    dropout: 4 steps (the p50 of the last 3), on the same host clock as
    the steps with it."""
    import torch

    from paddle_tpu_torch.convert import load_params

    cfg = bert.BertConfig.base()
    cfg.use_flash_attention = True
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    main, startup, _, fetches = bert.build_bert_pretrain(
        cfg, seq_len=TRAIN_SEQ, lr=TRAIN_LR, max_predictions_per_seq=TRAIN_P)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    load_params(scope, {COUNTER: np.full([1], WARMED_UP, np.float32)})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        exe.run(main, feed=batch, fetch_list=[fetches[0]], scope=scope)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return (float(np.median(seconds[1:])) * 1e3,
            torch.cuda.max_memory_allocated())


class _MaskTap:
    """Within the block, a fingerprint of every ``Mask`` the dropout op
    returns (in order), the kept count and the types of its input ``X``
    (``dtypes``): the op def's kernel lowering is
    wrapped, so the executor's plan calls the wrapper. Both stay on the
    card until read (no sync in the steps): the fingerprint is the int64
    sum of the mask's 0/1 values times fixed random int32 weights (the
    same weights for every run of a size), so equal masks give equal
    fingerprints and a differing mask differs with near certainty."""

    _weights = {}

    def __enter__(self):
        from paddle_tpu_torch.core.registry import get_op_def

        self._op = get_op_def("dropout")
        self._inner = self._op.kernel
        self._prints, self._kept, self._n = [], [], 0
        self.dtypes = set()       # the types of X that reach the op

        def tapped(ins, attrs):
            import torch

            self.dtypes.add(str(ins["X"][0].dtype).replace("torch.", ""))
            outs = self._inner(ins, attrs)
            m = outs["Mask"][0].reshape(-1)
            w = self._weights.get((m.numel(), m.device))
            if w is None:
                gen = torch.Generator(device=m.device).manual_seed(SEED + 9)
                w = self._weights[(m.numel(), m.device)] = torch.randint(
                    -2 ** 31, 2 ** 31 - 1, (m.numel(),), generator=gen,
                    dtype=torch.int32, device=m.device)
            self._prints.append((m.to(torch.int64) * w).sum())
            self._kept.append(m.sum(dtype=torch.float64))
            self._n += m.numel()
            return outs

        self._op.kernel = tapped
        return self

    def __exit__(self, *exc):
        self._op.kernel = self._inner
        return False

    @property
    def digests(self):
        return [int(t) for t in self._prints]

    @property
    def kept(self):
        return sum(float(t) for t in self._kept) / max(self._n, 1)


def phase_bert_unfused():
    """Phase 5b: the JAX package's default BERT-base (unfused attention,
    hidden and attention-prob dropout at 0.1), K8 on against off."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.convert import load_params, persistables_to_numpy
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base()                # unfused, dropouts 0.1
    main, startup, _, fetches = bert.build_bert_pretrain(
        cfg, seq_len=TRAIN_SEQ, lr=TRAIN_LR, max_predictions_per_seq=TRAIN_P)
    startup.random_seed = main.random_seed = SEED
    loss = fetches[0]
    sites = sum(op.type == "dropout" for op in main.global_block().ops)
    batch = bert.synthetic_batch(np.random.RandomState(SEED + 1),
                                 TRAIN_BATCH, TRAIN_SEQ, cfg, TRAIN_P)

    def run(mode, steps):
        exe, scope = fluid.Executor(), fluid.Scope()
        with kernels.scoped_mode(mode):
            exe.run(startup, scope=scope)
            load_params(scope, {COUNTER: np.full([1], WARMED_UP, np.float32)})
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            with _MaskTap() as tap:
                losses, _, seconds, _ = _train_steps(
                    exe, main, scope, batch, loss, [], steps)
            launches = kernels.launches()
        peak = torch.cuda.max_memory_allocated()
        del scope
        return losses, seconds, launches, tap, peak

    t0 = time.perf_counter()
    on = run("auto", UNFUSED_STEPS)
    off = run("off", OFF_STEPS)
    losses, seconds, launches, tap_on, peak = on
    off_losses, off_seconds, off_launches, tap_off, _ = off
    rtol, atol = TRAIN_LOSS_TOL
    checks = {
        "K8 dropout launches": launches["threefry_dropout"]
        == sites * UNFUSED_STEPS,
        "no launch off": not any(off_launches.values()),
        "masks bit-equal on/off": tap_on.digests[:len(tap_off.digests)]
        == tap_off.digests and len(tap_off.digests) == sites * OFF_STEPS,
        "losses within the bars": all(abs(a - b) <= atol + rtol * abs(b)
                                      for a, b in zip(losses, off_losses)),
        "loss finite": bool(np.isfinite(losses).all()),
    }
    step_ms = float(np.median(seconds[1:])) * 1e3
    log(f"[train-unfused] BERT-base, unfused attention, hidden and "
        f"attention-prob dropout {cfg.hidden_dropout_prob}/"
        f"{cfg.attention_probs_dropout_prob}: {len(main.global_block().ops)} "
        f"ops, {sites} dropout sites; losses {losses}, kernels off "
        f"{off_losses}; step p50 {step_ms:.2f} ms (all "
        f"{[round(x * 1e3, 2) for x in seconds]}), "
        f"{TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.1f} tokens/s, device "
        f"memory peak {peak / 2**30:.3f} GiB, kept share {tap_on.kept:.5f}; "
        f"K8 launches {launches['threefry_dropout']}; "
        f"{time.perf_counter() - t0:.1f}s")
    log(f"[train-unfused] checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"phase 5b failed: {checks}")
    return launches


def phase_train_amp():
    """Phase 5c: BERT-base trained under bf16 AMP as the JAX bench runs it
    (``bench.py:106-133``: flash, hidden dropout 0.1, seq 128, P = 20, Adam
    with the warm-up schedule, batch 32, ``use_amp`` on), kernels on
    against off; then float16 with dynamic loss scaling."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, kernels
    from paddle_tpu_torch.convert import load_params, persistables_to_numpy
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.utils import unique_name

    cfg = bert.BertConfig.base()
    cfg.use_flash_attention = True
    cfg.hidden_dropout_prob = TRAIN_DROPOUT
    cfg.attention_probs_dropout_prob = 0.0
    layers = cfg.num_hidden_layers

    def build(f16=False):
        """The bench recipe's program (``use_amp=True``: bf16, no loss
        scaling), or the same network and Adam decorated for float16 with
        dynamic loss scaling from AMP_F16_SCALE."""
        with unique_name.guard():
            if not f16:
                main, startup, _, (loss, *_) = bert.build_bert_pretrain(
                    cfg, seq_len=TRAIN_SEQ, lr=TRAIN_LR, use_amp=True,
                    max_predictions_per_seq=TRAIN_P)
            else:
                main, startup = fluid.Program(), fluid.Program()
                with fluid.program_guard(main, startup):
                    _, (loss, *_) = bert.bert_pretrain_net(cfg, TRAIN_SEQ,
                                                           TRAIN_P)
                    scheduler = fluid.layers.learning_rate_scheduler \
                        .linear_lr_warmup(TRAIN_LR, warmup_steps=10000,
                                          start_lr=0.0, end_lr=TRAIN_LR)
                    amp.decorate(fluid.optimizer.Adam(learning_rate=scheduler),
                                 dest_dtype="float16",
                                 use_dynamic_loss_scaling=True,
                                 init_loss_scaling=AMP_F16_SCALE
                                 ).minimize(loss)
        startup.random_seed = main.random_seed = SEED
        return main, startup, loss

    def start(exe, scope, startup, state=None):
        exe.run(startup, scope=scope)
        load_params(scope, state or {COUNTER: np.full([1], WARMED_UP,
                                                      np.float32)})
        torch.cuda.synchronize()

    main, startup, loss = build()
    ops = [op.type for op in main.global_block().ops]
    sites = ops.count("dropout")
    batch = bert.synthetic_batch(np.random.RandomState(SEED), TRAIN_BATCH,
                                 TRAIN_SEQ, cfg, TRAIN_P)
    exe, scope = fluid.Executor(), fluid.Scope()
    t0 = time.perf_counter()
    kernels.reset_launches()
    start(exe, scope, startup)
    snapshot = persistables_to_numpy(scope, main)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with _MaskTap() as tap_on:
        losses, _, seconds, _ = _train_steps(exe, main, scope, batch, loss, [],
                                             AMP_TRAIN_STEPS)
    launches = kernels.launches()
    peak = torch.cuda.max_memory_allocated()
    syncs = _sync_warnings(lambda: exe.run(main, feed=batch, fetch_list=[loss],
                                           scope=scope, return_numpy=False))
    torch.cuda.synchronize()
    _profiled_steps("[train-amp] 5c", AMP_PROFILED, lambda: float(exe.run(
        main, feed=batch, fetch_list=[loss], scope=scope)[0][0]))
    del scope

    off_exe, off_scope = fluid.Executor(), fluid.Scope()
    with kernels.scoped_mode("off"):
        kernels.reset_launches()
        start(off_exe, off_scope, startup, snapshot)
        with _MaskTap() as tap_off:
            off_losses, _, off_seconds, _ = _train_steps(
                off_exe, main, off_scope, batch, loss, [], OFF_STEPS)
        off_launches = kernels.launches()
    del off_scope

    # float16 with dynamic loss scaling: the scale and its counters are
    # persistables of the step, on the card
    f16_main, f16_startup, f16_loss = build(f16=True)
    f16_exe, f16_scope = fluid.Executor(), fluid.Scope()
    kernels.reset_launches()
    start(f16_exe, f16_scope, f16_startup)
    f16_losses, _, f16_seconds, _ = _train_steps(
        f16_exe, f16_main, f16_scope, batch, f16_loss, [], AMP_F16_STEPS)
    f16_launches = kernels.launches()
    f16_syncs = _sync_warnings(lambda: f16_exe.run(
        f16_main, feed=batch, fetch_list=[f16_loss], scope=f16_scope,
        return_numpy=False))
    scaling = {n: float(f16_scope.find_var(n).reshape(-1)[0])
               for n in ("loss_scaling_0", "loss_scaling_good_steps_0",
                         "loss_scaling_bad_steps_0")}
    del f16_scope

    rtol, atol = AMP_TRAIN_LOSS_TOL
    bf16 = {n: launches[f"{n}_bf16"] for n in
            ("flash_attention_fwd", "flash_attention_bwd_dkdv",
             "flash_attention_bwd_dq")}
    checks = {
        "bf16 flash launches": bf16["flash_attention_fwd"]
        >= 2 * layers * AMP_TRAIN_STEPS
        and bf16["flash_attention_bwd_dkdv"] >= layers * AMP_TRAIN_STEPS
        and bf16["flash_attention_bwd_dq"] >= layers * AMP_TRAIN_STEPS,
        "no float32 or float16 flash launch": not any(
            v for n, v in launches.items() if n.startswith("flash_attention")
            and not n.endswith("_bf16")),
        "K8 dropout launches": launches["threefry_dropout"]
        == sites * AMP_TRAIN_STEPS,
        "K8 sees float32": tap_on.dtypes == {"float32"},
        "no launch off": not any(off_launches.values()),
        "masks bit-equal on/off": tap_on.digests[:len(tap_off.digests)]
        == tap_off.digests and len(tap_off.digests) == sites * OFF_STEPS,
        "losses within the bars": all(abs(a - b) <= atol + rtol * abs(b)
                                      for a, b in zip(losses, off_losses)),
        "loss finite": bool(np.isfinite(losses).all()),
        "f16 flash launches": f16_launches["flash_attention_fwd_f16"]
        >= 2 * layers * AMP_F16_STEPS
        and f16_launches["flash_attention_bwd_dkdv_f16"]
        >= layers * AMP_F16_STEPS
        and f16_launches["flash_attention_bwd_dq_f16"]
        >= layers * AMP_F16_STEPS,
        "f16 loss finite": bool(np.isfinite(f16_losses).all()),
        "f16 scale state": scaling["loss_scaling_bad_steps_0"]
        + scaling["loss_scaling_good_steps_0"] >= 1,
    }
    timed = np.asarray(seconds[1:]) * 1e3
    p50, p90 = float(np.median(timed)), float(np.percentile(timed, 90))
    log(f"[train-amp] 5c BERT-base bf16 AMP (flash, hidden dropout "
        f"{TRAIN_DROPOUT}, batch {TRAIN_BATCH}, seq {TRAIN_SEQ}, P {TRAIN_P}): "
        f"{len(ops)} ops ({ops.count('cast')} casts, {ops.count('cast_grad')} "
        f"cast grads), {sites} dropout sites; losses {losses}; step p50 "
        f"{p50:.2f} ms, p90 {p90:.2f} (all {[round(x * 1e3, 2) for x in seconds]}),"
        f" {TRAIN_BATCH * TRAIN_SEQ / p50 * 1e3:.1f} tokens/s; device memory "
        f"peak {peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB held before the "
        f"steps); host syncs a step {len(syncs)} {syncs}; bf16 flash launches "
        f"{bf16} ({AMP_TRAIN_STEPS} steps); dtypes reaching K8 "
        f"{sorted(tap_on.dtypes)}; {time.perf_counter() - t0:.1f}s")
    log(f"[train-amp] 5c kernels off: losses {off_losses} (max diff "
        f"{max(abs(a - b) for a, b in zip(losses, off_losses)):.3e}), step "
        f"p50 {float(np.median(off_seconds[1:])) * 1e3:.2f} ms; "
        f"{len(tap_off.digests)} masks bit-equal")
    log(f"[train-amp] 5c float16, dynamic loss scaling from {AMP_F16_SCALE}: "
        f"losses {f16_losses}, step p50 "
        f"{float(np.median(f16_seconds[1:])) * 1e3:.2f} ms, scale state "
        f"{scaling}, host syncs a step {len(f16_syncs)}, f16 flash launches "
        f"{ {n: v for n, v in f16_launches.items() if n.endswith('_f16')} }")
    log(f"[train-amp] checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"phase 5c failed: {checks}")
    launches.update({n: v for n, v in f16_launches.items() if n.endswith("_f16")})
    return launches


def _compare_states(on, off, start, params, noise):
    """Kernels on vs off after OFF_STEPS steps, as TRAIN_STATE_TOL says.
    Returns the worst error as a share of its bar."""
    if set(on) != set(off):
        raise AssertionError("the two runs hold different persistables")
    worst = 0.0
    for name in sorted(off):
        a, b = on[name].astype(np.float64), off[name].astype(np.float64)
        if name == COUNTER or "_pow_acc_" in name:
            if not np.array_equal(a, b):
                raise AssertionError(f"{name}: kernels on {a.ravel()[:4]} off "
                                     f"{b.ravel()[:4]}")
            continue
        if name in noise or name.rsplit("_moment", 1)[0] in noise:
            continue
        ref = b - start[name] if name in params else b
        bar = TRAIN_STATE_TOL * float(np.linalg.norm(ref))
        err = float(np.linalg.norm(a - b))
        if not (bar > 0 and err <= bar):
            raise AssertionError(f"{name}: kernels on/off differ by {err:.3e} "
                                 f"in norm after {OFF_STEPS} steps (bar "
                                 f"{bar:.3e})")
        worst = max(worst, err / bar)
    return worst


# -- phase 2c ---------------------------------------------------------------
def _bytes_bound(n_bytes):
    return n_bytes / PEAK_BYTES_S * 1e3, "bytes"


def phase_ctr_kernels():
    """K5 and K6 against their plain versions on the card, bit for bit;
    then their costs beside the library calls' and the launch floor."""
    import torch

    from paddle_tpu_torch.kernels import embedding as KE
    from paddle_tpu_torch.kernels import sparse_update as KS

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(SEED + 3)
    staging = KE.Staging()

    # K5: (capacity, dim, admitted rows); the bucket pads the rest with
    # slot == capacity, and admit_rows uploads the real rows only
    for cap, dim, n in ((4096, 16, 700), (4096, 16, 200), (4096, 1, 700),
                        (4096, 1, 200), (1 << 20, 16, 4096)):
        slab = torch.randn(cap, dim, device=dev)
        slots, rows = KE.pad_slots(rng.choice(cap, n, replace=False),
                                   rng.randn(n, dim).astype(np.float32), cap,
                                   dim, np.float32)
        got, want, real = slab.clone(), slab.clone(), slab.clone()
        KE.scatter_rows(got, slots, rows, staging)
        KE.scatter_rows_plain(want, slots, rows)
        KE.admit_rows(real, slots[:n], rows[:n], staging)
        torch.cuda.synchronize()
        keep = np.ones(cap, bool)
        keep[slots[slots < cap]] = False
        keep_t = torch.from_numpy(keep).to(dev)
        if not (torch.equal(got, want) and torch.equal(real, want)
                and torch.equal(got[keep_t], slab[keep_t])):
            raise AssertionError(f"K5 [{cap}, {dim}] bucket {len(slots)}: "
                                 "kernel and plain version differ")
        log(f"[ctr-kernels] K5 slab [{cap}, {dim}] bucket {len(slots)} "
            f"({n} rows): bit-equal to the plain version, and admit_rows "
            "over the real rows alike; other rows untouched")
    # the sync debug mode sees no event wait: the staging counts its own
    waits = KE.staging_waits()
    syncs = [_sync_warnings(lambda: KE.admit_rows(
        slab, slots[:n], rows[:n], s))
        for s in (KE.Staging(), staging, None)]
    if syncs != [[], [], []] or KE.staging_waits() != waits:
        raise AssertionError(f"admit_rows synced with the card: {syncs}, "
                             f"{KE.staging_waits() - waits} staging waits "
                             "(fresh staging, reused, the card's)")
    log("[ctr-kernels] admit_rows makes no host sync and no staging wait "
        "(fresh staging, reused, the card's)")

    # K6: the unique ids of CTR_BATCH x 3 uniform draws from 2^20, as one
    # sgd_sparse of the dense CTR path sees them, as int32 and as int64
    # (torch.unique's); then id 0 among the ids with fill rows past the
    # unique count holding NaN
    for dim, kind, id_dtype in ((16, "", np.int32), (16, "", np.int64),
                                (1, "", np.int32), (1, "", np.int64),
                                (16, "fill", np.int32),
                                (16, "fill", np.int64)):
        vocab = CTR_VOCAB
        param = torch.randn(vocab, dim, device=dev)
        ids = np.unique(rng.randint(0, vocab, CTR_BATCH * 3))
        n_unique = len(ids)
        rows = rng.randn(n_unique, dim).astype(np.float32)
        if kind == "fill":
            ids[0] = 0
            ids = np.concatenate([ids, np.zeros(64, ids.dtype)])
            rows = np.concatenate([rows, np.full((64, dim), np.nan,
                                                 np.float32)])
        ids_t = torch.from_numpy(ids.astype(id_dtype)).to(dev)
        rows_t = torch.from_numpy(rows).to(dev)
        got, want = param.clone(), param.clone()
        KS.sparse_row_update(got, ids_t, rows_t, n_unique=n_unique)
        KS.sparse_row_update_plain(want, ids_t, rows_t, n_unique=n_unique)
        torch.cuda.synchronize()
        keep = np.ones(vocab, bool)
        keep[ids[:n_unique]] = False
        keep_t = torch.from_numpy(keep).to(dev)
        label = (f"K6 param [{vocab}, {dim}] {n_unique} unique "
                 f"{np.dtype(id_dtype).name} ids"
                 f"{' + 64 NaN fill rows, id 0 among the ids' if kind else ''}")
        if not (torch.equal(got, want) and bool(torch.isfinite(got).all())
                and torch.equal(got[keep_t], param[keep_t])):
            raise AssertionError(f"{label}: kernel and plain version differ")
        log(f"[ctr-kernels] {label}: bit-equal to the plain version, other "
            "rows untouched")

    waits = KE.staging_waits()
    costs = ctr_costs(floor=launch_floors())
    log_ctr_costs(costs)
    log(f"[ctr-kernels] K5 wrapper: {KE.staging_waits() - waits} of its "
        "timed calls waited for the upload before them")
    results = {}
    for name, key in (("embedding_admission", "K5"),
                      ("sparse_row_update", "K6")):
        c = costs[key]
        b_ms, b_by = _bytes_bound(c["bound_bytes"])
        results[name] = dict(
            max_abs_err=0.0, ms=c["device_ms"], plain_ms=c["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, library_ms=c["library_ms"],
            host_us=c["host_us"], wrapper_host_us=c["wrapper_host_us"],
            library_host_us=c["library_host_us"],
            floor_ms=costs["floor"]["device_ms"],
            floor_host_us=costs["floor"]["host_us"],
            floor_block_host_us=costs["floor"]["block_host_us"])
    return results


def ctr_costs(int64_ids=True, floor=None, stagings=8):
    """Per-call costs of K5 and K6 and of their library calls at phase
    2c's timed shapes, through the ``paddle_tpu_torch`` that ``sys.path``
    finds (``tools/torch_ctr_kernel_cost.py`` points it at another tree):
    K5 on a deep slab [4096, 16] with a bucket of 1024 slots (700 real
    rows, the rest pad slots), K6 on [1048576, 16] with the unique ids of
    12288 draws. For the bare launch and for ``index_copy_`` /
    ``index_add_`` (on the same device tensors; K5's over the kept rows):
    device ms per call (``device_ms``) and host µs per call
    (``host_us_turns``: every host-timed call in turns, so that a drift of
    the host's speed falls on all alike); for the wrappers the host µs
    (K5's ``scatter_rows`` with the upload of host slots and rows, turn
    by turn through one of ``stagings`` staging buffers, as the engine
    keeps one a table, or with none when ``stagings`` is 0; K6's with its
    checks); for the plain versions the ms of ``time_ms``; and the bytes
    each call must move. With ``int64_ids``, K6 also with int64 ids; with
    ``floor`` (the pair of ``launch_floors``), the launch floor too: the
    device time, and the host time by either binding."""
    import torch

    from paddle_tpu_torch.kernels import embedding as KE
    from paddle_tpu_torch.kernels import sparse_update as KS

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(SEED + 6)
    cap, dim, n = 4096, 16, 700
    slab = torch.randn(cap, dim, device=dev)
    slots, rows = KE.pad_slots(rng.choice(cap, n, replace=False),
                               rng.randn(n, dim).astype(np.float32), cap, dim,
                               np.float32)
    s_dev = torch.from_numpy(slots).to(dev)
    r_dev = torch.from_numpy(rows).to(dev)
    kept = s_dev < cap
    k_slots, k_rows = s_dev[kept].long(), r_dev[kept]
    param = torch.randn(CTR_VOCAB, dim, device=dev)
    ids = np.unique(rng.randint(0, CTR_VOCAB, CTR_BATCH * 3))
    u = len(ids)
    ids32 = torch.from_numpy(ids.astype(np.int32)).to(dev)
    ids64 = ids32.long()
    rows_t = torch.from_numpy(rng.randn(u, dim).astype(np.float32)).to(dev)

    # (key, name): the device-timed calls, then the host-only ones
    device = {
        ("K5", ""): lambda: KE.launch(slab, s_dev, r_dev),
        ("K5", "library_"): lambda: slab.index_copy_(0, k_slots, k_rows),
        ("K6", ""): lambda: KS.launch(param, ids32, rows_t, u),
        ("K6", "library_"): lambda: param.index_add_(0, ids64, rows_t),
    }
    host = dict(device)
    if stagings:
        turn = itertools.cycle([KE.Staging() for _ in range(stagings)])
        host[("K5", "wrapper_")] = lambda: KE.scatter_rows(
            slab, slots, rows, next(turn))
    else:
        host[("K5", "wrapper_")] = lambda: KE.scatter_rows(slab, slots, rows)
    host[("K6", "wrapper_")] = lambda: KS.sparse_row_update(
        param, ids32, rows_t, n_unique=u)
    if int64_ids:
        device[("K6", "int64_")] = lambda: KS.launch(param, ids64, rows_t, u)
        host[("K6", "int64_")] = device[("K6", "int64_")]
        host[("K6", "wrapper_int64_")] = lambda: KS.sparse_row_update(
            param, ids64, rows_t, n_unique=u)
    if floor is not None:
        device[("floor", "")] = host[("floor", "")] = floor[0]
    costs = {"K5": dict(
        plain_ms=time_ms(lambda: KE.scatter_rows_plain(slab, s_dev, r_dev),
                         20),
        # every slot read once; only the kept rows are read and written
        # (pad rows, slot == C, are never loaded)
        bound_bytes=len(slots) * 4 + 2 * n * dim * 4),
        "K6": dict(
        plain_ms=time_ms(lambda: KS.sparse_row_update_plain(
            param, ids32, rows_t, n_unique=u), 20),
        bound_bytes=u * (4 + 3 * dim * 4), unique=u)}
    if floor is not None:
        costs["floor"] = {}
    for (key, name), fn in device.items():
        costs[key][f"{name}device_ms"] = device_ms(fn)
    for (key, name), us in host_us_turns(host).items():
        costs[key][f"{name}host_us"] = float(np.median(us))
    if floor is not None:           # the two bindings, in ten paired rounds
        for name, us in host_us_turns({"": floor[0], "block_": floor[1]},
                                      turns=10).items():
            costs["floor"][f"{name}host_us_rounds"] = us
        costs["floor"]["block_host_us"] = float(np.median(
            costs["floor"]["block_host_us_rounds"]))
    for c in costs.values():     # the library's device time: library_ms
        if "library_device_ms" in c:
            c["library_ms"] = c.pop("library_device_ms")
    return costs


def host_us_turns(fns, turns=4):
    """``host_us`` of each of ``fns`` (a dict of calls), measured in
    ``turns`` rounds, every call once a round, in the reverse order every
    other round: the list of the rounds' times per call."""
    keys = list(fns)
    got = {k: [] for k in keys}
    for t in range(turns):
        for k in (keys if t % 2 == 0 else keys[::-1]):
            got[k].append(host_us(fns[k], windows=3))
    return got


def log_ctr_costs(costs):
    for key, lib in (("K5", "index_copy_"), ("K6", "index_add_")):
        c = costs[key]
        extra = (f"; int64 ids: launch {c['int64_device_ms']:.6f} ms, "
                 f"{c['int64_host_us']:.2f} us, wrapper "
                 f"{c['wrapper_int64_host_us']:.2f} us"
                 if "int64_device_ms" in c else "")
        log(f"[ctr-kernels] {key}: launch device {c['device_ms']:.6f} ms, "
            f"host {c['host_us']:.2f} us; wrapper host "
            f"{c['wrapper_host_us']:.2f} us; {lib} device "
            f"{c['library_ms']:.6f} ms, host {c['library_host_us']:.2f} us; "
            f"plain {c['plain_ms']:.4f} ms; bound "
            f"{_bytes_bound(c['bound_bytes'])[0]:.6f} ms{extra}")
    if "floor" in costs:
        f = costs["floor"]
        typed, block = f["host_us_rounds"], f["block_host_us_rounds"]
        log(f"[ctr-kernels] launch floor (empty kernel, same ctypes route, "
            f"K6's 11 arguments): device {f['device_ms']:.6f} ms, host "
            f"{f['host_us']:.2f} us with the arguments declared one by one; "
            f"binding A/B in {len(typed)} paired rounds: declared "
            f"{np.median(typed):.2f} us (IQR "
            f"{np.subtract(*np.percentile(typed, [75, 25])):.2f}), packed in "
            f"one block {f['block_host_us']:.2f} us, the block faster in "
            f"{sum(b < t for t, b in zip(typed, block))} rounds (declared: "
            f"{', '.join(f'{a:.2f}' for a in typed)}; block: "
            f"{', '.join(f'{a:.2f}' for a in block)})")


# -- phase 2d ---------------------------------------------------------------
def cuda_launches(fn, calls=4, kernels_only=False):
    """CUDA kernels (and copies or sets, unless ``kernels_only``) that one
    call of ``fn`` puts on the card, from a ``torch.profiler`` trace of
    ``calls`` calls; None when the trace shows no device activity. The
    first trace of a process can come back without device events (CUPTI
    still starting); such a trace is taken once more."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if events:
            break
    if not events:
        return None
    if kernels_only:
        events = [e for e in events if not e.name.startswith(("Memset", "Memcpy"))]
    return len(events) / calls


def _topk_vector(gen, dev, n, kind):
    import torch

    x = torch.randn(n, generator=gen, device=dev)
    if kind == "ties":
        x = torch.round(x * 2) / 2
        x[::7] = -0.0
    elif kind == "equal":
        x = torch.where(x < 0, -1.5, 1.5)
    return x


def phase_topk():
    """K7 against its plain version on the card, bit for bit; timed."""
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import topk as KT

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    result = None
    for label, n, k, block, kind in TOPK_CASES:
        x = _topk_vector(gen, dev, n, kind)
        kernels.reset_launches()
        sv, si = KT.blocked_topk_stage(x, k, block)
        pv, pi = KT.blocked_topk_stage_plain(x, k, block)
        vals, idx = KT.blocked_topk_abs(x, k, block)
        wv, wi = KT.blocked_topk_abs_plain(x, k, block)
        torch.cuda.synchronize()
        if kernels.launches("blocked_topk_abs") != 2:
            raise AssertionError(f"K7 {label}: launched "
                                 f"{kernels.launches('blocked_topk_abs')} "
                                 "times, want 2")
        checks = {"stage": torch.equal(sv, pv) and torch.equal(si, pi),
                  "top-k": torch.equal(vals, wv) and torch.equal(idx, wi),
                  "|x[idx]| == vals": torch.equal(x.abs()[idx.long()], vals),
                  "idx < n": int(idx.max()) < n}
        if not all(checks.values()):
            raise AssertionError(f"K7 {label}: kernel and plain version "
                                 f"differ: {checks}")
        log(f"[topk] {label} (n={n}, block {block}, {-(-n // block)} blocks, "
            f"clusters of {KT.scheduled_cluster(0, block, -(-n // block))}): "
            "stage and top-k "
            "bit-equal to the plain version, |x[idx]| == vals")
        if result is not None:
            continue
        nb, kk = -(-n // block), min(k, block)
        ms = device_ms(lambda: KT.launch(x, k, block), 10)
        whole_ms = device_ms(lambda: KT.blocked_topk_abs(x, k, block), 10)
        plain_ms = device_ms(lambda: KT.blocked_topk_stage_plain(
            x, k, block), 5)
        lib_ms = device_ms(lambda: torch.topk(x.abs(), k), 10)
        # x read once, nb * kk (value, index) pairs written once
        b_ms, b_by = _bytes_bound(n * 4 + nb * kk * 8)
        result = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                      bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                      whole_ms=whole_ms)
        log(f"[topk] K7 {label}: device ms, stage {ms:.4f} (the whole "
            f"function, with the final selection over {nb * kk} candidates, "
            f"{whole_ms:.4f}) plain {plain_ms:.4f} (the plain stage) "
            f"library {lib_ms:.4f} (torch.topk of |x|) bound {b_ms:.4f} "
            f"({b_by})")

    # the whole sparse step's K7 work: every (numel, k) pair it launches on
    pairs = _dgc_topk_pairs()
    if sum(pairs.values()) != 97:
        raise AssertionError(f"{sum(pairs.values())} K7 launches a sparse "
                             "Transformer-base step, want 97")
    step = {"stage": 0.0, "whole": 0.0, "torch.topk": 0.0}
    rows = []
    for (n, k), count in sorted(pairs.items()):
        x = torch.randn(n, generator=gen, device=dev)
        fns = {"stage": lambda: KT.launch(x, k, TOPK_BLOCK),
               "whole": lambda: KT.blocked_topk_abs(x, k, TOPK_BLOCK),
               "torch.topk": lambda: torch.topk(x.abs(), k)}
        each = {name: device_ms(fn, 10) for name, fn in fns.items()}
        # host time a call, no sync; few calls a window (torch.topk makes
        # up to 39 launches a call), so that the card's queue of launches
        # never fills and blocks the host
        host = {name: host_us(fns[name], reps=10)
                for name in ("whole", "torch.topk")}
        launches = {name: cuda_launches(fns[name])
                    for name in ("whole", "torch.topk")}
        for name, ms in each.items():
            step[name] += count * ms
        rows.append(dict(n=n, k=k, count=count, stage_ms=each["stage"],
                         whole_ms=each["whole"],
                         library_ms=each["torch.topk"],
                         host_us=host["whole"],
                         library_host_us=host["torch.topk"],
                         cuda_launches=launches["whole"],
                         library_cuda_launches=launches["torch.topk"]))
        log(f"[topk] n={n} k={k} x{count} a step: device ms, stage "
            f"{each['stage']:.4f}, the whole blocked_topk_abs "
            f"{each['whole']:.4f}, torch.topk(|x|, k) "
            f"{each['torch.topk']:.4f}; host us a call, the whole "
            f"{host['whole']:.2f}, torch.topk {host['torch.topk']:.2f}; "
            f"CUDA launches a call, the whole {launches['whole']}, "
            f"torch.topk {launches['torch.topk']}")
    log(f"[topk] one sparse Transformer-base step, {sum(pairs.values())} "
        f"calls: device ms, stage {step['stage']:.4f}, the whole "
        f"blocked_topk_abs {step['whole']:.4f}, torch.topk(|x|, k) "
        f"{step['torch.topk']:.4f} (blocked_topk_abs takes "
        f"{step['whole'] / step['torch.topk']:.2f}x its time)")
    result.update(step_ms=step["stage"], step_whole_ms=step["whole"],
                  step_library_ms=step["torch.topk"], step_pairs=rows)
    return {"blocked_topk_abs": result}


def _dgc_topk_pairs():
    """{(numel, k): count} of the K7 launches of one sparse step of phase
    8's Transformer-base: the parameters over one block with n > 2k, at
    DGC's static k (``dgc_k``)."""
    from collections import Counter

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops.optimizers import dgc_k
    from paddle_tpu_torch.utils import unique_name

    cfg = T.TransformerConfig.base()            # dropout 0.1, as phase 8
    with unique_name.guard():
        main = T.build_wmt_train(
            cfg, src_len=DGC_SEQ, tgt_len=DGC_SEQ,
            optimizer=fluid.optimizer.DGCMomentumOptimizer(**DGC_OPT))[0]
    pairs = Counter()
    for p in main.all_parameters():
        n = int(np.prod(p.shape))
        k = dgc_k(n, DGC_OPT["sparsity"])
        if n > TOPK_BLOCK and n > 2 * k:
            pairs[(n, k)] += 1
    return pairs


def _count_syncs(fn):
    """Run ``fn`` once with PyTorch's sync debug mode on; returns the
    number of operations that synchronized the host with the card."""
    return len(_sync_warnings(fn))


def _sync_warnings(fn, threads=False):
    """Run ``fn`` once with PyTorch's sync debug mode on; returns where
    each operation that synchronized the host with the card was called
    (file:line of the warning, then its text), on any thread; with
    ``threads``, (``threading.get_ident()`` of the thread that made the
    call, where) pairs."""
    import warnings

    import torch

    caught = []

    def show(message, category, filename, lineno, file=None, line=None):
        # the mode's own one-time notice ("Synchronization debug mode is
        # a prototype feature ...") is not a sync: the sync's message only
        if "called a synchronizing CUDA operation" in str(message):
            caught.append((threading.get_ident(),
                           f"{os.path.basename(filename)}:{lineno} {message}"))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return caught if threads else [where for _, where in caught]


# -- phase 6 ----------------------------------------------------------------
_CLICK_RECORDS = []


def _click_records():
    """Phase 6's 24 x 4096 click-log records (``click_log(..., seed=0)``),
    made once a process: phases 6, 10b and 15a read the same records and
    never change them (the Python loop that draws them takes 15-20 s)."""
    from paddle_tpu_torch.models import wide_deep as wd

    if not _CLICK_RECORDS:
        _CLICK_RECORDS.extend(wd.click_log(WD_BATCH * WD_STEPS, seed=0))
    return _CLICK_RECORDS


def _wide_deep_run(batches, capacity, state=None, timed=False):
    """One Wide&Deep training run over ``batches`` on the card. Returns
    the losses, launches, per-step K5 launches and tables with misses,
    the host tier and persistables after a flush, the engine's stats,
    and (timed) step seconds, ``prepare_feed`` seconds, memory peak and
    one step's host syncs."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.convert import load_params, persistables_to_numpy
    from paddle_tpu_torch.embedding import EmbeddingEngine
    from paddle_tpu_torch.kernels import embedding as KE
    from paddle_tpu_torch.models import wide_deep as wd
    from paddle_tpu_torch.utils import unique_name

    with unique_name.guard():
        main, startup, feeds, (loss, _pred) = wd.build_programs(
            capacity=capacity)
    startup.random_seed = SEED
    exe, scope = fluid.Executor(), fluid.Scope()   # CUDAPlace(0)
    exe.run(startup, scope=scope)
    if state is None:
        state = persistables_to_numpy(scope, startup)
    else:
        load_params(scope, state)
    engine = EmbeddingEngine(scope=scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    roundtrips, waits = KE.roundtrips(), KE.staging_waits()
    losses, seconds, prep, per_step, syncs = [], [], [], [], None

    def step(feed):
        t0 = time.perf_counter()
        feed = engine.prepare_feed(main, dict(feed))
        prep.append(time.perf_counter() - t0)
        return float(exe.run(main, feed=feed, fetch_list=[loss],
                             scope=scope)[0][0])

    for i, batch in enumerate(batches):
        misses = {t: rt.misses for t, rt in engine.tables.items()}
        before = kernels.launches("embedding_admission")
        t0 = time.perf_counter()
        if timed and i == len(batches) - 1:
            out = []
            syncs = _count_syncs(lambda: out.append(step(batch)))
            losses.append(out[0])
        else:
            losses.append(step(batch))
        seconds.append(time.perf_counter() - t0)
        with_misses = sum(rt.misses > misses.get(t, 0)
                          for t, rt in engine.tables.items())
        per_step.append((kernels.launches("embedding_admission") - before,
                         with_misses))
    launches = kernels.launches()
    peak = torch.cuda.max_memory_allocated()
    stats = engine.stats()          # before the flush: eviction write-backs
    host = engine.host_rows()
    engine.close()
    if KE.roundtrips() != roundtrips:
        raise AssertionError("a whole slab was copied to the host")
    if KE.staging_waits() != waits:
        # a table's admissions are a step apart, and a step syncs
        raise AssertionError(f"{KE.staging_waits() - waits} admissions "
                             "waited for the upload before them")
    return dict(losses=losses, launches=launches, per_step=per_step,
                host=host, stats=stats, state=state, seconds=seconds,
                prep=prep, peak=peak, syncs=syncs,
                final=persistables_to_numpy(scope, main))


def _same_host_tier(a, b):
    if set(a) != set(b):
        return False
    for t, rows in a.items():
        if set(rows) != set(b[t]):
            return False
        if any(rows[i].tobytes() != b[t][i].tobytes() for i in rows):
            return False
    return True


def phase_wide_deep():
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import wide_deep as wd
    from paddle_tpu_torch.utils import unique_name

    t0 = time.perf_counter()
    records = _click_records()
    with unique_name.guard():
        feeds = wd.build_programs()[2]
    batches = [wd.make_batch(records[i * WD_BATCH:(i + 1) * WD_BATCH], feeds)
               for i in range(WD_STEPS)]
    log(f"[wide&deep] {WD_STEPS} click-log batches of {WD_BATCH} "
        f"({time.perf_counter() - t0:.2f}s to make)")
    on = _wide_deep_run(batches, WD_CAPACITY, timed=True)
    bad = [(i, k, m) for i, (k, m) in enumerate(on["per_step"]) if k != m]
    if bad:
        raise AssertionError(f"K5 launches per step != tables with misses "
                             f"(step, launches, tables): {bad}")
    if not sum(k for k, _ in on["per_step"]):
        raise AssertionError("K5 was never launched")
    if not all(st["evictions"] > 0 and st["writebacks"] > 0
               for st in on["stats"].values()):
        raise AssertionError(f"no evictions or writebacks: {on['stats']}")
    if not all(np.isfinite(on["losses"])):
        raise AssertionError(f"non-finite losses {on['losses']}")
    step_ms = float(np.median(on["seconds"][1:])) * 1e3
    prep_ms = float(np.median(on["prep"][1:])) * 1e3
    log(f"[wide&deep] losses {on['losses']}")
    log(f"[wide&deep] K5 launches per step (launches, tables with misses): "
        f"{on['per_step']}")
    log(f"[wide&deep] step p50 {step_ms:.2f} ms (first "
        f"{on['seconds'][0] * 1e3:.2f} ms), engine.prepare_feed p50 "
        f"{prep_ms:.2f} ms (min {min(on['prep'][1:]) * 1e3:.2f}, max "
        f"{max(on['prep'][1:]) * 1e3:.2f}), "
        f"{WD_BATCH / step_ms * 1e3:.1f} examples/s, device memory peak "
        f"{on['peak'] / 2**30:.3f} GiB, host syncs in one step "
        f"{on['syncs']}")
    for t, st in sorted(on["stats"].items()):
        log(f"[wide&deep]   {t}: {st}")

    with kernels.scoped_mode("off"):
        off = _wide_deep_run(batches, WD_CAPACITY, state=on["state"])
    if any(off["launches"].values()):
        raise AssertionError("a kernel launched with the kernels off")
    big = _wide_deep_run(batches, WD_BIG_CAPACITY, state={
        n: a for n, a in on["state"].items() if "__slab" not in n})
    checks = {
        "off: losses": off["losses"] == on["losses"],
        "off: host tier": _same_host_tier(off["host"], on["host"]),
        "off: persistables": set(off["final"]) == set(on["final"]) and all(
            off["final"][n].tobytes() == a.tobytes()
            for n, a in on["final"].items()),
        "capacity 65536: losses": big["losses"] == on["losses"],
        "capacity 65536: host tier": _same_host_tier(big["host"], on["host"]),
        "capacity 65536: dense persistables": all(
            big["final"][n].tobytes() == a.tobytes()
            for n, a in on["final"].items() if "__slab" not in n),
    }
    log(f"[wide&deep] bit-identical: {checks}; capacity 65536 evictions "
        f"{sum(st['evictions'] for st in big['stats'].values())}")
    if not all(checks.values()):
        diff = max(abs(a - b) for a, b in zip(on["losses"], off["losses"]))
        raise AssertionError(f"Wide&Deep runs differ: {checks}; largest "
                             f"loss difference kernels off {diff:.3e}")
    return on["launches"]


# -- phase 7 ----------------------------------------------------------------
def phase_dense_ctr():
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import ctr
    from paddle_tpu_torch.utils import unique_name
    from paddle_tpu_torch.utils.flags import flags

    rng = np.random.RandomState(SEED + 4)
    batches = [ctr.synthetic_batch(rng, CTR_BATCH, id_space=CTR_VOCAB)
               for _ in range(CTR_STEPS)]
    with unique_name.guard():
        main, startup, _feeds, (loss, _pred) = ctr.build_ctr_train(
            ps_mode=False, vocab_size=CTR_VOCAB,
            optimizer=fluid.optimizer.SGD(learning_rate=0.1))
    tables = [v.name for v in main.global_block().vars.values()
              if v.persistable and v.name.endswith("_w")
              and v.shape[0] == CTR_VOCAB]
    startup.random_seed = SEED
    scopes = {}
    for arm in ("on", "off"):       # the same seed gives the same init
        scopes[arm] = fluid.Scope()
        fluid.Executor().run(startup, scope=scopes[arm])
    if not all(torch.equal(scopes["on"].find_var(n), scopes["off"].find_var(n))
               for n in tables):
        raise AssertionError("the two startups differ")
    initial = {n: scopes["on"].find_var(n).clone() for n in tables}
    table_mb = sum(t.numel() * 4 for t in initial.values()) / 1e6
    old = flags.pallas_sparse_update
    flags.pallas_sparse_update = True
    try:
        exe = fluid.Executor()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        losses, seconds, per_step, syncs = [], [], [], None
        for i, batch in enumerate(batches):
            before = kernels.launches("sparse_row_update")
            t0 = time.perf_counter()
            run = lambda: losses.append(float(exe.run(  # noqa: E731
                main, feed=dict(batch), fetch_list=[loss],
                scope=scopes["on"])[0][0]))
            if i == len(batches) - 1:
                syncs = _count_syncs(run)
            else:
                run()
            seconds.append(time.perf_counter() - t0)
            per_step.append(kernels.launches("sparse_row_update") - before)
        launches = kernels.launches()
        peak = torch.cuda.max_memory_allocated()
        with kernels.scoped_mode("off"):
            kernels.reset_launches()
            off = [float(exe.run(main, feed=dict(b), fetch_list=[loss],
                                 scope=scopes["off"])[0][0]) for b in batches]
            if any(kernels.launches().values()):
                raise AssertionError("a kernel launched with the kernels off")
    finally:
        flags.pallas_sparse_update = old
    n_sparse = [op.type for op in main.global_block().ops].count("sgd_sparse")
    if n_sparse != 16 or per_step != [16] * CTR_STEPS:
        raise AssertionError(f"{n_sparse} sgd_sparse ops; K6 launches per "
                             f"step {per_step}, want 16")
    if syncs != CTR_STEP_SYNCS:
        raise AssertionError(f"a dense CTR step made {syncs} host syncs, "
                             f"want {CTR_STEP_SYNCS}")
    one_op = _sgd_sparse_syncs(scopes["on"].find_var(tables[0]),
                               batches[0]["slot_0"])
    bad_id = _bad_id_check()
    if losses != off:
        raise AssertionError(f"loss streams differ: on {losses} off {off}")
    changed, moved = 0, []
    for n in tables:
        slot = int(n.split("_")[1])
        touched = torch.from_numpy(np.unique(np.concatenate(
            [b[f"slot_{slot}"].ravel() for b in batches]))).cuda()
        a = scopes["on"].find_var(n)
        b = scopes["off"].find_var(n)
        if not torch.equal(a, b):
            raise AssertionError(f"{n}: kernels on and off differ by "
                                 f"{float((a - b).abs().max()):.3e}")
        delta = a.index_select(0, touched) - initial[n].index_select(
            0, touched)
        n_changed = int((delta != 0).any(1).sum())
        if not n_changed:
            raise AssertionError(f"{n}: no row changed")
        changed += n_changed
        # each table's largest change over the run, beside its bit-equality
        moved.append(f"{n} {float(delta.abs().max()):.3e}")
        keep = torch.ones(CTR_VOCAB, dtype=torch.bool, device=a.device)
        keep[touched] = False
        if not torch.equal(a[keep], initial[n][keep]):
            raise AssertionError(f"{n}: rows no step touched changed")
    step_ms = float(np.median(seconds[1:])) * 1e3
    log(f"[dense-ctr] {len(tables)} tables, {table_mb:.1f} MB; losses "
        f"{losses}; kernels off bit-equal (losses and every table); {changed} "
        f"rows changed, every table moved, untouched rows unchanged; largest change of a "
        f"touched row per table: {', '.join(moved)}")
    log(f"[dense-ctr] K6 launches per step {per_step}; step p50 "
        f"{step_ms:.2f} ms (first {seconds[0] * 1e3:.2f} ms), "
        f"{CTR_BATCH / step_ms * 1e3:.1f} examples/s, device memory peak "
        f"{peak / 2**30:.3f} GiB, host syncs in one step {syncs} (one "
        f"sgd_sparse with K6: {one_op}, torch.unique's)")
    log(f"[dense-ctr] {bad_id}")
    return launches


def _sgd_sparse_syncs(table, ids):
    """The host syncs of one ``sgd_sparse`` with K6 (the lowering called
    alone, on a copy of ``table``): exactly one, ``torch.unique``'s."""
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.backward import resolve_op_def
    from paddle_tpu_torch.utils.flags import flags

    dev = table.device
    ids = torch.from_numpy(np.asarray(ids) % table.shape[0]).to(dev)
    ins = {"Param": [table.clone()], "Ids": [ids],
           "RowGrad": [torch.ones(tuple(ids.shape) + (table.shape[1],),
                                  device=dev)],
           "LearningRate": [torch.full((1,), 0.1, device=dev)]}
    lowering = resolve_op_def("sgd_sparse").lowering()
    old = flags.pallas_sparse_update
    flags.pallas_sparse_update = True
    try:
        before = kernels.launches("sparse_row_update")
        syncs = _count_syncs(lambda: lowering(ins, {"padding_idx": -1}))
        launched = kernels.launches("sparse_row_update") - before
    finally:
        flags.pallas_sparse_update = old
    if syncs != 1 or launched != 1:
        raise AssertionError(f"one sgd_sparse made {syncs} host syncs and "
                             f"{launched} K6 launches, want 1 and 1")
    return syncs


def _bad_id_check():
    """An id outside the table through ``Executor.run`` with K6, with a
    fetch copy and with no fetches: the run raises by its end, as the CPU
    path does (``EnforceError`` naming ``sgd_sparse``, caused by the
    ``ValueError`` naming the id), the in-range ids' rows are updated and
    every other row is unchanged; the next run is clean."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.ctr import sgd_sparse_program
    from paddle_tpu_torch.utils.enforce import EnforceError
    from paddle_tpu_torch.utils.flags import flags

    vocab, dim = 1000, 16
    main = sgd_sparse_program(vocab, dim, 4)
    exe = fluid.Executor()
    messages = []
    for fetch_list in (["lr"], []):
        scope = fluid.Scope()
        table = torch.randn(vocab, dim, device=exe.device)
        before = table.clone()
        scope.set("table", table)
        feed = {"ids": np.array([3, vocab + 7, 5, 3], np.int64),
                "rows": np.ones((4, dim), np.float32),
                "lr": np.array([0.5], np.float32)}
        old = flags.pallas_sparse_update
        flags.pallas_sparse_update = True
        try:
            try:
                exe.run(main, feed=feed, fetch_list=fetch_list, scope=scope)
            except EnforceError as e:
                message, cause = str(e), e.__cause__
            else:
                raise AssertionError(f"fetches {fetch_list}: an id outside "
                                     "the table did not raise by the end of "
                                     "Executor.run")
            feed["ids"] = np.array([3, 9, 5, 3], np.int64)
            exe.run(main, feed=feed, fetch_list=fetch_list, scope=scope)
            torch.cuda.synchronize()
        finally:
            flags.pallas_sparse_update = old
        want = before.clone()
        want[[3, 5]] -= torch.tensor([1.0, 0.5], device=exe.device)[:, None]
        want[[3, 9, 5]] -= torch.tensor([1.0, 0.5, 0.5],
                                        device=exe.device)[:, None]
        if ("sgd_sparse" not in message or not isinstance(cause, ValueError)
                or f"id {vocab + 7} outside" not in str(cause)):
            raise AssertionError(f"fetches {fetch_list}: unexpected error "
                                 f"for a bad id: {message!r} from {cause!r}")
        if not torch.equal(scope.find_var("table"), want):
            raise AssertionError(f"fetches {fetch_list}: a bad id's run "
                                 "changed a row outside its update, or the "
                                 "clean run after it was wrong")
        messages.append(message.replace("\n", " "))
    return (f"an id outside the table raised by the end of Executor.run, "
            f"with a fetch copy and with no fetches ({messages[0]!r}); no "
            "other row changed; the next run clean")


# -- phase 8 ----------------------------------------------------------------
# -- phase 2e ---------------------------------------------------------------
def _sass_counts(function):
    """Instructions by opcode in ``function`` of K8's built library
    (``cuobjdump -sass``), or None where the toolkit has no cuobjdump."""
    from paddle_tpu_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(build.library_path(K8_SOURCE))],
                         capture_output=True, text=True, timeout=120).stdout
    counts, inside = {}, False
    for line in out.splitlines():
        if "Function :" in line:
            inside = function in line
            continue
        if inside and "/*" in line and ";" in line:
            op = line.split("*/", 1)[1].strip().split()[0]
            if op.startswith("@"):
                op = line.split("*/", 1)[1].strip().split()[1]
            op = op.split(".")[0].rstrip(";")
            counts[op] = counts.get(op, 0) + 1
    return counts


def k8_bound(n, bytes_per_draw):
    """(bound_ms, bound_by) of ``n`` threefry draws: the larger of the
    bytes over the HBM rate and K8_OPS_PER_DRAW integer operations a draw
    over the card's INT32 rate."""
    t_bytes = n * bytes_per_draw / PEAK_BYTES_S * 1e3
    t_ops = n * K8_OPS_PER_DRAW / PEAK_INT32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_random():
    """K8 against its plain version on the card, bit for bit, and its
    random bits against the host numpy copy of jax.random's bytes; timed
    beside the plain version, the bound and torch's own dropout."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core import prng
    from paddle_tpu_torch.kernels import random as KR

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    key = prng.fold_in(prng.prng_key(SEED), 11)
    kernels.reset_launches()
    for n in K8_BITS_SHAPES:
        got = KR.random_bits(key, n, dev)
        plain = KR.random_bits_plain(key, n, dev)
        host = prng.random_bits(key, (n,))
        torch.cuda.synchronize()
        if not torch.equal(got, plain):
            raise AssertionError(f"K8 random_bits n={n}: kernel and plain "
                                 "version differ")
        if not np.array_equal(got.cpu().numpy().view(np.uint32), host):
            raise AssertionError(f"K8 random_bits n={n}: not the host copy "
                                 "of jax.random's bytes")
        log(f"[random] random_bits n={n}: bit-equal to the plain version and "
            "to the host numpy copy of jax.random.bits")
    results = {}
    for shape, p, upscale, timed in K8_DROPOUT_CASES:
        x = torch.randn(shape, generator=gen, device=dev)
        out, mask = KR.dropout_fwd(x, key, p, upscale)
        pout, pmask = KR.dropout_fwd_plain(x, key, p, upscale)
        torch.cuda.synchronize()
        if not (torch.equal(out, pout) and torch.equal(mask, pmask)):
            raise AssertionError(f"K8 dropout {shape} p={p} upscale={upscale}"
                                 ": kernel and plain version differ")
        kept = float(mask.mean())
        log(f"[random] dropout {list(shape)} p={p} "
            f"{'upscale_in_train' if upscale else 'downgrade_in_infer'}: Out "
            f"and Mask bit-equal to the plain version, {kept:.4f} kept")
        if not timed:
            continue
        n = x.numel()
        ms = device_ms(lambda: KR.dropout_fwd(x, key, p, upscale))
        plain_ms = device_ms(lambda: KR.dropout_fwd_plain(x, key, p, upscale),
                             5)
        lib_ms = device_ms(lambda: F.dropout(x, p, training=True))
        # x read once, Out and Mask written once
        b_ms, b_by = k8_bound(n, 12)
        results.setdefault("threefry_dropout", dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, shape=list(shape)))
        log(f"[random] K8 dropout {list(shape)}: device ms {ms:.4f} plain "
            f"{plain_ms:.4f} library {lib_ms:.4f} "
            "(torch.nn.functional.dropout, Philox: another stream) bound "
            f"{b_ms:.4f} ({b_by}; bytes {n * 12 / PEAK_BYTES_S * 1e3:.4f}, "
            f"integer work {n * K8_OPS_PER_DRAW / PEAK_INT32_OPS * 1e3:.4f})")
    # a dense data-parallel rank's draws: its block of the global
    # counters, both entry points, against the plain version and the host
    # copy of jax.random's bytes
    for base in K8_BASES:
        n = 1_000_003
        got = KR.random_bits(key, n, dev, base)
        plain = KR.random_bits_plain(key, n, dev, base)
        host = prng.random_bits(key, (n,), base)
        x = torch.randn((16, 128, 768), generator=gen, device=dev)
        out, mask = KR.dropout_fwd(x, key, 0.1, True, base)
        pout, pmask = KR.dropout_fwd_plain(x, key, 0.1, True, base)
        torch.cuda.synchronize()
        if not (torch.equal(got, plain) and np.array_equal(
                got.cpu().numpy().view(np.uint32), host)):
            raise AssertionError(f"K8 random_bits at counter base {base}: "
                                 "not the plain version's or the host's")
        if not (torch.equal(out, pout) and torch.equal(mask, pmask)):
            raise AssertionError(f"K8 dropout at counter base {base}: "
                                 "kernel and plain version differ")
        log(f"[random] counter base {base}: random_bits n={n} bit-equal to "
            "the plain version and the host copy; dropout [16, 128, 768] "
            "Out and Mask bit-equal to the plain version")
    x = torch.randn((16, 128, 768), generator=gen, device=dev)
    at_base = [device_ms(lambda b=b: KR.dropout_fwd(x, key, 0.1, True, b))
               for b in (0, K8_BASES[0])]
    results["threefry_dropout"]["rank_block_ms"] = at_base
    log(f"[random] K8 dropout [16, 128, 768] (a rank's half of the site): "
        f"device ms {at_base[0]:.4f} at base 0, {at_base[1]:.4f} at rank "
        f"1's base {K8_BASES[0]}")
    n = K8_TIMED_BITS
    ms = device_ms(lambda: KR.random_bits(key, n, dev))
    plain_ms = device_ms(lambda: KR.random_bits_plain(key, n, dev), 5)
    lib_ms = device_ms(lambda: torch.randint(
        -2 ** 31, 2 ** 31, (n,), dtype=torch.int32, device=dev))
    b_ms, b_by = k8_bound(n, 4)
    # no PyTorch call computes threefry bits: library_ms is null, and
    # torch.randint's Philox bits are printed beside for scale
    results["threefry_random_bits"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, philox_randint_ms=lib_ms, n=n)
    log(f"[random] K8 random_bits n={n} (BERT-base's word_embedding draw): "
        f"device ms {ms:.4f} plain {plain_ms:.4f} bound {b_ms:.4f} ({b_by}); "
        f"torch.randint int32 (Philox, another function) {lib_ms:.4f}")
    # the executor's host cost of one key (a scalar fold_in in Python
    # ints), about 50 a BERT-base step
    t0 = time.perf_counter()
    for i in range(20000):
        prng.fold_in(key, i)
    key_us = (time.perf_counter() - t0) / 20000 * 1e6
    results["threefry_dropout"]["key_host_us"] = key_us
    log(f"[random] one executor key (fold_in on the host): {key_us:.3f} us")
    # the counter-0 build (the template's other build adds a base)
    sass = _sass_counts("random_bits_kernelILb0E")
    if sass is not None:
        log(f"[random] random_bits_kernel<false> SASS, instructions by "
            f"opcode (a vector path of 4 draws and a scalar path of 1 a loop "
            f"trip): {dict(sorted(sass.items(), key=lambda kv: -kv[1]))}")
    return results


def _digest(tensors):
    """One hash of the bytes of ``tensors``, in order (on the host)."""
    h = hashlib.blake2b(digest_size=16)
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _dgc_steps(exe, prog, scope, feed, loss, params, uv, steps):
    """``steps`` steps of the compiled program: losses, host seconds (the
    run, ending in the loss's copy, and a synchronize), K7 launches and
    collectives per step, the parameters' digest after every step and the
    U/V digest after the last."""
    import torch

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.parallel import env as penv

    out = dict(losses=[], seconds=[], k7=[], sent=[], reduced=[], digests=[])
    for _ in range(steps):
        before = kernels.launches("blocked_topk_abs")
        penv.reset_collective_stats()
        t0 = time.perf_counter()
        value = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)[0]
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["losses"].append(float(value.reshape(-1)[0]))
        out["k7"].append(kernels.launches("blocked_topk_abs") - before)
        stats = penv.collective_stats()
        out["sent"].append(stats.get("all_gather", (0, 0))[1])
        out["reduced"].append(stats.get("all_reduce", (0, 0))[1])
        out["digests"].append(_digest(scope.find_var(n) for n in params))
    out["uv_digest"] = _digest(scope.find_var(n) for n in uv)
    return out


def dgc_rank_main(out_dir):
    """One rank of phase 8 (``chip_smoke.py --dgc-rank DIR``): train, check
    nothing across ranks, write what it saw to ``DIR/rank<r>.json``."""
    check_environment()
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.convert import (
        dgc_state_names, load_params, persistables_to_numpy)
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops.optimizers import dgc_k
    from paddle_tpu_torch.parallel import env as penv
    from paddle_tpu_torch.utils.flags import flags

    # kernels on against off bit for bit needs every other op run-to-run
    # deterministic: cuBLAS with a fixed workspace, the deterministic
    # index_put_/gather/index_select backward paths
    torch.use_deterministic_algorithms(True)
    flags.pallas_dgc_topk = True
    mesh = penv.make_mesh()
    rank = mesh.rank
    t0 = time.perf_counter()
    cfg = T.TransformerConfig.base()            # dropout 0.1
    main, startup, _, (loss,) = T.build_wmt_train(
        cfg, src_len=DGC_SEQ, tgt_len=DGC_SEQ,
        optimizer=fluid.optimizer.DGCMomentumOptimizer(**DGC_OPT))
    startup.random_seed = main.random_seed = SEED
    site = [op.output("Mask")[0] for op in main.global_block().ops
            if op.type == "dropout"][0]
    params = [p.name for p in main.all_parameters()]
    uv = dgc_state_names(main)
    sizes = [int(np.prod(p.shape)) for p in main.all_parameters()]
    k7_per_step = sum(1 for n in sizes if n > TOPK_BLOCK
                      and n > 2 * dgc_k(n, DGC_OPT["sparsity"]))
    exe = fluid.Executor()                        # CUDAPlace(0), shared
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    snapshot = persistables_to_numpy(scope, main)
    init = _digest(scope.find_var(n) for n in params)
    feed = T.synthetic_batch(np.random.RandomState(SEED), DGC_BATCH, DGC_SEQ,
                             DGC_SEQ, cfg)
    prog = fluid.CompiledProgram(main).with_parallel(mesh=mesh,
                                                     loss_name=loss.name)
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with _MaskTap() as tap_on:
        on = _dgc_steps(exe, prog, scope, feed, loss, params, uv, DGC_STEPS)
    launches = kernels.launches()
    peak = torch.cuda.max_memory_allocated()
    # a fresh executor repeats the first one's run counter, so its keys
    off_exe, off_scope = fluid.Executor(), fluid.Scope()
    off_exe.run(startup, scope=off_scope)
    load_params(off_scope, snapshot)
    with kernels.scoped_mode("off"):
        kernels.reset_launches()
        with _MaskTap() as tap_off:
            off = _dgc_steps(off_exe, prog, off_scope, feed, loss, params,
                             uv, DGC_STEPS)
        off_launches = sum(kernels.launches().values())
    nodrop_seconds = _dgc_nodropout_seconds(fluid, T, mesh, feed)
    diffs = {}
    if on["digests"][-1] != off["digests"][-1]:
        for n in params:
            d = float((scope.find_var(n) - off_scope.find_var(n)).abs().max())
            if d:
                diffs[n] = d
    result = dict(
        rank=rank, backend=mesh.backend, ops=len(main.global_block().ops),
        n_params=len(params), n_values=sum(sizes), dense_bytes=sum(sizes) * 4,
        k7_per_step=k7_per_step, init=init, build_s=build_s, peak=peak,
        launches=launches, off_launches=off_launches, on=on, off=off,
        diffs=diffs, nodrop_seconds=nodrop_seconds, site=site,
        masks_on=tap_on.digests,
        masks_off=tap_off.digests, kept=tap_on.kept)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _dgc_nodropout_seconds(fluid, T, mesh, feed):
    """Host seconds of DGC_NODROP_STEPS compiled steps of phase 8's model
    without dropout (from its own startup), for the cost of dropout on
    the same host clock."""
    import torch

    cfg = T.TransformerConfig.base()
    cfg.dropout = 0.0
    main, startup, _, (loss,) = T.build_wmt_train(
        cfg, src_len=DGC_SEQ, tgt_len=DGC_SEQ,
        optimizer=fluid.optimizer.DGCMomentumOptimizer(**DGC_OPT))
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    prog = fluid.CompiledProgram(main).with_parallel(mesh=mesh,
                                                     loss_name=loss.name)
    seconds = []
    for _ in range(DGC_NODROP_STEPS):
        t0 = time.perf_counter()
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return seconds


def phase_dgc():
    """Launch the 2 ranks, then hold their results against each other and
    against the predicted K7 launches."""
    from paddle_tpu_torch.distributed import launch

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dgc_")
    try:
        procs = launch.spawn_gang(
            [os.path.abspath(__file__), "--dgc-rank", out_dir],
            nproc=DGC_RANKS, init_method="file://" + os.path.join(
                out_dir, "store"),
            extra_env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
        try:
            codes = launch.wait_gang(procs, timeout_s=900)
        finally:
            launch.terminate_gang(procs)
        if codes != [0] * DGC_RANKS:
            raise AssertionError(f"dgc ranks exited {codes}")
        ranks = []
        for r in range(DGC_RANKS):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    r0 = ranks[0]
    sparse_steps = [i for i in range(DGC_STEPS)
                    if i >= DGC_OPT["rampup_begin_step"]]
    want = [r0["k7_per_step"] if i in sparse_steps else 0
            for i in range(DGC_STEPS)]
    losses = r0["on"]["losses"]
    checks = {
        "backend gloo": all(r["backend"] == "gloo" for r in ranks),
        "same init": len({r["init"] for r in ranks}) == 1,
        "K7 launches as predicted": all(r["on"]["k7"] == want
                                        for r in ranks),
        "no launch with the kernels off": all(r["off_launches"] == 0
                                              for r in ranks),
        "ranks bit-identical every step": all(
            r["on"]["digests"] == r0["on"]["digests"] for r in ranks),
        "ranks' losses equal": all(r["on"]["losses"] == losses
                                   for r in ranks),
        "kernels off: losses": all(r["off"]["losses"] == r["on"]["losses"]
                                   for r in ranks),
        "kernels off: parameters every step": all(
            r["off"]["digests"] == r["on"]["digests"] for r in ranks),
        "kernels off: per-rank U/V": all(
            r["off"]["uv_digest"] == r["on"]["uv_digest"] for r in ranks),
        "ranks' U/V differ": ranks[0]["on"]["uv_digest"]
        != ranks[1]["on"]["uv_digest"],
        "kernels off: dropout masks": all(
            r["masks_off"] == r["masks_on"] for r in ranks),
        "K8 dropout launches": all(
            r["launches"]["threefry_dropout"] == len(r["masks_on"]) > 0
            for r in ranks),
        f"ranks' masks differ at {r0['site']}": ranks[0]["masks_on"][0]
        != ranks[1]["masks_on"][0],
        "loss finite and falling": bool(np.isfinite(losses).all())
        and losses[-1] < losses[0],
    }
    log(f"[dgc] Transformer-base: {r0['ops']} ops, {r0['n_params']} "
        f"parameters ({r0['n_values']} values), {DGC_RANKS} ranks over "
        f"{r0['backend']} on one card, global batch {DGC_BATCH} x seq "
        f"{DGC_SEQ}; build + startup {r0['build_s']:.2f}s")
    log(f"[dgc] losses {losses}; kernels off {r0['off']['losses']}")
    log(f"[dgc] dropout {0.1}: {len(r0['masks_on'])} masks a rank over "
        f"{DGC_STEPS} steps, kept share {r0['kept']:.5f} / "
        f"{ranks[1]['kept']:.5f}; K8 dropout launches "
        f"{[r['launches']['threefry_dropout'] for r in ranks]}")
    log(f"[dgc] K7 launches per step, rank 0 {r0['on']['k7']} (predicted "
        f"{want}: {r0['k7_per_step']} parameters over one block on the "
        f"sparse steps {sparse_steps}), rank 1 {ranks[1]['on']['k7']}")
    step_ms = float(np.median(r0["on"]["seconds"][1:])) * 1e3
    sparse_ms = float(np.median([r0["on"]["seconds"][i]
                                 for i in sparse_steps[1:]])) * 1e3
    nodrop = r0["nodrop_seconds"]
    log(f"[dgc] without dropout, same call: sparse steps p50 "
        f"{float(np.median(nodrop[1:])) * 1e3:.2f} ms (steps "
        f"{[round(x * 1e3, 2) for x in nodrop]}) against {sparse_ms:.2f} "
        "with it")
    tokens = DGC_BATCH * DGC_SEQ
    log(f"[dgc] step p50 {step_ms:.2f} ms (steps {[round(x * 1e3, 2) for x in r0['on']['seconds']]}; "
        f"kernels off {[round(x * 1e3, 2) for x in r0['off']['seconds']]}), "
        f"sparse steps after the first p50 {sparse_ms:.2f} ms, "
        f"{tokens / step_ms * 1e3:.1f} target tokens/s over both ranks; "
        f"device memory peak per rank "
        f"{[round(r['peak'] / 2**30, 3) for r in ranks]} GiB")
    log(f"[dgc] bytes each rank sent per step (all-gather of index, value "
        f"pairs) {r0['on']['sent']}, all-reduced {r0['on']['reduced']}; the "
        f"dense gradient is {r0['dense_bytes']} bytes")
    log(f"[dgc] checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"dgc phase failed: {checks}; largest "
                             f"parameter differences kernels on/off "
                             f"{sorted(r0['diffs'].items(), key=lambda x: -x[1])[:5]}")
    return r0["launches"]


# -- phase 9 ----------------------------------------------------------------
def _fit_a_line(fluid):
    """examples/fit_a_line.py's program, built with the port's layers."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[-1, 13], dtype="float32")
        y = fluid.data("y", shape=[-1, 1], dtype="float32")
        y_predict = fluid.layers.fc(x, size=1, act=None)
        avg_cost = fluid.layers.mean(
            fluid.layers.square_error_cost(y_predict, y))
        fluid.optimizer.SGD(learning_rate=0.01).minimize(avg_cost)
    return main, startup, avg_cost, y_predict


def _recognize_digits(fluid):
    """examples/recognize_digits.py's program, built with the port's
    layers."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.data("img", shape=[-1, 1, 28, 28], dtype="float32")
        label = fluid.data("label", shape=[-1, 1], dtype="int64")
        c1 = fluid.layers.conv2d(img, num_filters=8, filter_size=5, act="relu")
        p1 = fluid.layers.pool2d(c1, pool_size=2, pool_stride=2)
        c2 = fluid.layers.conv2d(p1, num_filters=16, filter_size=5,
                                 act="relu")
        p2 = fluid.layers.pool2d(c2, pool_size=2, pool_stride=2)
        flat = fluid.layers.reshape(p2, [0, 16 * 4 * 4])
        prediction = fluid.layers.fc(flat, size=10, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(prediction, label))
        acc = fluid.layers.accuracy(prediction, label)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss, acc, prediction


def synthetic_digits(rng, n):
    """examples/recognize_digits.py's blob-per-class images."""
    labels = rng.randint(0, 10, n).astype("int64")
    imgs = rng.randn(n, 1, 28, 28).astype("float32") * 0.1
    for i, c in enumerate(labels):
        r, col = divmod(int(c), 4)
        imgs[i, 0, 4 + r * 7:10 + r * 7, 2 + col * 6:8 + col * 6] += 1.5
    return imgs, labels.reshape(-1, 1)


def phase_book():
    """9a: the two book programs through ``Executor()`` on the card, from
    startups drawn through K8; fit_a_line's loss falls, recognize_digits
    reaches the example's accuracy. Returns the launches and, for phase
    10c/10d, each trained program with its scope, loss, prediction, feed
    names and one batch."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.utils import unique_name

    rng = np.random.RandomState(SEED)
    w_true = rng.randn(13, 1).astype("float32")
    xs = rng.randn(LINE_BATCH * LINE_STEPS, 13).astype("float32")
    ys = xs @ w_true + 0.1 * rng.randn(len(xs), 1).astype("float32")
    digits, labels = synthetic_digits(rng, DIGITS)
    t_phase = time.perf_counter()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with unique_name.guard():
        main, startup, avg_cost, y_predict = _fit_a_line(fluid)
    startup.random_seed = main.random_seed = SEED
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed={"x": xs[i:i + LINE_BATCH],
                                        "y": ys[i:i + LINE_BATCH]},
                            fetch_list=[avg_cost], scope=scope)[0][0])
              for i in range(0, len(xs), LINE_BATCH)]
    line_s = time.perf_counter() - t0
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not (np.isfinite(losses).all() and last < 0.5 * first):
        raise AssertionError(f"fit_a_line did not learn: losses {losses}")
    trained = {"fit_a_line": dict(
        main=main, scope=scope, loss=avg_cost, target=y_predict, feeds=["x"],
        feed={"x": xs[:LINE_BATCH], "y": ys[:LINE_BATCH]})}
    log(f"[book] fit_a_line: {LINE_STEPS} SGD steps of {LINE_BATCH} rows, "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first five "
        f"{first:.4f}, of the last five {last:.4f}), {line_s:.2f}s")

    t0 = time.perf_counter()
    with unique_name.guard():
        main, startup, loss, acc, prediction = _recognize_digits(fluid)
    startup.random_seed = main.random_seed = SEED
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    epochs = []
    for _ in range(DIGITS_EPOCHS):
        accs, ls = [], []
        for i in range(0, DIGITS, DIGITS_BATCH):
            l, a = exe.run(main, feed={"img": digits[i:i + DIGITS_BATCH],
                                       "label": labels[i:i + DIGITS_BATCH]},
                           fetch_list=[loss, acc], scope=scope)
            ls.append(float(l[0]))
            accs.append(float(a[0]))
        epochs.append((float(np.mean(ls)), float(np.mean(accs))))
    torch.cuda.synchronize()
    digits_s = time.perf_counter() - t0
    launches = kernels.launches()
    log(f"[book] phase 9a {time.perf_counter() - t_phase:.1f}s")
    if not epochs[-1][1] > DIGITS_ACC:
        raise AssertionError(f"recognize_digits did not learn the digit "
                             f"blobs: (loss, accuracy) by epoch {epochs}")
    if not launches["threefry_random_bits"]:
        raise AssertionError(f"the startups drew nothing through K8: "
                             f"{launches}")
    log(f"[book] recognize_digits: {DIGITS_EPOCHS} epochs of {DIGITS} digits "
        f"at batch {DIGITS_BATCH}, (loss, accuracy) by epoch "
        f"{[(round(l, 4), round(a, 4)) for l, a in epochs]}, {digits_s:.2f}s; "
        f"launches {launches}")
    trained["recognize_digits"] = dict(
        main=main, scope=scope, loss=loss, target=prediction, feeds=["img"],
        feed={"img": digits[:DIGITS_BATCH], "label": labels[:DIGITS_BATCH]})
    return launches, trained


def _conv_flops(program, batch):
    """Forward multiply-adds x 2 of the program's conv2d and mul ops at
    ``batch`` (from the shapes the layers inferred)."""
    block = program.global_block()
    total = 0
    for op in block.ops:
        if op.type == "conv2d":
            w = block.vars[op.input("Filter")[0]].shape
            out = block.vars[op.output("Output")[0]].shape
            total += 2 * batch * int(np.prod(out[1:])) * int(np.prod(w[1:]))
        elif op.type == "mul":
            w = block.vars[op.input("Y")[0]].shape
            total += 2 * batch * int(np.prod(w))
    return total


def _resnet_batch(rng, n):
    """bench.py:363-367's batch: standard normal images, uniform labels."""
    return {"img": rng.randn(n, *RESNET_IMAGE).astype("float32"),
            "label": rng.randint(0, 1000, (n, 1)).astype("int64")}


def _rel_errors(got, want):
    """{name: max |got - want| / max |want|} over two {name: array}."""
    return {n: float(np.abs(np.asarray(got[n]) - w).max()
                     / max(float(np.abs(w).max()), 1e-30))
            for n, w in want.items()}


def _resnet_step(fluid, main, state, batch, dtype, place, fetch, stats):
    """One step of ``main`` from ``state`` on ``batch``, every float cast
    to ``dtype``, through a fresh ``Executor(place)`` (the card for
    None): the fetches and the moving statistics after the step, as
    numpy. Tensors go in as they are, so float64 stays float64."""
    import torch

    def tensor(a):
        a = np.asarray(a)
        return torch.from_numpy(a.astype(dtype) if a.dtype.kind == "f"
                                else a.copy())

    exe, scope = fluid.Executor(place=place), fluid.Scope()
    for name, a in state.items():
        scope.set(name, tensor(a))
    out = exe.run(main, feed={k: tensor(v) for k, v in batch.items()},
                  fetch_list=fetch, scope=scope)
    return out, {n: scope.find_var(n).cpu().numpy() for n in stats}


def _check_resnet_step(gpu, cpu, grads, stats, dtype, seconds):
    """9b's comparison of one step on the card and on the CPU: logs the
    largest error by layer, returns what broke a bar."""
    (g_loss, *g_grads), g_stats = gpu
    (c_loss, *c_grads), c_stats = cpu
    f32 = dtype == np.float32
    loss_tol, stat_tol, grad_tol = RESNET_F32_TOLS if f32 else RESNET_F64_TOLS
    loss_err = abs(float(g_loss[0]) - float(c_loss[0])) / abs(float(c_loss[0]))
    stat_err = _rel_errors(g_stats, c_stats)
    grad_max = _rel_errors(dict(zip(grads, g_grads)), dict(zip(grads, c_grads)))
    grad_norm = {n: float(np.linalg.norm(g - c) / max(np.linalg.norm(c), 1e-300))
                 for n, g, c in zip(grads, g_grads, c_grads)}
    # float32 grads are held in norm (a ReLU whose input lies within
    # rounding of 0 on one side flips its mask), float64 ones elementwise
    grad_err = grad_norm if f32 else grad_max

    def by_layer(errs):
        layers = {}
        for name, e in errs.items():
            layer = name.split("@")[0]
            for suffix in ("_weights", "_bn_scale", "_bn_offset", "_bn_mean",
                           "_bn_variance"):
                layer = layer.removesuffix(suffix)
            layers[layer] = max(layers.get(layer, 0.0), e)
        return {k: float(f"{v:.2e}") for k, v in layers.items()}

    kind = "float32" if f32 else "float64"
    log(f"[resnet] 9b {kind}: one step at batch {RESNET_CHECK_BATCH}, card "
        f"against the host's CPU ({seconds:.2f}s for both): loss "
        f"{float(g_loss[0]):.9g} against {float(c_loss[0]):.9g} (rel "
        f"{loss_err:.3e}, bar {loss_tol}); moving statistics, largest error "
        f"{max(stat_err.values()):.3e} of the largest value (bar {stat_tol}); "
        f"grads, largest error {max(grad_err.values()):.3e} "
        + ("in norm" if f32 else "of the largest value") + f" (bar {grad_tol})")
    log(f"[resnet] 9b {kind} grads by layer "
        + ("(norm): " if f32 else "(elementwise): ") + str(by_layer(grad_err)))
    if f32:
        log(f"[resnet] 9b float32 grads by layer, elementwise (not held): "
            f"{by_layer(grad_max)}")
    log(f"[resnet] 9b {kind} moving statistics by layer: {by_layer(stat_err)}")
    bad = [f"{kind} loss rel {loss_err:.3e}"] if not loss_err <= loss_tol else []
    bad += [f"{kind} {n} {e:.3e}" for n, e in stat_err.items()
            if not e <= stat_tol]
    bad += [f"{kind} {n} {e:.3e}" for n, e in grad_err.items()
            if not e <= grad_tol]
    return bad


def _profile(tag, run):
    """Runs ``run()`` under ``torch.profiler``: (the profile, device busy
    us (the union of the card's kernel and copy intervals), wall us (the
    profiler's own host cost in), ``run()``'s result). Raises when the
    profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    from torch_decode_profile import _busy_us

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = _busy_us(prof.events(), DeviceType.CUDA)
    if not busy_us:
        raise AssertionError(f"{tag}: the profiler saw no device activity")
    return prof, busy_us, wall_us, result


def _profiled_steps(tag, steps, step):
    """Runs ``step()`` (one training step, returning its loss as a float)
    ``steps`` times under ``torch.profiler`` and logs, a step: the wall
    time, device busy and the idle share (``_profile``), the top aten ops
    by device time and the top kernels. Returns the losses."""
    from torch.autograd import DeviceType

    prof, busy_us, wall_us, losses = _profile(
        tag, lambda: [step() for _ in range(steps)])
    log(f"{tag} profile of {steps} steps: wall {wall_us / steps / 1e3:.2f} "
        f"ms a step (the profiler's own host cost in), device busy "
        f"{busy_us / steps / 1e3:.2f} ms a step, idle share "
        f"{1 - busy_us / wall_us:.4f}")

    def device_us(evt):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, attr):
                return getattr(evt, attr)
        return 0.0

    ops = sorted(((e.key, device_us(e), e.count) for e in prof.key_averages()
                  if e.key.startswith("aten::") and device_us(e) > 0),
                 key=lambda r: -r[1])
    for key, us, count in ops[:12]:
        log(f"{tag}   op {key[:48]:48s} {us / steps / 1e3:9.3f} ms a step "
            f"({count / steps:.0f} calls)")
    kernel_us = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernel_us[e.name] = (kernel_us.get(e.name, 0.0)
                                 + e.time_range.end - e.time_range.start)
    for name, us in sorted(kernel_us.items(), key=lambda kv: -kv[1])[:8]:
        log(f"{tag}   kernel {us / steps / 1e3:9.3f} ms a step  {name[:90]}")
    return losses


def phase_resnet():
    """9b and 9c: ResNet-50 through ``Executor()`` on the card. 9b: one
    step at batch 8 against the same step on the host's CPU from the card
    startup's weights. 9c: the bench's batch of 128, warm-up and timed
    steps, a profiled window, and the inference clone on the trained
    scope."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.convert import load_params, persistables_to_numpy
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.utils import unique_name

    with unique_name.guard():
        main, startup, _, (loss, _acc) = resnet.build_resnet_train(
            depth=50, class_dim=1000, image_shape=RESNET_IMAGE, lr=0.1)
    startup.random_seed = main.random_seed = SEED
    params = [p.name for p in main.all_parameters() if p.trainable]
    grads = [p + "@GRAD" for p in params]
    stats = [p.name for p in main.all_parameters() if not p.trainable]
    n_ops = len(main.global_block().ops)
    fwd_flops = _conv_flops(main, RESNET_BATCH)
    exe, scope = fluid.Executor(), fluid.Scope()
    kernels.reset_launches()
    t0 = t_phase = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_launches = kernels.launches()
    state0 = persistables_to_numpy(scope, main)
    log(f"[resnet] ResNet-50 float32: {n_ops} ops a step, {len(params)} "
        f"trainable parameters "
        f"({sum(state0[p].size for p in params)} values), {len(stats)} "
        f"moving statistics; startup {time.perf_counter() - t0:.2f}s, K8 "
        f"random_bits launches {startup_launches['threefry_random_bits']}")
    if not startup_launches["threefry_random_bits"]:
        raise AssertionError("the ResNet-50 startup drew nothing through K8")

    # 9b: the card against the host's CPU, one step at batch 8, in
    # float32 and in float64
    check = _resnet_batch(np.random.RandomState(SEED + 1), RESNET_CHECK_BATCH)
    failures, runs = [], {}
    for dtype in (np.float32, np.float64):
        t0 = time.perf_counter()
        runs[dtype] = [_resnet_step(fluid, main, state0, check, dtype, place,
                                    [loss.name] + grads, stats)
                       for place in (None, fluid.CPUPlace())]
        seconds = time.perf_counter() - t0
        failures += _check_resnet_step(*runs[dtype], grads, stats, dtype,
                                       seconds)
    # float32's own error, against the float64 step on the same device:
    # the card's may not exceed RESNET_F32_ACCURACY times the CPU's
    f32_err = []
    for device in (0, 1):
        lo = runs[np.float32][device][0][1:]
        hi = runs[np.float64][device][0][1:]
        f32_err.append(float(np.sqrt(sum(np.sum((a - b) ** 2)
                                         for a, b in zip(lo, hi))
                                     / sum(np.sum(b ** 2) for b in hi))))
    log(f"[resnet] 9b float32 grads against float64 on the same device, in "
        f"norm over all grads: card {f32_err[0]:.3e}, CPU {f32_err[1]:.3e} "
        f"(bar: the card's at most {RESNET_F32_ACCURACY}x the CPU's)")
    if not f32_err[0] <= RESNET_F32_ACCURACY * f32_err[1]:
        failures.append(f"float32 grads on the card {f32_err[0]:.3e} from "
                        f"float64, the CPU's {f32_err[1]:.3e}")
    del runs

    # 9c: throughput at batch 128 from the startup's weights
    load_params(scope, state0)
    batch = _resnet_batch(np.random.RandomState(SEED), RESNET_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    losses, seconds = [], []
    for _ in range(RESNET_WARMUP + RESNET_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=batch, fetch_list=[loss], scope=scope)
        losses.append(float(out[0][0]))
        seconds.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    timed = np.asarray(seconds[RESNET_WARMUP:]) * 1e3
    p50, p90 = float(np.median(timed)), float(np.percentile(timed, 90))
    # forward, the grads' rerun forward, dX and dW: about 4x the forward
    flops = 4 * fwd_flops
    log(f"[resnet] 9c: batch {RESNET_BATCH}, step p50 "
        f"{p50:.2f} ms, p90 {p90:.2f} (timed {np.round(timed, 2).tolist()}, "
        f"warm-up {[round(t * 1e3, 2) for t in seconds[:RESNET_WARMUP]]}), "
        f"{RESNET_BATCH / p50 * 1e3:.1f} images/s; device memory peak "
        f"{peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB held before the "
        f"steps); conv and fc work {flops / 1e12:.3f} TFLOP a step "
        f"(forward {fwd_flops / 1e12:.3f}, about x4 with the grads' rerun), "
        f"{flops / p50 / 1e9:.1f} TFLOP/s over the step")

    losses += _profiled_steps(
        "[resnet] 9c", RESNET_PROFILED,
        lambda: float(exe.run(main, feed=batch, fetch_list=[loss],
                              scope=scope)[0][0]))
    # lr 0.1 with momentum 0.9 and no warm-up overshoots on one fixed batch
    # (the loss climbs for a few steps, then falls): the loss must stay
    # finite and end below its peak, which a diverging run never does
    if not (np.isfinite(losses).all() and losses[-1] < max(losses)):
        raise AssertionError(f"ResNet-50 loss did not fall on its fixed "
                             f"batch: {losses}")
    log(f"[resnet] 9c losses over the {len(losses)} steps {losses}")

    with unique_name.guard():
        infer, _, _, (prob,) = resnet.build_resnet_infer(
            depth=50, class_dim=1000, image_shape=RESNET_IMAGE)
    rows = min(16, RESNET_BATCH)
    (probs,) = exe.run(infer, feed={"img": batch["img"][:rows]},
                       fetch_list=[prob], scope=scope)
    sums = probs.sum(axis=1)
    if probs.shape != (rows, 1000) or not np.isfinite(probs).all() or \
            not np.allclose(sums, 1.0, atol=1e-5):
        raise AssertionError(f"the inference clone's softmax rows: shape "
                             f"{probs.shape}, sums {sums}")
    launches = kernels.launches()
    log(f"[resnet] phases 9b and 9c {time.perf_counter() - t_phase:.1f}s")
    if failures:
        raise AssertionError("ResNet-50 step, card against the host's CPU: "
                             + "; ".join(failures))
    log(f"[resnet] inference clone (for_test: BN on the moving statistics) "
        f"on the trained scope: {rows} rows of 1000 summing to 1 within "
        f"{float(np.abs(sums - 1).max()):.2e}; launches over the phase "
        f"{launches}")
    return launches


def phase_resnet_amp():
    """Phase 9d: ResNet-50 under bf16 AMP as ``bench.py:344-367`` trains it
    (BASELINE workload 2, ``use_amp=True``): one step at batch 8 on the
    card against the host's CPU (the loss, the grads nearest the loss and
    every L2 decay term, with planted faults that the check must catch);
    then the bench's batch of 128, warm-up, timed and profiled steps."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.convert import load_params, persistables_to_numpy
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.utils import unique_name

    with unique_name.guard():
        main, startup, _, (loss, _acc) = resnet.build_resnet_train(
            depth=50, class_dim=1000, image_shape=RESNET_IMAGE, lr=0.1,
            use_amp=True)
    startup.random_seed = main.random_seed = SEED
    params = [p.name for p in main.all_parameters() if p.trainable]
    grads = [p + "@GRAD" for p in params]
    velocities = [p + "_velocity_0" for p in params]
    ops = [op.type for op in main.global_block().ops]
    fwd_flops = _conv_flops(main, RESNET_BATCH)
    exe, scope = fluid.Executor(), fluid.Scope()
    t_phase = time.perf_counter()
    kernels.reset_launches()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    state0 = persistables_to_numpy(scope, main)
    log(f"[resnet-amp] ResNet-50 bf16 AMP: {len(ops)} ops a step "
        f"({ops.count('cast')} casts, {ops.count('cast_grad')} cast grads)")

    # one step at batch 8 from the same state: the card against the
    # host's CPU, both bf16 AMP
    check = _resnet_batch(np.random.RandomState(SEED + 1), RESNET_CHECK_BATCH)
    steps, seconds = {}, {}
    for device, place in (("card", None), ("cpu", fluid.CPUPlace())):
        t0 = time.perf_counter()
        (out_loss, *out_grads), after = _resnet_step(
            fluid, main, state0, check, np.float32, place,
            [loss.name] + grads, velocities)
        seconds[device] = round(time.perf_counter() - t0, 2)
        g = {n: a.astype(np.float64) for n, a in zip(params, out_grads)}
        v = {n: after[vel].astype(np.float64)
             for n, vel in zip(params, velocities)}
        steps[device] = (float(out_loss[0]), g, v)
    if any(state0[v].any() for v in velocities):
        raise AssertionError("phase 9d: a velocity was not zero at startup")

    def norm_gap(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))

    def decay_off(g, v):
        """{param: the largest |velocity - grad - RESNET_L2 x weight| over
        float32's rounding of the velocity and the product}."""
        out = {}
        for n in params:
            decay = RESNET_L2 * state0[n].astype(np.float64)
            out[n] = float(np.max(np.abs(v[n] - g[n] - decay)
                                  / (2.0 ** -22 * (np.abs(v[n]) + np.abs(decay))
                                     + 1e-45)))
        return out

    def broken(card, cpu):
        """What of the card's step breaks a bar against the CPU's or, for
        the decay terms, against their definition."""
        (c_loss, c_g, c_v), (h_loss, h_g, _) = card, cpu
        loss_err = abs(c_loss - h_loss) / abs(h_loss)
        bad = [f"loss rel {loss_err:.3e}"] \
            if not loss_err <= RESNET_AMP_LOSS_TOL else []
        bad += [f"{n}@GRAD {norm_gap(c_g[n], h_g[n]):.3e} in norm"
                for n, tol in RESNET_AMP_GRAD_TOLS.items()
                if not norm_gap(c_g[n], h_g[n]) <= tol]
        bad += [f"{n} decay {e:.3g}x its rounding"
                for n, e in decay_off(c_g, c_v).items() if not e <= 1]
        return bad

    card, cpu = steps["card"], steps["cpu"]
    near = {n: norm_gap(card[1][n], cpu[1][n]) for n in RESNET_AMP_NEAR_LOSS}
    decay = {d: max(decay_off(*steps[d][1:]).values()) for d in steps}
    stages = {}
    for n in params:
        stage = n[:4] if n[3].isdigit() else n.split("_")[0]
        stages.setdefault(stage, []).append(norm_gap(card[1][n], cpu[1][n]))
    log(f"[resnet-amp] 9d one step at batch {RESNET_CHECK_BATCH}, card "
        f"against the host's CPU, both bf16 AMP: loss {card[0]:.7g} against "
        f"{cpu[0]:.7g} (rel {abs(card[0] - cpu[0]) / abs(cpu[0]):.3e}, bar "
        f"{RESNET_AMP_LOSS_TOL}); grads nearest the loss in norm "
        f"{ {n: float(f'{e:.3e}') for n, e in near.items()} } (bars "
        f"{RESNET_AMP_GRAD_TOLS}); L2 decay terms against {RESNET_L2} x the "
        f"weights, the largest error in units of the float32 rounding bar: "
        f"{ {d: float(f'{e:.3g}') for d, e in decay.items()} } (bar 1); "
        f"seconds {seconds}")
    log(f"[resnet-amp] 9d grads in norm by stage, median and largest (not "
        f"held): { {k: (float(f'{np.median(v):.3e}'), float(f'{max(v):.3e}')) for k, v in stages.items()} }")
    failures = broken(card, cpu)
    if not decay["cpu"] <= 1:
        failures.append(f"the CPU's decay terms {decay['cpu']:.3g}x their bar")
    # the check must catch planted faults in the card's step: a wrong grad
    # (its velocity, grad plus decay, moved with it) or a wrong decay term
    def wrong_grads(g, v, f):
        return ({n: f(a) for n, a in g.items()},
                {n: v[n] - g[n] + f(g[n]) for n in g})

    planted = {
        "grads zeroed": lambda g, v: wrong_grads(g, v, lambda a: 0 * a),
        "grads doubled": lambda g, v: wrong_grads(g, v, lambda a: 2 * a),
        "grads scrambled": lambda g, v: wrong_grads(
            g, v, lambda a: a.ravel()[::-1].reshape(a.shape)),
        "decay dropped": lambda g, v: (g, {n: g[n] for n in g}),
        "decay doubled": lambda g, v: (g, {n: 2 * v[n] - g[n] for n in g}),
    }
    caught = {k: len(broken((card[0], *fault(card[1], card[2])), cpu))
              for k, fault in planted.items()}
    log(f"[resnet-amp] 9d planted faults, bars each breaks: {caught}")
    failures += [f"the check passed a planted fault: {k}"
                 for k, n in caught.items() if not n]
    del steps, card, cpu

    # the bench's batch of 128 from the startup's weights
    load_params(scope, state0)
    batch = _resnet_batch(np.random.RandomState(SEED), RESNET_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    losses, seconds = [], []
    for _ in range(RESNET_WARMUP + RESNET_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=batch, fetch_list=[loss], scope=scope)
        losses.append(float(out[0][0]))
        seconds.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    timed = np.asarray(seconds[RESNET_WARMUP:]) * 1e3
    p50, p90 = float(np.median(timed)), float(np.percentile(timed, 90))
    flops = 4 * fwd_flops
    log(f"[resnet-amp] 9d: batch {RESNET_BATCH}, step p50 {p50:.2f} ms, p90 "
        f"{p90:.2f} (timed {np.round(timed, 2).tolist()}, warm-up "
        f"{[round(t * 1e3, 2) for t in seconds[:RESNET_WARMUP]]}), "
        f"{RESNET_BATCH / p50 * 1e3:.1f} images/s; device memory peak "
        f"{peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB held before the "
        f"steps); conv and fc work {flops / 1e12:.3f} TFLOP a step, "
        f"{flops / p50 / 1e9:.1f} TFLOP/s over the step")
    losses += _profiled_steps(
        "[resnet-amp] 9d", RESNET_PROFILED,
        lambda: float(exe.run(main, feed=batch, fetch_list=[loss],
                              scope=scope)[0][0]))
    log(f"[resnet-amp] 9d losses over the {len(losses)} steps {losses}")
    if not (np.isfinite(losses).all() and losses[-1] < max(losses)):
        failures.append(f"the loss did not fall on its fixed batch: {losses}")
    launches = kernels.launches()
    log(f"[resnet-amp] phase 9d {time.perf_counter() - t_phase:.1f}s; "
        f"launches {launches}")
    if failures:
        raise AssertionError("phase 9d failed: " + "; ".join(failures))
    return launches


# -- phase 10 ---------------------------------------------------------------
def _gbps(n_bytes, seconds):
    return n_bytes / seconds / 1e9 if seconds > 0 else float("inf")


def _split(timings, keys):
    return ", ".join(f"{k[:-2]} {timings.get(k, 0.0):.3f}" for k in keys)


SAVE_KEYS = ("serialize_s", "crc_s", "write_s", "fsync_s")
RESTORE_KEYS = ("read_s", "file_crc_s", "parse_s", "array_crc_s", "upload_s")


def _continue_bert(fluid, main, batch, loss, scope, names):
    """One step of ``main`` on ``scope`` by a fresh executor (its run
    counter, and so its dropout keys, start where every other fresh
    executor's do): the loss and every persistable after it."""
    exe = fluid.Executor()
    out = exe.run(main, feed=batch, fetch_list=[loss], scope=scope)
    return float(out[0].reshape(-1)[0]), {n: scope.find_var(n) for n in names}


def _max_abs(a, b):
    import torch

    if a.dtype.is_floating_point:
        return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
    return 0.0 if torch.equal(a, b) else float("inf")


def _ckpt_bert(ckdir):
    """10a: BERT-base saved after CKPT_STEPS steps, restored into a fresh
    scope with no startup run, continued by fresh executors: the restored
    state bit-equal to the saved one, the continued step to the
    in-memory continuation; then an async save while training goes on."""
    import warnings

    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.convert import load_params
    from paddle_tpu_torch.incubate.checkpoint import AutoCheckpoint
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base()
    cfg.use_flash_attention = True
    cfg.hidden_dropout_prob = TRAIN_DROPOUT
    cfg.attention_probs_dropout_prob = 0.0
    main, startup, _, fetches = bert.build_bert_pretrain(
        cfg, seq_len=TRAIN_SEQ, lr=TRAIN_LR, max_predictions_per_seq=TRAIN_P)
    startup.random_seed = main.random_seed = SEED
    loss = fetches[0]
    batch = bert.synthetic_batch(np.random.RandomState(SEED), TRAIN_BATCH,
                                 TRAIN_SEQ, cfg, TRAIN_P)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    load_params(scope, {COUNTER: np.full([1], WARMED_UP, np.float32)})
    losses = [float(exe.run(main, feed=batch, fetch_list=[loss],
                            scope=scope)[0][0]) for _ in range(CKPT_STEPS)]
    names = [v.name for v in main.global_block().vars.values()
             if v.persistable and scope.find_var(v.name) is not None]
    n_bytes = sum(scope.find_var(n).numel() * scope.find_var(n).element_size()
                  for n in names)

    ck = AutoCheckpoint(exe, main, ckdir, scope=scope)
    ck.save(CKPT_STEPS - 1, blocking=True)
    st = dict(ck.save_timings)
    writer = sum(st[k] for k in SAVE_KEYS)
    log(f"[ckpt] 10a BERT-base: {len(names)} persistables, {n_bytes} bytes on "
        f"the card, losses {losses}; blocking save {st['snapshot_s'] + writer:.3f}s "
        f"for {st['bytes']} bytes in state.npz "
        f"({_gbps(st['bytes'], st['snapshot_s'] + writer):.3f} GB/s): snapshot "
        f"{st['snapshot_s']:.3f} ({_gbps(n_bytes, st['snapshot_s']):.3f} GB/s "
        f"card to pinned host), {_split(st, SAVE_KEYS)}")

    # a second copy of the in-memory state, on the card
    mem = fluid.Scope()
    for n in names:
        mem.set(n, scope.find_var(n).clone())
    back = fluid.Scope()
    ck_back = AutoCheckpoint(fluid.Executor(), main, ckdir, scope=back)
    at = ck_back.resume()
    rt = dict(ck_back.restore_timings)
    restore = sum(rt[k] for k in RESTORE_KEYS)
    if at != CKPT_STEPS:
        raise AssertionError(f"resume() returned {at}, want {CKPT_STEPS}")
    wrong = [n for n in names
             if back.find_var(n) is None
             or back.find_var(n).device != exe.device
             or back.find_var(n).dtype != scope.find_var(n).dtype
             or not torch.equal(back.find_var(n), scope.find_var(n))]
    if wrong:
        raise AssertionError(f"restored persistables differ from the saved "
                             f"scope's: {wrong[:8]} ({len(wrong)})")
    log(f"[ckpt] 10a restore into a fresh scope (no startup run) on the card: "
        f"all {len(names)} persistables bit-equal (torch.equal); "
        f"{restore:.3f}s for {rt['bytes']} bytes "
        f"({_gbps(rt['bytes'], restore):.3f} GB/s): {_split(rt, RESTORE_KEYS)}")

    # three continuations, each by a fresh executor: the saved scope, its
    # in-memory copy (run to run) and the restored scope. Deterministic
    # algorithms where torch has them, so the atomics-summed grads (the
    # embedding's index_select and the masked positions' gather) sum in a
    # fixed order; the warnings name the ops that still have none
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            l_mem, s_mem = _continue_bert(fluid, main, batch, loss, scope, names)
            l_twin, s_twin = _continue_bert(fluid, main, batch, loss, mem, names)
            l_back, s_back = _continue_bert(fluid, main, batch, loss, back, names)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(prev)
    nondet = sorted({str(w.message).split(" does not have")[0][:80]
                     for w in caught if "deterministic" in str(w.message)})
    run_to_run = {n: _max_abs(s_mem[n], s_twin[n]) for n in names}
    moved = {n: d for n, d in run_to_run.items() if d}
    if not moved and l_mem == l_twin:
        bad = [n for n in names if not torch.equal(s_back[n], s_mem[n])]
        if bad or l_back != l_mem:
            raise AssertionError(
                f"the restored continuation differs from the in-memory one: "
                f"loss {l_back!r} vs {l_mem!r}, persistables {bad[:8]} "
                f"({len(bad)})")
        log(f"[ckpt] 10a continued step: two in-memory continuations agree "
            f"bit for bit, and the restored one equals them: loss {l_back!r}, "
            f"all {len(names)} persistables bit-equal")
    else:
        # the run-to-run gap is the bar: twice it, tensor by tensor in
        # relative terms
        rel = max(d / max(float(s_mem[n].abs().max()), 1e-30)
                  for n, d in moved.items()) if moved else 0.0
        bad = {n: _max_abs(s_back[n], s_mem[n]) for n in names}
        bad = {n: d for n, d in bad.items()
               if d > 2 * rel * float(s_mem[n].abs().max())}
        loss_bar = 2 * max(abs(l_twin - l_mem), rel * abs(l_mem))
        log(f"[ckpt] 10a two in-memory continuations differ run to run in "
            f"{len(moved)} persistables (largest relative gap {rel:.3e}; "
            f"{sorted(moved)[:6]}), loss {l_mem!r} vs {l_twin!r}; ops with no "
            f"deterministic path: {nondet}")
        if bad or abs(l_back - l_mem) > loss_bar:
            raise AssertionError(
                f"the restored continuation is further from the in-memory one "
                f"than twice the run-to-run gap: loss {l_back!r} vs {l_mem!r} "
                f"(bar {loss_bar:.3e}), persistables {sorted(bad)[:8]}")
        log(f"[ckpt] 10a restored continuation within twice the run-to-run "
            f"gap: loss {l_back!r}")
    del mem, back, s_twin, s_back

    # an async save while training goes on
    ck_async = AutoCheckpoint(exe, main, ckdir, scope=scope,
                              max_to_keep=CKPT_KEEP)
    t0 = time.perf_counter()
    ck_async.save(CKPT_STEPS)
    stall = time.perf_counter() - t0
    step_s = []
    for _ in range(CKPT_ASYNC_STEPS):
        t0 = time.perf_counter()
        exe.run(main, feed=batch, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    ck_async.close()
    waited = time.perf_counter() - t0
    at = ck_async.save_timings
    log(f"[ckpt] 10a async save: training-thread stall {stall:.3f}s (snapshot "
        f"{at['snapshot_s']:.3f}), writer {sum(at[k] for k in SAVE_KEYS):.3f}s "
        f"({_split(at, SAVE_KEYS)}); {CKPT_ASYNC_STEPS} steps during the write "
        f"{[round(x, 4) for x in step_s]} s, then close() waited {waited:.3f}s")


def _ckpt_wide_deep(ckdir):
    """10b: Wide&Deep (phase 6's config) checkpointed with the engine as
    extra state every WD_CKPT_INTERVAL steps (format 2, per-shard CRCs);
    a fresh engine and scope resume, and a probe batch's predictions are
    bit-equal to the trained engine's, K5 re-admitting the rows."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.embedding import EmbeddingEngine
    from paddle_tpu_torch.incubate.checkpoint import AutoCheckpoint
    from paddle_tpu_torch.models import wide_deep as wd
    from paddle_tpu_torch.utils import unique_name

    records = _click_records()
    with unique_name.guard():
        main, startup, feeds, (loss, pred) = wd.build_programs(
            capacity=WD_CAPACITY)
    startup.random_seed = SEED
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    engine = EmbeddingEngine(scope=scope)
    ck = AutoCheckpoint(exe, main, ckdir, save_interval_steps=WD_CKPT_INTERVAL,
                        scope=scope, extra_state=engine)
    saves = []
    for i in range(WD_STEPS):
        feed = engine.prepare_feed(main, wd.make_batch(
            records[i * WD_BATCH:(i + 1) * WD_BATCH], feeds))
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        t0 = time.perf_counter()
        if ck.maybe_save(i):
            saves.append((i, time.perf_counter() - t0))
    ck.close()
    tables = sorted(engine.tables)
    for i, _ in saves:
        with open(os.path.join(ckdir, f"ckpt_{i}", "manifest.json")) as f:
            man = json.load(f)
        sharded = man.get("sharded", {})
        want = {f"__embedding_store__::{t}::{k}" for t in tables
                for k in ("ids", "rows")}
        if (man["format"] != 2 or set(sharded) != want or not all(
                len(e["shards"]) == wd.EP and all("crc32" in sh
                                                  for sh in e["shards"])
                for e in sharded.values())):
            raise AssertionError(f"ckpt_{i}: not a format-2 manifest with "
                                 f"{wd.EP} CRC'd shards per store array")
    probe = wd.make_batch(list(wd.click_log(WD_BATCH, seed=9)), feeds)
    feed = engine.prepare_feed(main, dict(probe), train=False)
    before = exe.run(main, feed=feed, fetch_list=[pred], scope=scope,
                     return_numpy=False)[0]
    engine.close()

    scope2 = fluid.Scope()
    engine2 = EmbeddingEngine(scope=scope2)
    exe2 = fluid.Executor()
    ck2 = AutoCheckpoint(exe2, main, ckdir, scope=scope2, extra_state=engine2)
    at = ck2.resume()
    k5 = kernels.launches("embedding_admission")
    feed = engine2.prepare_feed(main, dict(probe), train=False)
    readmit = kernels.launches("embedding_admission") - k5
    after = exe2.run(main, feed=feed, fetch_list=[pred], scope=scope2,
                     return_numpy=False)[0]
    engine2.close()
    import torch

    if at != WD_STEPS or not torch.equal(before, after):
        raise AssertionError(f"Wide&Deep resume: step {at}, predictions "
                             f"bit-equal {torch.equal(before, after)}")
    if readmit != len(tables):
        raise AssertionError(f"K5 launched {readmit} times re-admitting "
                             f"{len(tables)} tables")
    rt = ck2.restore_timings
    log(f"[ckpt] 10b Wide&Deep: saves at steps {[i for i, _ in saves]} "
        f"(format 2, {wd.EP} CRC'd shards per store array; training-thread "
        f"stall {[round(s, 4) for _, s in saves]} s, last write "
        f"{_split(ck.save_timings, SAVE_KEYS)}, {ck.save_timings['bytes']} "
        f"bytes); resume() -> {at} in {sum(rt[k] for k in RESTORE_KEYS):.3f}s; "
        f"the probe's {before.numel()} predictions bit-equal; K5 re-admitted "
        f"{len(tables)} tables in {readmit} launches")


def _ckpt_export(book, root):
    """10c: each book program exported with ``save_inference_model`` and
    loaded into a fresh scope on the card predicts bit-equal to the
    trained program's ``clone(for_test=True)``; one ``save_persistables``
    (separate files) and one ``save`` round trip, each bit-equal."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io

    for name, t in book.items():
        d = os.path.join(root, name)
        exe = fluid.Executor()
        persist = [v.name for v in t["main"].global_block().vars.values()
                   if v.persistable and not v.is_data]
        with fluid.scope_guard(t["scope"]):
            want = exe.run(t["main"].clone(for_test=True), feed=t["feed"],
                           fetch_list=[t["target"]], return_numpy=False)[0]
            io.save_inference_model(os.path.join(d, "infer"), t["feeds"],
                                    [t["target"]], exe, main_program=t["main"])
            io.save_persistables(exe, os.path.join(d, "persist"), t["main"])
            io.save(t["main"], os.path.join(d, "model"))
        fresh = fluid.Scope()
        with fluid.scope_guard(fresh):
            program, feed_names, fetch_vars = io.load_inference_model(
                os.path.join(d, "infer"), exe)
            got = exe.run(program, feed={n: t["feed"][n] for n in feed_names},
                          fetch_list=fetch_vars, return_numpy=False)[0]
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: the exported model predicts "
                                 f"{float((got - want).abs().max()):.3e} away")
        checks = {}
        for how in ("persist", "model"):
            s = fluid.Scope()
            with fluid.scope_guard(s):
                if how == "persist":
                    io.load_persistables(exe, os.path.join(d, how), t["main"])
                else:
                    io.load(t["main"], os.path.join(d, how), exe)
            checks[how] = [n for n in persist if not (
                s.find_var(n).device == exe.device
                and torch.equal(s.find_var(n), t["scope"].find_var(n)))]
        if any(checks.values()):
            raise AssertionError(f"{name}: round trips differ: {checks}")
        log(f"[ckpt] 10c {name}: {len(program.global_block().ops)} ops "
            f"exported, {got.numel()} predictions bit-equal on the card; "
            f"save_persistables and save/load round trips of {len(persist)} "
            f"persistables bit-equal")


def _ckpt_recovery(book, ckdir):
    """10d: fit_a_line checkpointed three times with max_to_keep=2; a
    corrupt newest state.npz is walked past and quarantined; checkpoint.io
    raising twice still commits; a pinned step on a corrupt entry raises."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.incubate.checkpoint import (AutoCheckpoint,
                                                      CheckpointCorruptError)
    from paddle_tpu_torch.resilience import faults

    t = book["fit_a_line"]
    main, scope = t["main"], t["scope"]
    exe = fluid.Executor()
    persist = [v.name for v in main.global_block().vars.values()
               if v.persistable]
    ck = AutoCheckpoint(exe, main, ckdir, max_to_keep=CKPT_KEEP, scope=scope)
    states = []
    for step in range(3):
        exe.run(main, feed=t["feed"], fetch_list=[t["loss"]], scope=scope)
        ck.save(step, blocking=True)
        states.append({n: scope.find_var(n).clone() for n in persist})
    kept = sorted(d for d in os.listdir(ckdir) if d.startswith("ckpt_"))
    if kept != ["ckpt_1", "ckpt_2"]:
        raise AssertionError(f"max_to_keep=2 kept {kept}")
    faults.corrupt_file(os.path.join(ckdir, "ckpt_2", "state.npz"))
    back = fluid.Scope()
    at = AutoCheckpoint(exe, main, ckdir, scope=back).resume()
    if (at != 2 or not os.path.isdir(os.path.join(ckdir, "ckpt_2.corrupt"))
            or not all(torch.equal(back.find_var(n), states[1][n])
                       for n in persist)):
        raise AssertionError(f"walk-back: resume() -> {at}, "
                             f"{sorted(os.listdir(ckdir))}")
    try:
        faults.configure([{"site": "checkpoint.io", "action": "raise",
                           "times": 2}])
        ck.save(3, blocking=True)
        fired = sum(r["fired"] for r in
                    faults.get_injector().rule_stats().values())
    finally:
        faults.reset()
    with open(os.path.join(ckdir, "latest")) as f:
        latest = f.read()
    if fired != 2 or latest != "ckpt_3":
        raise AssertionError(f"checkpoint.io fired {fired}, latest {latest}")
    faults.corrupt_file(os.path.join(ckdir, "ckpt_3", "state.npz"))
    try:
        AutoCheckpoint(exe, main, ckdir, scope=fluid.Scope()).resume(step=3)
    except CheckpointCorruptError as e:
        pinned = str(e)
    else:
        raise AssertionError("a pinned corrupt step was restored")
    log(f"[ckpt] 10d recovery: kept {kept}; the corrupt ckpt_2 quarantined, "
        f"resume() walked back to step {at - 1} bit-equal; checkpoint.io "
        f"raised {fired} times and ckpt_3 committed; pinned step 3: "
        f"{pinned[:120]}")


def phase_checkpoint(book):
    """10: checkpoints and model io on the card (10a-10d). Returns the
    launches of 10a and 10b (counters zeroed before each, read after)."""
    import torch

    from paddle_tpu_torch import kernels

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        kernels.reset_launches()
        _ckpt_bert(os.path.join(root, "bert"))
        bert = kernels.launches()
        log(f"[ckpt] 10a {time.perf_counter() - t0:.1f}s, launches {bert}")
        if not all(bert[n] for n in ("flash_attention_fwd",
                                     "flash_attention_bwd_dkdv",
                                     "flash_attention_bwd_dq",
                                     "threefry_dropout",
                                     "threefry_random_bits")):
            raise AssertionError(f"10a: a kernel of the path never launched: "
                                 f"{bert}")
        t0 = time.perf_counter()
        kernels.reset_launches()
        _ckpt_wide_deep(os.path.join(root, "wide_deep"))
        wide = kernels.launches()
        log(f"[ckpt] 10b {time.perf_counter() - t0:.1f}s, launches {wide}")
        t0 = time.perf_counter()
        _ckpt_export(book, os.path.join(root, "export"))
        _ckpt_recovery(book, os.path.join(root, "recovery"))
        log(f"[ckpt] 10c-10d {time.perf_counter() - t0:.1f}s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[ckpt] phase 10 {time.perf_counter() - t_phase:.1f}s")
    return {n: bert[n] + wide[n] for n in bert}


# -- phase 11 ---------------------------------------------------------------
class _Launches:
    """Kernel launches summed over a phase's legs: ``take()`` returns the
    launches since the last take and adds them to ``total``."""

    def __init__(self):
        from paddle_tpu_torch import kernels

        self._kernels = kernels
        self.total = {}
        kernels.reset_launches()

    def take(self):
        now = self._kernels.launches()
        self._kernels.reset_launches()
        for n, c in now.items():
            self.total[n] = self.total.get(n, 0) + c
        return now


def _bert_feeds(rng, rows, vocab, lens):
    """``rows`` BERT requests: random ids and segments, the mask covering
    each row's real length (``lens[i]``; 0 is a padded row, every key
    masked). Ids keep clear of the poison marker's pair."""
    ids = rng.randint(0, vocab, (rows, INFER_SEQ)).astype("int64")
    ids[:, 0] = np.where(ids[:, 0] == POISON_ID, POISON_ID + 1, ids[:, 0])
    return {"input_ids": ids,
            "token_type_ids": rng.randint(0, 2, (rows, INFER_SEQ)).astype(
                "int64"),
            "input_mask": (np.arange(INFER_SEQ)[None, :]
                           < np.asarray(lens)[:, None]).astype("int64")}


def _pcts_ms(seconds):
    ms = np.asarray(seconds) * 1e3
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 90))


def _timed_calls(pred, feed, reps):
    """``reps`` calls through the zero-copy handles, each timed on the
    host clock from the inputs' copy in to the outputs' ``copy_to_cpu``."""
    seconds = []
    outs = [pred.get_output_handle(n) for n in pred.get_output_names()]
    for _ in range(reps):
        t0 = time.perf_counter()
        for n in pred.get_input_names():
            pred.get_input_handle(n).copy_from_cpu(feed[n])
        pred.zero_copy_run()
        for h in outs:
            h.copy_to_cpu()
        seconds.append(time.perf_counter() - t0)
    return seconds


def _max_abs_np(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _infer_export_bert(root):
    """BERT-base's encoder (the JAX default: unfused attention, dropouts
    0.1) at seq 128, its startup on the card, exported with
    ``save_inference_model`` as [sequence_output, pooled]."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.utils import unique_name

    cfg = bert.BertConfig.base()
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.data("input_ids", [-1, INFER_SEQ], dtype="int64")
        tt = fluid.data("token_type_ids", [-1, INFER_SEQ], dtype="int64")
        mask = fluid.data("input_mask", [-1, INFER_SEQ], dtype="int64")
        seq_out, pooled = bert.bert_encoder(ids, tt, mask, cfg, INFER_SEQ)
    startup.random_seed = main.random_seed = SEED
    exe, scope = fluid.Executor(), fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    d = os.path.join(root, "bert")
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(
            d, ["input_ids", "token_type_ids", "input_mask"],
            [seq_out, pooled], exe, main_program=main)
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    log(f"[infer] 11a BERT-base encoder exported: "
        f"{len(main.global_block().ops)} ops, {size / 2**20:.1f} MiB, "
        f"startup and save {time.perf_counter() - t0:.2f}s")
    return d, cfg


def _infer_bert(d, cfg, counts):
    """11a: the default passes on the exported BERT-base, K1 launched once
    a layer a call, outputs against the exported program with the kernels
    off, padded rows finite; latency, throughput, device busy, memory,
    warmup. Returns batch 32's feed and outputs."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference, io, kernels

    layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    pred = inference.create_predictor(inference.Config(d))
    load_s = time.perf_counter() - t0
    stats = pred.analysis_stats()
    fused = {k: stats[k]["fused"] for k in
             ("fc_fuse", "multihead_matmul_fuse", "conv_bn_fuse")}
    types = [op.type for op in pred._program.global_block().ops]
    if (fused["fc_fuse"] != BERT_FC_FUSED
            or fused["multihead_matmul_fuse"] != layers
            or types.count("scaled_dot_product_attention") != layers
            or "softmax" in types or "mul" in types):
        raise AssertionError(f"11a analysis: {fused}, ops {sorted(set(types))}")
    log(f"[infer] 11a load + analysis {load_s:.2f}s: {fused}, "
        f"{len(types)} ops, dropouts left at is_test "
        f"{types.count('dropout')}")
    counts.take()
    warm = pred.warmup({"batch_sizes": INFER_BATCHES, "seq_lens": None})
    log(f"[infer] 11a warmup a bucket: "
        f"{[(sig[0][0][0], round(s, 3)) for sig, s in warm]} (batch, s)")

    rng = np.random.RandomState(SEED)
    B = max(INFER_BATCHES)
    lens = rng.randint(ENGINE_LENS[0], ENGINE_LENS[1] + 1, B)
    lens[-2:] = 0                        # two padded rows: every key masked
    feed = _bert_feeds(rng, B, cfg.vocab_size, lens)
    names = pred.get_input_names()
    counts.take()
    got = pred.run([feed[n] for n in names])
    per_call = counts.take()
    flash = {n: c for n, c in per_call.items() if n.startswith("flash") and c}
    if flash != {"flash_attention_fwd": layers}:
        raise AssertionError(f"11a: a call launched {flash}, want "
                             f"{layers} flash_attention_fwd")
    exe, scope = fluid.Executor(), fluid.Scope()
    with fluid.scope_guard(scope):
        program, _, fetch_vars = io.load_inference_model(d, exe)
    with kernels.scoped_mode("off"):
        want = exe.run(program, feed=feed, fetch_list=fetch_vars,
                       scope=scope)
    if any(counts.take().values()):
        raise AssertionError("11a: a kernel launched with the kernels off")
    del scope, program
    errs = [_max_abs_np(g, w) for g, w in zip(got, want)]
    finite = all(np.isfinite(g).all() for g in got)
    log(f"[infer] 11a batch {B} against the exported program with the "
        f"kernels off (mul + add, composite attention): max abs "
        f"{errs} (bar {INFER_TOL}); padded rows finite {finite}, their "
        f"pooled |max| {float(np.abs(got[1][-2:]).max()):.4f}")
    if not finite or max(errs) > INFER_TOL:
        raise AssertionError(f"11a outputs: max abs {errs}, finite {finite}")

    times = {}
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for b in INFER_BATCHES:
        fb = {n: v[:b] for n, v in feed.items()}
        _timed_calls(pred, fb, 2)
        times[b] = _pcts_ms(_timed_calls(pred, fb, INFER_REPS))
    peak = torch.cuda.max_memory_allocated()
    for b, (p50, p90) in times.items():
        log(f"[infer] 11a batch {b}: p50 {p50:.3f} ms, p90 {p90:.3f} ms a "
            f"call (host clock to copy_to_cpu), {b / p50 * 1e3:.1f} "
            f"sequences/s")
    _profiled_steps("[infer] 11a batch 32", 5,
                    lambda: (pred.run([feed[n] for n in names]), 0.0)[1])
    log(f"[infer] 11a device memory peak {peak / 2**30:.3f} GiB "
        f"({held / 2**30:.3f} GiB held before the timed calls)")
    counts.take()
    return feed, got


def _infer_bert_bf16(d, cfg, feed, f32_out, counts):
    """11b: ``enable_bf16()`` on the same export: the fc weights folded to
    bf16, K1's bf16 build once a layer a call, outputs within the bf16
    bars of 11a's; p50 at batch 32."""
    import torch

    from paddle_tpu_torch import inference

    layers = cfg.num_hidden_layers
    config = inference.Config(d)
    config.enable_bf16()
    pred = inference.create_predictor(config)
    scope = pred._scope
    folded = sorted(n for n in scope.var_names()
                    if scope.find_var(n).dtype == torch.bfloat16)
    if len(folded) != 2 * BERT_FC_FUSED:
        raise AssertionError(f"11b: {len(folded)} weights folded to bf16, "
                             f"want {2 * BERT_FC_FUSED} (each fc's W, Bias)")
    names = pred.get_input_names()
    pred.run([feed[n] for n in names])          # the bucket's first run
    counts.take()
    got = pred.run([feed[n] for n in names])
    flash = {n: c for n, c in counts.take().items()
             if n.startswith("flash") and c}
    if flash != {"flash_attention_fwd_bf16": layers}:
        raise AssertionError(f"11b: a call launched {flash}, want {layers} "
                             "flash_attention_fwd_bf16")
    report = []
    for g, w in zip(got, f32_out):
        diff = np.asarray(g, np.float64) - np.asarray(w, np.float64)
        rms = float(np.sqrt((diff ** 2).mean())
                    / np.sqrt((np.asarray(w, np.float64) ** 2).mean()))
        report.append((rms, float(np.abs(diff).max())))
    log(f"[infer] 11b bf16: {len(folded)} weights folded, launches a call "
        f"{flash}; against 11a (RMS of the difference over the RMS, max "
        f"abs) {report} (bars {INFER_BF16_RMS}, {INFER_BF16_MAX})")
    if any(r > INFER_BF16_RMS or m > INFER_BF16_MAX for r, m in report):
        raise AssertionError(f"11b outputs: {report}")
    fb = {n: v for n, v in feed.items()}
    _timed_calls(pred, fb, 2)
    p50, p90 = _pcts_ms(_timed_calls(pred, fb, INFER_REPS))
    B = len(feed["input_ids"])
    log(f"[infer] 11b batch {B}: p50 {p50:.3f} ms, p90 {p90:.3f} ms, "
        f"{B / p50 * 1e3:.1f} sequences/s")
    _profiled_steps(f"[infer] 11b batch {B}", 5,
                    lambda: (pred.run([feed[n] for n in names]), 0.0)[1])
    counts.take()
    return p50


def _engine_burst(eng, reqs):
    """One client thread a list of ``reqs``, each submitting its requests
    back to back (a queue-full refusal waits its retry_after and
    resubmits), then every answer collected. Returns the results (None
    for a failed request), the failed request's (client, index, code),
    the wall seconds from the first submit to the last answer and the
    retries by client."""
    import threading

    from paddle_tpu_torch.serving import RejectedError, RequestError

    resps = [[None] * len(mine) for mine in reqs]
    retries = [0] * len(reqs)

    def client(c):
        for i, r in enumerate(reqs[c]):
            while True:
                try:
                    resps[c][i] = eng.submit(r)
                    break
                except RejectedError as e:   # queue full: back off
                    retries[c] += 1
                    time.sleep(max(e.retry_after_s, 0.001))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    results = [[None] * len(mine) for mine in reqs]
    failed = None
    for c, mine in enumerate(resps):
        for i, resp in enumerate(mine):
            try:
                results[c][i] = resp.result(timeout=300)
            except RequestError as e:
                failed = (c, i, e.code)
    return results, failed, time.perf_counter() - t0, retries


def _infer_engine(d, cfg, counts):
    """11c: the ServingEngine over 11a's config: every request served
    within SERVED_TOL of single-request, no bucket missed after start, the
    poison request isolated, late submits refused by the drain."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.serving import RejectedError, ServingEngine

    config = inference.Config(d)
    config.set_serving_buckets(INFER_LATTICE)
    eng = ServingEngine(config, num_replicas=2, queue_depth=256,
                        max_wait_ms=5.0)
    t0 = time.perf_counter()
    eng.start()
    warm_s = time.perf_counter() - t0
    warm_launches = counts.take()["flash_attention_fwd"]
    rng = np.random.RandomState(SEED + 1)
    reqs = []
    for c in range(ENGINE_CLIENTS):
        mine = []
        for i in range(ENGINE_PER_CLIENT):
            rows = int(rng.randint(ENGINE_ROWS[0], ENGINE_ROWS[1] + 1))
            lens = rng.randint(ENGINE_LENS[0], ENGINE_LENS[1] + 1, rows)
            mine.append(_bert_feeds(rng, rows, cfg.vocab_size, lens))
        reqs.append(mine)
    poison = reqs[0][POISON_AT]
    poison["input_ids"][:, :2] = POISON_ID

    def is_poison(feeds):
        ids = feeds["input_ids"]
        return bool(((ids[:, 0] == POISON_ID) & (ids[:, 1] == POISON_ID)).any())

    ref = inference.create_predictor(inference.Config(d))
    refs = [[None if r is poison else ref.run_batch(r) for r in mine]
            for mine in reqs]
    del ref
    for rep in eng._replicas:
        def run_batch(feeds, _real=rep.run_batch):
            if is_poison(feeds):
                raise RuntimeError("poison request in the batch")
            return _real(feeds)
        rep.run_batch = run_batch
    counts.take()
    results, poisoned, wall, retries = _engine_burst(eng, reqs)
    traffic = counts.take()
    eng.shutdown()
    try:
        eng.submit(reqs[0][0])
        late = None
    except RejectedError as e:
        late = e.retry_after_s
    st = eng.stats()
    gaps, bit_equal, total = [], 0, 0
    for c, mine in enumerate(results):
        for i, got in enumerate(mine):
            if reqs[c][i] is poison:
                continue
            for n, want in refs[c][i].items():
                gaps.append(_max_abs_np(got[n], want))
                bit_equal += int(np.array_equal(got[n], want))
                total += 1
    served = sum(r is not None for mine in results for r in mine)
    rows = sum(len(r["input_ids"]) for mine in reqs for r in mine)
    n_req = len(reqs) * ENGINE_PER_CLIENT
    log(f"[infer] 11c engine: warmup of {len(INFER_LATTICE)} buckets "
        f"{warm_s:.2f}s ({warm_launches} K1 launches); {served} of {n_req} "
        f"requests served in {wall:.3f}s: {n_req / wall:.1f} req/s, "
        f"{rows / wall:.1f} rows/s; latency p50 "
        f"{st['latency_p50_s'] * 1e3:.2f} ms, p99 "
        f"{st['latency_p99_s'] * 1e3:.2f} ms; queue wait p50 "
        f"{st['queue_wait_p50_s'] * 1e3:.2f} ms; {st['batches']} batches, "
        f"avg rows {st['avg_batch_rows']:.3f}, occupancy "
        f"{st['avg_batch_occupancy']:.4f}; queue-full retries {retries}; "
        f"K1 launches {traffic['flash_attention_fwd']}; cache misses after "
        f"start {st['cache_misses']}, hit rate {st['cache_hit_rate']}")
    log(f"[infer] 11c served against single-request: max abs "
        f"{max(gaps):.3e} (bar {SERVED_TOL}), {bit_equal} of {total} "
        f"outputs bit-equal; poison {poisoned}, failed {st['failed']}, "
        f"batch failures {st['batch_failures']}; a submit after the drain "
        f"refused with retry_after {late}")
    # the same burst, the poison left out, on one replica
    eng1 = ServingEngine(config, num_replicas=1, queue_depth=256,
                         max_wait_ms=5.0).start()
    clean = [[r for r in mine if r is not poison] for mine in reqs]
    _, _, wall1, _ = _engine_burst(eng1, clean)
    eng1.shutdown()
    st1 = eng1.stats()
    log(f"[infer] 11c the same burst but the poison on 1 replica: "
        f"{n_req - 1} requests in {wall1:.3f}s: {(n_req - 1) / wall1:.1f} "
        f"req/s, {(rows - len(poison['input_ids'])) / wall1:.1f} rows/s; "
        f"latency p50 {st1['latency_p50_s'] * 1e3:.2f} ms, p99 "
        f"{st1['latency_p99_s'] * 1e3:.2f} ms; {st1['batches']} batches, "
        f"avg rows {st1['avg_batch_rows']:.3f}")
    counts.take()
    if (served != n_req - 1 or poisoned is None or poisoned[:2] != (0, POISON_AT)
            or st["failed"] != 1 or st["cache_misses"] != 0
            or st["completed"] != n_req - 1 or late != 0.0
            or not traffic["flash_attention_fwd"]
            or max(gaps) > SERVED_TOL):
        raise AssertionError(f"11c engine: served {served}, poison "
                             f"{poisoned}, stats {st}, late {late}, gap "
                             f"{max(gaps)}")
    return {"req_s": n_req / wall, "rows_s": rows / wall}


def _infer_resnet(root, counts):
    """11d: ResNet-50 exported and served at batch 32: conv_bn_fuse folds
    every conv's batch_norm, outputs against the unfused test clone."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference, io
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.utils import unique_name

    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.data("img", shape=[-1] + list(RESNET_IMAGE))
        logits = resnet.resnet(img, 1000, 50)
        prob = fluid.layers.softmax(logits)
    startup.random_seed = main.random_seed = SEED
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    # batch_norm's statistics and affine terms off their initial values,
    # so the fold has real numbers to absorb
    rng = np.random.RandomState(SEED)
    for op in main.global_block().ops:
        if op.type != "batch_norm":
            continue
        mean = scope.find_var(op.input("Mean")[0])
        c = mean.shape[0]
        for slot, val in (("Mean", rng.randn(c) * 0.1),
                          ("Variance", rng.uniform(0.5, 1.5, c)),
                          ("Scale", rng.uniform(0.5, 1.5, c)),
                          ("Bias", rng.randn(c) * 0.1)):
            scope.set(op.input(slot)[0], torch.tensor(
                val, dtype=torch.float32, device=mean.device))
    d = os.path.join(root, "resnet")
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, ["img"], [logits, prob], exe,
                                      main_program=main)
    del scope
    pred = inference.create_predictor(inference.Config(d))
    stats = pred.analysis_stats()
    folds = stats["conv_bn_fuse"]["fused"]
    types = [op.type for op in pred._program.global_block().ops]
    batch = rng.rand(INFER_RESNET_BATCH, *RESNET_IMAGE).astype("float32")
    got = pred.run([batch])
    ref_scope = fluid.Scope()
    with fluid.scope_guard(ref_scope):
        program, _, fetch_vars = io.load_inference_model(d, exe)
        want = exe.run(program, feed={"img": batch}, fetch_list=fetch_vars)
    del ref_scope, program
    scale = float(np.abs(want[0]).max())
    err = _max_abs_np(got[0], want[0])
    sums = got[1].sum(axis=1)
    fb = {"img": batch}
    _timed_calls(pred, fb, 2)
    p50, p90 = _pcts_ms(_timed_calls(pred, fb, INFER_REPS // 2))
    log(f"[infer] 11d ResNet-50: conv_bn_fuse {folds} (the JAX pass's "
        f"count {RESNET50_BN_FOLDS}), fc_fuse {stats['fc_fuse']['fused']}, "
        f"batch_norm ops left {types.count('batch_norm')}; logits against "
        f"the unfused clone max abs {err:.3e} of |max| {scale:.3e} (bar "
        f"{RESNET_FOLD_TOL} relative); batch {INFER_RESNET_BATCH}: p50 "
        f"{p50:.3f} ms, p90 {p90:.3f} ms, "
        f"{INFER_RESNET_BATCH / p50 * 1e3:.1f} images/s")
    if (folds != RESNET50_BN_FOLDS or "batch_norm" in types
            or not np.isfinite(got[0]).all() or err > RESNET_FOLD_TOL * scale
            or not np.allclose(sums, 1.0, atol=1e-4)):
        raise AssertionError(f"11d: folds {folds}, err {err} of {scale}, "
                             f"prob sums {sums[:4]}")
    counts.take()
    return INFER_RESNET_BATCH / p50 * 1e3


def phase_inference():
    """11: the predictor and the ServingEngine on the card (11a-11d).
    Returns the phase's kernel launches (K1 and its bf16 build)."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    counts = _Launches()
    root = tempfile.mkdtemp(prefix="chip_smoke_infer_")
    try:
        d, cfg = _infer_export_bert(root)
        t0 = time.perf_counter()
        feed, f32_out = _infer_bert(d, cfg, counts)
        log(f"[infer] 11a {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        _infer_bert_bf16(d, cfg, feed, f32_out, counts)
        log(f"[infer] 11b {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        _infer_engine(d, cfg, counts)
        log(f"[infer] 11c {time.perf_counter() - t0:.1f}s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _infer_resnet(root, counts)
        log(f"[infer] 11d {time.perf_counter() - t0:.1f}s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    counts.take()
    log(f"[infer] phase 11 {time.perf_counter() - t_phase:.1f}s, launches "
        f"{ {n: c for n, c in counts.total.items() if c} }")
    return counts.total


# -- phase 12 ---------------------------------------------------------------
FLEET_SPEC = dict(MODEL, name="fleet", version="1")
# new tokens of each fleet request (MAX_NEW until the whole script neared
# its time limit)
FLEET_MAX_NEW = 16
# the victim's worker dies at its 6th RPC (pings, submits and polls all
# count): the fleet test's schedule (tests/test_fleet_serving.py), by
# which time it holds accepted work
FLEET_KILL = [{"site": "replica.kill", "action": "kill", "at_call": 6,
               "rank": 1, "id": "fleet-kill"}]
FLEET_SPAWN_TIMEOUT = 600.0


def _fleet_spawn(index, extra_env=None):
    from paddle_tpu_torch.serving.fleet import SubprocessReplica

    return SubprocessReplica.spawn(
        f"r{index}", index, FLEET_SPEC, extra_env=extra_env, device="cuda",
        startup_timeout=FLEET_SPAWN_TIMEOUT)


def _fleet_spawn_all(jobs, handles):
    """Spawn workers side by side (``jobs``: (index, extra_env)); every
    worker that came up joins ``handles``, which the caller closes."""
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = [pool.submit(_fleet_spawn, *job) for job in jobs]
    out, errors = [], []
    for f in futs:
        try:
            out.append(f.result())
        except Exception as e:      # noqa: BLE001 - re-raised below
            errors.append(e)
    handles.extend(out)
    if errors:
        raise errors[0]
    return out


def _fleet_close(handles):
    for h in handles:
        try:
            h.close(60)
        except Exception:           # noqa: BLE001 - best effort, then kill
            pass
        if h.proc.poll() is None:
            h.proc.kill()
            h.proc.wait()


def _fleet_burst(router, prompts):
    """Submit the burst at once; returns (tokens, latencies s, wall s, the
    replica each request was first dispatched to)."""
    t0 = time.perf_counter()
    resps, sent, first = [], [], []
    for p in prompts:
        resps.append(router.submit(p, max_new_tokens=FLEET_MAX_NEW))
        sent.append(time.perf_counter())
        with router._lock:
            rr = next((r for r in router._inflight.values()
                       if r.response is resps[-1]), None)
            first.append(rr.attempts[0] if rr is not None else None)
    outs = [[int(t) for t in r.result(timeout=FLEET_SPAWN_TIMEOUT)["tokens"]]
            for r in resps]
    wall = time.perf_counter() - t0
    return outs, [r.finish_time - s for r, s in zip(resps, sent)], wall, first


def _fleet_worker_launches(handles, tag):
    """Each live worker's ``stats`` RPC: its K3 launches must be 12 a
    decode step; returns the K3 and K8 (startup) launches summed."""
    total = {"paged_attention": 0, "threefry_random_bits": 0}
    for h in handles:
        ws = h.worker_stats()
        steps = sum(m["steps"] for m in ws["models"].values())
        k3 = ws["kernel_launches"]["paged_attention"]
        k8 = ws["kernel_launches"]["threefry_random_bits"]
        step_ms = [s * 1e3 for m in ws["models"].values()
                   for s in m["step_seconds"]]
        log(f"[fleet] {tag} {h.rid} (pid {ws['pid']}): {steps} decode "
            f"steps, step {_pcts(step_ms)}, K3 {k3}, K8 random_bits {k8}")
        if k3 == 0 or k3 != MODEL["num_layers"] * steps:
            raise AssertionError(
                f"{tag} {h.rid}: paged_attention launched {k3} times over "
                f"{steps} decode steps of {MODEL['num_layers']} layers")
        if k8 == 0:
            raise AssertionError(f"{tag} {h.rid}: no threefry_random_bits "
                                 "launch in the worker's startup")
        total["paged_attention"] += k3
        total["threefry_random_bits"] += k8
    return total


def _fleet_latencies(tag, lat, wall, outs):
    ms = np.asarray(lat) * 1e3
    tokens = sum(len(o) for o in outs)
    log(f"[fleet] {tag}: {len(outs)} requests in {wall:.2f}s, "
        f"{tokens / wall:.1f} tokens/s, latency p50 {np.median(ms):.1f} ms "
        f"p99 {np.percentile(ms, 99):.1f} ms")
    return float(np.percentile(ms, 99))


def _lock_cost():
    """Host µs of one acquire + release of a named lock with the witness
    disabled (the serving hot path's default), beside a plain
    ``threading.Lock``'s."""
    import threading

    from paddle_tpu_torch.observability import lockdep

    was = lockdep.enabled()
    lockdep.enable(False)
    try:
        named, plain = lockdep.named_lock("chip.smoke"), threading.Lock()

        def take(lk):
            def fn():
                for _ in range(100):
                    with lk:
                        pass
            return fn

        named_us = host_us(take(named), reps=100) / 100
        plain_us = host_us(take(plain), reps=100) / 100
    finally:
        lockdep.enable(was)
    log(f"[fleet] lockdep off: a named lock's acquire + release "
        f"{named_us:.3f} µs, a plain lock's {plain_us:.3f} µs")


def _fleet_chaos(entry, prompts, refs, handles, p99_steady, r0, r1):
    """12b: a fresh router (autoscale, 2-3 workers) over ``r0`` and the
    armed ``r1`` (spawned beside 12a's workers); worker 1 dies at its 6th
    RPC while it holds work."""
    import threading

    from paddle_tpu_torch.serving.fleet import FleetRouter
    from paddle_tpu_torch.serving.fleet.router import RoutedRequest
    from paddle_tpu_torch.serving.request import Priority

    log(f"[fleet] 12b spawn-to-ready (beside 12a's): r0 {r0.ready_s:.2f}s, "
        f"r1 (armed) {r1.ready_s:.2f}s")

    def factory(index):
        h = _fleet_spawn(index)
        handles.append(h)
        return h

    router = FleetRouter(replica_factory=factory, autoscale=True,
                         min_replicas=2, max_replicas=3,
                         affinity_prefix=MODEL["block_size"],
                         health_interval_s=0.05, label="chip-fleet-chaos")
    router.add_replica(r0)
    router.add_replica(r1)
    seen = {}
    stop = threading.Event()

    def watch():            # when the victim exits, and when it is latched
        while not stop.is_set() and len(seen) < 2:
            if "exit" not in seen and r1.proc.poll() is not None:
                seen["exit"] = time.perf_counter()
            if "dead" not in seen and router.replicas()["r1"] == "dead":
                seen["dead"] = time.perf_counter()
            time.sleep(0.0005)

    watcher = threading.Thread(target=watch, daemon=True)
    router.start()
    watcher.start()
    try:
        outs, lat, wall, _ = _fleet_burst(router, prompts)
        code = r1.proc.wait(timeout=60)
        deadline = time.monotonic() + FLEET_SPAWN_TIMEOUT
        while (router.metrics.count("scale_ups") < 1
               and time.monotonic() < deadline):
            time.sleep(0.05)
        stop.set()
        watcher.join(5)
        st = router.stats()
        p99 = _fleet_latencies("12b", lat, wall, outs)
        log(f"[fleet] 12b: victim exit {code}, state "
            f"{st['replicas']['r1']['state']}, deaths "
            f"{st['replica_deaths']}, rerouted {st['rerouted']}, accepted "
            f"{st['accepted']}, completed {st['completed']}, scale-ups "
            f"{st['scale_ups']}; the victim's exit seen -> DEAD latch "
            f"{(seen.get('dead', np.nan) - seen.get('exit', np.nan)) * 1e3:.2f}"
            f" ms (a 0.5 ms poll of each; negative: the router latched at "
            f"the failed RPC first); replacement "
            f"spawn-to-ready {st['last_scaleup_s']:.2f}s; p99 "
            f"{p99:.1f} ms against 12a's {p99_steady:.1f} ms")
        if code != 43 or st["replicas"]["r1"]["state"] != "dead":
            raise AssertionError(f"12b: the victim exited {code}, state "
                                 f"{st['replicas']['r1']['state']}")
        if st["replica_deaths"] != 1 or st["rerouted"] < 1:
            raise AssertionError(f"12b: deaths {st['replica_deaths']}, "
                                 f"rerouted {st['rerouted']}")
        ended = (st["completed"] + st["deadline_missed"] + st["failed"]
                 + st["drained_unserved"])
        if st["accepted"] != ended or st["completed"] != N_REQUESTS:
            raise AssertionError(f"12b: zero-loss identity broken: {st}")
        verdicts = [check_against_offline(entry, p, o, w, tag="fleet 12b")
                    for p, o, w in zip(prompts, outs, refs)]
        log(f"[fleet] 12b streams: {verdicts.count('equal')} equal, "
            f"{verdicts.count('near-tie')} parted at a near-tie")
        if st["scale_ups"] < 1:
            raise AssertionError("12b: autoscale spawned no replacement")
        new = next(rid for rid in st["replicas"] if rid not in ("r0", "r1"))
        with router._lock:
            i = next(i for i, p in enumerate(prompts) if router._route(
                RoutedRequest(0, p, FLEET_MAX_NEW, "t", Priority.NORMAL,
                              None, None, None), set()) == new)
        got = [int(t) for t in router.submit(
            prompts[i], max_new_tokens=FLEET_MAX_NEW).result(
                timeout=FLEET_SPAWN_TIMEOUT)["tokens"]]
        verdict = check_against_offline(entry, prompts[i], got, refs[i],
                                        tag="fleet 12b replacement")
        replacement = router._replicas[new]
        log(f"[fleet] 12b replacement {new} served request {i}: {verdict}")
        live = [router._replicas["r0"], replacement]
        launches = _fleet_worker_launches(live, "12b")
        if not any(m["completed"] for m in
                   replacement.worker_stats()["models"].values()):
            raise AssertionError("12b: the replacement served nothing")
        return launches
    finally:
        stop.set()
        router.shutdown()


def phase_fleet():
    """12: the fleet on the card — a FleetRouter over GPT-base worker
    processes (12a), then the same burst with one worker killed (12b).
    Returns the workers' K3 and K8 launches."""
    import torch

    from paddle_tpu_torch.serving import GenerationEngine, build_decoder_model
    from paddle_tpu_torch.serving.fleet import FleetRouter

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    _lock_cost()
    # the in-process reference, from the same spec as the workers (the
    # startup program's own seed draws the same weights in every process)
    engine = GenerationEngine()
    entry = engine.register_model(build_decoder_model(**FLEET_SPEC))
    prompts = make_prompts(MODEL["vocab_size"])
    t0 = time.perf_counter()
    refs = [entry.offline_decode(p, FLEET_MAX_NEW) for p in prompts]
    log(f"[fleet] offline references {time.perf_counter() - t0:.1f}s")
    handles = []
    total = {"paged_attention": 0, "threefry_random_bits": 0}
    try:
        # -- 12a: no chaos --------------------------------------------------
        # 12b's two workers (the second armed) come up beside 12a's
        r0, r1, c0, c1 = _fleet_spawn_all(
            [(0, None), (1, None), (0, None),
             (1, {"PADDLE_TPU_FAULTS": json.dumps(FLEET_KILL)})], handles)
        log(f"[fleet] 12a spawn-to-ready: r0 {r0.ready_s:.2f}s, r1 "
            f"{r1.ready_s:.2f}s ({r0._meta['device']}, pids "
            f"{r0._meta['pid']} {r1._meta['pid']})")
        router = FleetRouter(affinity_prefix=MODEL["block_size"],
                             health_interval_s=0.05, label="chip-fleet")
        router.add_replica(r0)
        router.add_replica(r1)
        router.start()
        try:
            outs, lat, wall, first = _fleet_burst(router, prompts)
            st = router.stats()
            p99 = _fleet_latencies("12a", lat, wall, outs)
            if st["accepted"] != N_REQUESTS or st["completed"] != N_REQUESTS:
                raise AssertionError(f"12a: not every request completed: "
                                     f"{st}")
            verdicts = [check_against_offline(entry, p, o, w,
                                              tag="fleet 12a")
                        for p, o, w in zip(prompts, outs, refs)]
            shared = [first[i] for i in range(0, N_REQUESTS, 4)]
            log(f"[fleet] 12a streams: {verdicts.count('equal')} equal, "
                f"{verdicts.count('near-tie')} parted at a near-tie; the "
                f"shared-prefix requests went to {shared}, the rest "
                f"{[first[i] for i in range(N_REQUESTS) if i % 4]}")
            if len(set(shared)) != 1 or shared[0] is None:
                raise AssertionError(f"12a: the 4 shared-prefix requests "
                                     f"were not routed together: {shared}")
            # the same burst again on the warm workers (their first burst
            # pays each process's first cuBLAS calls and kernel loads)
            outs, lat, wall, _ = _fleet_burst(router, prompts)
            _fleet_latencies("12a warm", lat, wall, outs)
            verdicts = [check_against_offline(entry, p, o, w,
                                              tag="fleet 12a warm")
                        for p, o, w in zip(prompts, outs, refs)]
            log(f"[fleet] 12a warm streams: {verdicts.count('equal')} "
                f"equal, {verdicts.count('near-tie')} at a near-tie")
            for n, c in _fleet_worker_launches([r0, r1], "12a").items():
                total[n] += c
        finally:
            router.shutdown()
        # -- 12b: a worker killed mid-flight --------------------------------
        for n, c in _fleet_chaos(entry, prompts, refs, handles, p99, c0,
                                 c1).items():
            total[n] += c
    finally:
        _fleet_close(handles)
        engine.shutdown()
    orphans = [h.rid for h in handles if h.proc.poll() is None]
    if orphans:
        raise AssertionError(f"workers still running: {orphans}")
    log(f"[fleet] phase 12 {time.perf_counter() - t_phase:.1f}s, worker "
        f"launches {total}")
    return total


# -- phase 13 ---------------------------------------------------------------
# Dense data parallelism: BERT-base in phase 5's recipe on DP_RANKS ranks
# of one card (gloo), global batch DP_BATCH, through the collective fleet.
# Rank 1's 16 rows keep DP_KEEP of their 18 masked tokens, so the MLM
# ratio's sums differ by rank. The bar against the one-rank run of the same
# steps, stated before the first run: every step sums float32 in another
# order (a GEMM of 16 rows may pick another cuBLAS algorithm than one of
# 32, and the grads are two partial sums added), as phase 5's kernels on
# against off do, so TRAIN_LOSS_TOL.
DP_RANKS, DP_BATCH, DP_STEPS, DP_KEEP = 2, 32, 4, 9
DP_LOSS_TOL = TRAIN_LOSS_TOL
DP_TIMEOUT = 600.0


def _dp_program(fleet_path):
    """Phase 13's BERT-base (phase 5's recipe, built as
    ``build_bert_pretrain`` builds it): ``(cfg, main, startup, program to
    run, fetches)``; with ``fleet_path`` the optimizer goes through
    ``fleet.distributed_optimizer(...).minimize`` and the program to run is
    ``fleet.main_program``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.utils import unique_name

    cfg = bert.BertConfig.base()
    cfg.use_flash_attention = True
    cfg.hidden_dropout_prob = TRAIN_DROPOUT
    cfg.attention_probs_dropout_prob = 0.0
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        _, fetches = bert.bert_pretrain_net(cfg, TRAIN_SEQ, TRAIN_P)
        sched = fluid.layers.learning_rate_scheduler.linear_lr_warmup(
            TRAIN_LR, warmup_steps=10000, start_lr=0.0, end_lr=TRAIN_LR)
        opt = fluid.optimizer.Adam(learning_rate=sched)
        if fleet_path:
            from paddle_tpu_torch.fleet import (
                DistributedStrategy, PaddleCloudRoleMaker, fleet)

            fleet.init(PaddleCloudRoleMaker())
            fleet.distributed_optimizer(opt, DistributedStrategy()).minimize(
                fetches[0])
            prog = fleet.main_program
        else:
            opt.minimize(fetches[0])
            prog = main
    startup.random_seed = main.random_seed = SEED
    return cfg, main, startup, prog, fetches


def _dp_feed(cfg):
    """One seeded batch of DP_BATCH; rank 1's rows keep DP_KEEP masked
    tokens of their 18."""
    from paddle_tpu_torch.models import bert

    batch = bert.synthetic_batch(np.random.RandomState(SEED + 13), DP_BATCH,
                                 TRAIN_SEQ, cfg, TRAIN_P)
    batch["mlm_labels"][DP_BATCH // DP_RANKS:, DP_KEEP:] = -1
    return batch


def _dp_names(main):
    """The first dropout site's Mask and the MLM token losses."""
    ops = main.global_block().ops
    mask = [op.output("Mask")[0] for op in ops if op.type == "dropout"][0]
    tok = [op.output("Loss")[0] for op in ops
           if op.type == "softmax_with_cross_entropy"][0]
    return mask, tok


def _dp_steps(exe, prog, scope, feed, fetches, main):
    """DP_STEPS steps: losses, host seconds (the run, ending in the loss's
    copy, and a synchronize), the parameters' digest after every step, the
    collectives and the fused all-reduce's time split of every step; at the
    first step also the MLM loss, the first dropout site's Mask (its
    digest), the token losses and their grads."""
    import torch

    from paddle_tpu_torch.parallel import env as penv

    mask, tok = _dp_names(main)
    params = [p.name for p in main.all_parameters()]
    out = dict(losses=[], seconds=[], digests=[], stats=[], times=[])
    for step in range(DP_STEPS):
        fetch = [fetches[0]] + ([fetches[1], mask, tok, tok + "@GRAD"]
                                if step == 0 else [])
        penv.reset_collective_stats()
        t0 = time.perf_counter()
        vals = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["losses"].append(float(vals[0].reshape(-1)[0]))
        out["stats"].append(penv.collective_stats())
        out["times"].append(penv.collective_times())
        if step == 0:
            out.update(mlm=float(vals[1].reshape(-1)[0]),
                       mask=hashlib.blake2b(vals[2].tobytes(),
                                            digest_size=16).hexdigest(),
                       mask_shape=list(vals[2].shape),
                       tok=vals[3].reshape(-1).tolist(),
                       tok_grad=vals[4].reshape(-1).tolist())
        out["digests"].append(_digest(scope.find_var(n) for n in params))
    return out


def _dp_idle(exe, prog, scope, feed, loss):
    """(device busy ms, wall ms) of one more step under torch.profiler
    (``_profile``): this process's kernels and copies."""
    _, busy_us, wall_us, _ = _profile("[dp] 13", lambda: exe.run(
        prog, feed=feed, fetch_list=[loss], scope=scope))
    return busy_us / 1e3, wall_us / 1e3


def _dp_run(fleet_path):
    """One process's part of phase 13: startup, the step counter past the
    warmup, DP_STEPS steps, one profiled step. Returns what it saw."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.convert import load_params

    t0 = time.perf_counter()
    cfg, main, startup, prog, fetches = _dp_program(fleet_path)
    ops = main.global_block().ops
    exe, scope = fluid.Executor(), fluid.Scope()
    kernels.reset_launches()
    exe.run(startup, scope=scope)
    load_params(scope, {COUNTER: np.full([1], WARMED_UP, np.float32)})
    startup_launches = kernels.launches()
    feed = _dp_feed(cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with _MaskTap() as tap:
        run = _dp_steps(exe, prog, scope, feed, fetches, main)
    launches = kernels.launches()
    busy, wall = _dp_idle(exe, prog, scope, feed, fetches[0])
    sizes = [int(np.prod(p.shape)) for p in main.all_parameters()]
    return dict(
        run, launches=launches, startup_launches=startup_launches,
        masks=tap.digests, build_s=build_s, busy_ms=busy, wall_ms=wall,
        peak=torch.cuda.max_memory_allocated(), n_values=sum(sizes),
        n_sdpa=sum(op.type == "scaled_dot_product_attention" for op in ops),
        n_sites=sum(op.type == "dropout" for op in ops), ops=len(ops),
        device=torch.cuda.get_device_name(0),
        masked=int((feed["mlm_labels"] != -1).sum()),
        masked_by_rank=[int((r != -1).sum()) for r in np.split(
            feed["mlm_labels"], DP_RANKS)])


def dp_rank_main(out_dir):
    """One rank of phase 13 (``chip_smoke.py --dp-rank DIR``): without its
    card it exits nonzero before any step; it writes what it saw to
    ``DIR/rank<r>.json``."""
    check_environment()
    from paddle_tpu_torch.parallel import env as penv

    result = _dp_run(fleet_path=True)
    axis = penv.make_mesh().axis("data")
    result.update(rank=axis.rank, size=axis.size, backend=axis.backend)
    with open(os.path.join(out_dir, f"rank{axis.rank}.json"), "w") as f:
        json.dump(result, f)


def _dp_launch(flag="--dp-rank"):
    """Runs this script with ``flag DIR`` on DP_RANKS ranks of the card
    (gloo over a ``file://`` rendezvous) and returns each rank's
    ``DIR/rank<r>.json``."""
    return _rank_results(_rank_spawn(flag))


def _rank_spawn(flag, n=DP_RANKS):
    """Starts ``n`` ranks of this script with ``flag DIR``: (the
    processes, DIR), for ``_rank_results``."""
    from paddle_tpu_torch.distributed import launch

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        procs = launch.spawn_gang(
            [os.path.abspath(__file__), flag, out_dir],
            nproc=n, init_method="file://" + os.path.join(
                out_dir, "store"))
    except BaseException:
        shutil.rmtree(out_dir, ignore_errors=True)
        raise
    return procs, out_dir


def _rank_results(gang, n=DP_RANKS, timeout=DP_TIMEOUT, keep=False):
    """Waits for the ``n`` ranks of ``_rank_spawn`` (stopping every one of
    them whatever happens) and returns each rank's ``rank<r>.json``; the
    directory goes after, unless ``keep`` (the caller removes it)."""
    from paddle_tpu_torch.distributed import launch

    procs, out_dir = gang
    try:
        try:
            codes = launch.wait_gang(procs, timeout_s=timeout)
        finally:
            launch.terminate_gang(procs)
        if codes != [0] * n:
            raise AssertionError(f"ranks exited {codes}")
        ranks = []
        for r in range(n):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        return ranks
    finally:
        if not keep:
            shutil.rmtree(out_dir, ignore_errors=True)


def _p50_ms(seconds):
    return float(np.median(seconds[1:])) * 1e3


def phase_dp():
    """Phase 13: the one-rank run here, then the 2 ranks; hold them
    against each other and against the prediction from the program."""
    import torch

    ref = _dp_run(fleet_path=False)
    torch.cuda.empty_cache()
    ranks = _dp_launch()
    r0 = ranks[0]
    steps = DP_STEPS
    want = {"flash_attention_fwd": 2 * r0["n_sdpa"] * steps,
            "flash_attention_bwd_dkdv": r0["n_sdpa"] * steps,
            "flash_attention_bwd_dq": r0["n_sdpa"] * steps,
            "threefry_dropout": r0["n_sites"] * steps}
    grad_bytes = 4 * r0["n_values"]
    rtol, atol = DP_LOSS_TOL
    gap = max(abs(a - b) for a, b in zip(r0["losses"], ref["losses"]))
    total = r0["masked"]
    tok = np.asarray(r0["tok"], np.float64).reshape(DP_RANKS, -1)
    global_ratio = tok.sum() / total
    per_rank = float(np.mean(tok.sum(axis=1) / r0["masked_by_rank"]))
    weights = np.asarray(r0["tok_grad"]).reshape(DP_RANKS, -1)
    checks = {
        "backend gloo": all(r["backend"] == "gloo" and r["size"] == DP_RANKS
                            for r in ranks),
        "ranks bit-equal every step": all(r["digests"] == r0["digests"]
                                          for r in ranks),
        "ranks' losses equal": all(r["losses"] == r0["losses"]
                                   for r in ranks),
        f"losses within {DP_LOSS_TOL} of one rank": all(
            abs(a - b) <= atol + rtol * abs(b)
            for a, b in zip(r0["losses"], ref["losses"])),
        "mask bit-equal to one rank's": all(
            r["mask"] == ref["mask"] and r["mask_shape"] == ref["mask_shape"]
            for r in ranks),
        "launches as predicted": all(
            r["launches"].get(k, 0) == v for r in ranks
            for k, v in want.items()),
        "one fused grad all-reduce a step": all(
            s.get("all_reduce_fused") == [1, grad_bytes]
            for r in ranks for s in r["stats"]),
        "3 scalar all-reduces a step": all(
            s.get("all_reduce") == [3, 12] for r in ranks
            for s in r["stats"]),
        "rank 0 broadcast once": "broadcast" in r0["stats"][0] and all(
            "broadcast" not in s for r in ranks for s in r["stats"][1:]),
        "MLM loss is the global ratio": bool(abs(
            r0["mlm"] - global_ratio) <= 1e-5 * global_ratio),
        "token weights 1/(all masked)": bool(np.allclose(
            weights, 1.0 / total, rtol=1e-6, atol=0)),
        "losses finite": bool(np.isfinite(r0["losses"]).all()),
        "K8 launched on each rank": all(
            r["launches"].get("threefry_dropout", 0) == len(r["masks"]) > 0
            for r in ranks),
    }
    log(f"[dp] BERT-base ({r0['ops']} ops, {r0['n_values']} parameter "
        f"values) on {DP_RANKS} ranks over {r0['backend']}, each on "
        f"{[r['device'] for r in ranks]}; global batch {DP_BATCH} x seq "
        f"{TRAIN_SEQ}, P {TRAIN_P}, masked tokens by rank "
        f"{r0['masked_by_rank']}; build + startup "
        f"{[round(r['build_s'], 2) for r in ranks]} s a rank")
    log(f"[dp] losses {r0['losses']}; one rank {ref['losses']}; largest "
        f"gap {gap:.3e} (bar rtol {rtol}, atol {atol})")
    log(f"[dp] MLM ratio, rank 1's numbers: the global step "
        f"{global_ratio:.9f} (rank-reported {r0['mlm']:.9f}, one rank "
        f"{ref['mlm']:.9f}); the per-rank average would be {per_rank:.9f}; "
        f"token weights {float(weights.mean()):.6e} (global 1/{total}; per "
        f"rank 1/({DP_RANKS}*{r0['masked_by_rank'][0]}) and "
        f"1/({DP_RANKS}*{r0['masked_by_rank'][1]}))")
    log(f"[dp] launches a rank over {steps} steps "
        f"{[{k: r['launches'].get(k, 0) for k in want} for r in ranks]} "
        f"(predicted {want}); startup random_bits "
        f"{[r['startup_launches'].get('threefry_random_bits', 0) for r in ranks]}")
    ms = [_p50_ms(r["seconds"]) for r in ranks]
    one = _p50_ms(ref["seconds"])
    log(f"[dp] step p50 by rank {[round(m, 2) for m in ms]} ms (steps "
        f"{[[round(x * 1e3, 2) for x in r['seconds']] for r in ranks]}); one "
        f"rank on the whole batch {one:.2f} ms (steps "
        f"{[round(x * 1e3, 2) for x in ref['seconds']]}); "
        f"{DP_BATCH * TRAIN_SEQ / max(ms) * 1e3:.1f} tokens/s over both "
        f"ranks against {DP_BATCH * TRAIN_SEQ / one * 1e3:.1f}")
    for r in ranks:
        split = [t.get("all_reduce_fused", (0.0, 0.0, 0.0))
                 for t in r["times"]]
        d2h, wire, h2d = (float(np.median([t[i] for t in split[1:]])) * 1e3
                          for i in range(3))
        step = _p50_ms(r["seconds"])
        log(f"[dp] rank {r['rank']}: fused grad all-reduce {grad_bytes} "
            f"bytes a step: D2H {d2h:.2f} ms, gloo {wire:.2f} ms, H2D "
            f"{h2d:.2f} ms (p50 of steps 2-{steps}), "
            f"{(d2h + wire + h2d) / step:.4f} of the step; device busy "
            f"{r['busy_ms']:.2f} ms of a {r['wall_ms']:.2f} ms profiled "
            f"step, idle share {1 - r['busy_ms'] / r['wall_ms']:.4f}; memory "
            f"peak {r['peak'] / 2**30:.3f} GiB; collectives of step 1 "
            f"{r['stats'][0]}, of step 2 {r['stats'][1]}")
    log(f"[dp] one rank: device busy {ref['busy_ms']:.2f} ms of a "
        f"{ref['wall_ms']:.2f} ms profiled step, idle share "
        f"{1 - ref['busy_ms'] / ref['wall_ms']:.4f}; memory peak "
        f"{ref['peak'] / 2**30:.3f} GiB")
    log(f"[dp] {card_line()}")
    log(f"[dp] checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"dp phase failed: {checks}")
    # the path's launches: both ranks' (startup and steps) and the one-rank
    # run's
    launches = {}
    for r in ranks + [ref]:
        for part in (r["launches"], r["startup_launches"]):
            for k, v in part.items():
                launches[k] = launches.get(k, 0) + v
    return launches


# -- phase 14: beam translation and dygraph ---------------------------------
BEAM_LENS, BEAM_BUCKETS, BEAM_BATCH, BEAM_MAX_LEN = (11, 27, 50), (16, 32, 64), 8, 64
BEAM_SIZE, BEAM_ALPHA = 4, 0.6
# (i): bucket-padded against exact length on the card. cuBLAS may pick
# another GEMM for another row count (the row-bits fault ROADMAP queue C
# shares with the reference), so scores are held within a relative bar
# (a 64-token hypothesis scores about -150), the bit-equal ones counted,
# and a hypothesis may part from the other run's only where the two runs'
# selected candidates were within BEAM_PART_GAP
BEAM_SCORE_TOL, BEAM_PART_GAP = 1e-4, 1e-4
# (ii): the cached decode's length-penalised score against the cacheless
# forward's rescoring of the same tokens
BEAM_RESCORE_RTOL = 1e-3
COPY_STEPS, COPY_GATE = 300, 6
DYGRAPH_STEPS, DYGRAPH_BATCH, DYGRAPH_LR = 8, 32, 0.1
DYGRAPH_CPU_TOL = (1e-5, 1e-6)
CONV_BATCH, CONV_STEPS = 64, 4
DYGRAPH_DP_TOL = (1e-4, 1e-5)
KERNELS_K1_K7 = ("paged_attention", "decode_attention", "embedding_admission",
                 "sparse_row_update", "blocked_topk_abs")


def _k8(launches):
    return {n: c for n, c in launches.items() if n.startswith("threefry")}


def _other_kernels(launches):
    return {n: c for n, c in launches.items()
            if c and (n in KERNELS_K1_K7 or n.startswith("flash_attention"))}


def _parting(trace_a, trace_b, row):
    """The first step at which two traced beam runs select other
    candidates for ``row``, and the largest gap between their selected
    scores there: (step, gap), or (None, 0.0)."""
    for t, ((sa, ia), (sb, ib)) in enumerate(zip(trace_a, trace_b)):
        if not np.array_equal(ia[row], ib[row]):
            return t, float(np.abs(sa[row] - sb[row]).max())
    return None, 0.0


def _rescore(tfm, params, cfg, src, toks, alpha):
    """The length-penalised log-prob of each row of ``toks`` under the
    cacheless forward, with the decoder's lengths (up to the first EOS,
    else all of them)."""
    import torch

    tgt = np.concatenate([np.full((len(toks), 1), cfg.bos_id), toks[:, :-1]],
                         axis=1)
    logp = torch.log_softmax(tfm.decode_logits(params, cfg, src, tgt),
                             -1).double().cpu().numpy()
    out = []
    for b, row in enumerate(toks):
        eos = np.nonzero(row == cfg.eos_id)[0]
        n = int(eos[0]) + 1 if len(eos) else len(row)
        total = sum(logp[b, t, row[t]] for t in range(n))
        out.append(total / ((5.0 + n) / 6.0) ** alpha)
    return np.asarray(out)


def _greedy_flips(tfm, params, cfg, src, toks):
    """Where beam 1's tokens leave the cacheless forward's argmax path:
    [(row, position, gap between the two logits)] up to each row's EOS."""
    tgt = np.concatenate([np.full((len(toks), 1), cfg.bos_id), toks[:, :-1]],
                         axis=1)
    logits = tfm.decode_logits(params, cfg, src, tgt).cpu().numpy()
    flips = []
    for b, row in enumerate(toks):
        eos = np.nonzero(row == cfg.eos_id)[0]
        n = int(eos[0]) + 1 if len(eos) else len(row)
        for t in range(n):
            best = int(logits[b, t].argmax())
            if best != row[t]:
                flips.append((b, t, float(logits[b, t, best]
                                          - logits[b, t, row[t]])))
                break
    return flips


def _p14_beam():
    """14a: Transformer-big beam translation."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import transformer as tfm

    t0 = time.perf_counter()
    cfg = tfm.TransformerConfig.big()
    main, startup, _, _ = tfm.build_wmt_train(cfg, src_len=BEAM_MAX_LEN,
                                              tgt_len=BEAM_MAX_LEN)
    startup.random_seed = main.random_seed = SEED
    scope = fluid.Scope()
    kernels.reset_launches()
    fluid.Executor().run(startup, scope=scope)
    startup_launches = kernels.launches()
    params = tfm.params_from_scope(cfg, scope)
    del scope, main, startup
    torch.cuda.empty_cache()
    n_values = sum(t.numel() for t in params.values())
    build_s = time.perf_counter() - t0

    kernels.reset_launches()
    t0 = time.perf_counter()
    tr = tfm.BucketedBeamTranslator(
        cfg, params, beam_size=BEAM_SIZE, src_buckets=BEAM_BUCKETS,
        max_len=BEAM_MAX_LEN, length_penalty=BEAM_ALPHA).warmup(BEAM_BATCH)
    warm_s = time.perf_counter() - t0
    ref = tfm.make_beam_decoder(cfg, beam_size=BEAM_SIZE, max_len=BEAM_MAX_LEN,
                                length_penalty=BEAM_ALPHA)
    greedy = tfm.make_beam_decoder(cfg, beam_size=1, max_len=BEAM_MAX_LEN,
                                   length_penalty=BEAM_ALPHA)
    rng = np.random.RandomState(SEED + 14)
    t0 = time.perf_counter()
    checks, parted, bit_equal, rows = {}, [], 0, 0
    worst_score = worst_rescore = 0.0
    flips_all = []
    for length, bucket in zip(BEAM_LENS, BEAM_BUCKETS):
        src = rng.randint(3, cfg.vocab_size, (BEAM_BATCH, length))
        toks, scores = tr.translate(src)
        rtoks, rscores = (t.cpu().numpy() for t in ref(params, src))
        differ = [b for b in range(BEAM_BATCH)
                  if not np.array_equal(toks[b], rtoks[b])]
        if differ:
            padded = np.full((BEAM_BATCH, bucket), cfg.pad_id, np.int64)
            padded[:, :length] = src
            ta, tb = [], []
            tr._decode(tr.params, padded, trace=ta)
            ref(params, src, trace=tb)
            for b in differ:
                step, gap = _parting(ta, tb, b)
                parted.append((length, b, step, gap))
        same = [b for b in range(BEAM_BATCH) if b not in differ]
        if same:
            worst_score = max(worst_score, float(np.max(
                np.abs(scores[same] - rscores[same]) / np.abs(rscores[same]))))
        bit_equal += int((scores == rscores).sum())
        rows += BEAM_BATCH
        rescored = _rescore(tfm, params, cfg, src, toks, BEAM_ALPHA)
        worst_rescore = max(worst_rescore, float(np.max(
            np.abs(rescored - scores) / np.abs(scores))))
        g_toks = greedy(params, src)[0].cpu().numpy()
        flips_all += [(length,) + f
                      for f in _greedy_flips(tfm, params, cfg, src, g_toks)]
    check_s = time.perf_counter() - t0
    # the unprofiled translations' numbers, then one more translation of
    # the middle bucket under the profiler
    st, tps = dict(tr.stats), tr.tokens_per_sec()
    src = rng.randint(3, cfg.vocab_size, (BEAM_BATCH, BEAM_LENS[1]))
    _, busy_us, wall_us, _ = _profile("[beam] 14a", lambda: tr.translate(src))
    launches = kernels.launches()
    checks.update({
        "(i) hypotheses equal, or parted at a near-tie": all(
            step is not None and gap < BEAM_PART_GAP
            for _, _, step, gap in parted),
        f"(i) scores within {BEAM_SCORE_TOL} relative":
            worst_score <= BEAM_SCORE_TOL,
        f"(ii) rescored within {BEAM_RESCORE_RTOL} relative":
            worst_rescore <= BEAM_RESCORE_RTOL,
        "(iii) beam 1 is the cacheless greedy path": all(
            gap < BEAM_PART_GAP for *_, gap in flips_all),
        "(iv) K8 drew the startup": startup_launches.get(
            "threefry_random_bits", 0) > 0,
        "(iv) no K1-K7 launch": not _other_kernels(launches)
                                 and not _other_kernels(startup_launches),
        "one host sync a step at most": st["syncs"] <= st["steps"],
    })
    step_ms = st["seconds"] / st["steps"] * 1e3
    log(f"[beam] 14a Transformer-big ({n_values} parameter values) built and "
        f"initialised in {build_s:.1f} s (startup K8 {_k8(startup_launches)}); "
        f"warmup of buckets {BEAM_BUCKETS} at batch {BEAM_BATCH}, beam "
        f"{BEAM_SIZE}: {warm_s:.2f} s; the translations and checks (i)-(iii) "
        f"{check_s:.2f} s")
    log(f"[beam] 14a (i) {rows - len(parted)}/{rows} hypotheses equal to the "
        f"exact-length run's, parted {parted} (source length, row, step, "
        f"gap); scores of the equal ones within {worst_score:.3e} relative, "
        f"{bit_equal}/{rows} bit-equal; (ii) largest relative rescoring gap "
        f"{worst_rescore:.3e}; (iii) greedy flips {flips_all} (length, row, "
        f"position, logit gap)")
    log(f"[beam] 14a {tps:.1f} tokens/s over "
        f"{st['sentences']} sentences, {step_ms:.3f} ms a decode step "
        f"({st['steps']} steps in {st['seconds']:.3f} s), "
        f"{st['syncs'] / st['steps']:.4f} host syncs a step; profiled "
        f"translate: device busy {busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} "
        f"ms, idle share {1 - busy_us / wall_us:.4f}; launches {_k8(launches)} "
        f"{_other_kernels(launches)}")
    log(f"[beam] 14a checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"phase 14a failed: {checks}")
    del tr, params
    torch.cuda.empty_cache()
    return startup_launches


@contextlib.contextmanager
def _deterministic(nondet):
    """torch's deterministic algorithms inside the block (the embedding's
    scatter-added grad and cuDNN's atomics sum in a fixed order, so a run
    repeats); the ops that have no deterministic path are appended to
    ``nondet``."""
    import warnings

    import torch

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        torch.use_deterministic_algorithms(prev)
        nondet.extend(sorted({str(w.message).split(" does not have")[0][:80]
                              for w in caught
                              if "deterministic" in str(w.message)}))


def _p14_copy():
    """14b: the copy task of examples/machine_translation.py, under
    torch's deterministic algorithms (its 300 steps otherwise sum the
    embedding's grads in another order each run, and the copy count
    moves with them)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import transformer as tfm

    kernels.reset_launches()
    t0 = time.perf_counter()
    nondet = []
    with _deterministic(nondet):
        cfg, losses, tr, body, toks, scores, copied = tfm.copy_task_recipe(
            steps=COPY_STEPS)
    seconds = time.perf_counter() - t0
    launches = kernels.launches()
    exact = tfm.make_beam_decoder(cfg, beam_size=4)(tr.params, body)[0]
    checks = {f"copied >= {COPY_GATE}/8": copied >= COPY_GATE,
              "padded tokens equal exact": bool(np.array_equal(
                  toks, exact.cpu().numpy())),
              "loss falls": losses[-1] < losses[0]}
    log(f"[beam] 14b copy task: {COPY_STEPS} steps in {seconds:.1f} s with "
        f"the translation, loss {losses[0]:.3f} -> {losses[-1]:.3f}; copied "
        f"{copied}/8; {tr.tokens_per_sec():.1f} tokens/s; K8 {_k8(launches)}; "
        f"ops without a deterministic path: {nondet}")
    log(f"[beam] 14b checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"phase 14b failed: {checks}")
    return launches


def _p14_mnist():
    """14c: imperative MNIST (BASELINE workload 1)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import mnist

    seconds = []
    kernels.reset_launches()
    eager, captured = mnist.dygraph_mnist_recipe(
        DYGRAPH_STEPS, DYGRAPH_BATCH, DYGRAPH_LR, seed=0,
        step_hook=lambda step, s: seconds.append(s))
    launches = kernels.launches()
    cpu, _ = mnist.dygraph_mnist_recipe(DYGRAPH_STEPS, DYGRAPH_BATCH,
                                        DYGRAPH_LR, seed=0,
                                        place=fluid.CPUPlace())
    rtol, atol = DYGRAPH_CPU_TOL
    checks = {"eager bit-equal to to_static": eager == captured,
              f"within {DYGRAPH_CPU_TOL} of the CPU": all(
                  abs(a - b) <= atol + rtol * abs(b) for a, b in zip(eager, cpu)),
              "loss falls": eager[-1] < eager[0],
              "K8 drew the initial weights": launches.get(
                  "threefry_random_bits", 0) > 0}
    log(f"[dygraph] 14c MNIST MLP 784-64-10: eager {eager}; to_static "
        f"{captured}; CPU {cpu}; step p50 {_p50_ms(seconds):.3f} ms (steps "
        f"{[round(x * 1e3, 3) for x in seconds]}); K8 {_k8(launches)}")
    log(f"[dygraph] 14c checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"phase 14c failed: {checks}")
    return launches


def _conv_stack_run():
    """14d's net, CONV_STEPS Adam steps under a fresh guard on the card:
    (losses, final state digest, step seconds, launches)."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph, kernels
    from paddle_tpu_torch.models import mnist

    imgs, labels = mnist.synthetic_digits(np.random.RandomState(SEED + 4),
                                          CONV_BATCH)
    imgs = imgs.reshape(-1, 1, 28, 28)
    kernels.reset_launches()
    losses, seconds = [], []
    with dygraph.guard(seed=SEED):
        net = dygraph.Sequential(
            dygraph.Conv2D(1, 20, 5), dygraph.Pool2D(2, "max", 2),
            dygraph.BatchNorm(20), dygraph.Conv2D(20, 50, 5),
            dygraph.Pool2D(2, "max", 2),
            dygraph.Dropout(0.5, dropout_implementation="upscale_in_train"))
        fc = dygraph.Linear(800, 10)
        opt = fluid.optimizer.Adam(learning_rate=1e-3)
        params = net.parameters() + fc.parameters()
        for _ in range(CONV_STEPS):
            t0 = time.perf_counter()
            h = dygraph.trace_op("reshape2", {"X": [net(
                dygraph.to_variable(imgs))]}, {"shape": [CONV_BATCH, -1]})["Out"][0]
            ce = dygraph.trace_op(
                "softmax_with_cross_entropy",
                {"Logits": [fc(h)], "Label": [dygraph.to_variable(labels)]},
                {})["Loss"][0]
            loss = dygraph.trace_op("mean", {"X": [ce]}, {})["Out"][0]
            loss.backward()
            opt.minimize(loss, parameter_list=params)
            for p in params:
                p.clear_gradient()
            losses.append(float(loss.numpy().reshape(-1)[0]))
            seconds.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        digest = _digest(p.value for p in params + [net[2]._mean,
                                                    net[2]._variance])
    return losses, digest, seconds, kernels.launches()


def _p14_conv():
    """14d: the dygraph conv stack with dropout, kernels on against off."""
    from paddle_tpu_torch import kernels

    nondet = []
    with _deterministic(nondet):
        on = _conv_stack_run()
        with kernels.scoped_mode("off"):
            off = _conv_stack_run()
    launches = on[3]
    checks = {"losses bit-equal on/off": on[0] == off[0],
              "parameters bit-equal on/off": on[1] == off[1],
              "K8 once a Dropout call": launches.get("threefry_dropout", 0)
                                        == CONV_STEPS,
              "K8 once an initial draw": launches.get(
                  "threefry_random_bits", 0) == 3,
              "off run launched nothing": not any(off[3].values()),
              "loss finite": bool(np.isfinite(on[0]).all())}
    log(f"[dygraph] 14d conv stack batch {CONV_BATCH}: losses {on[0]} (off "
        f"{off[0]}); step ms on {[round(x * 1e3, 3) for x in on[2]]}, off "
        f"{[round(x * 1e3, 3) for x in off[2]]}; K8 {_k8(launches)}; ops "
        f"without a deterministic path: {nondet}")
    log(f"[dygraph] 14d checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"phase 14d failed: {checks}")
    return launches


def _dygraph_dp_run(rank, world):
    """14c's MLP and data, ``DataParallel`` over ``world`` ranks (1: the
    whole batch, no collectives): losses (this rank's rows' means),
    parameter digests after every step, step seconds, launches."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph, kernels
    from paddle_tpu_torch.models import mnist

    imgs, labels = mnist.synthetic_digits(np.random.RandomState(0),
                                          DYGRAPH_STEPS * DYGRAPH_BATCH)
    rows = DYGRAPH_BATCH // world
    kernels.reset_launches()
    out = dict(losses=[], digests=[], seconds=[])
    with dygraph.guard(seed=0):
        model = mnist.dygraph_mlp()
        if world > 1:
            model = dygraph.DataParallel(model)
        opt = fluid.optimizer.SGD(learning_rate=DYGRAPH_LR)
        for step in range(DYGRAPH_STEPS):
            lo = step * DYGRAPH_BATCH + rank * rows
            t0 = time.perf_counter()
            loss = mnist.dygraph_loss(model, dygraph.to_variable(
                imgs[lo:lo + rows]), dygraph.to_variable(labels[lo:lo + rows]))
            if world > 1:
                loss = model.scale_loss(loss)
            loss.backward()
            if world > 1:
                model.apply_collective_grads()
            opt.minimize(loss, parameter_list=model.parameters())
            model.clear_gradients()
            out["losses"].append(float(loss.numpy().reshape(-1)[0]) * world)
            out["seconds"].append(time.perf_counter() - t0)
            out["digests"].append(_digest(p.value for p in model.parameters()))
    out["launches"] = kernels.launches()
    return out


def dygraph_rank_main(out_dir):
    """One rank of phase 14e (``chip_smoke.py --dygraph-rank DIR``)."""
    check_environment()
    from paddle_tpu_torch.parallel import env as penv

    axis = penv.make_mesh().axis("data")
    result = _dygraph_dp_run(axis.rank, axis.size)
    result.update(rank=axis.rank, size=axis.size, backend=axis.backend)
    with open(os.path.join(out_dir, f"rank{axis.rank}.json"), "w") as f:
        json.dump(result, f)


def _p14_dp(gang):
    """14e: DataParallel on 2 ranks of the card (started by
    ``phase_beam_dygraph`` after 14a, so that their start-up overlaps
    14b-14d) against one rank."""
    one = _dygraph_dp_run(0, 1)
    ranks = _rank_results(gang)
    both = np.mean([r["losses"] for r in ranks], axis=0)
    rtol, atol = DYGRAPH_DP_TOL
    checks = {"backend gloo": all(r["backend"] == "gloo"
                                  and r["size"] == DP_RANKS for r in ranks),
              "ranks bit-equal every step": all(
                  r["digests"] == ranks[0]["digests"] for r in ranks),
              f"losses within {DYGRAPH_DP_TOL} of one rank": bool(np.allclose(
                  both, one["losses"], rtol=rtol, atol=atol))}
    log(f"[dygraph] 14e DataParallel on {DP_RANKS} ranks: losses {both.tolist()} "
        f"against one rank {one['losses']}; step p50 by rank "
        f"{[round(_p50_ms(r['seconds']), 3) for r in ranks]} ms, one rank "
        f"{_p50_ms(one['seconds']):.3f} ms")
    log(f"[dygraph] 14e checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"phase 14e failed: {checks}")
    launches = dict(one["launches"])
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


def phase_beam_dygraph():
    """Phase 14: beam translation at Transformer-big width and dygraph.
    Returns the K8 launches of the path (14a's startup, 14b, 14c, 14d's
    kernels-on run, 14e)."""
    t0 = time.perf_counter()
    launches = {}
    gang = None

    def spawn_ranks():
        # 14e's ranks start after 14a's timed translations, so that their
        # start-up overlaps 14b-14d and not 14a's rates
        nonlocal gang
        gang = _rank_spawn("--dygraph-rank")
        return {}

    parts = (("14a", _p14_beam), ("", spawn_ranks), ("14b", _p14_copy),
             ("14c", _p14_mnist), ("14d", _p14_conv),
             ("14e", lambda: _p14_dp(gang)))
    try:
        for tag, part in parts:
            t1 = time.perf_counter()
            for k, v in part().items():
                launches[k] = launches.get(k, 0) + v
            if tag:
                log(f"[p14] {tag}: {time.perf_counter() - t1:.1f} s")
    finally:
        if gang is not None:
            # a failed part must not leave the ranks running
            from paddle_tpu_torch.distributed import launch

            launch.terminate_gang(gang[0])
            shutil.rmtree(gang[1], ignore_errors=True)
    log(f"[p14] phase 14: {time.perf_counter() - t0:.1f} s; K8 {_k8(launches)}; "
        f"{card_line()}")
    return launches


# -- phase 15 ---------------------------------------------------------------
NATIVE = ("datafeed", "ps")  # the host components, built in phase 1
P15_FILES = 4                # MultiSlot files the generator writes (15b/15c)
P15_THREADS = 4              # native feed parse threads
P15_PS_STEPS = 8             # 15c: steps a leg
P15_PARITY_STEPS = 4         # 15c: steps of the parity leg's two runs
P15_PS_BATCH = 4096
P15_SERIAL = 8               # 15a: batches of the loader alone and unpooled
P15_PARITY_LR = 0.3
P15_PARITY_TOL = dict(rtol=2e-3, atol=2e-4)   # tests/test_ps.py's bars


def _p15_load_native():
    """Loads the native feed and PS, which phase 1 built from the port's
    copies (a build that failed there failed the script)."""
    from paddle_tpu_torch import native

    t0 = time.perf_counter()
    libs = [native.load_native(c) for c in NATIVE]
    log(f"[p15] native datafeed and ps (built in phase 1) loaded in "
        f"{time.perf_counter() - t0:.2f}s "
        f"({', '.join(os.path.basename(l._name) for l in libs)})")


def _p15_syncs(fn):
    """(host syncs on this thread, host syncs on every other thread) of
    one ``fn()``, each warning counted on the thread that raised it."""
    me = threading.get_ident()
    caught = _sync_warnings(fn, threads=True)
    mine = sum(ident == me for ident, _ in caught)
    return mine, len(caught) - mine


def _p15_waits(pipeline):
    """The registry's prefetch waits of ``pipeline`` so far: (the
    consumer's seconds, the producer's waits on its copies, their
    seconds). The producer's are event waits, which the sync debug mode
    does not report, so they are counted here."""
    from paddle_tpu_torch.observability import registry

    reg = registry()
    consumer = reg.histogram("dataio_consumer_wait_seconds",
                             labels={"pipeline": pipeline})
    copies = reg.histogram("dataio_copy_wait_seconds",
                           labels={"pipeline": pipeline})
    return consumer.sum, copies.count, copies.sum


def _p15_idle(tag, run):
    """(device busy ms, wall ms, idle share) of ``run()`` under
    torch.profiler (``_profile``)."""
    _, busy_us, wall_us, _ = _profile(tag, run)
    return busy_us / 1e3, wall_us / 1e3, 1 - busy_us / wall_us


def _p15_wd_run(feeds, state=None, profile_steps=0, keep=False):
    """Phase 6's Wide&Deep on the card over ``feeds`` (an iterable of feed
    dicts: the DataLoader's or ``make_batch``'s), each through
    ``engine.prepare_feed`` and ``exe.run``; the last ``profile_steps``
    steps under torch.profiler. Returns losses, step seconds (the run
    alone, not the wait for the feed; the profiled steps not among
    them), wall seconds, K5 launches, the
    persistables and host tier after a flush, the feeds' placement, the
    idle share and (``keep``) the feeds themselves."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.convert import load_params, persistables_to_numpy
    from paddle_tpu_torch.embedding import EmbeddingEngine
    from paddle_tpu_torch.models import wide_deep as wd
    from paddle_tpu_torch.utils import unique_name

    with unique_name.guard():
        main, startup, names, (loss, _pred) = wd.build_programs(
            capacity=WD_CAPACITY)
    startup.random_seed = SEED
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    if state is None:
        state = persistables_to_numpy(scope, startup)
    else:
        load_params(scope, state)
    engine = EmbeddingEngine(scope=scope)
    torch.cuda.synchronize()
    before = kernels.launches("embedding_admission")
    losses, seconds, placement, idle, kept = [], [], set(), None, []
    t_all = time.perf_counter()

    def step(feed, timed=True):
        if keep:
            kept.append(feed)
        t0 = time.perf_counter()
        feed = engine.prepare_feed(main, dict(feed))
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0][0]))
        if timed:
            seconds.append(time.perf_counter() - t0)

    it = iter(feeds)
    for i, feed in enumerate(it):
        for n in names:
            v = feed[n]
            placement.add((n.startswith("slot_") and not n.endswith("_w"),
                           type(v).__name__,
                           v.device.type if isinstance(v, torch.Tensor)
                           else "host"))
        if profile_steps and i == WD_STEPS - profile_steps:
            # the last steps under the profiler, the loader still feeding
            rest = [feed]
            idle = _p15_idle("[p15a]", lambda: [
                step(f, timed=False) for f in itertools.chain(rest, it)])
            break
        step(feed)
    wall = time.perf_counter() - t_all
    launches = kernels.launches("embedding_admission") - before
    host = engine.host_rows()
    engine.close()
    return dict(losses=losses, seconds=seconds, wall=wall, state=state,
                launches=launches, host=host, placement=placement,
                idle=idle, final=persistables_to_numpy(scope, main),
                feeds=kept)


def _p15_loader():
    """15a: phase 6's click log through the DataLoader into Wide&Deep."""
    import torch

    from paddle_tpu_torch.models import wide_deep as wd
    from paddle_tpu_torch.utils import unique_name

    t0 = time.perf_counter()
    records = _click_records()
    with unique_name.guard():
        main, _startup, names, _ = wd.build_programs(capacity=WD_CAPACITY)
    t1 = time.perf_counter()
    direct = [wd.make_batch(records[i * WD_BATCH:(i + 1) * WD_BATCH], names)
              for i in range(WD_STEPS)]
    log(f"[p15a] {len(records)} click-log records ready in {t1 - t0:.2f}s "
        f"(phase 6's, when it ran), stacked by make_batch in "
        f"{time.perf_counter() - t1:.2f}s")

    def loader(workers):
        return wd.make_loader(main, names, lambda: iter(records), WD_BATCH,
                              capacity=8, num_workers=workers)

    # the loader alone, and the synchronous pool, over the first
    # P15_SERIAL batches (the loaded run below checks all of them)
    t0 = time.perf_counter()
    staged = list(itertools.islice(loader(2), P15_SERIAL))
    torch.cuda.synchronize()
    alone_s = time.perf_counter() - t0
    serial = list(itertools.islice(loader(0), P15_SERIAL))

    def host(v):
        return v.cpu().numpy() if isinstance(v, torch.Tensor) else v

    def equal(got, want):
        return all(host(g[n]).dtype == w[n].dtype
                   and host(g[n]).shape == w[n].shape
                   and host(g[n]).tobytes() == w[n].tobytes()
                   for g, w in zip(got, want) for n in names)

    same = (len(staged) == len(serial) == P15_SERIAL
            and equal(staged, direct) and equal(serial, direct))
    del staged, serial
    fed = _p15_wd_run(direct)
    waits = _p15_waits("dataloader-prefetch")
    loaded = _p15_wd_run(loader(2), state=fed["state"], profile_steps=4,
                         keep=True)
    wait, copies, copy_s = (b - a for a, b in zip(
        waits, _p15_waits("dataloader-prefetch")))
    same = same and len(loaded["feeds"]) == WD_STEPS and equal(
        loaded["feeds"], direct)
    import paddle_tpu_torch as fluid

    want_place = {(True, "ndarray", "host"),
                  (False, "Tensor", fluid.Executor().device.type)}
    checks = {
        "batches (workers 2 and 0) == make_batch": same,
        "losses": loaded["losses"] == fed["losses"],
        "persistables": set(loaded["final"]) == set(fed["final"]) and all(
            loaded["final"][n].tobytes() == a.tobytes()
            for n, a in fed["final"].items()),
        "host tier": _same_host_tier(loaded["host"], fed["host"]),
        "K5 launches": loaded["launches"] == fed["launches"] > 0,
        "ids on the host, dense feeds on the card":
            loaded["placement"] == want_place,
        "the producer waited on its copies once a batch": copies == WD_STEPS,
    }
    step_ms = float(np.median(loaded["seconds"][1:])) * 1e3
    fed_ms = float(np.median(fed["seconds"][1:])) * 1e3
    busy, wall, idle = loaded["idle"]
    log(f"[p15a] DataLoader alone: {P15_SERIAL} batches of {WD_BATCH} in "
        f"{alone_s:.3f}s, {P15_SERIAL / alone_s:.2f} batches/s (2 workers, "
        f"staged on the card)")
    log(f"[p15a] step p50 {step_ms:.2f} ms through the loader against "
        f"{fed_ms:.2f} ms fed directly; wall {loaded['wall']:.3f}s against "
        f"{fed['wall']:.3f}s, the consumer's wait {wait:.3f}s, a share "
        f"{wait / loaded['wall']:.4f}; the producer's {copies} waits on its "
        f"copies {copy_s:.3f}s; K5 launches {loaded['launches']} (directly "
        f"{fed['launches']}); placement {sorted(loaded['placement'])}")
    log(f"[p15a] the last 4 loaded steps profiled: device busy {busy:.2f} ms of "
        f"{wall:.2f}, idle share {idle:.4f}; bit-equal: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"15a: the loader's run differs: {checks}")
    return step_ms


class _LossTap:
    """A fetch handler that keeps every step's fetches and the time
    between them (``period_secs`` 0: ``train_from_dataset`` hands it
    every step's)."""

    period_secs = 0.0

    def __init__(self):
        self.values, self.stamps = [], []

    def handler(self, fetched):
        self.stamps.append(time.perf_counter())
        self.values.append({k: np.asarray(v).copy() for k, v in fetched.items()})


def _p15_write_multislot(batches, root, names):
    """MultiSlot files of ``batches``' rows through the port's
    MultiSlotDataGenerator, ``P15_FILES`` files in row order."""
    from paddle_tpu_torch.incubate.data_generator import MultiSlotDataGenerator

    rows = [(b, r) for b in batches for r in range(len(b[names[0]]))]

    class Rows(MultiSlotDataGenerator):
        def generate_sample(self, line):
            b, r = rows[int(line)]

            def it():
                yield [(n, b[n][r].reshape(-1).tolist()) for n in names]

            return it

    os.makedirs(root, exist_ok=True)
    per = -(-len(rows) // P15_FILES)
    files = []
    for f in range(P15_FILES):
        path = os.path.join(root, f"part-{f}")
        lines = Rows().run_from_memory(
            str(i) for i in range(f * per, min((f + 1) * per, len(rows))))
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        files.append(path)
    return files


def _p15_dataset(feed_vars, files, batch, native=True):
    import paddle_tpu_torch as fluid

    ds = fluid.DatasetFactory().create_dataset("InMemoryDataset")
    ds._use_native = native
    ds.set_batch_size(batch)
    ds.set_thread(P15_THREADS)
    ds.set_use_var(feed_vars)
    ds.set_filelist(files)
    t0 = time.perf_counter()
    ds.load_into_memory()
    return ds, time.perf_counter() - t0


def _same_batches(a, b):
    return len(a) == len(b) and all(
        set(x) == set(y) and all(np.asarray(x[k]).tobytes()
                                 == np.asarray(y[k]).tobytes() for k in x)
        for x, y in zip(a, b))


def _p15_dataset_ctr(root):
    """15b: phase 7's dense CTR fed by an InMemoryDataset on the native
    feed through ``train_from_dataset`` (Hogwild, the prefetcher),
    against ``exe.run`` over the same batches."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.models import ctr
    from paddle_tpu_torch.utils import unique_name
    from paddle_tpu_torch.utils.flags import flags

    rng = np.random.RandomState(SEED + 4)
    batches = [ctr.synthetic_batch(rng, CTR_BATCH, id_space=CTR_VOCAB)
               for _ in range(CTR_STEPS)]
    with unique_name.guard():
        main, startup, feed_vars, (loss, _pred) = ctr.build_ctr_train(
            ps_mode=False, vocab_size=CTR_VOCAB,
            optimizer=fluid.optimizer.SGD(learning_rate=0.1))
    names = [v.name for v in feed_vars]
    t0 = time.perf_counter()
    files = _p15_write_multislot(batches, os.path.join(root, "ctr"), names)
    write_s = time.perf_counter() - t0
    ds, load_s = _p15_dataset(feed_vars, files, CTR_BATCH)
    py_ds, py_load_s = _p15_dataset(feed_vars, files, CTR_BATCH, native=False)
    if not ds.native_feed:
        raise AssertionError("15b: the dataset is not on the native feed")
    native_b, py_b = list(ds._iter_batches()), list(py_ds._iter_batches())
    want = [{n: b[n].astype(np.int64 if n.startswith("slot_") else np.float32)
             for n in names} for b in batches]
    feed_checks = {"native == _PyFeed": _same_batches(native_b, py_b),
                   "native == the generator's rows": _same_batches(
                       native_b, want)}
    del native_b, py_b, py_ds
    tables = [v.name for v in main.global_block().vars.values()
              if v.persistable and v.name.endswith("_w")
              and v.shape[0] == CTR_VOCAB]
    startup.random_seed = SEED
    scopes = {}
    for arm in ("dataset", "run"):
        scopes[arm] = fluid.Scope()
        fluid.Executor().run(startup, scope=scopes[arm])
    old = flags.pallas_sparse_update
    flags.pallas_sparse_update = True
    try:
        exe = fluid.Executor()
        ref, ref_s = [], []
        for i, b in enumerate(batches):
            t0 = time.perf_counter()
            run = lambda: ref.append(float(exe.run(  # noqa: E731
                main, feed=dict(b), fetch_list=[loss],
                scope=scopes["run"])[0][0]))
            if i == len(batches) - 1:
                ref_syncs = _count_syncs(run)
            else:
                run()
            ref_s.append(time.perf_counter() - t0)
        # the feed uploads' share of exe.run's syncs: what the prefetcher
        # takes off the training thread
        feed_syncs = _count_syncs(lambda: [
            torch.from_numpy(np.ascontiguousarray(a)).to(exe.device)
            for a in batches[0].values()])
        torch.cuda.synchronize()
        before = kernels.launches("sparse_row_update")
        tap = _LossTap()
        waits = _p15_waits("train_from_dataset")
        t0 = time.perf_counter()
        consumer_syncs, other_syncs = _p15_syncs(
            lambda: exe.train_from_dataset(main, ds, scope=scopes["dataset"],
                                           fetch_list=[loss],
                                           fetch_handler=tap))
        wall = time.perf_counter() - t0
        launches = kernels.launches("sparse_row_update") - before
        wait, copies, copy_s = (b - a for a, b in zip(
            waits, _p15_waits("train_from_dataset")))
    finally:
        flags.pallas_sparse_update = old
    got = [float(v[loss.name].reshape(-1)[0]) for v in tap.values]
    steps = np.diff([t0] + tap.stamps)
    checks = dict(feed_checks)
    checks["losses"] = got == ref
    checks["tables"] = all(torch.equal(scopes["dataset"].find_var(n),
                                       scopes["run"].find_var(n))
                           for n in tables)
    checks["K6 16 a step"] = launches == 16 * CTR_STEPS
    checks["the producer waited on its copies once a batch"] = (
        copies == CTR_STEPS)
    checks[f"exe.run's syncs {CTR_STEP_SYNCS} a step (phase 7)"] = (
        ref_syncs == CTR_STEP_SYNCS)
    checks["training-thread syncs: exe.run's less the feed uploads'"] = (
        consumer_syncs == (ref_syncs - feed_syncs) * CTR_STEPS)
    n_records = CTR_BATCH * CTR_STEPS
    log(f"[p15b] {n_records} records in {P15_FILES} MultiSlot files "
        f"(written in {write_s:.2f}s); load_into_memory native "
        f"{load_s:.3f}s = {n_records / load_s:.0f} records/s parsed "
        f"({P15_THREADS} threads), _PyFeed {py_load_s:.3f}s = "
        f"{n_records / py_load_s:.0f} records/s")
    log(f"[p15b] train_from_dataset step p50 "
        f"{float(np.median(steps[1:])) * 1e3:.2f} ms (first "
        f"{steps[0] * 1e3:.2f}) against exe.run's "
        f"{float(np.median(ref_s[1:])) * 1e3:.2f} ms; wall {wall:.3f}s, "
        f"the consumer's wait {wait:.3f}s; K6 launches {launches}; host "
        f"syncs {consumer_syncs / CTR_STEPS:.2f} a step on the training "
        f"thread, {other_syncs / CTR_STEPS:.2f} on the others; the "
        f"producer's {copies} waits on its copies (an event, which the "
        f"sync debug mode does not see) {copy_s:.3f}s; exe.run's step "
        f"{ref_syncs}, {feed_syncs} of them the 9 feeds' uploads")
    log(f"[p15b] losses {got}; bit-equal: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"15b: train_from_dataset differs: {checks}")
    return launches


def _p15_ps_leg(tag, ps_mode, batches, optimizer=None, sparse_lr=0.1,
                zero_init=False, dataset=None, vocab=None):
    """One PS leg: ``build_ctr_train(ps_mode=...)`` against a fresh
    in-process native PSServer, ``len(batches)`` steps through
    ``fleet.worker(exe).run`` (True), ``exe.run`` with
    ``prefetch_for_program`` ("remote"), ``train_from_dataset`` with the
    DownpourSGD worker (``dataset=``), or the dense baseline (False).
    Returns losses, step seconds, pull/push seconds, host syncs of one
    step, the idle share of one step, table row counts and the unique
    ids a table pulled."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed import lookup
    from paddle_tpu_torch.fleet import parameter_server as psfleet
    from paddle_tpu_torch.fleet.role_maker import UserDefinedRoleMaker
    from paddle_tpu_torch.models import ctr
    from paddle_tpu_torch.utils import unique_name

    fleet = psfleet.fleet
    fleet.init(UserDefinedRoleMaker(current_id=0, worker_num=1))
    with unique_name.guard():
        main, startup, feed_vars, (loss, _pred) = ctr.build_ctr_train(
            ps_mode=ps_mode, optimizer=optimizer, sparse_lr=sparse_lr,
            vocab_size=vocab)
    if zero_init:
        for t in getattr(main, "_sparse_tables", {}).values():
            t["init_range"] = 0.0
    startup.random_seed = SEED
    exe, scope = fluid.Executor(), fluid.Scope()
    out = dict(losses=[], seconds=[], syncs=None, idle=None, rows=None,
               pulled={}, pull_s=0.0, push_s=0.0, hits=None)
    srv = fleet.init_server(port=0) if ps_mode else None
    try:
        if ps_mode:
            fleet.init_worker(main)
        exe.run(startup, scope=scope)
        if ps_mode is False and zero_init:
            for v in main.all_parameters():
                if v.name.startswith("deep_") and v.name.endswith("_w"):
                    scope.set(v.name, torch.zeros(v.shape,
                                                  device=exe.device))
        worker = fleet.worker(exe, main) if ps_mode is True else None
        ctx = lookup.active_context()
        if dataset is not None:
            tap = _LossTap()
            t0 = time.perf_counter()
            exe.train_from_dataset(main, dataset, scope=scope,
                                   fetch_list=[loss], fetch_handler=tap)
            out["losses"] = [float(v[loss.name].reshape(-1)[0])
                             for v in tap.values]
            out["seconds"] = list(np.diff([t0] + tap.stamps))
        else:
            def step(i):
                b = batches[i]
                t0 = time.perf_counter()
                if ps_mode is True:
                    if i + 1 < len(batches):
                        worker.prefetch(main, batches[i + 1])
                    r = worker.run(main, dict(b), fetch_list=[loss],
                                   scope=scope)
                else:
                    if ps_mode == "remote" and i + 1 < len(batches):
                        lookup.prefetch_for_program(main, batches[i + 1])
                    r = exe.run(main, feed=dict(b), fetch_list=[loss],
                                scope=scope)
                out["losses"].append(float(r[0][0]))
                out["seconds"].append(time.perf_counter() - t0)

            last = len(batches) - 1
            for i in range(len(batches)):
                if i == last - 1:
                    out["syncs"] = _count_syncs(lambda: step(i))
                elif i == last:
                    out["idle"] = _p15_idle(f"[p15c] {tag}",
                                            lambda: step(i))
                else:
                    step(i)
        if worker is not None:
            worker.flush()
            out["pull_s"] = worker.stats["pull_seconds"]
            out["push_s"] = worker.stats["push_seconds"]
        if ctx is not None:
            out["pull_s"] = ctx.stats["pull_seconds"]
            out["push_s"] = ctx.stats["push_seconds"]
            out["hits"] = ctx.stats["prefetch_hits"]
            out["transfers"] = (ctx.stats["uploads"], ctx.stats["downloads"])
        if ps_mode:
            out["rows"] = fleet._client.table_stats()
            for tables in (getattr(main, "_sparse_tables", {}),
                           getattr(main, "_remote_tables", {})):
                for t in tables.values():
                    ids = np.concatenate([np.asarray(b[t["ids"]]).ravel()
                                          for b in batches])
                    out["pulled"][t["table_id"]] = len(np.unique(ids))
    finally:
        if ps_mode:
            fleet.stop_worker()
            srv.stop()
    return out, feed_vars


def _p15_ps(root):
    """15c: ``build_ctr_train()`` at its own width against the port's
    native PS: (i) ps_mode=True, (ii) "remote", (iii) (i) as DownpourSGD
    through ``train_from_dataset``, and the parity leg against the dense
    baseline."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import ctr

    rng = np.random.RandomState(SEED + 15)
    big = [ctr.synthetic_batch(rng, P15_PS_BATCH) for _ in range(P15_PS_STEPS)]
    small = [ctr.synthetic_batch(rng, P15_PS_BATCH, id_space=2 ** 31 - 1)
             for _ in range(P15_PS_STEPS)]
    legs = {}
    t0 = time.perf_counter()
    legs["i"], feed_vars = _p15_ps_leg("i", True, big)
    legs["ii"], _ = _p15_ps_leg("ii", "remote", small)
    log(f"[p15c] legs (i) and (ii) in {time.perf_counter() - t0:.1f}s")
    names = [v.name for v in feed_vars]
    files = _p15_write_multislot(big, os.path.join(root, "ps"), names)
    ds, _ = _p15_dataset(feed_vars, files, P15_PS_BATCH)
    if not ds.native_feed:
        raise AssertionError("15c: the dataset is not on the native feed")
    legs["iii"], _ = _p15_ps_leg("iii", True, big, dataset=ds)
    parity_batches = [ctr.synthetic_batch(rng, P15_PS_BATCH,
                                          id_space=CTR_VOCAB)
                      for _ in range(P15_PARITY_STEPS)]
    sgd = dict(sparse_lr=P15_PARITY_LR, zero_init=True)
    ps_par, _ = _p15_ps_leg("parity PS", True, parity_batches,
                            optimizer=fluid.optimizer.SGD(P15_PARITY_LR),
                            **sgd)
    dense_par, _ = _p15_ps_leg("parity dense", False, parity_batches,
                               optimizer=fluid.optimizer.SGD(P15_PARITY_LR),
                               vocab=CTR_VOCAB, **sgd)
    diff = np.abs(np.subtract(ps_par["losses"], dense_par["losses"]))
    parity = bool(np.all(diff <= P15_PARITY_TOL["atol"]
                         + P15_PARITY_TOL["rtol"]
                         * np.abs(dense_par["losses"])))
    checks = {
        "(iii) == (i) bit for bit": legs["iii"]["losses"] == legs["i"]["losses"],
        "server rows == unique ids pulled": all(
            legs[k]["rows"] == legs[k]["pulled"] for k in ("i", "ii", "iii")),
        "prefetch hits > 0": (legs["ii"]["hits"] or 0) > 0,
        "parity within rtol 2e-3, atol 2e-4": parity,
        "losses finite": all(np.all(np.isfinite(legs[k]["losses"]))
                             for k in legs),
    }
    for k, leg in legs.items():
        n = len(leg["seconds"])
        p50 = float(np.median(leg["seconds"][1:])) * 1e3
        pull_ms, push_ms = leg["pull_s"] / n * 1e3, leg["push_s"] / n * 1e3
        idle = leg["idle"]
        log(f"[p15c] leg ({k}): step p50 {p50:.2f} ms (first "
            f"{leg['seconds'][0] * 1e3:.2f}); pull {pull_ms:.2f} ms and push "
            f"{push_ms:.2f} ms a step ({(pull_ms + push_ms) / p50:.3f} of "
            f"the p50); host syncs in one step {leg['syncs']}; "
            + (f"profiled step: device busy {idle[0]:.2f} of {idle[1]:.2f} "
               f"ms, idle share {idle[2]:.4f}; " if idle else "")
            + f"prefetch hits {leg['hits']}, transfers (uploads, downloads) "
            f"{leg.get('transfers')}; server rows "
            f"{sum(leg['rows'].values())} in {len(leg['rows'])} tables; "
            f"losses {leg['losses']}")
    log(f"[p15c] parity (SGD {P15_PARITY_LR}, zero init, vocab 2^20): PS "
        f"{ps_par['losses']} against dense {dense_par['losses']}, largest "
        f"difference {float(diff.max()):.3e}; checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"15c: the parameter-server legs fail: {checks}")


def phase_data_plane():
    """15: the data plane and the parameter server (15a-15c). Returns
    the launches of the whole phase (K5 in 15a, K6 in 15b, K8 in the
    startups)."""
    import tempfile

    from paddle_tpu_torch import kernels

    t0 = time.perf_counter()
    _p15_load_native()
    root = tempfile.mkdtemp(prefix="p15_")
    try:
        kernels.reset_launches()
        _p15_loader()
        log(f"[p15] 15a done at {time.perf_counter() - t0:.1f}s")
        _p15_dataset_ctr(root)
        log(f"[p15] 15b done at {time.perf_counter() - t0:.1f}s")
        _p15_ps(root)
        counts = kernels.launches()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[p15] phase 15 {time.perf_counter() - t0:.1f}s; launches "
        f"{ {n: c for n, c in counts.items() if c} }")
    return counts


# -- phase 16: hybrid parallelism on the IR path ----------------------------
# models/gpt_ir.py at the JAX package's GPT-base width (GPTConfig,
# paddle_tpu/models/gpt.py:44-50: vocab 32000, hidden 768, 12 layers, 12
# heads, ffn 4x, context 1024), Megatron tp 2, on 4 gloo ranks of the one
# card as (data, stage, model) = (1, 2, 2): GPipe over 2 stages of 6
# layers, 4 microbatches of 2 sequences of 1024 tokens (global batch 8),
# 3 Adam steps at `build_gpt_ir`'s lr; against one rank (this process) running
# the same global weights at tp 1 through the plain executor. Every rank's
# startup draws the global weights the one-rank run draws (the programs
# create the same parameters in the same order); placement slices them.
P16_CONFIG = dict(vocab_size=32000, hidden_size=768, num_layers=12,
                  num_heads=12, ffn_mult=4, max_seq_len=1024)
P16_TP, P16_MESH, P16_AXES = 2, (1, 2, 2), ("data", "stage", "model")
P16_RANKS = int(np.prod(P16_MESH))
P16_SEQ, P16_BATCH, P16_MICROBATCHES, P16_STEPS, P16_LR = 1024, 8, 4, 3, 1e-3
P16_TIMEOUT = 600.0
# The bars sit between what sound runs read on an H100 80GB HBM3 at 700 W
# and the smallest fault they must catch. Losses: the JAX package's
# tp-parity bar (tests/test_pipeline_ir.py:141-168), rtol 5e-4. Grads of
# step 1 (every parameter, gathered from the shards): each within 1e-5 of
# its parameter's largest |grad| of the one-rank run (or of 1e-3 of the
# model's largest, for the key biases, whose grads are 0 up to rounding,
# softmax being blind to a per-query constant); sound runs read 1.91e-06
# (a rank's GEMMs contract half the width, or sum two partial products
# through the model all-reduce, in another order); a wrong shard, a
# missing or doubled all-reduce or a LayerNorm grad summed over the wrong
# axis moves a grad by its own size. Parameters after the steps: Adam
# moves an element by up to lr a step, so a wrong update of any one
# element (a fault in the optimizer slots, which step 1's grads cannot
# see) moves it by about 1e-3; sound runs read 4.066e-06 at most and
# 2.517e-09 on average over the 134,994,432 values: every element within
# 1e-4, and the mean |difference| within 1e-8.
P16_LOSS_TOL, P16_GRAD_TOL = (5e-4, 1e-6), 1e-5
P16_PARAM_MAX, P16_PARAM_MEAN = 1e-4, 1e-8
P16_FLASH = ("flash_attention_fwd", "flash_attention_bwd_dkdv",
             "flash_attention_bwd_dq")


def _p16_program(tp):
    """(cfg, main, startup, loss, stack) of phase 16's gpt_ir at ``tp``."""
    from paddle_tpu_torch.models import gpt_ir
    from paddle_tpu_torch.utils import unique_name

    cfg = gpt_ir.GPTIRConfig(**P16_CONFIG, tp=tp)
    with unique_name.guard():
        main, startup, _, loss, stack = gpt_ir.build_gpt_ir(
            cfg, seq_len=P16_SEQ, num_microbatches=P16_MICROBATCHES,
            lr=P16_LR)
    startup.random_seed = main.random_seed = SEED
    return cfg, main, startup, loss, stack


def _p16_feed(cfg):
    from paddle_tpu_torch.models import gpt_ir

    toks, labs = gpt_ir.synthetic_batch(np.random.RandomState(SEED + 16),
                                        P16_BATCH, P16_SEQ, cfg)
    return {"tokens": toks, "labels": labs}


def _p16_steps(exe, prog, scope, feed, loss, names):
    """P16_STEPS steps: losses, host seconds (the run, ending in the
    loss's copy, and a synchronize), the collectives by axis of each step;
    the first also fetches every parameter's grad (returned, numpy)."""
    import torch

    from paddle_tpu_torch.parallel import env as penv

    out = dict(losses=[], seconds=[], stats=[])
    grads = None
    for step in range(P16_STEPS):
        fetch = [loss] + ([n + "@GRAD" for n in names] if step == 0 else [])
        penv.reset_collective_stats()
        t0 = time.perf_counter()
        vals = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["losses"].append(float(vals[0].reshape(-1)[0]))
        out["stats"].append({f"{k}|{a}": list(v) for (k, a), v in
                             penv.collective_stats(by_axis=True).items()})
        if step == 0:
            grads = dict(zip(names, vals[1:]))
    return out, grads


def _p16_run(exe, prog, main, startup, scope, loss, feed):
    """Startup, the steps and one profiled step of phase 16 in this
    process; returns (what it saw, the grads of step 1)."""
    import torch

    from paddle_tpu_torch import kernels

    names = [p.name for p in main.all_parameters()]
    kernels.reset_launches()
    exe.run(startup, scope=scope)
    startup_launches = kernels.launches()
    init = _digest(scope.find_var(n) for n in names)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    run, grads = _p16_steps(exe, prog, scope, feed, loss, names)
    launches = kernels.launches()
    peak = torch.cuda.max_memory_allocated()
    sub = [b for b in main.blocks if b.idx > 0]
    n_sdpa = sum(op.type == "scaled_dot_product_attention"
                 for b in sub for op in b.ops)
    return dict(run, names=names, init=init, launches=launches,
                startup_launches=startup_launches, peak=peak, n_sdpa=n_sdpa,
                device=torch.cuda.get_device_name(0)), grads


def _p16_profile(exe, prog, scope, feed, loss, tag):
    """(device busy ms, wall ms) of one more step under torch.profiler."""
    _, busy_us, wall_us, _ = _profile(tag, lambda: exe.run(
        prog, feed=feed, fetch_list=[loss], scope=scope))
    return busy_us / 1e3, wall_us / 1e3


def hybrid_rank_main(out_dir):
    """One rank of phase 16 (``chip_smoke.py --hybrid-rank DIR``): without
    its card it exits nonzero before any step. It writes what it saw to
    ``DIR/rank<r>.json`` and rank 0 the global parameters after the steps
    and the grads of step 1 to ``DIR/state.npz``."""
    check_environment()
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel import env as penv

    t0 = time.perf_counter()
    mesh = penv.make_mesh(P16_MESH, P16_AXES)
    cfg, main, startup, loss, stack = _p16_program(P16_TP)
    exe, scope = fluid.Executor(), fluid.Scope()
    prog = fluid.CompiledProgram(main).with_parallel(
        mesh=mesh, loss_name=loss.name,
        param_specs=stack.param_spec_overrides())
    feed = _p16_feed(cfg)
    result, grads = _p16_run(exe, prog, main, startup, scope, loss, feed)
    names = result["names"]
    specs = prog.specs(names)
    result.update(
        rank=mesh.rank, coords=mesh.coords, backend=mesh.backend,
        build_s=time.perf_counter() - t0 - sum(result["seconds"]),
        specs={n: [list(e) if isinstance(e, tuple) else e for e in specs[n]]
               for n in names},
        local={n: _digest([scope.find_var(n)]) for n in names},
        shapes={n: list(scope.find_var(n).shape) for n in names})
    # every rank takes part in the gathers; rank 0 keeps the result
    params = {n: prog.global_value(scope, n).cpu().numpy() for n in names}
    if mesh.rank == 0:
        np.savez(os.path.join(out_dir, "state.npz"),
                 **{"p." + n: v for n, v in params.items()},
                 **{"g." + n: v for n, v in grads.items()})
    del params, grads
    torch.cuda.synchronize()
    result["busy_ms"], result["wall_ms"] = _p16_profile(
        exe, prog, scope, feed, loss, f"[hybrid] rank {mesh.rank}")
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(result, f)


def _p16_reference():
    """The one-rank run: tp 1, the plain executor, this process."""
    import torch

    import paddle_tpu_torch as fluid

    cfg, main, startup, loss, _ = _p16_program(1)
    exe, scope = fluid.Executor(), fluid.Scope()
    feed = _p16_feed(cfg)
    ref, grads = _p16_run(exe, main, main, startup, scope, loss, feed)
    params = {n: scope.find_var(n).cpu().numpy() for n in ref["names"]}
    ref["busy_ms"], ref["wall_ms"] = _p16_profile(
        exe, main, scope, feed, loss, "[hybrid] one rank")
    del scope, exe
    torch.cuda.empty_cache()
    return ref, grads, params


def _p16_axis_line(r, key, steps):
    """calls, MB and host ms a step of one collective kind on one axis
    (p50 of the steps after the first)."""
    vals = [s.get(key, [0, 0, 0.0]) for s in r["stats"][1:]] or [[0, 0, 0.0]]
    calls, nbytes, secs = (float(np.median([v[i] for v in vals]))
                           for i in range(3))
    return calls, nbytes, secs * 1e3


def phase_hybrid():
    """Phase 16: the one-rank run here, then the 4 ranks; hold them
    against each other and against the plan."""
    import torch

    from paddle_tpu_torch.parallel import pipeline

    t_phase = time.perf_counter()
    ref, ref_grads, ref_params = _p16_reference()
    procs, out_dir = _rank_spawn("--hybrid-rank", P16_RANKS)
    try:
        ranks = _rank_results((procs, out_dir), P16_RANKS, P16_TIMEOUT,
                              keep=True)
        state = np.load(os.path.join(out_dir, "state.npz"))
        got_params = {n: state["p." + n] for n in ref["names"]}
        got_grads = {n: state["g." + n] for n in ref["names"]}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    r0 = ranks[0]
    n_stage, n_model = P16_MESH[1], P16_MESH[2]
    layers = P16_CONFIG["num_layers"] // n_stage
    m = P16_MICROBATCHES
    act = P16_BATCH // P16_MESH[0] // m * P16_SEQ * P16_CONFIG["hidden_size"] * 4
    plan = {"all_reduce|model": (4 * layers * m, 4 * layers * m * act),
            "send|stage": (m, m * act), "recv|stage": (m, m * act),
            "broadcast|stage": (1, m * act)}
    # one K1, K2a and K2b a layer a microbatch: the grad keeps the
    # forward's graph, so no forward runs twice
    want_launches = {n: r0["n_sdpa"] * layers * m * P16_STEPS
                     for n in P16_FLASH}
    want_ref = {n: ref["n_sdpa"] * P16_CONFIG["num_layers"] * m * P16_STEPS
                for n in P16_FLASH}
    rtol, atol = P16_LOSS_TOL
    largest = max(float(np.abs(g).max()) for g in ref_grads.values())
    grad_err = {n: float(np.abs(got_grads[n] - ref_grads[n]).max())
                / max(float(np.abs(ref_grads[n]).max()), 1e-3 * largest)
                for n in ref["names"]}
    diffs = {n: np.abs(got_params[n] - ref_params[n]) for n in ref["names"]}
    n_values = sum(d.size for d in diffs.values())
    param_max = max(float(d.max()) for d in diffs.values())
    param_mean = sum(float(d.sum()) for d in diffs.values()) / n_values
    by_shard = {}
    for r in ranks:
        for n, digest in r["local"].items():
            used = {a for e in r["specs"][n] if e is not None
                    for a in (e if isinstance(e, list) else [e])}
            key = (n,) + tuple(sorted((a, i) for a, i in r["coords"].items()
                                      if a in used))
            by_shard.setdefault(key, set()).add(digest)
    def as_planned(s, i):
        # the first step also places the parameters (broadcasts along the
        # axes they are replicated on) and gathers the grads it fetches
        return all(tuple(s.get(k, [0, 0])[:2]) == v for k, v in plan.items()
                   if i or k != "broadcast|stage")

    checks = {
        "backend gloo": all(r["backend"] == "gloo" for r in ranks),
        "every rank's startup drew the one-rank weights": all(
            r["init"] == ref["init"] for r in ranks),
        "ranks' losses equal": all(r["losses"] == r0["losses"]
                                   for r in ranks),
        f"losses within {P16_LOSS_TOL} of one rank": all(
            abs(a - b) <= atol + rtol * abs(b)
            for a, b in zip(r0["losses"], ref["losses"])),
        f"grads of step 1 within {P16_GRAD_TOL} of their largest": all(
            e <= P16_GRAD_TOL for e in grad_err.values()),
        f"parameters within {P16_PARAM_MAX} (max) and {P16_PARAM_MEAN} "
        "(mean)": param_max <= P16_PARAM_MAX and param_mean <= P16_PARAM_MEAN,
        "replicas of a shard bit-equal": all(
            len(d) == 1 for d in by_shard.values()),
        "K1, K2a, K2b launched on every rank as planned": all(
            r["launches"].get(k, 0) == v for r in ranks
            for k, v in want_launches.items()),
        "one rank's launches as planned": all(
            ref["launches"].get(k, 0) == v for k, v in want_ref.items()),
        "each step's model all-reduces and stage hops as planned": all(
            as_planned(s, i) for r in ranks
            for i, s in enumerate(r["stats"])),
        "losses finite and falling": bool(np.isfinite(r0["losses"]).all())
        and r0["losses"][-1] < r0["losses"][0],
    }
    ms = [_p50_ms(r["seconds"]) for r in ranks]
    one = _p50_ms(ref["seconds"])
    log(f"[hybrid] gpt_ir GPT-base width ({P16_CONFIG}), tp {P16_TP}, mesh "
        f"{dict(zip(P16_AXES, P16_MESH))} on {P16_RANKS} ranks over "
        f"{r0['backend']} sharing {r0['device']}; seq {P16_SEQ}, global "
        f"batch {P16_BATCH}, {m} microbatches, {P16_STEPS} Adam steps; "
        f"{r0['n_sdpa']} attention ops a stage, build + startup "
        f"{[round(r['build_s'], 2) for r in ranks]} s a rank")
    log(f"[hybrid] losses {r0['losses']}; one rank at tp 1 {ref['losses']}; "
        f"largest gap {max(abs(a - b) for a, b in zip(r0['losses'], ref['losses'])):.3e}")
    worst = sorted(grad_err.items(), key=lambda x: -x[1])[:4]
    log(f"[hybrid] grads of step 1 against one rank, |diff| / max|grad|: "
        f"largest {[(n, f'{e:.2e}') for n, e in worst]}; parameters after "
        f"{P16_STEPS} steps: max |diff| {param_max:.3e}, mean "
        f"{param_mean:.3e} over {n_values} values; {len(by_shard)} "
        f"(parameter, shard) pairs, replicas bit-equal")
    log(f"[hybrid] launches a rank over {P16_STEPS} steps "
        f"{[{k: r['launches'].get(k, 0) for k in P16_FLASH} for r in ranks]}"
        f" (planned {want_launches}); one rank {[ref['launches'].get(k, 0) for k in P16_FLASH]}")
    bubble = pipeline.predicted_bubble(n_stage, m)
    log(f"[hybrid] step p50 by rank {[round(x, 2) for x in ms]} ms (steps "
        f"{[[round(s * 1e3, 2) for s in r['seconds']] for r in ranks]}); one "
        f"rank at tp 1 {one:.2f} ms (steps "
        f"{[round(s * 1e3, 2) for s in ref['seconds']]}); "
        f"{P16_BATCH * P16_SEQ / max(ms) * 1e3:.1f} tokens/s against "
        f"{P16_BATCH * P16_SEQ / one * 1e3:.1f}; GPipe bubble predicted "
        f"{bubble:.4f} of a stage's ticks")
    for r in ranks:
        step = _p50_ms(r["seconds"])
        parts = {k: _p16_axis_line(r, k, P16_STEPS) for k in plan}
        recv_ms = parts["recv|stage"][2]
        log(f"[hybrid] rank {r['rank']} {r['coords']}: " + ", ".join(
            f"{k} {c:.0f} calls {b / 1e6:.1f} MB {t:.1f} ms"
            for k, (c, b, t) in parts.items())
            + f" a step (p50 after the first); waiting on the stage's "
            f"receives {recv_ms / step:.4f} of the step (the bubble and the "
            f"other stage's work); model all-reduces "
            f"{parts['all_reduce|model'][2] / step:.4f} of it; device busy "
            f"{r['busy_ms']:.2f} ms of a {r['wall_ms']:.2f} ms profiled step,"
            f" idle share {1 - r['busy_ms'] / r['wall_ms']:.4f}; memory peak "
            f"{r['peak'] / 2**30:.3f} GiB")
    log(f"[hybrid] one rank: device busy {ref['busy_ms']:.2f} ms of a "
        f"{ref['wall_ms']:.2f} ms profiled step, idle share "
        f"{1 - ref['busy_ms'] / ref['wall_ms']:.4f}; memory peak "
        f"{ref['peak'] / 2**30:.3f} GiB")
    parted = sorted(k for k, d in by_shard.items() if len(d) > 1)
    if parted:
        log(f"[hybrid] replicas that part: {parted}")
    log(f"[hybrid] {card_line()}")
    log(f"[hybrid] checks: {checks}")
    log(f"[hybrid] phase 16 {time.perf_counter() - t_phase:.1f}s")
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"hybrid phase failed: {checks}")
    launches = {}
    for r in ranks + [ref]:
        for part in (r["launches"], r["startup_launches"]):
            for k, v in part.items():
                launches[k] = launches.get(k, 0) + v
    return launches


PHASES = tuple(str(n) for n in range(1, 17))


def parse_phases(argv):
    """``--phases 1,11`` -> {"1", "11"}; no argument -> every phase. The
    build (1) always runs: every later phase needs the kernels."""
    if not argv:
        return set(PHASES)
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit(f"usage: chip_smoke.py [--phases 1,2,...] (got {argv})")
    chosen = {p.strip() for p in argv[1].split(",") if p.strip()}
    unknown = chosen - set(PHASES)
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {sorted(unknown)}; "
                         f"have {', '.join(PHASES)}")
    return chosen | {"1"}


def main(phases=frozenset(PHASES)):
    check_environment()
    import torch

    from paddle_tpu_torch.kernels import KERNELS

    t_all = time.perf_counter()
    card = card_line()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}; phases "
        f"{sorted(phases, key=int)}")
    zero = {n: 0 for n in KERNELS}

    def timed(tag, fn, *args):
        """``fn(*args)``, and a line with its seconds (the breakdown the
        whole script's time limit is budgeted by)."""
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[time] phase {tag}: {time.perf_counter() - t0:.1f}s")
        return out

    timed("1", phase_build)
    parity = {}
    if "2" in phases:
        for tag, fn in (("2", phase_parity), ("2 flash", phase_flash),
                        ("2f", phase_flash16), ("2 ctr", phase_ctr_kernels),
                        ("2 topk", phase_topk), ("2e", phase_random)):
            parity.update(timed(tag, fn))
    engine_launches, modes_launches = zero, 0
    beam_launches = overload_launches = 0
    if "3" in phases:
        engine_launches, greedy_tps, greedy_step = timed("3", phase_engine)
        modes_launches = timed("3b", phase_decode_modes, greedy_tps)
        beam_launches = timed("3c", phase_beam_grammar, greedy_tps,
                              greedy_step)
        overload_launches = timed("3d", phase_overload, greedy_tps)
    dense_launches = timed("4", phase_dense) if "4" in phases else zero
    train_launches = unfused_launches = amp_launches = zero
    if "5" in phases:
        train_launches = timed("5", phase_train)
        unfused_launches = timed("5b", phase_bert_unfused)
        amp_launches = timed("5c", phase_train_amp)
    wide_deep_launches = (timed("6", phase_wide_deep) if "6" in phases
                          else zero)
    ctr_launches = timed("7", phase_dense_ctr) if "7" in phases else zero
    dgc_launches = timed("8", phase_dgc) if "8" in phases else zero
    book_launches = resnet_launches = resnet_amp_launches = zero
    if "9" in phases or "10" in phases:
        # phase 10 exports 9a's trained book programs
        book_launches, book = timed("9a", phase_book)
    if "9" in phases:
        resnet_launches = timed("9b-9c", phase_resnet)
        resnet_amp_launches = timed("9d", phase_resnet_amp)
    ckpt_launches = (timed("10", phase_checkpoint, book) if "10" in phases
                     else zero)
    infer_launches = timed("11", phase_inference) if "11" in phases else zero
    fleet_launches = timed("12", phase_fleet) if "12" in phases else zero
    dp_launches = timed("13", phase_dp) if "13" in phases else zero
    p14_launches = (timed("14", phase_beam_dygraph) if "14" in phases
                    else zero)
    p15_launches = (timed("15", phase_data_plane) if "15" in phases
                    else zero)
    p16_launches = timed("16", phase_hybrid) if "16" in phases else zero
    log(f"[done] paged_attention launches: phase 3 "
        f"{engine_launches['paged_attention']}, phase 3b {modes_launches}, "
        f"phase 3c {beam_launches}, phase 3d {overload_launches}")
    log(f"[done] phase 12's workers: "
        f"{ {n: fleet_launches[n] for n in ('paged_attention', 'threefry_random_bits')} }")
    path_launches = {"paged_attention": engine_launches["paged_attention"]
                                        + modes_launches + beam_launches
                                        + overload_launches
                                        + fleet_launches["paged_attention"],
                     "decode_attention": dense_launches["decode_attention"],
                     "embedding_admission":
                         wide_deep_launches["embedding_admission"]
                         + ckpt_launches["embedding_admission"]
                         + p15_launches["embedding_admission"],
                     "sparse_row_update": ctr_launches["sparse_row_update"]
                         + p15_launches["sparse_row_update"],
                     "blocked_topk_abs": dgc_launches["blocked_topk_abs"]}
    # the float32 flash builds on phase 5's, 10a's, 11's and 13's paths
    # (13: both ranks and the one-rank run), the bf16
    # ones on 5c's and 11b's, the float16 ones on 5c's float16 leg
    path_launches.update({n: (amp_launches[n] if n.endswith(("_bf16", "_f16"))
                              else train_launches[n] + ckpt_launches[n]
                              + dp_launches.get(n, 0)
                              + p16_launches.get(n, 0))
                          + infer_launches.get(n, 0)
                          for n in KERNELS if n.startswith("flash_attention")})
    # K8: phase 5's startup (random_bits) and dropout sites, phase 5b's,
    # 5c's (its bf16 run) and rank 0's of phase 8, phase 9's startups,
    # phase 10a's startup and steps, phase 11's startups, the startups of
    # phase 12's workers (read over their stats RPC; the killed one's are
    # lost with it), phase 13's startups and steps (both ranks and the
    # one-rank run), phase 14's (14a's startup, 14b, 14c, 14d's kernels-on
    # run, 14e's ranks and one-rank run), phase 15's startups
    path_launches.update({n: train_launches[n] + unfused_launches[n]
                          + amp_launches[n] + dgc_launches[n]
                          + book_launches[n] + resnet_launches[n]
                          + resnet_amp_launches[n] + ckpt_launches[n]
                          + infer_launches.get(n, 0)
                          + fleet_launches.get(n, 0)
                          + dp_launches.get(n, 0)
                          + p14_launches.get(n, 0)
                          + p15_launches.get(n, 0)
                          + p16_launches.get(n, 0)
                          for n in KERNELS if n.startswith("threefry")})
    log(f"[done] K8 launches: phase 5 "
        f"{ {n: train_launches[n] for n in path_launches if n.startswith('threefry')} }, "
        f"phase 5b {unfused_launches['threefry_dropout']}, phase 5c "
        f"{ {n: amp_launches[n] for n in path_launches if n.startswith('threefry')} }, "
        f"phase 8 rank 0 "
        f"{dgc_launches['threefry_dropout']}, phase 9 random_bits "
        f"{book_launches['threefry_random_bits']} (9a) + "
        f"{resnet_launches['threefry_random_bits']} (ResNet-50's startup) + "
        f"{resnet_amp_launches['threefry_random_bits']} (9d's), phase 10 "
        f"{ {n: ckpt_launches[n] for n in path_launches if n.startswith('threefry')} }, "
        f"phase 11 {infer_launches.get('threefry_random_bits', 0)}")
    log(f"[done] phase 13 launches (both ranks and the one-rank run): "
        f"{ {n: c for n, c in dp_launches.items() if c} }")
    log(f"[done] phase 14 launches: "
        f"{ {n: c for n, c in p14_launches.items() if c} }")
    log(f"[done] phase 15 launches: "
        f"{ {n: c for n, c in p15_launches.items() if c} }")
    log(f"[done] phase 16 launches (the 4 ranks and the one-rank run): "
        f"{ {n: c for n, c in p16_launches.items() if c} }")
    log(f"[done] phase 10 launches: "
        f"{ {n: c for n, c in ckpt_launches.items() if c} }; phase 11: "
        f"{ {n: c for n, c in infer_launches.items() if c} }")
    rows = []
    for name, info in KERNELS.items():
        # a kernel whose parity phase (2) was not selected has no numbers
        r = parity.get(name, {})
        rows.append({"name": name, "route": "cuda", "source": info.source,
                     "replaces": info.replaces,
                     "launches": path_launches[name],
                     **{k: r.get(k) for k in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms")},
                     # host costs and whole-step sums, where measured
                     **{k: v for k, v in r.items() if k not in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms")}})
    log(f"[done] {time.perf_counter() - t_all:.1f}s")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dgc-rank"]:
        dgc_rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--dp-rank"]:
        dp_rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--dygraph-rank"]:
        dygraph_rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--hybrid-rank"]:
        hybrid_rank_main(sys.argv[2])
    else:
        main(parse_phases(sys.argv[1:]))
