#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA GPU and
``nvcc`` (CUDA_HOME or /usr/local/cuda). In order, it

1. fails unless ``torch.cuda.is_available()``, and prints the card's name
   and power limit as ``nvidia-smi`` reports them;
2. builds the port's CUDA kernels from ``mxnet_tpu_torch/csrc`` (one
   ``nvcc`` per source, started together), prints the build seconds and
   each kernel's route (``ROUTES``: the bf16 flash forward and ring-carry
   step run the tensor-core template ``flash_fwd_sm90``, the bf16 flash
   backward the templates ``flash_bwd_dq_sm90`` and
   ``flash_bwd_dkv_sm90``, every other kernel and dtype the CUDA cores);
3. holds each kernel against its plain PyTorch version on the card, in
   float32 and bfloat16, each at the tolerance stated by ``TOL`` or
   ``TOL_FLASH``: the paged decode kernel on 32 lanes of 8 KV heads x 64
   dims, a pool of 2049 16-position blocks, 256-entry tables, live
   lengths in [1, 4096], spans 1 and 4, groups 1 and 2, and again with
   lanes on the edges of the split plan (``paged_edge_case``: a parked
   lane, windows ending at the chunk C - 1, C and C + 1, one across a
   chunk boundary, one at the table's capacity); the flash-decode kernel
   on 8 lanes x 8 heads against a 4096-position cache with lengths
   including 0 and 4096, and again with lengths 0, 1, C - 1, C, C + 1
   and 4096 and with every lane longer than one chunk; both split
   kernels must give bitwise equal results on two calls; the flash
   forward (o and lse) and the
   two flash backward kernels (dq, and dk/dv), causal and not, at the
   training shape (64 batch-heads x 1024 positions x 128 dims), at head
   dim 64, and at one ragged cross-length case; the bf16 backward kernels
   again at 8 batch-heads x 8192 x 128, causal (a row sums 128 key tiles,
   a key 128 query tiles), at the same gate; and the paged kernel's
   int8 mode (split-K like the float mode) on int8 pools (codes and fp32
   scales quantised from seeded rows) with float32 and bfloat16 queries,
   at the paged cases above, at head dim 128 and at 16 query rows a KV
   head (span 4 x G 4), and again on the split plan's edges at spans 1
   and 4 and groups 1, 2 and 4, two calls there bitwise equal, allowing
   one probability code beside ``TOL`` in at most ``INT8_CODE_SHARE`` of
   the elements; and the ring-carry kernel
   (o, m and l at the fp32 ``TOL_FLASH``, in float32 and bfloat16, head
   dims 64 and 128) on a fresh carry at equal offsets, an in-flight carry
   over a past shard, a dead call (its carry back bitwise), partial
   overlaps at offsets off the 64-row tiles, a non-causal call and a
   ragged Tq != Tk case, on the rows its contract specifies; then runs
   the ring schedule on the card: the flagship's attention (8 heads of
   128, bf16, causal) at 8 x 1024 and 1 x 8192, split into 4 and 8
   shards, each shard's ring folded through the carry kernel in
   ``ring_attention``'s order (exactly n^2 launches), held against the
   flash forward over the whole sequence at the bf16 ``TOL_FLASH``;
4. serves 16 requests (prompts of 64-512 seeded tokens, 32 new tokens
   each) through ``ContinuousBatcher(paged=True)`` at the full width of
   the repo's paged serving model (vocab 32000, d_model 512, 8 heads,
   8 layers, d_ff 2048, max_len 4096, bfloat16, random weights from a
   seed), checks every stream's length, the block allocator's
   invariants, that every decode step launched the paged kernel once
   per layer and no other kernel ran, and that each emitted token's
   logit lies within a stated tolerance of its row's maximum when the
   stream is teacher-forced through ``prefill_chunk`` (a dense
   contraction, no kernel);
5. runs greedy ``generate()`` (batch 8, prompt 256, 32 new tokens) at
   the same width with the flash kernels (the prompt through the flash
   forward, each token through flash decode), with the same checks;
   then serves the same requests, and runs the same ``generate()``,
   with an int8 KV cache (the width of the int8-KV serving A/B of
   ``benchmark/serving_bench.py``): every decode step launches the
   paged kernel's int8 mode once per layer, ``generate()``'s dense int8
   path launches no kernel, and the int8 pool's bytes are printed beside
   the bfloat16 pool's; then serves the RoPE model of step 6 (its full
   width, bfloat16, random weights): ``generate()`` through the flash
   forward and flash decode, and 8 requests through the batcher and the
   paged kernel at head dim 128, each with the launch and teacher-forced
   checks; then (``serve_dispatch_phase``) serves the job mix of
   ``benchmark/serving_bench.py``'s pipelining A/B (16 requests of
   256-511 prompt tokens and 128 new ones, 8 lanes, SERVE_CFG's model)
   through dense lanes (the flash-decode kernel) and the paged pool (the
   paged kernel) at (chunk, depth) (1, 1), (16, 1) and (16, 2), greedy
   and sampled (temperature 0.8, top-k 50, top-p 0.95, a seed per
   request): each dispatch must launch the layout's kernel n_layers x
   chunk times and nothing else, the streams must be bitwise equal across
   the settings, greedy tokens must pass the teacher-forced check and
   sampled ones lie in their row's kept set on the teacher-forced logits
   (``TOL_TEACHER`` slack at the threshold), the sampling noise's integer
   bits must equal the CPU's, a cached 256-token prefix must give the
   uncached streams (up to a token whose teacher-forced gap is within
   ``TOL_TEACHER``) and, paged, hold fewer blocks; every pipelined
   dispatch, lane patch and free runs under
   ``torch.cuda.set_sync_debug_mode("error")``; it prints tokens/s at
   each setting (greedy three times, in turns) and each setting's step
   profile; then (``spec_phase``) serves the speculative mix of
   ``benchmark/serving_bench.py`` (its model with an int8 KV pool of
   16-position blocks, 24 jobs from ``RandomState(17)`` of 32-255 prompt
   and 8-127 new tokens) at (lanes, max_len) (8, 1024), (8, 4096),
   (16, 1024) and (16, 4096) with spec_k off and on (3, n-gram drafts;
   off on on off, tokens/s paired), on a bf16 pool at (8, 4096), and
   with a 2-layer draft model at (8, 1024), dense (its steps through
   the flash-decode kernel) and paged (through the paged kernel on the
   target's tables), and at (8, 1024) once more at chunk 16 and
   pipeline depth 2: every verify round launches the paged kernel once
   a layer at span 4 and nothing else runs, streams equal the spec_k-off
   run's up to a token within ``TOL_TEACHER`` of its row's runner-up,
   blocks balance at the end, no dispatch is requeued; one profiled spec
   dispatch of each arm; a run at (8, 1024) where a priority-1
   admission preempts a lane, an injected dispatch failure is requeued
   (the one requeue the phase allows) and a ``shrink_pool``/``grow_pool``
   round trip preempts more, all resumed through
   ``admit_continuation``;
   the paged kernel at the verify window (span 4, 8 and 16 lanes, full
   4096-position tables, bf16 and int8) against its plain version, timed
   beside its bound and SDPA, and a 20-row window that takes two
   launches; ``speculative_generate`` and ``beam_search`` (beam 4, batch
   2) at the serving model's width with exact launches; every
   speculative dispatch, lane patch and free under the sync detector;
   then (``durable_phase``, PR 14) the durable serving stack: the
   journal A/B of ``serving_bench.py`` (SERVE_CFG's model at max_len
   2048, 8 jobs of 96-191 + 64 tokens, 4 lanes, paged, depth 2; a
   warm-up, then the journal off and on in turns, journals in TMPDIR):
   streams and dispatch counts bitwise equal, every replay 8 finished,
   B3 n_layers times a dispatch and nothing else, every dispatch under
   the sync detector; a child process (``--durable-child DIR MODE``)
   killed at a journal commit point (exit code 9), greedy with spec_k
   2 and sampled, recovered here: nothing skipped, the streams the
   uninterrupted run's up to a teacher-forced near tie (sampled: the
   smallest logit shift that flips the sampler), the pool quiescent;
   an injected out-of-memory dispatch of the dispatch mix (chunk 16,
   depth 2) that parks blocks with no lane rebuild and one failure; the
   router's overload leg without brownout (2 replicas x 3 lanes, paged
   and then dense, r1 failing dispatches 1-4): no deadlock, nothing
   above priority 0 dropped, r1 back with its breaker closed, the
   streams teacher-forced; a rolling rollout to a checkpointed second
   seed (lineage verified, both fingerprints the manifest's, each
   canary printed beside ``generate()``'s), one whose canary lies
   (rolled back), and a checkpoint with a flipped byte (refused); and
   the training flagship cut to 2 layers: an async save with the next
   step taken at once, ``resume_from_latest``, the restored state and
   the resumed run bitwise (else within the gradient gate);
6. takes one training step of the LM of ``benchmark/train_lm_bench.py``
   at full width (vocab 32000, d_model 1024, 8 heads of 128, 12 layers,
   d_ff 4096, 1024 positions, batch 8, rope, random weights from a seed)
   in float32 with TF32 off, once through the flash kernels and once
   through dense attention, and requires the losses to agree to 1e-4 and
   every parameter's gradient to a relative L2 error of 1e-3;
7. trains the same model in bfloat16 for 10 steps of SGD with momentum
   (lr 1e-2) on one fixed batch through ``make_train_step``: the loss
   must stay finite and fall, and each step must launch each flash
   kernel once per layer; prints the step ms, tokens/s and MFU (6 N
   FLOPs per token over 989 TFLOP/s); then drives the parallel slice:
   the same model (max_len 8192) under ``parallel.make_mesh({"dp": 1,
   "sp": 1})`` on a world of one, ``loss_fn`` and ``forward`` at 8 x 1024
   and 1 x 8192: each launches the ring-carry kernel once per layer and
   nothing else, the fp32 mesh loss is within 1e-4 of the no-mesh loss
   (through the flash forward), the bf16 loss is finite, and the forward
   ms and tokens/s are printed; and ``sp_flash_decode`` at sp = 1 on the
   serving cache (8 lanes x 8 KV heads x 4096 x 64, bf16), through the
   flash-decode kernel, against its dense route at ``TOL``, both timed;
   then (``mesh_train_phase``) the LM stack under a mesh, on a world of
   one (NCCL takes no two ranks on one card), and int8 weight trees: the
   flagship (bf16, batch 8 x 1024, the sequence gathered rather than
   ringed) trains 10 steps through ``make_train_step(cfg, mesh)`` under
   ``make_mesh({"dp": 1, "tp": 1, "sp": 1, "ep": 1})`` beside
   ``make_train_step(cfg)`` from the same init and batch, in turns:
   every loss, parameter and momentum must be bitwise equal and each
   step must launch B1, B2a and B2b once a layer and nothing else; it
   prints both steps' ms, tokens/s, MFU and peak memory and the bucket
   plan; the flagship cut to 2 layers, fp32, takes one mesh step through
   the plain ring at sp = 1, which must launch no kernel (B5 is forward
   only) and whose loss and gradients must match the flash route's at
   ``train_equivalence``'s limits; ``generate()`` and ``beam_search()``
   (beam 4) at ``GENERATE``'s width under ``make_mesh({"dp": 1, "tp":
   1})`` must give the no-mesh calls' tokens and B1 and B4 launches;
   and the serving model's bf16 weights quantised
   (``quantize_weights_int8``, its bytes printed beside bf16's) serve
   ``SERVE``'s mix through the paged batcher (B3) in turns with their
   dequantised twin (q8, bf16, bf16, q8; tokens/s printed), the streams
   equal token for token, as are ``generate()``'s tokens (B1 + B4) and
   the int8 KV pool's streams (B3 int8) against the twin, and a q8
   checkpoint must save and load back bitwise;
8. drives the imperative slice on gpu(0) through ``mxnet_tpu_torch.nd``,
   ``autograd`` and ``rtc`` (B6) alone: the output head of step 6's
   model at full width (8192 tokens x d_model 1024, bf16, against a
   1024 x 32000 fp32 W, random from a seed), its mean cross-entropy in
   ``nd`` reductions and its backward, held against the same expression
   in plain torch (loss 1e-4 relative, W's gradient 1e-3 relative L2);
   then five steps of SGD with momentum (lr 1.0, momentum 0.9) whose
   update is a user kernel, once as CUDA C++ compiled at runtime by
   NVRTC (``CudaModule``, the template ``sgd_mom_update<float>``) and
   once as a Triton body (``PallasModule``), each step held against the
   same update in ``nd`` ops at ``TOL_RTC``, with exactly one rtc launch
   per step per route and a falling loss; saxpy at 2^28 fp32 elements as
   a Triton body and MXNet's ``axpy`` template through ``CudaModule``;
   a one-CTA-per-row sum of the 8192 x 32000 fp32 logits with 64 KB of
   dynamic shared memory; a source that does not compile and a dtype
   mismatch, which must raise before any launch; and a kernel writing a
   reshaped NDArray, which must leave its source as it was;
9. times each decode step, and each kernel beside its plain version, a
   one-call PyTorch yardstick (``scaled_dot_product_attention``, timed
   here only, forward, and backward through autograd for the flash
   backward kernels; none for the int8 mode; for the carry kernel SDPA's
   forward, which a fresh carry at equal offsets turns into o / l) and
   its bound; the ring-carry kernel at the flash forward's timing shape
   and at one past-shard step of the sp = 8 split of 1 x 8192; the flash
   forward, the ring-carry kernel and the two backward kernels again at
   head dim 64 beside SDPA's forward and backward;
   the paged kernel is timed on the served pool full, each block in one
   lane's table, in bfloat16 and int8; each decode kernel also by its
   device time under torch.profiler beside SDPA's, with its split plan,
   and the wrapper's host microseconds per call;
10. drives the ResNet-50 path (``resnet_phase``; no hand-written kernel:
    convolutions, pooling, batch norm and the dense layer are torch ops,
    cuDNN and cuBLAS in MXNet's NCHW layout): ResNet-50 v1 traced by
    ``utils.functionalize_block`` takes one fp32 training step (TF32 off)
    at batch 2, 224^2 on the card and on the CPU, whose logits, loss,
    gradients and new running statistics must agree to ``TOL_RESNET``
    (relative L2); the stem's ``MaxPool2D(3, 2, 1)`` on all-equal windows
    must send each window's gradient to its first position, bitwise as on
    the CPU; ``entry.build_train_step`` at ``bench.py``'s shape (batch
    128, 224^2, 1000 classes, bf16 fold-cast, lr 0.1, momentum 0.9) takes
    10 steps on one seeded batch, with a finite loss that must fall, and
    prints the step ms, img/s and peak device memory, then a
    torch.profiler breakdown of 3 steps; ``entry()``'s forward (batch 8)
    must give finite (8, 1000) logits agreeing with the CPU's at
    ``TOL_RESNET``, and is timed; and the same net in bf16, forward +
    backward under ``autograd.record``, is timed imperative (``nd``) and
    hybridized (``CachedOp``) in turns; each line with the card's name
    and power limit;
11. drives the Gluon training loop (``gluon_train_phase``; no
    hand-written kernel: the optimizers, the Trainer, the losses and the
    rest of ``ops/nn.py`` are torch ops): the ResNet-18 thumbnail's 3
    ``Trainer("sgd")`` steps with ``SoftmaxCrossEntropyLoss`` and
    ``examples/dcgan.py``'s 3 iterations (Adam, sigmoid BCE,
    ``Conv2DTranspose``, ``LeakyReLU``) run on the card, on the CPU in
    fp32 and on the CPU in float64 from the same parameters, loss, logits
    and every parameter after each step held by ``resnet_card_vs_cpu``'s
    rule; each op of ``ops/nn.py`` beyond the ResNet subset forward and
    backward on the card against the CPU at ``TOL_OPS_E``; then ResNet-50
    v1 cast to bf16, hybridized, ``Trainer("sgd", multi_precision=True)``
    (lr 0.1, momentum 0.9, wd 1e-4) at bench.py's shape for 10 steps on
    one seeded batch, with a finite loss that must fall, printing the step
    ms, img/s, peak memory, ``trainer.step``'s host ms and its kernel
    launches and device ms from a trace of one call, beside
    ``build_train_step``'s step ms of the same call, then a
    torch.profiler breakdown of 3 steps;
12. drives data and IO (``io_phase``; no hand-written kernel: the
    input pipeline is host numpy and the repo's C++ RecordIO scanner,
    ``src/io/recordio_scan.cc``, built by g++ through ``_native``):
    bench.py's ``--real-data`` leg through ``entry.real_data`` at its
    accelerator shape (ResNet-50 bf16 fold-cast, batch 128, 224^2, 1000
    classes, lr 0.1, momentum 0.9), fed by ``ImageRecordIter`` (shuffle,
    random crop and mirror) from 512 .npy records of 256^2 x 3 written
    to TMPDIR: 20 fed steps, then 20 on resident tensors; it fails unless
    the loss is finite, the native library read the records and the
    first fed batch, on the card, equals bitwise the first batch of the
    same iterator built on the CPU from the same file and seed; it
    prints fed and synthetic img/s, the feed-bound fraction and a fed
    batch's host ms in the iterator's ``next()`` (decode, augment, stack,
    copy) and in the step's call; then every ``_image_*`` op on the card
    against the same op on the CPU at ``TOL_IMAGE`` (the 2x uint8 resize
    bitwise), the random ops' bodies on a fixed draw, and each random op
    on the card's generator within its range; then a ``DataLoader`` over
    64 seeded uint8 224^2 images through ``ToTensor`` and ``Normalize``,
    serial, with two threads and with two spawned worker processes and
    pinned memory, the last two bitwise the first on the card.
    ``image.ImageIter`` and ``ImageDetIter`` decode JPEG through cv2,
    which the card's machine lacks: they are held against the JAX package
    on the CPU only (``tests/test_torch_image.py``);
13. drives the kvstore stack and the Module front end (``module_phase``;
    no hand-written kernel, and it fails if one is launched):
    ``entry.module_fit`` at ``train_imagenet.py``'s defaults (the
    example's ResNet-50 symbol, 1000 classes, 3 x 224^2, batch 128, fp32,
    24 batches of ``synthetic_iter``'s data, SGD with momentum under the
    recipe's scheduler, Xavier, ``eval_metric="acc"``, Speedometer) with
    no store and through ``dist_sync`` (a world of one: the update on the
    store through ``pushpull_fused``), printing each run's img/s over
    batches 4-24 on Speedometer's clock, the host ms a batch in
    ``forward_backward``, ``update()`` and ``update_metric``, the store's
    ``dispatch_stats`` (checked: every key every batch, one collective a
    bucket, no sharded update) and the train accuracy; a profile of the
    dist_sync module's step on a resident batch; a ``do_checkpoint``
    round trip through ``model.load_checkpoint`` and ``Module.load``,
    bitwise; from one snapshot of weights and gradients, Module's update
    through the dist store against its local updater, and the Gluon
    ``Trainer(kvstore="device")`` (through ``pushpull_fused``) against
    ``Trainer(kvstore=None)`` on ResNet-50 in bf16, three updates each,
    weights and optimizer states bitwise equal; the store's 2-bit
    compressed push on ResNet-50's gradients, twice, words, residuals and
    aggregates bitwise the CPU's; Accuracy, top-5, F1 counts on scores
    made on the host (the label's rank set per row, exact ties) equal to
    the CPU's and to the counts the scores were made with, CrossEntropy
    within ``TOL_METRIC`` of the CPU's and of float64; the example's
    ResNet-18 CIFAR branch fitted two batches on the card and on the CPU
    from the same parameters, the parameters' and the moving statistics'
    change and the eval outputs within ``TOL_MODULE_FIT``; ``score`` and
    ``predict`` over 8 batches against the module's own ``forward``;
14. drives elastic worlds and the shard checkpoints (``elastic_phase``;
    B1/B2a/B2b in the training flagship's steps, 12 x accum a step each):
    ``python -m mxnet_tpu_torch.tools.elastic_launch`` over
    ``entry.elastic_worker`` with the training flagship (bf16, lr 1e-2,
    64 x 1024 tokens from ``RandomState(7)``, 8 rows a step, the global
    batch kept): generation 0 is a world of 2 whose rank 1 never starts
    (the simulated peer: exit 31, no heartbeat) and whose rank 0, on the
    card, trains while its monitor thread finds the peer dead on the
    sideband, captures the last completed step and exits 44; generation
    1 resumes at world 1 with 2 micro-batches a step and finishes step 8;
    its LOSS lines and final parameters must equal bitwise those of a
    clean world-1 run from the same shard set in another process, the
    DATA lines tile the 64 rows, and each of its steps launch each flash
    kernel 24 times; it prints the capture's ms and bytes, the write's
    MB/s, the TTR and the step ms. Then, in this process, flagship steps
    at accum 1, a ~20 s spin kernel on the compute stream with the next
    step queued behind it, and the coordinator's shrink on another
    thread: the capture must commit within ``ELASTIC_CAPTURE_LIMIT_S``
    while the stream is still wedged, bitwise the completed step's state;
    during the wedge the flagship state is written as a 4-rank shard set
    and merged at world 1 bitwise, merged with rank 2 lost and
    ``allow_partial`` (exactly rank 2's lane slices zero), and a world-1
    set is resharded to world 4 bitwise, with the bytes and MB/s;
    ``examples/model_parallel/matrix_factorization.py`` at its defaults
    through ``Module.fit`` with ``group2ctxs`` (the user half on the
    host, the item half on the card) within ``TOL_MF`` of the all-card
    fit, with the boundary transfers a batch; and ``Module(context=
    [gpu(0), cpu(0)], kvstore="device")`` on the ResNet-18 thumbnail,
    two batches bitwise the one-context module with a created store
    (cuDNN deterministic for the leg);
15. drives random sampling, control flow and the recurrent nets
    (``rnn_phase``; no hand-written kernel, and it fails if one is
    launched): every scalar sampler of ``nd.random`` and every
    multisample ``sample_*`` op draws 2^20 values on gpu(0), in float32
    and, where it takes a float dtype, float16 (stored as bfloat16),
    whose mean and variance must lie within ``RNN_SE`` standard errors
    of the distribution's and whose seeded KS or chi-square p-value must
    exceed ``RNN_P_MIN``; ``mx.random.seed`` twice must give bitwise
    equal draws; ``_sample_unique_zipfian``'s rows must be
    duplicate-free; the pdf ops and their gradients must match the CPU's
    within ``TOL_PDF``; each sampler's ms per 2^20 draws is printed. Then
    upstream's Gluon word language model at its medium configuration
    with ``--tied`` (``entry.word_lm``: vocab 33278, a 2-layer LSTM of
    650, dropout 0.5, bptt 35 x batch 32, SGD lr 20, gradient clipping)
    takes 20 hybridized steps on seeded tokens: the loss starts within
    0.5 of ln 33278, stays finite and falls; it prints tokens/s over
    steps 5-20, the step's profile (host and device ms, idle share) and
    the RNN op's kernel launches a step; one fp32 step with dropout 0
    on the card and on the CPU from the same parameters must agree by
    ``TOL_WORD_LM``. ``lstm_bucketing.py`` at its defaults
    (``entry.bucketing_lm``: vocab 10000, embed 200, two
    ``rnn.LSTMCell(200)``, buckets 10-60, batch 32, 24 batches of seeded
    sentences through ``BucketSentenceIter`` and ``BucketingModule.fit``)
    must bind each bucket once and score its sentences after the fit
    below the epoch's training perplexity, and its rnn checkpoint must
    round-trip bitwise; it prints samples/s. Last, the LSTM of
    ``benchmark/python/control_flow/rnn.py`` (seq 64, batch 32, hidden
    256) through ``sym.contrib.foreach``, a hybridized ``gluon.rnn.LSTM``
    and an unrolled ``LSTMCell`` loop: outputs within
    ``TOL_CONTROL_FLOW``, each route's ms printed;
16. traces 16 decode steps of a serve run, of an int8 serve run and of
   ``generate()``, 3 train steps and 3 mesh forwards, with
   ``torch.profiler`` and prints, for each, the host ms per step, the
   device ms per step (the sum of the kernels' own times), the device's
   idle share and the kernels that took the most time; the serve step
   must show the three split kernels of the paged decode, the int8 serve
   step the three of its int8 mode, the
   ``generate()`` decode step the two of flash decode, the bf16 train
   step the three tensor-core kernels, and the mesh forward the forward
   template;
17. times the decode kernels (the paged kernel in bfloat16 and int8)
    and the yardstick with every lane at one length, over 8, 32 and 128
    lanes and lengths 256 and 4096, by CUDA events and by device time
    with each kernel's GB/s of live bytes, and the
    flash forward, forward + backward and the yardstick over sequence
    lengths 1024, 4096 and 8192 at 8192 tokens, to show what limits the
    kernels;
18. prints the whole script's seconds, the card's name and power limit
    again, the kernels' JSON line (the paged kernel's rows with their
    speculative launches and their time at the verify window, the
    flash-decode row with the draft, solo-speculative and beam launches,
    every row with its launches in the durable, the mesh-training, the
    Module, the elastic and the rnn phases),
    then as its last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits nonzero and prints no
result line. It imports nothing of JAX or of the JAX package.

    python3 chip_smoke.py --durable-child DIR MODE

is the durable phase's child: it serves the journal A/B's mix with a
journal in DIR (MODE ``greedy`` or ``sampled``) until the chaos crash
kills it.

    python3 chip_smoke.py --decode-host OTHER

compares the decode path's host cost, and the int8 paged kernel's device
time, with the port in the checkout at ``OTHER`` (``decode_host``), in
one process on the same card.
"""

import collections
import copy
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 and fp32
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

# kernel vs plain version: |kernel - plain| <= atol + rtol * |plain| for
# every output element, as (atol, rtol). float32: both sum the same fp32
# products in another order, which moves an output by ~1e-6 at these
# lengths. bfloat16: each rounds its fp32 result to bf16 once; where the
# two fp32 sums differ in their last bits the roundings may land one
# bf16 ulp apart, and one ulp is at most 2^-7 of the value (rtol). atol
# covers the rare flip of one probability rounded to bf16 before PV,
# which moves an output by at most 2^-7 p|v|: below 1e-3 wherever a
# probability of a lane of more than a few dozen keys flips. Typical
# outputs are ~0.03 at these lengths, where the bound is 1.2e-3.
TOL = {"float32": (1e-4, 0.0), "bfloat16": (1e-3, 2.0 ** -7)}
# lse is float32 in both and ~8 here, where one fp32 ulp is 9.5e-7
TOL_LSE = 1e-4
# training flash kernels vs plain versions, (atol, rtol). Outputs (o, dq,
# dk, dv) run to ~10 on random inputs. float32: the kernel's fp32 FMAs and
# the plain version's fp32 matmuls sum up to 1024 products per element in
# another order, which moves a result by ~1e-6 of its size and at worst
# ~1024 * 2^-24 = 6e-5 of it (rtol 1e-4); atol covers elements near 0,
# where the backward's dP - delta cancels. bfloat16: both work in fp32 on
# the same bf16 inputs and round each result to bf16 once, so a flip is
# one bf16 ulp (2^-7 of a value at most), as for the decode kernels.
TOL_FLASH = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 2.0 ** -7)}
# teacher-forced check: an emitted token's logit may sit this far below
# its row's maximum. Logits have std ~0.45 here; the batched dense prefill
# and the stepped decode round bf16 activations at other places over 8
# layers, which moves a logit by a few bf16 ulps (2^-7 near 1).
TOL_TEACHER = 0.1
# int8 paged kernel vs its plain version: TOL plus one probability code.
# Both re-quantise a * vs with the row's scale as_ from statistics summed
# in another order, so a code sitting on a rounding edge may come out one
# apart; one code moves each element of its row by as_ * |v code| <=
# 127 as_. That allowance may be needed by at most this share of the
# elements (a bias of a third of a code step needs it everywhere).
INT8_CODE_SHARE = 0.01

SERVE_CFG = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=8,
                 d_ff=2048, max_len=4096, use_flash_kernel=True)
SERVE = dict(max_batch=32, block_size=16, num_blocks=2049, requests=16,
             prompt_lo=64, prompt_hi=512, n_new=32)
GENERATE = dict(batch=8, prompt=256, n_new=32)
# the RoPE serving run: TRAIN_CFG's model behind the batcher
ROPE_SERVE = dict(max_batch=8, block_size=16, num_blocks=8 * 64 + 1,
                  requests=8, prompt_lo=64, prompt_hi=512, n_new=32)
# (span, G, head dim) of the int8 kernel checks; (4, 4, 64) fills the
# 16 query rows a CTA takes
INT8_CHECKS = ((1, 1, 64), (4, 1, 64), (1, 2, 64), (4, 2, 64), (1, 1, 128),
               (4, 4, 64))

# the training flagship of benchmark/train_lm_bench.py at full width
TRAIN_CFG = dict(vocab_size=32000, d_model=1024, n_heads=8, n_layers=12,
                 d_ff=4096, max_len=1024, rope=True, use_flash_kernel=True)
TRAIN = dict(batch=8, steps=10, lr=1e-2)
# (label, batch*heads, Tq, Tk, head dim) of the flash kernel checks
FLASH_CHECKS = (("train", 64, 1024, 1024, 128), ("d64", 64, 1024, 1024, 64),
                ("ragged", 6, 333, 200, 128))
# (batch*heads, T, head dim) of the long bf16 backward check, causal: the
# backward kernels sum dQ, dK and dV across tiles inside the tensor cores'
# accumulators, whose truncation would show over 128 tiles
FLASH_BWD_LONG = (8, 8192, 128)
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
TRAIN_SWEEP = (1024, 4096, 8192)        # sequence lengths at 8192 tokens

# the ring-carry kernel's checks: (label, batch*heads, Tq, Tk, q_offset,
# kv_offset, causal, carry): "fresh" starts from (0, -1e30, 0), "flight"
# from the kernel's output of the q shard's own block (a ring's state).
# The "main" rows are the calls of the mesh forward at MESH_RUNS (8 heads,
# a ring of one: a fresh carry at offsets 0, 0); they run at MAIN_D only.
CARRY_CHECKS = (("main 8x1024", 64, 1024, 1024, 0, 0, True, "fresh"),
                ("main 1x8192", 8, 8192, 8192, 0, 0, True, "fresh"),
                ("own block", 16, 1024, 1024, 1024, 1024, True, "fresh"),
                ("past shard", 16, 1024, 1024, 1024, 0, True, "flight"),
                ("dead", 16, 1024, 1024, 1024, 2048, True, "flight"),
                ("partial", 16, 1024, 1024, 1000, 520, True, "flight"),
                ("partial fresh", 16, 1024, 1024, 40, 100, True, "fresh"),
                ("non-causal", 16, 1024, 1024, 0, 1024, False, "flight"),
                ("ragged", 6, 333, 200, 200, 0, True, "fresh"))
MAIN_D = 128
# the ring schedule on one card: (batch, T) of the training flagship's
# attention (8 heads of 128, bf16, causal), split over sp ranks
RING_SHAPES = ((8, 1024), (1, 8192))
RING_SP = (4, 8)
# the parallel slice's main path: the flagship under a world-of-one mesh,
# (batch, T) per run; max_len rises to the longest T (RoPE has no table)
MESH_RUNS = ((8, 1024), (1, 8192))
MESH_CFG = dict(TRAIN_CFG, max_len=8192)

SOURCE = {"paged_decode": "mxnet_tpu_torch/csrc/decode_attention.cu",
          "paged_decode_int8": "mxnet_tpu_torch/csrc/decode_attention.cu",
          "flash_decode": "mxnet_tpu_torch/csrc/decode_attention.cu",
          "flash_fwd": "mxnet_tpu_torch/csrc/flash_fwd_sm90.cuh",
          "flash_bwd_dq": "mxnet_tpu_torch/csrc/flash_bwd_sm90.cuh",
          "flash_bwd_dkv": "mxnet_tpu_torch/csrc/flash_bwd_sm90.cuh",
          "flash_carry": "mxnet_tpu_torch/csrc/flash_fwd_sm90.cuh"}
REPLACES = {"paged_decode": "mxnet_tpu/kernels/paged_decode.py:69",
            "paged_decode_int8": "mxnet_tpu/kernels/paged_decode.py:69",
            "flash_decode": "mxnet_tpu/kernels/flash_attention.py:439",
            "flash_fwd": "mxnet_tpu/kernels/flash_attention.py:44",
            "flash_bwd_dq": "mxnet_tpu/kernels/flash_attention.py:253",
            "flash_bwd_dkv": "mxnet_tpu/kernels/flash_attention.py:291",
            "flash_carry": "mxnet_tpu/kernels/flash_attention.py:134"}
# what each kernel runs on: bf16 B1 and B5 are the tensor-core template
# flash_fwd_sm90.cuh, bf16 B2a and B2b the two kernels of
# flash_bwd_sm90.cuh; float32 keeps the CUDA-core kernels, whose every dot
# is fp32 (the fp32 gates, the fp32 train step's and the mesh loss's
# equalities rest on them)
TEMPLATE = "flash_fwd_sm90"
BWD_TEMPLATES = ("flash_bwd_dq_sm90", "flash_bwd_dkv_sm90")
# the split-K decode kernels, by the words the profiler shows
PAGED_SPLIT = ("paged_scores_kernel", "paged_pv_kernel",
               "paged_combine_kernel")
INT8_SPLIT = ("paged_int8_scores_kernel", "paged_int8_pv_kernel",
              "paged_int8_combine_kernel")
FLASH_SPLIT = ("flash_decode_split_kernel", "flash_decode_combine_kernel")
ROUTES = {"paged_decode": "CUDA cores, split-K over the sequence: %s "
                          "(fp32, bf16)" % " + ".join(PAGED_SPLIT),
          "paged_decode_int8": "CUDA cores (dp4a), split-K over the "
                               "sequence, rows staged by cp.async: %s"
                               % " + ".join(INT8_SPLIT),
          "flash_decode": "CUDA cores, split-K over the sequence: %s "
                          "(fp32, bf16)" % " + ".join(FLASH_SPLIT),
          "flash_fwd": "bf16: wgmma template %s (TMA, P split hi + lo); "
                       "fp32: CUDA cores" % TEMPLATE,
          "flash_bwd_dq": "bf16: wgmma template %s (TMA, dS split hi + "
                          "lo); fp32: CUDA cores" % BWD_TEMPLATES[0],
          "flash_bwd_dkv": "bf16: wgmma template %s (TMA, P and dS split "
                           "hi + lo); fp32: CUDA cores" % BWD_TEMPLATES[1],
          "flash_carry": "bf16: wgmma template %s (TMA, P split hi + lo); "
                         "fp32: CUDA cores" % TEMPLATE}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out.splitlines()[0]


def time_ms(fn, iters):
    """Mean ms per call on the card: CUDA events around ``iters`` calls
    after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops, dtype_name):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def dtype_name(dtype):
    return str(dtype).split(".")[-1]


def compare(got, want, dtype_name, what, tol=TOL):
    """Hold a kernel's output against its plain version at ``tol``;
    returns the max abs error. The log line gives the worst element's
    error as a share of what it is allowed."""
    atol, rtol = tol[dtype_name]
    want = want.float()
    err = (got.float() - want).abs()
    share = float((err / (atol + rtol * want.abs())).max())
    log("%s: max abs err %.3g, worst err / (%g + %g |plain|) = %.3f "
        "(max |plain| %.3g)" % (what, float(err.max()), atol, rtol, share,
                                float(want.abs().max())))
    if not share <= 1.0:
        raise AssertionError("%s disagrees with its plain version" % what)
    return float(err.max())


# ---------------------------------------------------------------- B3 ---

def randn(torch, shape, gen, device, dtype):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def paged_tensors(torch, device, dtype, tables, pos, span, g, seed,
                  kvh=8, d=64, bs=16, nb=SERVE["num_blocks"], int8=False):
    """Pool, q, tables and pos of one paged-kernel case on the card; the
    pool and q are drawn from ``seed``. With ``int8`` the pool holds the
    int8 codes and fp32 scales of float32 rows so drawn."""
    from mxnet_tpu_torch.kernels.common import kv_quant
    gen = torch.Generator(device=device).manual_seed(seed)
    pool = {n: randn(torch, (nb, bs, kvh, d), gen, device,
                     torch.float32 if int8 else dtype) for n in ("k", "v")}
    if int8:
        for n in ("k", "v"):
            pool[n], pool[n + "s"] = kv_quant(pool[n])
    q = randn(torch, (len(pos), span, kvh * g, d), gen, device, dtype)
    return (q, pool, torch.from_numpy(tables.astype(np.int32)).to(device),
            torch.from_numpy(pos.astype(np.int32)).to(device))


def paged_case(torch, device, dtype, span, g, seed, lanes=32, bs=16,
               nbl=256, nb=SERVE["num_blocks"], d=64, int8=False):
    """One check case at the served shapes (a pool of 2049 blocks,
    256-entry tables), made from ``seed``: each lane's table holds
    distinct blocks drawn for that lane alone, so lanes may share blocks
    as prefix sharing makes them; live lengths are uniform up to the
    table's 4096 positions; lane 0 is an idle lane parked at position 0
    on an all-null table."""
    rng = np.random.RandomState(seed)
    tables = np.stack([rng.choice(np.arange(1, nb), nbl, replace=False)
                       for _ in range(lanes)])
    pos = rng.randint(0, nbl * bs - span + 1, size=lanes)
    tables[0], pos[0] = 0, 0
    return paged_tensors(torch, device, dtype, tables, pos, span, g, seed,
                         d=d, int8=int8)


def full_pool_case(torch, device, dtype, seed, lanes=32, bs=16, nbl=256,
                   nb=SERVE["num_blocks"], int8=False):
    """The served pool full, made from ``seed``: its nb - 1 usable blocks
    split among the lanes at random and dealt from one permutation, so
    each block sits in one lane's table only, as ContinuousBatcher maps
    them; each lane's live length ends inside its last block."""
    rng = np.random.RandomState(seed)
    counts = 1 + rng.multinomial(nb - 1 - lanes, np.full(lanes, 1 / lanes))
    assert counts.max() <= nbl
    perm = 1 + rng.permutation(nb - 1)
    tables = np.zeros((lanes, nbl), np.int64)
    for b, end in enumerate(np.cumsum(counts)):
        tables[b, :counts[b]] = perm[end - counts[b]:end]
    pos = counts * bs - 1 - rng.randint(0, bs, size=lanes)
    return paged_tensors(torch, device, dtype, tables, pos, 1, 1, seed,
                         int8=int8)


def paged_work(q, pool, tables, pos):
    """(bytes, operations) the paged function needs on these inputs:
    every pool cell some lane attends, read once (a cell two lanes share
    counts once) with all its leaves (K and V rows, and an int8 pool's
    two fp32 scales: 2D + 8 bytes per KV head), q, the tables, pos and
    the output."""
    lanes, span, h, d = q.shape
    nb, bs = pool["k"].shape[:2]
    tables, pos = tables.cpu().numpy(), pos.cpu().numpy()
    used = np.zeros((nb, bs), bool)
    for b in range(lanes):
        t = np.arange(pos[b] + span)
        used[tables[b, t // bs], t % bs] = True
    cell = sum(leaf[0, 0].numel() * leaf.element_size()
               for leaf in pool.values())
    nbytes = (int(used.sum()) * cell + 2 * q.numel() * q.element_size()
              + 4 * tables.size + 4 * lanes)
    flops = 4 * int((pos + span).sum()) * span * h * d
    return nbytes, flops


def check_paged(torch, kernels, device):
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        for span, g in ((1, 1), (4, 1), (1, 2), (4, 2)):
            q, pool, tables, pos = paged_case(torch, device, dtype, span, g,
                                              seed=10 * span + g)
            got = kernels.paged_attention(q, pool, tables, pos)
            want = kernels.paged_attention_reference(q, pool, tables, pos)
            errs[(name, span, g)] = compare(
                got, want, name,
                "paged_decode %-8s span=%d G=%d" % (name, span, g))
    return errs


def paged_edge_case(torch, device, dtype, span, g, seed, lanes=32, bs=16,
                    nbl=256, nb=SERVE["num_blocks"], int8=False):
    """A check case at the served shapes whose lanes sit on the split
    plan's edges (C = the plan's largest chunk, S its split count): lane
    0 parked at position 0 on an all-null table; lanes 1-3 with their
    last attended position at C - 1, C and C + 1; lane 4's window over
    2C - 2 .. 2C + span - 3 (across a chunk boundary when span > 2); lane
    5 ending at the table's capacity; lanes 6 and 7 attending S * bs and
    S * bs + 1 positions (where a lane's own chunk grows by one block);
    the others uniform, as ``paged_case``; ``int8`` as
    ``paged_tensors``. Returns the case and the plan."""
    from mxnet_tpu_torch import kernels
    splits, chunk = kernels.paged_decode_splits(lanes, 8, nbl, bs)
    rng = np.random.RandomState(seed)
    tables = np.stack([rng.choice(np.arange(1, nb), nbl, replace=False)
                       for _ in range(lanes)])
    pos = rng.randint(0, nbl * bs - span + 1, size=lanes)
    tables[0], pos[0] = 0, 0
    for i, last in enumerate((chunk - 1, chunk, chunk + 1), 1):
        pos[i] = last - span + 1
    pos[4] = 2 * chunk - 2
    pos[5] = nbl * bs - span
    pos[6], pos[7] = splits * bs - span, splits * bs + 1 - span
    return paged_tensors(torch, device, dtype, tables, pos, span, g, seed,
                         int8=int8), (splits, chunk)


def check_bitwise(torch, run, what):
    """Two calls of ``run`` on the same inputs must be bitwise equal: the
    split kernels merge in a fixed order, with no atomics."""
    first, second = run(), run()
    for a, b in zip(first, second):
        if not torch.equal(a, b):
            raise AssertionError("%s: two calls on the same inputs differ"
                                 % what)


def check_paged_splits(torch, kernels, device):
    """The paged kernel at the split plan's edges (``paged_edge_case``),
    in float32 and bfloat16, spans 1 and 4, groups 1 and 2, at TOL, and
    two calls bitwise equal."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        for span, g in ((1, 1), (4, 1), (1, 2), (4, 2)):
            (q, pool, tables, pos), (splits, chunk) = paged_edge_case(
                torch, device, dtype, span, g, seed=30 + 10 * span + g)
            what = "paged_decode edges %-8s span=%d G=%d (%d splits of %d)" \
                % (name, span, g, splits, chunk)
            got = kernels.paged_attention(q, pool, tables, pos)
            want = kernels.paged_attention_reference(q, pool, tables, pos)
            errs[(name, span, g)] = compare(got, want, name, what)
            check_bitwise(torch, lambda: (kernels.paged_attention(
                q, pool, tables, pos),), what)
            del pool
    return errs


def int8_code_step(torch, q, pool, tables, pos):
    """127 * as_ of every output row of the int8 plain version, as
    [B, C, H, 1]: as_ is the row's probability scale (max over the
    attended positions of a * vs, over 127), the step of one probability
    code, and one code moves an element of its row by as_ * |v code| at
    most. Computed here in the plain version's op order."""
    import math
    from mxnet_tpu_torch.kernels.common import NEG_INF, kv_quant
    b, span, h, d = q.shape
    bs, kvh = pool["k"].shape[1:3]
    idx = tables.long()
    t = tables.shape[1] * bs
    kq = pool["k"][idx].reshape(b, t, kvh, d)
    ks, vs = (pool[n][idx].reshape(b, t, kvh).transpose(1, 2)
              [:, None, :, None, :] for n in ("ks", "vs"))
    q8, qs = kv_quant(q.reshape(b, span, kvh, h // kvh, d))
    s = torch.einsum("bckgd,btkd->bckgt", q8.double(), kq.double()).float()
    s = s * qs[..., None] * ks / math.sqrt(d)
    positions = pos.long()[:, None] + torch.arange(span, device=q.device)
    mask = torch.arange(t, device=q.device) <= positions[:, :, None]
    a = torch.softmax(torch.where(mask[:, :, None, None, :], s, NEG_INF), -1)
    as_ = (a * vs).amax(dim=-1).clamp_min(1e-8) / 127
    return (127 * as_).reshape(b, span, h, 1)


def compare_int8(got, want, code_step, dtype_name, what):
    """Hold the int8 kernel's output against its plain version: every
    element within TOL plus one probability code of its row
    (``code_step``), and at most INT8_CODE_SHARE of the elements beyond
    TOL alone. Returns (max abs error, share beyond TOL)."""
    atol, rtol = TOL[dtype_name]
    want = want.float()
    err = (got.float() - want).abs()
    base = atol + rtol * want.abs()
    worst = float((err / (base + code_step)).max())
    share = float((err > base).float().mean())
    log("%s: max abs err %.3g, worst err / (TOL + one code) = %.3f, share "
        "of elements beyond TOL %.5f (limit %g; median code step %.3g)"
        % (what, float(err.max()), worst, share, INT8_CODE_SHARE,
           float(code_step.median())))
    if not worst <= 1.0 or not share <= INT8_CODE_SHARE:
        raise AssertionError("%s disagrees with its plain version" % what)
    return float(err.max()), share


def check_paged_int8(torch, kernels, device):
    """The paged kernel's int8 mode on INT8_CHECKS, q in fp32 and bf16,
    at the served pool and tables (an idle lane on the null table), then
    on the split plan's edges (``paged_edge_case``) at spans 1 and 4 and
    groups 1, 2 and 4, there also two calls bitwise equal. Returns the
    max abs errors by (dtype, span, G, head dim)."""
    errs, shares = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        for span, g, d in INT8_CHECKS:
            q, pool, tables, pos = paged_case(torch, device, dtype, span, g,
                                              seed=60 + 10 * span + g, d=d,
                                              int8=True)
            got = kernels.paged_attention(q, pool, tables, pos)
            want = kernels.paged_attention_reference(q, pool, tables, pos)
            step = int8_code_step(torch, q, pool, tables, pos)
            errs[(name, span, g, d)], share = compare_int8(
                got, want, step, name, "paged_decode_int8 %-8s span=%d G=%d "
                "D=%d" % (name, span, g, d))
            shares.append(share)
            del pool
        for span, g in ((1, 1), (4, 1), (1, 2), (4, 2), (4, 4)):
            (q, pool, tables, pos), (splits, chunk) = paged_edge_case(
                torch, device, dtype, span, g, seed=80 + 10 * span + g,
                int8=True)
            what = "paged_decode_int8 edges %-8s span=%d G=%d (%d splits " \
                "of %d)" % (name, span, g, splits, chunk)
            got = kernels.paged_attention(q, pool, tables, pos)
            want = kernels.paged_attention_reference(q, pool, tables, pos)
            step = int8_code_step(torch, q, pool, tables, pos)
            shares.append(compare_int8(got, want, step, name, what)[1])
            check_bitwise(torch, lambda: (kernels.paged_attention(
                q, pool, tables, pos),), what)
            del pool
    log("paged_decode_int8: worst error %.3g, largest share on the code "
        "allowance %.5f" % (max(errs.values()), max(shares)))
    return errs


# ---------------------------------------------------------------- B4 ---

def flash_case(torch, device, dtype, g, seed, b=8, kvh=8, tmax=4096, d=64,
               lengths=None):
    """Inputs of one flash-decode case, made from ``seed``; lane 0 has
    no valid key and lane 1 a full cache, unless ``lengths`` are given."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    k, v = (randn(torch, (b, tmax, kvh, d), gen, device, dtype)
            for _ in range(2))
    q = randn(torch, (b, kvh * g, d), gen, device, dtype)
    if lengths is None:
        lengths = rng.randint(1, tmax, size=b)
        lengths[0], lengths[1] = 0, tmax
    return q, k, v, torch.from_numpy(
        np.asarray(lengths, np.int32)).to(device)


def flash_work(q, k, lengths):
    b, h, d = q.shape
    kvh = k.shape[2]
    live = int(lengths.long().sum())
    item = q.element_size()
    nbytes = 2 * live * kvh * d * item + 2 * q.numel() * item + 4 * b * (1 + h)
    flops = 4 * live * h * d
    return nbytes, flops


def check_flash(torch, kernels, device):
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        for g in (1, 2):
            q, k, v, lengths = flash_case(torch, device, dtype, g, seed=20 + g)
            o, lse = kernels.flash_decode_with_lse(q, k, v, lengths)
            o_ref, lse_ref = kernels.dense_decode_with_lse(q, k, v, lengths)
            what = "flash_decode %-8s G=%d" % (name, g)
            errs[(name, g)] = compare(o, o_ref.to(dtype), name, what)
            err_lse = max_err(lse, lse_ref)
            log("%s: lse max abs err %.3g (tol %g)" % (what, err_lse,
                                                      TOL_LSE))
            if not err_lse <= TOL_LSE:
                raise AssertionError("flash_decode's lse disagrees with its "
                                     "plain version")
    return errs


def check_flash_splits(torch, kernels, device, b=8, kvh=8, tmax=4096):
    """The flash-decode kernels at the split plan's edges (C = the plan's
    largest chunk, S its split count, g the granule of a lane's own
    chunk), in float32 and bfloat16, G 1 and 2, at TOL and TOL_LSE:
    lengths 0, 1, C - 1, C, C + 1, tmax, S * g and S * g + 1 (where a
    lane's chunk grows by one granule); then every lane longer than C
    (each spans more than one split); two calls bitwise equal."""
    from mxnet_tpu_torch.kernels.flash_attention import (
        FLASH_DECODE_GRANULE as granule)
    splits, chunk = kernels.flash_decode_splits(b, kvh, tmax)
    rng = np.random.RandomState(25)
    edges = [0, 1, chunk - 1, chunk, chunk + 1, tmax, splits * granule,
             splits * granule + 1][:b]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        for g in (1, 2):
            for label, lens in (("edges", edges), ("all split", rng.randint(
                    chunk + 1, tmax + 1, size=b))):
                q, k, v, lengths = flash_case(torch, device, dtype, g,
                                              seed=26 + g, b=b, kvh=kvh,
                                              tmax=tmax, lengths=lens)
                what = "flash_decode %-9s %-8s G=%d (%d splits of %d)" % (
                    label, name, g, splits, chunk)
                o, lse = kernels.flash_decode_with_lse(q, k, v, lengths)
                o_ref, lse_ref = kernels.dense_decode_with_lse(q, k, v,
                                                               lengths)
                errs[(label, name, g)] = compare(o, o_ref.to(dtype), name,
                                                 what)
                err_lse = max_err(lse, lse_ref)
                log("%s: lse max abs err %.3g (tol %g)"
                    % (what, err_lse, TOL_LSE))
                if not err_lse <= TOL_LSE:
                    raise AssertionError("flash_decode's lse disagrees with "
                                         "its plain version")
                if label == "edges" and not (
                        (o[0] == 0).all() and (lse[0] < -1e29).all()):
                    raise AssertionError("a length-0 lane must give o = 0 "
                                         "and lse ~ -1e30")
                check_bitwise(torch, lambda: kernels.flash_decode_with_lse(
                    q, k, v, lengths), what)
    return errs


# ------------------------------------------------------- B1, B2a, B2b ---

def flash_inputs(torch, device, dtype, bh, tq, tk, d, seed):
    """q, k, v and an output gradient do of one flash-kernel case, drawn
    on the card from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q = randn(torch, (bh, tq, d), gen, device, dtype)
    k, v = (randn(torch, (bh, tk, d), gen, device, dtype) for _ in range(2))
    return q, k, v, randn(torch, (bh, tq, d), gen, device, dtype)


def check_flash_attention(torch, kernels, device):
    """The flash forward (o, lse) and backward (dq, dk, dv) kernels
    against their plain versions on FLASH_CHECKS, causal and not, in fp32
    and bf16. Both backward versions get the kernel's own (o, lse), so
    the backward check sees the backward kernels alone. Returns the max
    abs errors by (label, causal, dtype, output)."""
    errs = {}
    for seed, (label, bh, tq, tk, d) in enumerate(FLASH_CHECKS):
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                name = dtype_name(dtype)
                q, k, v, do = flash_inputs(torch, device, dtype, bh, tq, tk,
                                           d, seed=30 + seed)
                what = "%-6s %-8s causal=%d" % (label, name, causal)
                o, lse = kernels.flash_attention_with_lse(q, k, v, causal)
                o_ref, lse_ref = kernels.dense_attention_with_lse(q, k, v,
                                                                  causal)
                errs[(label, causal, name, "o")] = compare(
                    o, o_ref, name, "flash_fwd %s o" % what, TOL_FLASH)
                err_lse = max_err(lse, lse_ref)
                log("flash_fwd %s lse: max abs err %.3g (tol %g)"
                    % (what, err_lse, TOL_LSE))
                if not err_lse <= TOL_LSE:
                    raise AssertionError("flash_fwd's lse disagrees with its "
                                         "plain version")
                got = kernels.flash_attention_bwd(q, k, v, o, lse, do, causal)
                want = kernels.dense_attention_bwd(q, k, v, o, lse, do,
                                                   causal)
                for out, g, w in zip(("dq", "dk", "dv"), got, want):
                    kernel = "flash_bwd_dq" if out == "dq" else "flash_bwd_dkv"
                    errs[(label, causal, name, out)] = compare(
                        g, w, name, "%s %s %s" % (kernel, what, out),
                        TOL_FLASH)
    return errs


def check_flash_bwd_long(torch, kernels, device):
    """The bf16 backward kernels at FLASH_BWD_LONG, causal, against
    dense_attention_bwd at the bf16 TOL_FLASH (the kernels' forward gives
    both versions o and lse). Returns the max abs errors by output."""
    bh, t, d = FLASH_BWD_LONG
    q, k, v, do = flash_inputs(torch, device, torch.bfloat16, bh, t, t, d,
                               seed=33)
    o, lse = kernels.flash_attention_with_lse(q, k, v, True)
    got = kernels.flash_attention_bwd(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    want = kernels.dense_attention_bwd(q, k, v, o, lse, do, True)
    errs = {}
    for out, g, w in zip(("dq", "dk", "dv"), got, want):
        kernel = "flash_bwd_dq" if out == "dq" else "flash_bwd_dkv"
        errs[out] = compare(g, w, "bfloat16", "%s long %d x %d x %d bfloat16 "
                            "causal=1 %s" % (kernel, bh, t, d, out),
                            TOL_FLASH)
    del q, k, v, do, o, lse, got, want
    torch.cuda.empty_cache()
    return errs


PROFILE_ATTEMPTS = 5     # sessions tried before a trace with no kernel fails
# device_ms_each's marker: a spin kernel of this many cycles (under a
# microsecond) before each label's calls, found in a trace by its name
MARK_CYCLES = 1000
MARK_KERNEL = "spin_kernel"
# markers that open and close every profiler session (pad_trace), and
# that open each label's calls (two: either stands in for the other)
PAD_KERNELS = 64
LABEL_MARKERS = 2


def traced(torch, run, what):
    """``run()``'s profiler result, tried again (and logged) when a
    session records no kernel at all: torch.profiler on the card now and
    then drops every kernel of a session (seen on calls whose kernels the
    autograd thread launches and on plain launches alike). A session
    empty PROFILE_ATTEMPTS times fails."""
    for attempt in range(PROFILE_ATTEMPTS):
        result = run()
        if result:
            return result
        log("profiler: no kernel recorded for %s (session %d of %d)"
            % (what, attempt + 1, PROFILE_ATTEMPTS))
    raise AssertionError("the profiler saw no kernel of " + what)


def device_ms(torch, fn, iters=5):
    """ms per call of the kernels ``fn`` launches, their own device times
    under torch.profiler: a call whose host work outlasts its kernels
    reads more by ``time_ms`` than the card spent on it."""
    return sum(device_ms_each(torch, {0: fn}, iters)[0].values())


def pad_trace(torch):
    """PAD_KERNELS markers, waited for: what opens and closes a profiler
    session, so that no kernel that is counted sits at either end. A trace
    can lose the events at its start (seen: one marker of six missing,
    five sessions in a row, in two calls; before the markers, the first
    label of the sweep's shortest session found no kernel of its own)."""
    for _ in range(PAD_KERNELS):
        torch.cuda._sleep(MARK_CYCLES)
    torch.cuda.synchronize()


def device_ms_each(torch, fns, iters=5):
    """{label: {kernel name: ms per call}} for several calls timed in ONE
    torch.profiler session: each label's ``iters`` calls follow
    LABEL_MARKERS marker kernels (``torch.cuda._sleep``'s spin kernel) and
    end in a sync, inside the padding of ``pad_trace``. On the device's
    clock, each marker that a kernel follows opens the next label's run of
    kernels, so one lost marker of a label's pair, or of the padding,
    changes nothing; a session with another count of runs than labels is
    tried again. (Host record_function ranges attributed until a
    session's first label kept finding no kernel of its own.)"""
    from torch.profiler import ProfilerActivity, profile
    device_type = torch.autograd.DeviceType.CUDA
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    labels = list(fns)

    def run():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pad_trace(torch)
            for label in labels:
                for _ in range(LABEL_MARKERS):
                    torch.cuda._sleep(MARK_CYCLES)
                for _ in range(iters):
                    fns[label]()
                torch.cuda.synchronize()
            pad_trace(torch)
        events = sorted((e for e in prof.events()
                         if e.device_type == device_type),
                        key=lambda e: e.time_range.start)
        runs, after_marker, markers = [], False, 0
        for e in events:
            if MARK_KERNEL in e.name:
                after_marker = True
                markers += 1
                continue
            if after_marker:
                runs.append(collections.Counter())
                after_marker = False
            if runs:
                runs[-1][e.name] += e.time_range.elapsed_us() / 1e3 / iters
        if len(runs) == len(labels):
            return dict(zip(labels, runs))
        log("profiler: %d device events, %d markers of %d, %d runs of "
            "kernels for %d labels" % (len(events), markers,
                                        LABEL_MARKERS * len(labels)
                                        + 2 * PAD_KERNELS,
                                        len(runs), len(labels)))
        return None
    return traced(torch, run, "the calls %s" % ", ".join(map(str, fns)))


def sdpa_bwd_ms(torch, F, q, k, v, do, b, h, iters=10):
    """(ms by CUDA events, device ms of its kernels) of SDPA's whole
    backward (dq, dk and dv through autograd) on [b * h, T, D] inputs,
    causal."""
    t, d = q.shape[1:]
    q4, k4, v4 = (x.reshape(b, h, t, d).detach().requires_grad_(True)
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    do4 = do.reshape(b, h, t, d)

    def grad():
        torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True)
    return time_ms(grad, iters), device_ms(torch, grad)


# ---------------------------------------------------------------- B5 ---

def check_flash_carry(torch, kernels, device):
    """The carry kernel against its plain version on CARRY_CHECKS, in
    fp32 and bf16 at head dims 64 and 128 (the main path's rows at MAIN_D
    only): o, m and l elementwise at the flash kernels' fp32 TOL (all of
    its arithmetic is fp32), on the rows the contract specifies; a dead
    call must return its carry bitwise.
    Returns the max abs errors by (label, dtype, head dim)."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        for d in (128, 64):
            for seed, (label, bh, tq, tk, q_off, kv_off, causal,
                       carry) in enumerate(CARRY_CHECKS):
                if label.startswith("main") and d != MAIN_D:
                    continue
                q, k, v, _ = flash_inputs(torch, device, dtype, bh, tq, tk, d,
                                          seed=70 + seed)
                fresh = (torch.zeros((bh, tq, d), device=device),
                         torch.full((bh, tq), -1e30, device=device),
                         torch.zeros((bh, tq), device=device))
                c = fresh
                if carry == "flight":
                    gen = torch.Generator(device=device).manual_seed(90 + seed)
                    k0, v0 = (randn(torch, (bh, tq, d), gen, device, dtype)
                              for _ in range(2))
                    c = kernels.flash_carry_block(q, k0, v0, *fresh, q_off,
                                                  q_off, True)
                got = kernels.flash_carry_block(q, k, v, *c, q_off, kv_off,
                                                causal)
                want = kernels.carry_block_reference(q, k, v, *c, q_off,
                                                     kv_off, causal)
                # the rows the contract specifies (see flash_carry_block):
                # a real key in the carry already, or an unmasked one now
                rows = ((c[1] > -1e29) | (not causal)
                        | (q_off + torch.arange(tq, device=device)
                           >= kv_off)[None])
                what = "flash_carry %-13s %-8s D=%d" % (label, name, d)
                atol, rtol = TOL_FLASH["float32"]
                err, share = 0.0, 0.0
                for g, w in zip(got, want):
                    sel = rows[..., None].expand_as(g) if g.dim() == 3 \
                        else rows
                    e = (g[sel] - w[sel]).abs()
                    err = max(err, float(e.max()))
                    share = max(share, float(
                        (e / (atol + rtol * w[sel].abs())).max()))
                log("%s: o, m, l max abs err %.3g, worst err / (%g + %g "
                    "|plain|) = %.3f, on %d of %d rows"
                    % (what, err, atol, rtol, share, int(rows.sum()),
                       rows.numel()))
                if not share <= 1.0:
                    raise AssertionError("%s disagrees with its plain version"
                                         % what)
                if label == "dead":
                    if not all(torch.equal(g, c_in)
                               for g, c_in in zip(got, c)):
                        raise AssertionError("a dead flash_carry call changed "
                                             "its carry")
                    log("%s: carry returned bitwise" % what)
                errs[(label, name, d)] = err
    return errs


def ring_schedule(torch, ring, q, k, v, n):
    """Ring attention of [B, T, H, D] over n shards, every shard's ring
    run on this card in ring_attention's order (its own block, then the
    blocks of shards idx-1, idx-2, ... mod n), each fold through the carry
    kernel; returns the normalised [B, T, H, D]."""
    t = q.shape[1] // n
    scale = 1.0 / q.shape[-1] ** 0.5
    shard = [tuple(x[:, i * t:(i + 1) * t] for x in (q, k, v))
             for i in range(n)]
    outs = []
    for idx in range(n):
        carry = None
        for step in range(n):
            kv = (idx - step) % n
            carry = ring.local_attention_block(
                shard[idx][0], shard[kv][1], shard[kv][2], idx * t, kv * t,
                True, scale, carry=carry, use_flash_kernel=True)
        o, _, l = carry
        outs.append((o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None])
                    .to(q.dtype))
    return torch.cat(outs, 1)


def check_ring_schedule(torch, ring, kernels, device, h=8, d=128):
    """The ring at sp = RING_SP on one card, at RING_SHAPES, against the
    flash forward over the whole sequence at the bf16 TOL; exactly n^2
    carry launches per ring. Times each whole schedule (all n rings, the
    layout copies and normalisation included) beside the flash forward
    over the sequence."""
    for b, t in RING_SHAPES:
        q, k, v, _ = flash_inputs(torch, device, torch.bfloat16, b * h, t, t,
                                  d, seed=80)
        want, _ = kernels.flash_attention_with_lse(q, k, v, True)
        fwd_ms = time_ms(lambda: kernels.flash_attention_with_lse(q, k, v,
                                                                  True), 5)
        q4, k4, v4 = (x.reshape(b, h, t, d).transpose(1, 2) for x in (q, k, v))
        for n in RING_SP:
            kernels.launches.clear()
            got = ring_schedule(torch, ring, q4, k4, v4, n)
            torch.cuda.synchronize()
            check_only(kernels, {"flash_carry": n * n},
                       "the ring at sp=%d" % n)
            got = got.transpose(1, 2).reshape(b * h, t, d)
            compare(got, want, "bfloat16", "ring schedule %d x %d, sp=%d, "
                    "%d flash_carry launches, vs flash_fwd" % (b, t, n, n * n),
                    TOL_FLASH)
            ms = time_ms(lambda: ring_schedule(torch, ring, q4, k4, v4, n), 3)
            log("ring schedule %d x %d, sp=%d: %.3f ms, flash_fwd over the "
                "sequence %.3f ms (%.2fx)" % (b, t, n, ms, fwd_ms,
                                             ms / fwd_ms))
        del q, k, v, want, q4, k4, v4


def carry_work(bh, tq, tk, d, item, q_offset, kv_offset, causal):
    """(bytes, flops) of one carry step: q, k, v read once in their
    dtype, the fp32 carry (o, m, l) read once and written once; the two
    products over the (q, k) pairs the causal mask leaves, at 2 flops a
    multiply-add."""
    nbytes = (bh * (tq + 2 * tk) * d * item
              + 2 * 4 * bh * tq * (d + 2))
    qp = q_offset + np.arange(tq)
    kp = kv_offset + np.arange(tk)
    pairs = int((qp[:, None] >= kp[None, :]).sum()) if causal else tq * tk
    return nbytes, 2 * 2 * bh * pairs * d


def time_flash_carry(torch, F, kernels, device, b=8, h=8, t=1024, d=128):
    """The carry kernel at B1's timing shape (64 batch-heads x 1024 x
    128, bf16, causal, a fresh carry at equal offsets) beside B1, its
    plain version and one SDPA forward; then one past-shard step of the
    sp = 8 split of 1 x 8192 (8 batch-heads x 1024 at offsets 7168 and 0,
    an in-flight carry). Returns {label: (ms, plain ms, (bound, bound
    by), SDPA forward ms or None)} and logs both rows."""
    rows = {}
    for label, bh, q_off, kv_off in (("B1 shape", b * h, 0, 0),
                                     ("sp=8 past shard", h, 7 * t, 0)):
        q, k, v, _ = flash_inputs(torch, device, torch.bfloat16, bh, t, t, d,
                                  seed=85)
        c = (torch.zeros((bh, t, d), device=device),
             torch.full((bh, t), -1e30, device=device),
             torch.zeros((bh, t), device=device))
        if kv_off != q_off:
            c = kernels.flash_carry_block(q, k, v, *c, q_off, q_off, True)
        ms = time_ms(lambda: kernels.flash_carry_block(q, k, v, *c, q_off,
                                                       kv_off, True), 10)
        plain = time_ms(lambda: kernels.carry_block_reference(
            q, k, v, *c, q_off, kv_off, True), 5)
        nbytes, flops = carry_work(bh, t, t, d, 2, q_off, kv_off, True)
        bound = bound_ms(nbytes, flops, "bfloat16")
        extra, sdpa = "", None
        if label == "B1 shape":
            fwd = time_ms(lambda: kernels.flash_attention_with_lse(q, k, v,
                                                                   True), 10)
            q4, k4, v4 = (x.reshape(b, h, t, d) for x in (q, k, v))
            with torch.no_grad():
                sdpa = time_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True), 10)
            extra = ", flash_fwd %.4f ms, sdpa forward %.4f ms (%.2fx)" % (
                fwd, sdpa, ms / sdpa)
        log("flash_carry %s (%d x %d x %d, offsets %d / %d): %.4f ms, plain "
            "%.4f ms, bound %.4f ms (%s; %.1f MB, %.2f GFLOP)%s"
            % (label, bh, t, d, q_off, kv_off, ms, plain, bound[0], bound[1],
               nbytes / 1e6, flops / 1e9, extra))
        rows[label] = (ms, plain, bound, sdpa)
        del q, k, v, c
    return rows


def time_flash_d64(torch, F, kernels, device, b=8, h=8, t=1024, d=64):
    """The bf16 flash forward and ring-carry step (a fresh carry at equal
    offsets) at head dim 64 (64 batch-heads x 1024, causal), each beside
    SDPA's forward on the same inputs, and the two backward kernels beside
    SDPA's whole backward; logs one line per kernel and one for B2a + B2b."""
    q, k, v, do = flash_inputs(torch, device, torch.bfloat16, b * h, t, t, d,
                               seed=86)
    c = (torch.zeros((b * h, t, d), device=device),
         torch.full((b * h, t), -1e30, device=device),
         torch.zeros((b * h, t), device=device))
    q4, k4, v4 = (x.reshape(b, h, t, d) for x in (q, k, v))
    with torch.no_grad():
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), 10)
    fwd = time_ms(lambda: kernels.flash_attention_with_lse(q, k, v, True), 10)
    carry = time_ms(lambda: kernels.flash_carry_block(q, k, v, *c, 0, 0,
                                                      True), 10)
    nbytes, flops = train_flash_work(b * h, t, d, 2, "flash_fwd")
    cbytes, cflops = carry_work(b * h, t, t, d, 2, 0, 0, True)
    for name, ms, (bound, by) in (
            ("flash_fwd", fwd, bound_ms(nbytes, flops, "bfloat16")),
            ("flash_carry", carry, bound_ms(cbytes, cflops, "bfloat16"))):
        log("%s D=64 (%d x %d x %d, bf16, causal): %.4f ms, sdpa forward "
            "%.4f ms (%.2fx), bound %.4f ms (%s)"
            % (name, b * h, t, d, ms, sdpa, ms / sdpa, bound, by))
    o, lse = kernels.flash_attention_with_lse(q, k, v, True)
    delta = (do.float() * o.float()).sum(dim=-1)
    bwd = {"flash_bwd_dq": time_ms(
               lambda: kernels.flash_bwd_dq(q, k, v, do, lse, delta, True), 10),
           "flash_bwd_dkv": time_ms(
               lambda: kernels.flash_bwd_dkv(q, k, v, do, lse, delta, True),
               10)}
    sdpa_bwd, sdpa_dev = sdpa_bwd_ms(torch, F, q, k, v, do, b, h)
    for name, ms in bwd.items():
        bound, by = bound_ms(*train_flash_work(b * h, t, d, 2, name),
                             "bfloat16")
        log("%s D=64 (%d x %d x %d, bf16, causal): %.4f ms, bound %.4f ms "
            "(%s)" % (name, b * h, t, d, ms, bound, by))
    log_bwd_pair(torch, kernels, "D=64 ", sum(bwd.values()), sdpa_bwd,
                 sdpa_dev, (q, k, v, do, lse, delta))


def log_bwd_pair(torch, kernels, label, both, sdpa, sdpa_dev, args):
    """Log B2a + B2b beside SDPA's backward, each by CUDA events and by
    the device time of its kernels."""
    dev = device_ms(torch, lambda: (kernels.flash_bwd_dq(*args, True),
                                    kernels.flash_bwd_dkv(*args, True)))
    log("flash backward %s(B2a + B2b): %.4f ms (device %.4f), sdpa backward "
        "%.4f ms (device %.4f); %.2fx of it (device %.2fx; target 2x)"
        % (label, both, dev, sdpa, sdpa_dev, both / sdpa, dev / sdpa_dev))


# ------------------------------------------------------ main path runs ---

def teacher_gap(torch, tf, params, cfg, streams, t_prompt):
    """Largest (row max - emitted token's logit) over the emitted tokens
    of ``streams`` (lists of prompt + generated tokens; t_prompt[i] is
    stream i's prompt length), teacher-forcing each stream through
    prefill_chunk."""
    worst = 0.0
    for toks, t_p in zip(streams, t_prompt):
        x = torch.tensor([toks[:-1]], dtype=torch.long, device=params.device)
        cache = tf.init_cache(cfg, 1, params.device)
        logits, _ = tf.prefill_chunk(params, cache, x, 0, cfg,
                                     attend_limit=len(toks) - 1)
        rows = logits[0, t_p - 1:].float()
        emitted = torch.tensor(toks[t_p:], device=params.device)
        gap = rows.max(dim=-1).values - rows.gather(1, emitted[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def serve_jobs(cfg, n_new, spec=SERVE):
    """The served job mix: spec["requests"] seeded prompts of
    prompt_lo-prompt_hi tokens, each asking for ``n_new`` tokens."""
    rng = np.random.RandomState(1)
    return [(list(rng.randint(0, cfg.vocab_size,
                              rng.randint(spec["prompt_lo"],
                                          spec["prompt_hi"] + 1))),
             n_new) for _ in range(spec["requests"])]


def batcher(sv, params, cfg, device, spec=SERVE):
    return sv.ContinuousBatcher(params, cfg, max_batch=spec["max_batch"],
                                paged=True, block_size=spec["block_size"],
                                num_blocks=spec["num_blocks"], device=device)


def check_only(kernels, expect, what):
    """Every kernel launched exactly as ``expect`` ({name: count}) says,
    and no other kernel at all."""
    got = {n: c for n, c in kernels.launches.items() if c}
    if got != {n: c for n, c in expect.items() if c}:
        raise AssertionError("%s launched %s, not %s" % (what, got, expect))


def serve(torch, tf, sv, kernels, params, cfg, device, kernel, label="serve",
          spec=SERVE):
    """Serve spec's job mix through the batcher: each decode step must
    launch ``kernel`` once per layer and nothing else; every stream must
    pass the teacher-forced check."""
    jobs = serve_jobs(cfg, spec["n_new"], spec)
    srv = batcher(sv, params, cfg, device, spec)
    kernels.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [srv.admit(p, n) for p, n in jobs]
    torch.cuda.synchronize()
    t_admit = time.perf_counter() - t0
    if any(r is None for r in rids):
        raise AssertionError("a request was refused admission")
    results, step_s = {}, []
    while srv.active_count:
        t0 = time.perf_counter()
        results.update(srv.step())
        step_s.append(time.perf_counter() - t0)
    launches = kernels.launches[kernel]
    steps = srv.dispatch_count
    check_only(kernels, {kernel: cfg.n_layers * steps}, label)
    check_clean(srv, label)
    srv.check_invariants(quiesce=True)
    for rid, (prompt, n_new) in zip(rids, jobs):
        if len(results[rid]) != len(prompt) + n_new \
                or results[rid][:len(prompt)] != prompt:
            raise AssertionError("request %d: wrong stream" % rid)
    if steps < spec["n_new"] - 1:
        raise AssertionError("%d decode steps for %d new tokens"
                             % (steps, spec["n_new"]))
    gap = teacher_gap(torch, tf, params, cfg, [results[r] for r in rids],
                      [len(p) for p, _ in jobs])
    log("%s: %d requests, %d decode steps, %s launches %d, admission "
        "%.3f s, decode step %.3f ms (mean), teacher-forced max gap %.4f "
        "(tol %g)" % (label, len(jobs), steps, kernel, launches, t_admit,
                      1e3 * np.mean(step_s), gap, TOL_TEACHER))
    if not gap <= TOL_TEACHER:
        raise AssertionError("served tokens disagree with the "
                             "teacher-forced logits")
    return {"launches": launches, "steps": steps,
            "step_ms": 1e3 * float(np.mean(step_s))}


def run_generate(torch, tf, kernels, params, cfg, device, expect,
                 label="generate"):
    """Greedy generate() at GENERATE's batch: the launches must be exactly
    ``expect(n_layers, decode steps)`` ({kernel: count}); every token must
    pass the teacher-forced check."""
    rng = np.random.RandomState(2)
    b, t_p, n_new = GENERATE["batch"], GENERATE["prompt"], GENERATE["n_new"]
    prompt = rng.randint(0, cfg.vocab_size, (b, t_p)).astype(np.int32)
    kernels.launches.clear()
    out = tf.generate(params, prompt, n_new, cfg, device=device)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    check_only(kernels, expect(cfg.n_layers, n_new - 1), label)
    out = out.cpu().numpy()
    if out.shape != (b, t_p + n_new) or not (out[:, :t_p] == prompt).all() \
            or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError("%s returned a malformed batch" % label)
    gap = teacher_gap(torch, tf, params, cfg, [list(r) for r in out],
                      [t_p] * b)
    # ms per decode step: the 32-token call less the prefill-only call
    times = {}
    for n in (1, n_new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tf.generate(params, prompt, n, cfg, device=device)
        torch.cuda.synchronize()
        times[n] = time.perf_counter() - t0
    step_ms = 1e3 * (times[n_new] - times[1]) / (n_new - 1)
    log("%s: batch %d, prompt %d, %d new tokens, launches %s, decode step "
        "%.3f ms, teacher-forced max gap %.4f (tol %g)"
        % (label, b, t_p, n_new, launches, step_ms, gap, TOL_TEACHER))
    if not gap <= TOL_TEACHER:
        raise AssertionError("generated tokens disagree with the "
                             "teacher-forced logits")
    return {"launches": launches.get("flash_decode", 0), "steps": n_new - 1,
            "step_ms": step_ms}


def flash_generate(n_layers, steps):
    """generate()'s launches with use_flash_kernel: the prompt through the
    flash forward once per layer, each decode step through flash decode
    once per layer."""
    return {"flash_fwd": n_layers, "flash_decode": n_layers * steps}


def serve_int8(torch, tf, sv, kernels, device):
    """SERVE_CFG with an int8 KV cache, bf16: the batcher through the
    paged kernel's int8 mode, and generate() through the dense int8
    contraction (no kernel); the pools' bytes beside bf16's."""
    cfg = tf.TransformerConfig(dtype=torch.bfloat16, kv_cache_int8=True,
                               **SERVE_CFG)
    params = tf.init_params(cfg, seed=0, device=device)
    nb, bs = SERVE["num_blocks"], SERVE["block_size"]
    bf16 = dataclasses.replace(cfg, kv_cache_int8=False)
    log("int8 KV pool %d bytes, bf16 pool %d bytes (%.3f of it)" % (
        tf.paged_cache_nbytes(cfg, nb, bs), tf.paged_cache_nbytes(bf16, nb, bs),
        tf.paged_cache_nbytes(cfg, nb, bs) / tf.paged_cache_nbytes(bf16, nb,
                                                                   bs)))
    served = serve(torch, tf, sv, kernels, params, cfg, device,
                   "paged_decode_int8", "serve int8")
    run_generate(torch, tf, kernels, params, cfg, device, lambda n, s: {},
                 "generate int8")
    return served, params, cfg


def serve_rope(torch, tf, sv, kernels, device):
    """TRAIN_CFG's RoPE model served in bf16: generate() through the flash
    forward and flash decode, and ROPE_SERVE's requests through the
    batcher and the paged kernel at head dim 128."""
    cfg = tf.TransformerConfig(dtype=torch.bfloat16, **TRAIN_CFG)
    params = tf.init_params(cfg, seed=0, device=device)
    run_generate(torch, tf, kernels, params, cfg, device, flash_generate,
                 "generate rope")
    serve(torch, tf, sv, kernels, params, cfg, device, "paged_decode",
          "serve rope", ROPE_SERVE)


# ---------------------------------------------------- serve dispatch ---
# The width of benchmark/serving_bench.py's pipelining A/B (SERVE_CFG's
# model): 16 jobs from RandomState(1), prompts of 256-511 tokens, 128 new
# tokens each, 8 lanes, at each (chunk, depth) of DISPATCH_SETTINGS.
DISPATCH = dict(max_batch=8, block_size=16, requests=16, prompt_lo=256,
                prompt_hi=511, n_new=128)
DISPATCH_SETTINGS = ((1, 1), (16, 1), (16, 2))
DISPATCH_SAMPLE = dict(temperature=0.8, top_k=50, top_p=0.95)
# the prefix run: a 256-token prefix cached, 8 requests extending it by
# 1-64 tokens, 32 new tokens each, at (16, 2)
DISPATCH_PREFIX = dict(prefix=256, requests=8, suffix_hi=64, n_new=32)
# each setting's step traced for its idle share: tokens per request, and
# steps of chunk 16 traced (as many decode steps at every chunk size)
DISPATCH_PROFILE_NEW = 600
DISPATCH_PROFILE_STEPS = 4


def dispatch_jobs(cfg, spec=DISPATCH):
    """(prompt, n_new, seed) jobs of the dispatch phase."""
    rng = np.random.RandomState(1)
    return [(list(rng.randint(1, cfg.vocab_size,
                              rng.randint(spec["prompt_lo"],
                                          spec["prompt_hi"] + 1))),
             spec["n_new"], 1000 + i) for i in range(spec["requests"])]


def dispatch_batcher(sv, params, cfg, device, paged, chunk, depth,
                     controls=None):
    """A batcher of the dispatch phase; with depth > 1 each dispatch, lane
    patch and free runs under torch.cuda.set_sync_debug_mode("error"), so
    a host read there (a hidden .item(), .cpu() or pageable copy) fails
    the run."""
    import torch
    kw = dict(paged=True, block_size=DISPATCH["block_size"]) if paged \
        else {}
    srv = sv.ContinuousBatcher(params, cfg, max_batch=DISPATCH["max_batch"],
                               chunk_size=chunk, pipeline_depth=depth,
                               device=device, **dict(kw, **(controls or {})))
    if depth > 1:
        no_sync(torch, srv, ("_dispatch_chunk", "_patch_lane", "_free"))
    return srv


def dispatch_run(torch, sv, kernels, params, cfg, device, paged, chunk, depth,
                 jobs, controls=None):
    """Serve ``jobs`` at one (chunk, depth): each decode step must launch
    the layout's decode kernel once per layer (n_layers x chunk per
    dispatch) and nothing else, every stream must have its length, and
    the lanes and blocks must balance. Returns the streams in admission
    order, tokens/s (host clock, admissions included) and the counts."""
    kernel = "paged_decode" if paged else "flash_decode"
    srv = dispatch_batcher(sv, params, cfg, device, paged, chunk, depth,
                           controls)
    kernels.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, order = srv.run(jobs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    what = "%s (%d, %d)%s" % ("paged" if paged else "dense", chunk, depth,
                              " sampled" if controls else "")
    check_only(kernels, {kernel: cfg.n_layers * chunk * srv.dispatch_count},
               what)
    check_clean(srv, what)
    srv.check_invariants(quiesce=True)
    streams = [results[r] for r in order]
    for toks, (prompt, n_new, _) in zip(streams, jobs):
        if len(toks) != len(prompt) + n_new or toks[:len(prompt)] != prompt:
            raise AssertionError("%s: a malformed stream" % what)
    new = sum(n for _, n, _ in jobs)
    log("dispatch %s: %d dispatches, %s launches %d, %.3f s, %.1f tokens/s"
        % (what, srv.dispatch_count, kernel, kernels.launches[kernel],
           seconds, new / seconds))
    return {"streams": streams, "tok_s": new / seconds,
            "dispatches": srv.dispatch_count,
            "launches": kernels.launches[kernel]}


def teacher_rows(torch, tf, params, cfg, toks, t_p):
    """The fp32 logits that chose each generated token of ``toks``,
    teacher-forced through prefill_chunk, and those tokens."""
    x = torch.tensor([toks[:-1]], dtype=torch.long, device=params.device)
    logits, _ = tf.prefill_chunk(params, tf.init_cache(cfg, 1, params.device),
                                 x, 0, cfg, attend_limit=len(toks) - 1)
    return logits[0, t_p - 1:].float(), torch.tensor(toks[t_p:],
                                                     device=params.device)


def kept_set_gap(torch, tf, params, cfg, streams, t_prompt, temperature,
                 top_k, top_p):
    """Largest distance, in raw logits, by which a sampled token falls
    under its row's kept set (the sampler's top-k and top-p threshold)
    on the teacher-forced logits; 0 when every token is kept."""
    worst = 0.0
    for toks, t_p in zip(streams, t_prompt):
        rows, emitted = teacher_rows(torch, tf, params, cfg, toks, t_p)
        s = rows / temperature
        kth = torch.topk(s, top_k, dim=-1).values[:, -1:]
        s = torch.where(s < kth, float("-inf"), s)
        srt = torch.sort(s, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
        keep = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool),
                          cum[:, :-1] < top_p], dim=-1)
        thresh = torch.where(keep, srt, float("inf")).amin(dim=-1)
        tok = (rows / temperature).gather(1, emitted[:, None])[:, 0]
        worst = max(worst, float((thresh - tok).clamp(min=0).max())
                    * temperature)
    return worst


def first_split(torch, tf, params, cfg, got, want, t_p):
    """Where stream ``got`` first leaves ``want`` (None if nowhere), and
    want's teacher-forced top-1/top-2 gap at that token."""
    n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if n is None:
        return None, None
    rows, _ = teacher_rows(torch, tf, params, cfg, want[:n + 1], t_p)
    top = torch.topk(rows[-1], 2).values
    return n, float(top[0] - top[1])


def dispatch_prefix(torch, tf, sv, kernels, params, cfg, device, paged):
    """The prefix run at (16, 2): 8 requests extending one 256-token
    prefix, with the prefix cached and without. Cached streams must pass
    the teacher-forced check and equal the uncached ones up to a token
    whose teacher-forced gap is within TOL_TEACHER; paged, the blocks in
    use with every request admitted must be fewer when shared."""
    spec = DISPATCH_PREFIX
    rng = np.random.RandomState(3)
    prefix = list(rng.randint(1, cfg.vocab_size, spec["prefix"]))
    jobs = [(prefix + list(rng.randint(1, cfg.vocab_size,
                                       rng.randint(1, spec["suffix_hi"] + 1))),
             spec["n_new"]) for _ in range(spec["requests"])]
    out = {}
    for cached in (False, True):
        srv = dispatch_batcher(sv, params, cfg, device, paged, 16, 2)
        if cached:
            srv.cache_prefix(prefix)
        kernels.launches.clear()
        rids = [srv.admit(p, n) for p, n in jobs]
        if any(r is None for r in rids):
            raise AssertionError("a prefix request was refused admission")
        used = srv.num_blocks - 1 - srv.free_blocks if paged else None
        done = {}
        while srv.active_count:
            done.update(srv.step())
        kernel = "paged_decode" if paged else "flash_decode"
        check_only(kernels, {kernel: cfg.n_layers * 16 * srv.dispatch_count},
                   "prefix run")
        check_clean(srv, "prefix run")
        srv.check_invariants(quiesce=True)
        out[cached] = ([done[r] for r in rids], used)
    (plain, used_plain), (shared, used_shared) = out[False], out[True]
    gap = teacher_gap(torch, tf, params, cfg, shared,
                      [len(p) for p, _ in jobs])
    splits = [first_split(torch, tf, params, cfg, a, b, len(p))
              for a, b, (p, _) in zip(shared, plain, jobs)]
    late = [g for _, g in splits if g is not None and g > TOL_TEACHER]
    log("dispatch prefix %s: %d of %d streams equal the uncached run's "
        "(first splits at teacher gaps %s), teacher-forced max gap %.4f, "
        "blocks in use %s shared vs %s not"
        % ("paged" if paged else "dense",
           sum(n is None for n, _ in splits), len(jobs),
           [round(g, 4) for _, g in splits if g is not None], gap,
           used_shared, used_plain))
    if not gap <= TOL_TEACHER or late:
        raise AssertionError("prefix-cached streams disagree")
    if paged and not used_shared < used_plain:
        raise AssertionError("prefix sharing saved no blocks")
    return {"used": (used_shared, used_plain)}


def serve_dispatch_phase(torch, tf, sv, kernels, params, cfg, device):
    """Dense lanes (B4) and paged lanes (B3) at each (chunk, depth) of
    DISPATCH_SETTINGS, greedy and sampled: streams bitwise equal across
    the settings, the teacher-forced (greedy) and kept-set (sampled)
    checks, the noise's integer bits equal the CPU's, the prefix run, and
    the pipelined step's idle share. Returns the (16, 2) greedy runs."""
    t_phase = time.perf_counter()
    # the sync detector is armed: a host read under it raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.zeros(1, device=device).item()
    except RuntimeError:
        pass
    else:
        raise AssertionError("set_sync_debug_mode('error') let .item() "
                             "through")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    grid = torch.arange(64, device=device)
    bits = tf._gumbel_bits(grid * 7919 - 5, grid % 9, grid % 3,
                           cfg.vocab_size, device).cpu()
    want = tf._gumbel_bits(grid.cpu() * 7919 - 5, grid.cpu() % 9,
                           grid.cpu() % 3, cfg.vocab_size, "cpu")
    if not torch.equal(bits, want):
        raise AssertionError("the noise's integer bits differ on the card")
    log("dispatch: the noise's integer bits equal the CPU's on a 64 x %d "
        "grid" % cfg.vocab_size)
    jobs = dispatch_jobs(cfg)
    t_prompt = [len(p) for p, _, _ in jobs]
    for paged in (False, True):
        # warm-up: every setting's shapes once, untimed
        for chunk, depth in DISPATCH_SETTINGS:
            for controls in (None, DISPATCH_SAMPLE):
                srv = dispatch_batcher(sv, params, cfg, device, paged, chunk,
                                       depth, controls)
                srv.run([(p, 2 * chunk + 1, s) for p, _, s in jobs[:9]])
                check_clean(srv, "dispatch warm-up")
    runs = {}
    for paged in (False, True):
        for controls in (None, DISPATCH_SAMPLE):
            # greedy: each setting timed three times, in turns (1 2 3 3 2
            # 1 1 2 3): the host's clock spreads by a quarter between runs
            order = DISPATCH_SETTINGS if controls else (
                DISPATCH_SETTINGS + DISPATCH_SETTINGS[::-1]
                + DISPATCH_SETTINGS)
            got = collections.defaultdict(list)
            for kd in order:
                got[kd].append(dispatch_run(torch, sv, kernels, params, cfg,
                                            device, paged, kd[0], kd[1],
                                            jobs, controls))
            base = got[DISPATCH_SETTINGS[0]][0]["streams"]
            label = "%s%s" % ("paged" if paged else "dense",
                              " sampled" if controls else "")
            for kd, both in got.items():
                if any(run["streams"] != base for run in both):
                    raise AssertionError("%s: streams at %s differ from %s"
                                         % (label, kd, DISPATCH_SETTINGS[0]))
            if controls:
                gap = kept_set_gap(torch, tf, params, cfg, base, t_prompt,
                                   **controls)
            else:
                gap = teacher_gap(torch, tf, params, cfg, base, t_prompt)
            log("dispatch %s: streams bitwise equal at %s; %s max gap %.4f "
                "(tol %g); tokens/s %s (%s)" % (
                    label, ", ".join(map(str, DISPATCH_SETTINGS)),
                    "kept-set" if controls else "teacher-forced", gap,
                    TOL_TEACHER, ", ".join(
                        "%s %s (median %.1f)" % (
                            kd, " / ".join("%.1f" % r["tok_s"] for r in both),
                            np.median([r["tok_s"] for r in both]))
                        for kd, both in got.items()), card_line()))
            if not gap <= TOL_TEACHER:
                raise AssertionError("%s: tokens disagree with the "
                                     "teacher-forced logits" % label)
            runs[paged, bool(controls)] = {kd: both[0]
                                           for kd, both in got.items()}
    prefix = {paged: dispatch_prefix(torch, tf, sv, kernels, params, cfg,
                                     device, paged)
              for paged in (False, True)}
    log("dispatch phase: %.1f s before the profiles"
        % (time.perf_counter() - t_phase))
    for paged, expect in ((False, FLASH_SPLIT), (True, PAGED_SPLIT)):
        for chunk, depth in DISPATCH_SETTINGS:
            srv = dispatch_batcher(sv, params, cfg, device, paged, chunk,
                                   depth)
            for prompt, _, _ in jobs[:DISPATCH["max_batch"]]:
                srv.admit(prompt, DISPATCH_PROFILE_NEW)
            for _ in range(2):
                srv.step()
            profile_steps(torch, "%s serve step, chunk %d, depth %d, 8 live "
                          "lanes (%s)" % ("paged" if paged else "dense",
                                          chunk, depth, card_line()),
                          srv.step,
                          steps=DISPATCH_PROFILE_STEPS * 16 // chunk,
                          expect=expect)
            check_clean(srv, "dispatch profile")
            del srv
    log("dispatch phase: %.1f s" % (time.perf_counter() - t_phase))
    return {"dense": runs[False, False], "paged": runs[True, False],
            "prefix": prefix}


# -------------------------------------------------------- speculative ---

# the speculative mix of benchmark/serving_bench.py (megakernel_ab,
# :560-600) at its full width: its model with an int8 KV pool of
# 16-position blocks, spec_k 3 with n-gram drafts, 24 jobs from
# RandomState(17) of 32-255 prompt tokens and 8-127 new ones, at each
# (lanes, max_len) of SPEC_ARMS, each with spec_k off and on
SPEC_CFG = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=8,
                d_ff=2048, kv_cache_int8=True)
SPEC = dict(jobs=24, prompt=256, seed=17, spec_k=3, block_size=16)
SPEC_ARMS = ((8, 1024), (8, 4096), (16, 1024), (16, 4096))
# B3's fp mode at span 4: the same jobs on a bf16 pool
SPEC_BF16_ARM = (8, 4096)
# the draft-model provider: a 2-layer draft of the same vocab (bf16, its
# decode through B4 dense and B3 fp paged), dense and paged lanes
SPEC_DRAFT_ARM = (8, 1024)
SPEC_DRAFT_CFG = dict(vocab_size=32000, d_model=256, n_heads=4, n_layers=2,
                      d_ff=1024, use_flash_kernel=True)
# B3 timed at the verify window: span 4, every lane's 256-entry table full
SPEC_VERIFY_LANES = (8, 16)
# spans x G of the sliced window check: 20 rows, two launches
SPEC_SLICED = (10, 2)
SPEC_PROFILE_STEPS = 4
# the (8, 1024) int8 arm's spec run at a chunk and a pipeline depth
SPEC_PIPELINED = (16, 2)
SPEC_PROFILE_NEW = 600          # new tokens a profiled lane asks for
# speculative_generate and beam_search at SERVE_CFG's width
SPEC_SOLO = dict(prompt=256, n_new=64, k_draft=4)
SPEC_BEAM = dict(batch=2, prompt=128, n_new=32, beam=4)


def spec_jobs(cfg):
    """serving_bench.py's speculative jobs: (prompt, n_new)."""
    spec = SPEC
    rng = np.random.RandomState(spec["seed"])
    t_prompt, jobs = spec["prompt"], []
    for _ in range(spec["jobs"]):
        t_p = int(rng.randint(max(2, t_prompt // 8), t_prompt))
        n_new = int(rng.randint(8, max(9, t_prompt // 2)))
        jobs.append((list(rng.randint(1, cfg.vocab_size, t_p)), n_new))
    return jobs


def no_sync(torch, srv, names):
    """Run the batcher's methods ``names`` under
    torch.cuda.set_sync_debug_mode("error"): a host read there raises.
    Each exception that leaves one of them is kept in ``srv.escapes``, as
    the dispatch requeue would otherwise swallow it (see check_clean)."""
    srv.escapes = []

    def wrap(fn):
        def run(*args):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args)
            except Exception as exc:
                srv.escapes.append(repr(exc))
                raise
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run
    for name in names:
        setattr(srv, name, wrap(getattr(srv, name)))
    return srv


def check_clean(srv, what, failures=0, escapes=()):
    """The batcher requeued exactly ``failures`` dispatches over its life,
    and the exceptions that left its sync-checked methods are exactly
    ``escapes`` (substrings, in order): a requeue keeps the streams
    exact, so a host read under the sync detector or a failed launch
    shows only here."""
    got = getattr(srv, "escapes", [])
    if srv.dispatch_failures != failures or len(got) != len(escapes) \
            or any(w not in g for w, g in zip(escapes, got)):
        raise AssertionError("%s: %d dispatches requeued (not %d); raised "
                             "in the checked methods: %s"
                             % (what, srv.dispatch_failures, failures, got))


def spec_batcher(torch, sv, params, cfg, device, lanes, spec_k, paged=True,
                 draft=None, num_blocks=None, chunk=1, depth=1):
    """A batcher of the speculative phase; each speculative dispatch, lane
    patch and free runs under the sync detector."""
    kw = dict(max_batch=lanes, paged=paged, spec_k=spec_k, device=device,
              chunk_size=chunk, pipeline_depth=depth)
    if paged:
        bs = SPEC["block_size"]
        kw.update(block_size=bs, num_blocks=num_blocks
                  or lanes * (cfg.max_len // bs) + 1)
    if draft is not None and spec_k:
        kw.update(draft_params=draft[0], draft_cfg=draft[1])
    srv = sv.ContinuousBatcher(params, cfg, **kw)
    return no_sync(torch, srv, ("_dispatch_spec", "_patch_lane", "_free")
                   if spec_k else ("_patch_lane", "_free"))


def spec_run(torch, tf, sv, kernels, params, cfg, device, lanes, spec_k,
             jobs, paged=True, draft=None, expect=None, chunk=1, depth=1):
    """Serve ``jobs`` with spec_k (None: off) at (chunk, depth).
    ``expect(rounds)`` is {kernel: launches} of the run (rounds: decode
    steps or speculative rounds, chunk of them a dispatch), checked
    exactly with no other kernel; each paged-kernel call's span is
    counted, and no dispatch may be requeued. Returns the streams in
    admission order, tokens/s (host clock, admissions included), the
    dispatches, rounds, launches, spans and the acceptance ratio."""
    srv = spec_batcher(torch, sv, params, cfg, device, lanes, spec_k, paged,
                       draft, chunk=chunk, depth=depth)
    spans, real = collections.Counter(), tf.paged_attention

    def counted(q, layer_pool, tables, pos):
        spans[q.shape[1]] += 1
        return real(q, layer_pool, tables, pos)
    tf.paged_attention = counted
    try:
        kernels.launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results, order = srv.run(jobs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        tf.paged_attention = real
    launches = {n: c for n, c in kernels.launches.items() if c}
    what = "spec %s lanes %d max_len %d spec_k %s%s%s" % (
        "paged" if paged else "dense", lanes, cfg.max_len, spec_k,
        " draft model" if draft and spec_k else "",
        " at (chunk %d, depth %d)" % (chunk, depth)
        if (chunk, depth) != (1, 1) else "")
    rounds = chunk * srv.dispatch_count
    if expect is not None:
        check_only(kernels, expect(rounds), what)
    check_clean(srv, what)
    srv.check_invariants(quiesce=True)
    if paged and srv.free_blocks != srv.num_blocks - 1:
        raise AssertionError("%s: %d of %d blocks free at the end"
                             % (what, srv.free_blocks, srv.num_blocks - 1))
    streams = [results[r] for r in order]
    for toks, (prompt, n_new) in zip(streams, jobs):
        if len(toks) != len(prompt) + n_new or toks[:len(prompt)] != prompt:
            raise AssertionError("%s: a malformed stream" % what)
    new = sum(n for _, n in jobs)
    accept = srv.health_snapshot().get("serving.spec_draft_ratio")
    log("%s: %d dispatches (%.4f a token), launches %s, paged spans %s, "
        "acceptance %s, %.3f s, %.1f tokens/s"
        % (what, srv.dispatch_count, srv.dispatch_count / new, launches,
           dict(spans), "-" if accept is None else "%.4f" % accept,
           seconds, new / seconds))
    return {"streams": streams, "tok_s": new / seconds,
            "dispatches": srv.dispatch_count, "rounds": rounds,
            "launches": launches, "spans": dict(spans), "accept": accept}


def spec_gate(torch, tf, params, cfg, got, want, prompts, what):
    """Streams ``got`` equal ``want`` (the spec_k-off run's), or first
    leave them at a token whose teacher-forced top-1/top-2 gap on
    ``want`` is within TOL_TEACHER. Returns the count of such tokens."""
    splits = [first_split(torch, tf, params, cfg, a, b, len(p))
              for a, b, p in zip(got, want, prompts)]
    gaps = [g for n, g in splits if n is not None]
    log("%s: %d of %d streams equal the spec_k-off run's; first splits at "
        "teacher gaps %s (tol %g)" % (what, len(got) - len(gaps), len(got),
                                      [round(g, 4) for g in gaps],
                                      TOL_TEACHER))
    if any(g > TOL_TEACHER for g in gaps):
        raise AssertionError("%s: a stream leaves the spec_k-off run's at a "
                             "token the target is sure of" % what)
    return len(gaps)


def b3_name(cfg):
    return "paged_decode_int8" if cfg.kv_cache_int8 else "paged_decode"


def spec_arm(torch, tf, sv, kernels, params, cfg, device, lanes, jobs,
             turns=2, draft=None, paged=True, pipelined=None):
    """One arm: the jobs with spec_k off and on, ``turns`` times each in
    turns (off on on off), launches exact (paged: B3 n_layers times a
    round, at span 4 when on; the draft model's steps through its own
    kernel), streams gated; with ``pipelined`` (chunk, depth), one more
    spec_k run there, held to the same gates. Then one spec dispatch of
    the arm profiled for its idle share. Returns the runs' figures."""
    k, n = SPEC["spec_k"], cfg.n_layers
    b3 = b3_name(cfg)

    def expect(on):
        def counts(rounds):
            out = collections.Counter()
            if paged:
                out[b3] += n * rounds
            if on and draft is not None:
                dn = draft[1].n_layers * k * rounds
                out[b3_name(draft[1]) if paged else "flash_decode"] += dn
            return out
        return counts

    order = (None, k, k, None) if turns == 2 else (None, k)
    runs = collections.defaultdict(list)
    for spec_k in order:
        runs[spec_k].append(spec_run(torch, tf, sv, kernels, params, cfg,
                                     device, lanes, spec_k, jobs, paged,
                                     draft, expect(spec_k is not None)))
    off, on = runs[None], runs[k]
    piped = None
    if pipelined:
        piped = spec_run(torch, tf, sv, kernels, params, cfg, device, lanes,
                         k, jobs, paged, draft, expect(True), *pipelined)
    for r in on + ([piped] if piped else []):
        if paged and r["spans"].get(k + 1, 0) != n * r["rounds"]:
            raise AssertionError("B3 ran %s spans, not %d at span %d"
                                 % (r["spans"], n * r["rounds"], k + 1))
    label = "spec %s %d x %d%s%s" % (
        "paged" if paged else "dense", lanes, cfg.max_len,
        "" if cfg.kv_cache_int8 else " bf16 pool",
        " draft model" if draft else "")
    split = spec_gate(torch, tf, params, cfg, on[0]["streams"],
                      off[0]["streams"], [p for p, _ in jobs], label)
    if piped:
        spec_gate(torch, tf, params, cfg, piped["streams"],
                  off[0]["streams"], [p for p, _ in jobs],
                  "%s at (chunk %d, depth %d)" % ((label,) + pipelined))
        log("%s at (chunk %d, depth %d): %.1f tokens/s, %d dispatches of "
            "%d rounds, streams %s the (1, 1) spec run's (%s)"
            % ((label,) + pipelined + (
                piped["tok_s"], piped["dispatches"], pipelined[0],
                "equal" if piped["streams"] == on[0]["streams"]
                else "differ from", card_line())))
    if any(r["streams"] != on[0]["streams"] for r in on) or \
            any(r["streams"] != off[0]["streams"] for r in off):
        raise AssertionError("%s: repeated runs gave other streams" % label)
    tok_off = [r["tok_s"] for r in off]
    tok_on = [r["tok_s"] for r in on]
    new = sum(n_new for _, n_new in jobs)
    launched = ", ".join("%s %.2f" % (name, count / on[0]["dispatches"])
                         for name, count in sorted(on[0]["launches"].items()))
    log("%s: tokens/s off %s, on %s (on / off %.3f by means), target "
        "dispatches a token %.4f off, %.4f on, acceptance %.4f, launches a "
        "spec dispatch: %s; %d diverging streams (%s)"
        % (label, " / ".join("%.1f" % t for t in tok_off),
           " / ".join("%.1f" % t for t in tok_on),
           np.mean(tok_on) / np.mean(tok_off), off[0]["dispatches"] / new,
           on[0]["dispatches"] / new, on[0]["accept"], launched or "none",
           split, card_line()))
    profile_spec(torch, sv, params, cfg, device, lanes, jobs, label, draft,
                 paged)
    return {"off": off, "on": on, "split": split, "pipelined": piped}


def profile_spec(torch, sv, params, cfg, device, lanes, jobs, label, draft,
                 paged):
    """One spec dispatch of the arm under the profiler: every lane live
    (the first ``lanes`` prompts, SPEC_PROFILE_NEW new tokens each),
    warmed up by two dispatches; its idle share, and its kernels
    (those of B3's mode on a paged pool, the draft's decode kernel)."""
    srv = spec_batcher(torch, sv, params, cfg, device, lanes, SPEC["spec_k"],
                       paged, draft)
    for prompt, _ in jobs[:lanes]:
        srv.admit(prompt, SPEC_PROFILE_NEW)
    for _ in range(2):
        srv.step()
    expect = (INT8_SPLIT if cfg.kv_cache_int8 else PAGED_SPLIT) \
        if paged else ()
    if draft is not None:
        expect += PAGED_SPLIT if paged else FLASH_SPLIT
    profile_steps(torch, "%s: spec dispatch (spec_k %d, %s), %d live lanes "
                  "(%s)" % (label, SPEC["spec_k"], "draft model" if draft
                            else "n-gram", lanes, card_line()),
                  srv.step, steps=SPEC_PROFILE_STEPS,
                  expect=tuple(dict.fromkeys(expect)))
    check_clean(srv, label + " profile")


def verify_case(torch, device, lanes, seed, int8, span, g=1, bs=16,
                nbl=256):
    """The verify window at full tables: each lane's 256 entries its own
    blocks (lanes x 256 + 1 of them), its window ending in its last
    block; q bf16 [lanes, span, 8 * g, 64]."""
    rng = np.random.RandomState(seed)
    nb = lanes * nbl + 1
    tables = (1 + rng.permutation(nb - 1)).reshape(lanes, nbl)
    pos = nbl * bs - span - rng.randint(0, bs, size=lanes)
    return paged_tensors(torch, device, torch.bfloat16, tables, pos, span, g,
                         seed, nb=nb, int8=int8)


def time_verify(torch, F, kernels, device):
    """B3 at the verify window (span 4, max_len 4096) on 8 and 16 lanes,
    bf16 and int8 pools: held against its plain version, then ms by
    events, the plain version's ms, the bound (bytes) and, for bf16, SDPA
    on the gathered dense view with the window mask (gather not timed),
    and every call's device ms from one profiler session; then a 20-row
    window (span 10, G 2), which runs as two launches, against its plain
    version."""
    span = SPEC["spec_k"] + 1
    out, calls = {}, {}
    for int8 in (False, True):
        name = "paged_decode_int8" if int8 else "paged_decode"
        for lanes in SPEC_VERIFY_LANES:
            q, pool, tables, pos = verify_case(torch, device, lanes,
                                               300 + lanes, int8, span)
            got = kernels.paged_attention(q, pool, tables, pos)
            want = kernels.paged_attention_reference(q, pool, tables, pos)
            what = "%s verify %d lanes span %d" % (name, lanes, span)
            if int8:
                err = compare_int8(got, want, int8_code_step(
                    torch, q, pool, tables, pos), "bfloat16", what)[0]
            else:
                err = compare(got, want, "bfloat16", what)
            calls[name, lanes] = functools.partial(
                kernels.paged_attention, q, pool, tables, pos)
            plain = time_ms(lambda: kernels.paged_attention_reference(
                q, pool, tables, pos), 3)
            nbytes, ops = paged_work(q, pool, tables, pos)
            out[name, lanes] = {
                "ms": time_ms(calls[name, lanes], 20), "plain_ms": plain,
                "bound": bound_ms(nbytes, ops, "int8" if int8 else "bfloat16"),
                "library_ms": None, "err": err}
            if not int8:
                h, d = q.shape[2:]
                t = tables.shape[1] * pool["k"].shape[1]
                idx = tables.long()
                kd, vd = (pool[n][idx].reshape(lanes, t, h, d)
                          .transpose(1, 2) for n in ("k", "v"))
                rows = pos.long()[:, None] \
                    + torch.arange(span, device=device)
                mask = (torch.arange(t, device=device)[None, None, :]
                        <= rows[:, :, None])[:, None]
                calls["sdpa", lanes] = functools.partial(
                    F.scaled_dot_product_attention, q.transpose(1, 2), kd, vd,
                    attn_mask=mask)
                out[name, lanes]["library_ms"] = time_ms(calls["sdpa", lanes],
                                                         20)
    dev = {label: sum(parts.values())
           for label, parts in device_ms_each(torch, calls).items()}
    for (name, lanes), r in out.items():
        r["device_ms"] = dev[name, lanes]
        lib_dev = dev.get(("sdpa", lanes)) if r["library_ms"] else None
        r["library_device_ms"] = lib_dev
        bound, bound_by = r["bound"]
        log("%s verify %d lanes span %d: %.4f ms (device %.4f), plain %.4f "
            "ms, sdpa %s ms (device %s), bound %.4f ms (%s); device / bound "
            "%.2f (%s)" % (name, lanes, span, r["ms"], r["device_ms"],
                           r["plain_ms"], "-" if lib_dev is None else
                           "%.4f" % r["library_ms"], "-" if lib_dev is None
                           else "%.4f" % lib_dev, bound, bound_by,
                           r["device_ms"] / bound, card_line()))
    del calls
    torch.cuda.empty_cache()
    width, g = SPEC_SLICED
    for int8 in (False, True):
        name = "paged_decode_int8" if int8 else "paged_decode"
        q, pool, tables, pos = verify_case(torch, device, 8, 400, int8,
                                           width, g)
        kernels.launches.clear()
        got = kernels.paged_attention(q, pool, tables, pos)
        torch.cuda.synchronize()
        if kernels.launches[name] != 2:
            raise AssertionError("a %d-row window took %d launches, not 2"
                                 % (width * g, kernels.launches[name]))
        want = kernels.paged_attention_reference(q, pool, tables, pos)
        what = "%s sliced window span %d G %d (2 launches)" % (name, width, g)
        if int8:
            compare_int8(got, want, int8_code_step(torch, q, pool, tables,
                                                   pos), "bfloat16", what)
        else:
            compare(got, want, "bfloat16", what)
        del pool
    return out


def spec_solo_beam(torch, tf, kernels, params, cfg, device):
    """speculative_generate (a 2-layer draft, its steps through B4) and
    beam_search (its steps through B4) at SERVE_CFG's width: exact
    launches, tokens gated against generate()."""
    dcfg = tf.TransformerConfig(dtype=cfg.dtype, max_len=cfg.max_len,
                                **SPEC_DRAFT_CFG)
    dparams = tf.init_params(dcfg, seed=1, device=device)
    rng = np.random.RandomState(5)
    s = SPEC_SOLO
    prompt = rng.randint(1, cfg.vocab_size, (1, s["prompt"]))
    want = tf.generate(params, prompt, s["n_new"], cfg,
                       device=device)[0].tolist()
    kernels.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, stats = tf.speculative_generate(params, dparams, prompt, s["n_new"],
                                         cfg, dcfg, k_draft=s["k_draft"],
                                         return_stats=True, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rounds = len(stats["acceptances"])
    solo = {"flash_fwd": cfg.n_layers + dcfg.n_layers,
            "flash_decode": dcfg.n_layers * s["k_draft"] * rounds}
    check_only(kernels, solo, "speculative_generate")
    got = out[0].tolist()
    n, gap = first_split(torch, tf, params, cfg, got, want, s["prompt"])
    log("speculative_generate: %d rounds, %d of %d drafts accepted, "
        "big-model launches %d, launches %s, %.3f s (%.1f tokens/s), %s "
        "generate()'s stream%s (%s)"
        % (rounds, sum(stats["acceptances"]), s["k_draft"] * rounds,
           stats["big_model_launches"], solo,
           seconds, s["n_new"] / seconds, "equals" if n is None else
           "leaves", "" if n is None else " at token %d, teacher gap %.4f"
           % (n, gap), card_line()))
    if n is not None and gap > TOL_TEACHER:
        raise AssertionError("speculative_generate left generate()'s stream")
    b = SPEC_BEAM
    prompt = rng.randint(1, cfg.vocab_size, (b["batch"], b["prompt"]))
    kernels.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seqs, scores = tf.beam_search(params, prompt, b["n_new"], cfg,
                                  beam=b["beam"], device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    beam = {"flash_fwd": cfg.n_layers,
            "flash_decode": cfg.n_layers * (b["n_new"] - 1)}
    check_only(kernels, beam, "beam_search")
    total = b["prompt"] + b["n_new"]
    if tuple(seqs.shape) != (b["batch"], b["beam"], total) \
            or not torch.isfinite(scores).all() \
            or (scores[:, 1:] > scores[:, :-1]).any() \
            or not torch.equal(seqs[:, :, :b["prompt"]].cpu(), torch.from_numpy(
                prompt).to(torch.int32)[:, None].expand(-1, b["beam"], -1)):
        raise AssertionError("beam_search: malformed beams or scores")
    ones, _ = tf.beam_search(params, prompt, b["n_new"], cfg, beam=1,
                             device=device)
    greedy = tf.generate(params, prompt, b["n_new"], cfg, device=device)
    for i in range(b["batch"]):
        n, gap = first_split(torch, tf, params, cfg, ones[i, 0].tolist(),
                             greedy[i].tolist(), b["prompt"])
        if n is not None and gap > TOL_TEACHER:
            raise AssertionError("beam 1 left generate()'s stream")
    log("beam_search: batch %d x beam %d, %d new tokens, launches %s, %.3f "
        "s, best scores %s; beam 1 gives generate()'s streams (%s)"
        % (b["batch"], b["beam"], b["n_new"], beam, seconds,
           [round(float(x), 3) for x in scores[:, 0]], card_line()))
    return {"solo": solo, "beam": beam}


def spec_robust(torch, tf, sv, params, cfg, device, lanes, jobs, want):
    """At the served width (int8 pool, max_len 1024, 8 lanes, spec_k 3) a
    pool sized so that a priority-1 admission must preempt a lane, one
    injected dispatch failure requeued, one shrink_pool / grow_pool round
    trip that preempts, then every victim resumed through
    admit_continuation: streams gated against ``want`` (the spec_k-off
    run's), blocks balanced."""
    bs, live = SPEC["block_size"], jobs[:6]

    def lifetime(prompt, n_new):
        t_p = len(prompt)
        return max(t_p, t_p + n_new - 2) // bs + 1
    num_blocks = sum(lifetime(p, n) for p, n in live) + 3
    srv = spec_batcher(torch, sv, params, cfg, device, lanes, SPEC["spec_k"],
                       num_blocks=num_blocks)
    job_of = {srv.admit(p, n): i for i, (p, n) in enumerate(live)}
    done = {}
    for _ in range(3):
        done.update(srv.step())
    rid = srv.admit(*jobs[6], priority=1)
    if rid is None or not srv.preempted:
        raise AssertionError("the priority admission preempted nothing")
    job_of[rid] = 6
    preempted = len(srv.preempted)
    real, calls = srv._run_spec_rounds, []

    def once(*args):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected dispatch failure")
        return real(*args)
    srv._run_spec_rounds = once
    done.update(srv.step())
    if calls != [1] or srv._dispatch_failures != 1:
        raise AssertionError("the injected failure was not requeued")
    check_clean(srv, "spec robust run", 1, ("injected dispatch failure",))
    before = len(srv.preempted)
    parked = srv.shrink_pool(srv.free_blocks + 8)
    srv.check_invariants()
    shrunk = len(srv.preempted) - before
    if not shrunk:
        raise AssertionError("shrink_pool past the free blocks preempted "
                             "nothing")
    grown = srv.grow_pool(parked + 8)
    srv.check_invariants()
    alias = {}
    while srv.active_count or srv.preempted:
        while srv.preempted:
            req, _ = srv.preempted[0]
            new = srv.admit_continuation(
                req.tokens, req.n_new - req.emitted, emitted=req.emitted,
                priority=req.priority)
            if new is None:
                break
            srv.preempted.pop(0)
            alias[new] = alias.get(req.rid, req.rid)
        done.update(srv.step())
    srv.check_invariants(quiesce=True)
    check_clean(srv, "spec robust run", 1, ("injected dispatch failure",))
    if srv.free_blocks != srv.num_blocks - 1:
        raise AssertionError("the robust run leaked blocks")
    got = {job_of[alias.get(r, r)]: toks for r, toks in done.items()}
    idx = sorted(got)
    if idx != list(range(7)):
        raise AssertionError("the robust run lost a request: %s" % idx)
    split = spec_gate(torch, tf, params, cfg, [got[i] for i in idx],
                      [want[i] for i in idx], [jobs[i][0] for i in idx],
                      "spec robust run")
    log("spec robust run: %d lanes preempted by the priority admission, "
        "the injected failure requeued, shrink_pool parked %d blocks and "
        "preempted %d lanes, grow_pool returned %d (pool %d blocks), %d "
        "resumed through admit_continuation, %d diverging streams"
        % (preempted, parked, shrunk, grown, srv.num_blocks, len(alias),
           split))


def spec_launches(specd, name):
    """The speculative phase's launches of kernel ``name`` with spec_k on,
    by run, for the kernels line."""
    arms = dict(specd["arms"])
    out = {}
    if name == "paged_decode_int8":
        for (lanes, max_len), arm in arms.items():
            out["%d,%d" % (lanes, max_len)] = arm["on"][0]["launches"][name]
            if arm["pipelined"]:
                out["%d,%d at chunk %d, depth %d" % (
                    (lanes, max_len) + SPEC_PIPELINED)] = \
                    arm["pipelined"]["launches"][name]
        out["draft model paged %d,%d" % SPEC_DRAFT_ARM] = \
            specd["drafted"][True]["on"][0]["launches"][name]
    elif name == "paged_decode":
        out["bf16 pool %d,%d" % SPEC_BF16_ARM] = \
            specd["bf16"]["on"][0]["launches"][name]
        out["draft steps, paged %d,%d" % SPEC_DRAFT_ARM] = \
            specd["drafted"][True]["on"][0]["launches"][name]
    else:
        out["draft steps, dense %d,%d" % SPEC_DRAFT_ARM] = \
            specd["drafted"][False]["on"][0]["launches"][name]
        out["speculative_generate"] = specd["solo"]["solo"][name]
        out["beam_search"] = specd["solo"]["beam"][name]
    return out

def spec_phase(torch, F, tf, sv, kernels, params, cfg, device):
    """Speculative serving (see SPEC): the int8 arms, the bf16 pool, the
    draft model dense and paged (each arm with its profiled spec
    dispatch), the pipelined spec run, the robust run, B3 timed at the
    verify window, and speculative_generate /
    beam_search at SERVE_CFG's width (``params``, ``cfg``)."""
    t_phase = time.perf_counter()
    models = {}

    def model(max_len, int8=True):
        key = (max_len, int8)
        if key not in models:
            c = tf.TransformerConfig(dtype=torch.bfloat16, max_len=max_len,
                                     **dict(SPEC_CFG, kv_cache_int8=int8))
            models[key] = (tf.init_params(c, seed=0, device=device), c)
        return models[key]

    lanes0, len0 = SPEC_ARMS[0]
    p0, c0 = model(len0)
    jobs = spec_jobs(c0)
    # warm-up: both modes' shapes once, untimed
    for spec_k in (None, SPEC["spec_k"]):
        srv = spec_batcher(torch, sv, p0, c0, device, lanes0, spec_k)
        srv.run(jobs[:3])
        check_clean(srv, "spec warm-up")
    arms = {}
    for lanes, max_len in SPEC_ARMS:
        p, c = model(max_len)
        arms[lanes, max_len] = spec_arm(
            torch, tf, sv, kernels, p, c, device, lanes, jobs,
            pipelined=SPEC_PIPELINED if (lanes, max_len) == SPEC_ARMS[0]
            else None)
    p, c = model(SPEC_BF16_ARM[1], int8=False)
    bf16 = spec_arm(torch, tf, sv, kernels, p, c, device, SPEC_BF16_ARM[0],
                    jobs, turns=1)
    models.pop((SPEC_BF16_ARM[1], False))
    dcfg = tf.TransformerConfig(dtype=torch.bfloat16,
                                max_len=SPEC_DRAFT_ARM[1], **SPEC_DRAFT_CFG)
    draft = (tf.init_params(dcfg, seed=1, device=device), dcfg)
    p, c = model(SPEC_DRAFT_ARM[1])
    drafted = {paged: spec_arm(torch, tf, sv, kernels, p, c, device,
                               SPEC_DRAFT_ARM[0], jobs, turns=1, draft=draft,
                               paged=paged)
               for paged in (False, True)}
    spec_robust(torch, tf, sv, p0, c0, device, lanes0, jobs,
                arms[lanes0, len0]["off"][0]["streams"])
    log("spec phase: %.1f s before the timings"
        % (time.perf_counter() - t_phase))
    del models
    torch.cuda.empty_cache()
    verify = time_verify(torch, F, kernels, device)
    solo = spec_solo_beam(torch, tf, kernels, params, cfg, device)
    log("spec phase: %.1f s" % (time.perf_counter() - t_phase))
    return {"arms": arms, "bf16": bf16, "drafted": drafted,
            "verify": verify, "solo": solo}


# ------------------------------------------------------ durable serving ---
# serving_bench.py's journal_ab at full width: 8 jobs from RandomState(31)
# of 96-191 prompt and 64 new tokens, 4 lanes, paged, depth 2
DURABLE = dict(max_len=2048, jobs=8, prompt=192, n_new=64, lanes=4,
               block_size=16, seed=31)
DURABLE_SAMPLE = dict(temperature=0.8, top_k=50, top_p=0.95)
JOURNAL_ROUNDS = 3                # off / on pairs of the journal A/B
# journal.append matches twice a record (the pre-write fire and the at-rest
# corrupt_file hook): 600 dies at the 301st record's write, in the second
# wave of requests, with the first wave finished
DURABLE_CRASH_AT = 600
DURABLE_OOM_AT = 5
# serving_bench.py's overload leg without brownout: 2 replicas x 3 lanes,
# 96-token prompts, 4 steady requests of 128 new tokens, then a storm of
# 4 p2 + 4 p1 + 6 p0 + 2 p0 with deadline_ms=0, 64 new each
OVERLOAD = dict(max_len=4096, prompt=96, block_size=16, lanes=3,
                steady_new=128, storm_new=64, storm=(4, 4, 6), expired=2,
                shed_queue=8, seed=12, rounds=600)
# the rollout's traffic: 6 requests on 2 x 4 lanes, some short enough to finish on the
# replica still serving the old weights, the rest restarted from their
# prompt when no replica is left on those weights (the JAX router's
# version affinity); the rollout starts after ``warm`` fleet steps
ROLLOUT = dict(requests=6, prompt_lo=32, prompt_hi=128, new_lo=6, new_hi=40,
               lanes=4, seed=5, warm=2, rounds=2000)
# train_lm_bench.py's flagship cut to 2 layers: steps before the async
# save, then after it, in the uninterrupted run
RESUME_CFG = dict(TRAIN_CFG, n_layers=2)
RESUME = dict(batch=8, before=2, after=3, lr=1e-2)


def durable_root():
    """A fresh git-ignored directory of the checkout for journals and
    checkpoints (removed when the phase ends)."""
    import shutil
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "durable")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    return root


def durable_jobs(cfg, sampled=False):
    """journal_ab's jobs: (prompt, n_new, seed); sampled runs seed each
    request on its own."""
    rng = np.random.RandomState(DURABLE["seed"])
    t_prompt, jobs = DURABLE["prompt"], []
    for i in range(DURABLE["jobs"]):
        t_p = int(rng.randint(max(2, t_prompt // 2), t_prompt))
        jobs.append((list(rng.randint(1, cfg.vocab_size, t_p)),
                     DURABLE["n_new"], 100 + i if sampled else 0))
    return jobs


def durable_cfg(torch, tf):
    return tf.TransformerConfig(dtype=torch.bfloat16,
                                **dict(SERVE_CFG, max_len=DURABLE["max_len"]))


def durable_batcher(torch, sv, params, cfg, device, journal=None, **kw):
    """A journal_ab batcher (its pool: the lanes' lifetimes plus 2 blocks);
    every dispatch, lane patch and free under the sync detector."""
    bs = DURABLE["block_size"]
    life = (DURABLE["prompt"] + DURABLE["n_new"] - 2) // bs + 1
    srv = sv.ContinuousBatcher(
        params, cfg, max_batch=DURABLE["lanes"], paged=True, block_size=bs,
        num_blocks=DURABLE["lanes"] * life + 2, pipeline_depth=2,
        journal=journal, device=device, **kw)
    return no_sync(torch, srv, ("_dispatch_spec" if kw.get("spec_k")
                                else "_dispatch_chunk", "_patch_lane",
                                "_free"))


CRASH_MODES = {"greedy": dict(spec_k=2, spec_ngram=2),
               "sampled": DURABLE_SAMPLE}


def durable_child(path, mode):
    """``--durable-child DIR MODE``: serve the journal_ab mix on the card
    with a journal in DIR until the chaos crash at a journal commit point
    kills the process with exit code 9."""
    import torch
    from mxnet_tpu_torch.models import serving as sv
    from mxnet_tpu_torch.models import transformer as tf
    from mxnet_tpu_torch.observability import chaos
    device = torch.device("cuda", 0)
    cfg = durable_cfg(torch, tf)
    params = tf.init_params(cfg, seed=0, device=device)
    srv = durable_batcher(torch, sv, params, cfg, device, journal=path,
                          **CRASH_MODES[mode])
    chaos.install("journal.append:crash:at=%d:code=9" % DURABLE_CRASH_AT)
    srv.run(durable_jobs(cfg, mode == "sampled"))
    raise SystemExit("durable child: served to the end, the crash never "
                     "fired")


def sampler_flip(torch, tf, row, noise, a, b, limit=4.0):
    """The smallest shift s of logits ``row`` [1, V] that makes the
    sampler (DURABLE_SAMPLE, with ``noise``) choose token ``a`` over its
    choice ``b``: ``a`` raised by s, ``b`` lowered by s, or each by s / 2
    (a top-k or top-p boundary flips as well as an argmax); inf when none
    within ``limit``."""
    c = DURABLE_SAMPLE

    def chooses(da, db):
        r = row.clone()
        r[0, a] += da
        r[0, b] -= db
        return int(tf._sample_logits(r, noise, c["temperature"], c["top_k"],
                                     c["top_p"])[0]) == a
    best = float("inf")
    for wa, wb in ((1.0, 0.0), (0.0, 1.0), (0.5, 0.5)):
        if not chooses(limit * wa, limit * wb):
            continue
        lo, hi = 0.0, limit
        for _ in range(24):
            mid = (lo + hi) / 2
            if chooses(mid * wa, mid * wb):
                hi = mid
            else:
                lo = mid
        best = min(best, hi)
    return best


def durable_gate(torch, tf, params, cfg, got, want, prompts, what,
                 sampled=False, seeds=None):
    """Streams ``got`` equal ``want``, or first leave them at a token whose
    teacher-forced gap is within TOL_TEACHER: greedy, the top-1/top-2 gap
    of want's teacher-forced logits (PR 13's rule); sampled, the smallest
    shift of those logits that makes the sampler, with the request's
    noise at that token, choose got's token (``sampler_flip``). Returns
    the count of such streams."""
    gaps = []
    for a, b, p, seed in zip(got, want, prompts,
                             seeds or [0] * len(got)):
        if len(a) != len(b) or a[:len(p)] != p:
            raise AssertionError("%s: a malformed stream" % what)
        n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if n is None:
            continue
        rows, _ = teacher_rows(torch, tf, params, cfg, b[:n + 1], len(p))
        row = rows[-1:]
        if sampled:
            dev = row.device
            noise = tf._gumbel(
                torch.tensor([tf._seed_word(seed)], device=dev),
                torch.tensor([n - len(p)], device=dev),
                torch.zeros((1,), dtype=torch.int64, device=dev),
                cfg.vocab_size, dev)
            gaps.append(sampler_flip(torch, tf, row, noise, a[n], b[n]))
        else:
            top = torch.topk(row[0], 2).values
            gaps.append(float(top[0] - top[1]))
    log("%s: %d of %d streams equal; first splits at teacher gaps %s (tol "
        "%g)" % (what, len(got) - len(gaps), len(got),
                 [round(g, 4) for g in gaps], TOL_TEACHER))
    if any(g > TOL_TEACHER for g in gaps):
        raise AssertionError("%s: a stream leaves the reference at a token "
                             "the model is sure of" % what)
    return len(gaps)


def append_us(journal_cls, path, records=2000):
    """Host microseconds per ``append_emit`` of one token into a fresh
    journal in ``path`` (the record journal_ab writes a lane a sync)."""
    j = journal_cls(path)
    j.append_submit(0, list(range(150)), 64, emitted=1)
    t0 = time.perf_counter()
    for k in range(records):
        j.append_emit(0, [k % 32000], k + 2)
    us = 1e6 * (time.perf_counter() - t0) / records
    j.close()
    return us


def journal_ab(torch, sv, kernels, params, cfg, device, root):
    """journal_ab: a warm-up, then JOURNAL_ROUNDS rounds of the journal off
    and on in turns (off on on off ...), each journal in a fresh directory
    under TMPDIR. Streams and dispatch counts bitwise equal, every replay
    all finished, each dispatch n_layers B3 launches and nothing else,
    every dispatch under the sync detector. Also times one record's
    append in TMPDIR and in the checkout."""
    import tempfile
    from mxnet_tpu_torch.models.journal import RequestJournal
    jobs = durable_jobs(cfg)
    launches = collections.Counter()
    tmp = tempfile.mkdtemp(prefix="journal-ab-")

    in_loop = []                      # host s inside the journal's appends

    def leg(journal, what):
        srv = durable_batcher(torch, sv, params, cfg, device, journal)
        if srv._journal is not None:
            real, spent = srv._journal._append, [0.0]

            def timed(obj):
                t = time.perf_counter()
                real(obj)
                spent[0] += time.perf_counter() - t
            srv._journal._append = timed
            in_loop.append(spent)
        kernels.launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results, order = srv.run(list(jobs))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check_only(kernels,
                   {"paged_decode": cfg.n_layers * srv.dispatch_count}, what)
        launches.update(kernels.launches)
        check_clean(srv, what)
        srv.check_invariants(quiesce=True)
        return ([results[r] for r in order], srv.dispatch_count,
                len(jobs) * DURABLE["n_new"] / seconds)

    try:
        base = leg(None, "journal warm-up")
        rates = {"off": [], "on": []}
        depth = records = 0
        for k in range(2 * JOURNAL_ROUNDS):
            on = (k % 4) in (1, 2)
            jdir = os.path.join(tmp, "leg%d" % k) if on else None
            out = leg(jdir, "journal %s" % ("on" if on else "off"))
            if out[:2] != base[:2]:
                raise AssertionError("journal A/B: the journal changed the "
                                     "streams or the dispatch count")
            rates["on" if on else "off"].append(out[2])
            if on:
                j = RequestJournal(jdir)
                live, fin, skipped = j.replay()
                depth, records = j.depth_bytes, j.lag_records
                j.close()
                if live or skipped or len(fin) != len(jobs):
                    raise AssertionError(
                        "journal A/B: replay gave %d live, %d finished, %d "
                        "skipped" % (len(live), len(fin), len(skipped)))
        cost = {"TMPDIR": append_us(RequestJournal,
                                    os.path.join(tmp, "append")),
                "checkout": append_us(RequestJournal,
                                      os.path.join(root, "append"))}
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    off, on = float(np.median(rates["off"])), float(np.median(rates["on"]))
    log("journal A/B (%d jobs, %d lanes, max_len %d, depth 2, journals in "
        "TMPDIR): %d dispatches each; tokens/s off %s, on %s (in turns); "
        "medians off %.1f, on %.1f: overhead %.2f%%; journal %d bytes in %d "
        "records, replay 8 finished, 0 live, 0 skipped; the appends took "
        "%s s of each on run's host time; one record's append alone %.1f "
        "us in TMPDIR, %.1f us in the checkout"
        % (len(jobs), DURABLE["lanes"], cfg.max_len, base[1],
           [round(r, 1) for r in rates["off"]],
           [round(r, 1) for r in rates["on"]], off, on,
           100.0 * (off - on) / off, depth, records,
           [round(t[0], 4) for t in in_loop], cost["TMPDIR"],
           cost["checkout"]))
    return {"launches": launches, "overhead_pct": 100.0 * (off - on) / off,
            "bytes": depth}


def crash_recover(torch, tf, sv, kernels, params, cfg, device, root, mode):
    """A child process on the card dies at a journal commit point (exit
    code 9); a fresh batcher here recovers its journal and serves to the
    end: nothing skipped, every stream the uninterrupted run's up to the
    teacher-gap rule, the pool quiescent."""
    sampled = mode == "sampled"
    jobs = durable_jobs(cfg, sampled)
    kw = CRASH_MODES[mode]
    ref = durable_batcher(torch, sv, params, cfg, device, **kw)
    want, order = ref.run(list(jobs))
    check_clean(ref, "crash reference " + mode)
    want = [want[r] for r in order]
    jdir = os.path.join(root, "crash-" + mode)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--durable-child", jdir, mode],
                          capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if proc.returncode != 9:
        raise AssertionError("durable child (%s) exited %d, not 9: %s"
                             % (mode, proc.returncode, proc.stderr[-3000:]))
    srv = durable_batcher(torch, sv, params, cfg, device, journal=jdir, **kw)
    kernels.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed, got, skipped = srv.recover()
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    if skipped:
        raise AssertionError("recover (%s) skipped records: %s"
                             % (mode, skipped))
    finished_before = len(got)
    new2old = {v: k for k, v in resumed.items() if v is not None}
    # jobs the child never admitted have no record: the client submits
    # them again (rids were given in job order)
    missing = [i for i in range(len(jobs)) if i not in got
               and i not in resumed]
    res, again = srv.run([jobs[i] for i in missing])
    new2old.update(zip(again, missing))
    # run() resumes a parked record under its journaled rid
    for rid, toks in res.items():
        got[new2old.get(rid, rid)] = toks
    what = "crash and recover (%s%s)" % (
        mode, ", spec_k 2" if kw.get("spec_k") else "")
    check_only(kernels, {"paged_decode": cfg.n_layers * srv.dispatch_count},
               what)
    check_clean(srv, what)
    srv.check_invariants(quiesce=True)
    if sorted(got) != list(range(len(jobs))):
        raise AssertionError("%s: recovered rids %s" % (what, sorted(got)))
    split = durable_gate(torch, tf, params, cfg, [got[i] for i in order],
                         want, [p for p, _, _ in jobs], what, sampled,
                         [s for _, _, s in jobs])
    log("%s: child died with code 9 after %.1f s; the journal held %d "
        "finished and %d live requests, %d never admitted were submitted "
        "again; recover() %.3f s, %d dispatches to the end, %d B3 "
        "launches, %d diverging streams"
        % (what, child_s, finished_before, len(resumed), len(missing),
           recover_s, srv.dispatch_count, kernels.launches["paged_decode"],
           split))
    return {"launches": collections.Counter(kernels.launches),
            "recover_s": recover_s}


def oom_shrink(torch, tf, sv, kernels, params, cfg, device):
    """serving.dispatch:oom at the 5th dispatch of a paged batcher of the
    dispatch mix (8 lanes, chunk 16, depth 2): blocks parked, exactly one
    failure, no lane rebuild, the streams the run without the fault's."""
    from mxnet_tpu_torch.observability import chaos
    jobs = dispatch_jobs(cfg)
    ref = dispatch_batcher(sv, params, cfg, device, True, 16, 2)
    want, order = ref.run(jobs)
    check_clean(ref, "oom reference")
    want = [want[r] for r in order]
    srv = dispatch_batcher(sv, params, cfg, device, True, 16, 2)
    rebuilds, real = [], srv._rebuild_state

    def rebuild():
        rebuilds.append(1)
        real()
    srv._rebuild_state = rebuild
    parked, victims = [], []
    real_shrink = srv.shrink_pool

    def shrink(n):
        before = len(srv.preempted)
        parked.append(real_shrink(n))
        victims.append(len(srv.preempted) - before)
        return parked[-1]
    srv.shrink_pool = shrink
    chaos.install("serving.dispatch:oom:at=%d" % DURABLE_OOM_AT)
    try:
        kernels.launches.clear()
        got, order = srv.run(jobs)
    finally:
        chaos.reset()
    what = "oom shrink"
    check_only(kernels, {"paged_decode": cfg.n_layers * 16
                         * srv.dispatch_count}, what)
    check_clean(srv, what, 1, ("RESOURCE_EXHAUSTED",))
    srv.check_invariants(quiesce=True)
    if rebuilds or not parked or not parked[0] > 0:
        raise AssertionError("%s: parked %s blocks, %d lane rebuilds"
                             % (what, parked, len(rebuilds)))
    split = durable_gate(torch, tf, params, cfg, [got[r] for r in order],
                         want, [p for p, _, _ in jobs], what)
    log("%s: the fault at dispatch %d parked %d of %d blocks, %d lanes "
        "preempted and resumed, 1 failure, no rebuild, %d dispatches, %d "
        "diverging streams" % (what, DURABLE_OOM_AT, parked[0],
                               srv.num_blocks - 1, victims[0],
                               srv.dispatch_count, split))
    return {"launches": collections.Counter(kernels.launches)}


def overload_jobs(cfg):
    """(prompt, n_new, priority, deadline_ms): steady, then the storm."""
    o = OVERLOAD
    rng = np.random.RandomState(o["seed"])

    def prompt():
        return list(rng.randint(1, cfg.vocab_size, o["prompt"]))
    steady = [(prompt(), o["steady_new"], 0, None) for _ in range(4)]
    n2, n1, n0 = o["storm"]
    storm = ([(prompt(), o["storm_new"], 2, None) for _ in range(n2)]
             + [(prompt(), o["storm_new"], 1, None) for _ in range(n1)]
             + [(prompt(), o["storm_new"], 0, None) for _ in range(n0)]
             + [(prompt(), o["storm_new"], 0, 0)
                for _ in range(o["expired"])])
    return steady, storm


def overload(torch, tf, rt, kernels, params, cfg, device, paged):
    """The overload leg: r1 fails its dispatches 1-4, drains, its breaker
    opens, probes and closes. No deadlock, nothing above priority 0
    dropped, p1/p2 attainment 1.0, r1 alive and closed, the completed
    streams teacher-forced, the replicas quiescent."""
    from mxnet_tpu_torch.observability import chaos
    o = OVERLOAD
    kw = dict(paged=True, block_size=o["block_size"],
              num_blocks=2 * ((o["prompt"] + o["steady_new"] - 2)
                              // o["block_size"] + 1) + 1) if paged else {}
    r = rt.ReplicaRouter.build(params, cfg, n_replicas=2,
                               max_batch=o["lanes"],
                               shed_queue=o["shed_queue"], breaker=True,
                               device=device, **kw)
    steady, storm = overload_jobs(cfg)
    prio, prompt_of = {}, {}

    def submit(batch):
        for p, n, pr, ddl in batch:
            rid = r.submit(p, n, priority=pr, deadline_ms=ddl)
            prio[rid], prompt_of[rid] = pr, p
    kernels.launches.clear()
    t0 = time.perf_counter()
    results, rounds = {}, 0
    submit(steady)
    try:
        for _ in range(2):
            results.update(r.step())
            rounds += 1
        chaos.install(";".join("serving.dispatch.r1:error:at=%d" % k
                               for k in range(1, 5)))
        submit(storm)
        while (r._queue or r._live) and rounds < o["rounds"]:
            results.update(r.step())
            rounds += 1
    finally:
        chaos.reset()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    what = "overload (%s replicas)" % ("paged" if paged else "dense")
    kernel = "paged_decode" if paged else "flash_decode"
    dispatches = sum(rep.dispatch_count for rep in r.replicas)
    check_only(kernels, {kernel: cfg.n_layers * dispatches}, what)
    if r._queue or r._live:
        raise AssertionError("%s: deadlocked after %d rounds" % (what, rounds))
    for rep in r.replicas:
        rep.check_invariants(quiesce=True)
    if [rep.dispatch_failures for rep in r.replicas] != [0, 4]:
        raise AssertionError("%s: dispatch failures %s, not the 4 injected "
                             "into r1" % (what, [rep.dispatch_failures
                                                 for rep in r.replicas]))
    dropped = set(r.shed_rids) | set(r.expired_rids)
    if any(prio[rid] > 0 for rid in dropped):
        raise AssertionError("%s: dropped a request above priority 0" % what)
    done = [rid for rid in prio if rid not in dropped]
    if any(results.get(rid) is None for rid in done):
        raise AssertionError("%s: a request neither completed nor dropped"
                             % what)
    attain = {p: sum(1 for rid in prio if prio[rid] == p
                     and rid not in dropped)
              / float(sum(1 for rid in prio if prio[rid] == p))
              for p in (0, 1, 2)}
    if attain[1] < 1.0 or attain[2] < 1.0:
        raise AssertionError("%s: attainment %s" % (what, attain))
    if r._alive != [True, True] or r._brk_state != ["closed", "closed"]:
        raise AssertionError("%s: r1 did not come back: alive %s, breakers "
                             "%s" % (what, r._alive, r._brk_state))
    gap = teacher_gap(torch, tf, params, cfg, [results[rid] for rid in done],
                      [len(prompt_of[rid]) for rid in done])
    if not gap <= TOL_TEACHER:
        raise AssertionError("%s: teacher-forced gap %.4f" % (what, gap))
    log("%s: %d rounds, %.2f s, %d completed, %d shed, %d expired, "
        "attainment p0 %.3f p1 %.3f p2 %.3f, breaker %s, %s launches %d, "
        "teacher-forced max gap %.4f (tol %g)"
        % (what, rounds, seconds, len(done), len(r.shed_rids),
           len(r.expired_rids), attain[0], attain[1], attain[2],
           r.breaker_events, kernel, kernels.launches[kernel], gap,
           TOL_TEACHER))
    return {"launches": collections.Counter(kernels.launches)}


def rollout_jobs(cfg):
    rng = np.random.RandomState(ROLLOUT["seed"])
    return [(list(rng.randint(1, cfg.vocab_size,
                              rng.randint(ROLLOUT["prompt_lo"],
                                          ROLLOUT["prompt_hi"] + 1))),
             int(rng.randint(ROLLOUT["new_lo"], ROLLOUT["new_hi"] + 1)))
            for _ in range(ROLLOUT["requests"])]


def canary_check(torch, tf, ro, params, cfg, what):
    """Print each canary beside generate()'s; a divergence passes only at a
    token whose teacher-forced gap (under the swapped-in weights) is
    within TOL_TEACHER, and the line says so. Returns the diverged
    canaries' gaps."""
    gaps = []
    for name, toks, expected in ro.get("canaries", []):
        line = "%s: canary on %s %s, generate() %s" % (what, name, toks[3:],
                                                      expected[3:])
        if toks != expected:
            n, gap = first_split(torch, tf, params, cfg, toks, expected, 3)
            gaps.append(gap)
            line += ("; DIVERGES at token %d with teacher-forced gap %.4f "
                     "(tol %g): a near tie between prefill_chunk + the "
                     "decode kernels and generate()'s flash path"
                     % (n - 3, gap, TOL_TEACHER))
            if not gap <= TOL_TEACHER:
                raise AssertionError(line)
        log(line)
    return gaps


def rollout_fleet(rt, params, cfg, device):
    return rt.ReplicaRouter.build(params, cfg, n_replicas=2,
                                  max_batch=ROLLOUT["lanes"], paged=True,
                                  block_size=16, device=device)


def rollout_drive(torch, r, jobs, start):
    """Submit the jobs, take ROLLOUT["warm"] fleet steps, ``start()`` the
    rollout, record each live stream's synced prefix, and drive to the
    end."""
    order = [r.submit(p, n) for p, n in jobs]
    results = {}
    for _ in range(ROLLOUT["warm"]):
        results.update(r.step())
    synced = {}
    for (i, rep_rid), (rid, _) in r._live.items():
        req = next(q for q in r.replicas[i]._slots
                   if q is not None and q.rid == rep_rid)
        synced[rid] = list(req.tokens)
    start()
    rounds = 0
    while (r._queue or r._live or r.rollout_phase in ("draining", "canary")) \
            and rounds < ROLLOUT["rounds"]:
        results.update(r.step())
        rounds += 1
    if r._queue or r._live:
        raise AssertionError("rollout: stalled after %d rounds" % rounds)
    return order, results, synced, rounds


def rollout_phase(torch, tf, rt, ck, kernels, params, cfg, device, root):
    """Checkpoint a second seed's weights, verify its lineage, roll a
    2-replica paged fleet to it mid-traffic (done, both fingerprints the
    manifest's, nothing dropped, synced prefixes kept), roll again with a
    canary that lies (rolled back, prior fingerprints, nothing dropped),
    and refuse a checkpoint with one flipped byte."""
    import warnings
    from mxnet_tpu_torch.observability import chaos
    new = tf.init_params(cfg, seed=1, device=device)
    ckdir = os.path.join(root, "rollout-ckpt")
    t0 = time.perf_counter()
    ck.save_checkpoint(ckdir, cfg, new, step=1)
    save_s = time.perf_counter() - t0
    chain = ck.verify_lineage(ckdir, deep=True)
    if [e["status"] for e in chain] != ["verified"]:
        raise AssertionError("rollout checkpoint lineage: %s" % chain)
    with open(os.path.join(ckdir, "manifest.json")) as f:
        want_fp = json.load(f)["param_fingerprint"]
    jobs = rollout_jobs(cfg)
    kernels.launches.clear()
    r = rollout_fleet(rt, params, cfg, device)
    old_fp = r.replicas[0].weight_fingerprint
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        order, results, synced, rounds = rollout_drive(
            torch, r, jobs, lambda: r.start_rollout(new, manifest=ckdir))
    what = "rollout"
    ro = r._rollout
    gaps = canary_check(torch, tf, ro, new, cfg, what)
    fps = [rep.weight_fingerprint for rep in r.replicas]
    if r.rollout_phase != "done":
        if not (gaps and ro.get("reason", "").startswith("canary diverged")):
            raise AssertionError("rollout ended %s: %s" % (r.rollout_phase,
                                                          ro.get("reason")))
        log("rollout: rolled back on a near-tie canary under verified "
            "weights (recorded in ROADMAP section C)")
    elif fps != [want_fp] * 2 or any("router:" in str(w.message)
                                     for w in warned):
        raise AssertionError("rollout: fingerprints %s, manifest %s, "
                             "warnings %s" % (fps, want_fp,
                                              [str(w.message)
                                               for w in warned]))
    restarted = check_rollout_streams(torch, tf, params, new, cfg, jobs,
                                      order, results, synced, what)
    for rep in r.replicas:
        rep.check_invariants(quiesce=True)
        check_clean(rep, what)
    log("rollout: save %.3f s, lineage %s, %d rounds, phases %s, "
        "fingerprints %s -> %s (manifest %s), %d streams kept their synced "
        "prefix, %d restarted from their prompt under the new weights"
        % (save_s, chain[0]["status"], rounds,
           [e[0] for e in r.rollout_events], old_fp, fps, want_fp,
           len(synced) - restarted, restarted))
    launches = collections.Counter(kernels.launches)
    # a canary that lies: rolled back, prior fingerprints, nothing dropped
    r = rollout_fleet(rt, params, cfg, device)
    kernels.launches.clear()
    chaos.install("router.rollout:error:at=1")
    try:
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            order, results, synced, rounds = rollout_drive(
                torch, r, jobs, lambda: r.start_rollout(new, manifest=ckdir))
    finally:
        chaos.reset()
    launches.update(kernels.launches)
    what = "rollout with a lying canary"
    canary_check(torch, tf, r._rollout, new, cfg, what)
    fps = [rep.weight_fingerprint for rep in r.replicas]
    if r.rollout_phase != "rolled_back" or fps != [old_fp] * 2 \
            or not any("rolled back" in str(w.message) for w in warned):
        raise AssertionError("%s: %s, fingerprints %s" % (
            what, r.rollout_phase, fps))
    check_rollout_streams(torch, tf, params, new, cfg, jobs, order, results,
                          synced, what)
    for rep in r.replicas:
        rep.check_invariants(quiesce=True)
        check_clean(rep, what)
    log("%s: %d rounds, events %s, fingerprints back at %s"
        % (what, rounds, [e[0] for e in r.rollout_events], fps))
    # one flipped bit in the retained manifest's fingerprint
    r = rollout_fleet(rt, params, cfg, device)
    name = chain[0]["name"]
    path = os.path.join(ckdir, name)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    off = data.index(b'"param_fingerprint": "') + len('"param_fingerprint": "')
    data[off] ^= 0x01
    with open(path, "wb") as f:
        f.write(bytes(data))
    try:
        r.start_rollout(new, manifest=ckdir)
    except ck.CheckpointCorrupt as exc:
        log("rollout of a checkpoint with one flipped byte refused: %s" % exc)
    else:
        raise AssertionError("a corrupt checkpoint rolled out")
    if r._rollout is not None or any(rep.weight_fingerprint != old_fp
                                     for rep in r.replicas):
        raise AssertionError("the refused rollout touched the fleet")
    return {"launches": launches, "save_s": save_s}


def check_rollout_streams(torch, tf, params, new, cfg, jobs, order, results,
                          synced, what):
    """Nothing dropped; a stream live at the rollout's start keeps its
    synced prefix, unless the router restarted it from its prompt (no
    replica was left on its weights), when its whole generated part must
    pass the teacher-forced check under the new weights. Every other
    stream passes it under whichever weights served it. Returns the
    restarted count."""
    restarted = 0
    for rid, (prompt, n_new) in zip(order, jobs):
        toks = results.get(rid)
        if toks is None or len(toks) != len(prompt) + n_new \
                or toks[:len(prompt)] != prompt:
            raise AssertionError("%s: request %d dropped or malformed"
                                 % (what, rid))
        pre = synced.get(rid)
        if pre is not None and toks[:len(pre)] == pre:
            continue
        gaps = [teacher_gap(torch, tf, w, cfg, [toks], [len(prompt)])
                for w in (params, new)]
        if pre is not None:
            restarted += 1
            if not gaps[1] <= TOL_TEACHER:
                raise AssertionError(
                    "%s: request %d lost its synced prefix and is not the "
                    "new weights' stream (gap %.4f)" % (what, rid, gaps[1]))
        elif not min(gaps) <= TOL_TEACHER:
            raise AssertionError("%s: request %d matches neither weights "
                                 "(gaps %s)" % (what, rid, gaps))
    return restarted


def train_resume(torch, tf, ck, kernels, device, root):
    """train_lm_bench.py's flagship cut to 2 layers, bf16: 2 steps, an
    async save, the next step at once, then more; resume_from_latest into
    a fresh model and momentum takes the same steps. The restored state
    must equal the snapshot bitwise, and the resumed run the
    uninterrupted one (bitwise, else within the train phase's gradient
    gate)."""
    cfg = tf.TransformerConfig(dtype=torch.bfloat16, **RESUME_CFG)
    step = tf.make_train_step(cfg, lr=RESUME["lr"])
    gen = torch.Generator(device="cpu").manual_seed(11)
    batches = [torch.randint(0, cfg.vocab_size,
                             (RESUME["batch"], cfg.max_len), generator=gen)
               .to(device) for _ in range(RESUME["before"]
                                          + RESUME["after"])]
    params = tf.init_params(cfg, seed=0, device=device)
    mom = tf.init_momentum(params)
    ckdir = os.path.join(root, "train-ckpt")
    kernels.launches.clear()
    for b in batches[:RESUME["before"]]:
        step(params, mom, b)
    snap_p = {n: p.clone() for n, p in params.named_parameters()}
    snap_m = {n: m.clone() for n, m in mom.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save_checkpoint(ckdir, cfg, params, momentum=mom,
                       step=RESUME["before"], async_save=True)
    call_s = time.perf_counter() - t0
    for b in batches[RESUME["before"]:]:
        step(params, mom, b)              # the first one at once
    t0 = time.perf_counter()
    ck.wait_for_pending_save()
    wait_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(ckdir, f))
                 for f in os.listdir(ckdir))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg2, rp, rm, s = ck.resume_from_latest(ckdir, expect_cfg=cfg,
                                            device=device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if s != RESUME["before"]:
        raise AssertionError("resumed at step %d" % s)
    for name, p in rp.named_parameters():
        if not torch.equal(p, snap_p[name]) \
                or not torch.equal(rm[name], snap_m[name]):
            raise AssertionError("the restored %s is not the snapshot's "
                                 "(the step after the async save reached "
                                 "it?)" % name)
    for b in batches[RESUME["before"]:]:
        step(rp, rm, b)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(p, dict(params.named_parameters())[n])
                  and torch.equal(rm[n], mom[n])
                  for n, p in rp.named_parameters())
    worst = 0.0
    if not bitwise:
        for n, p in rp.named_parameters():
            ref = dict(params.named_parameters())[n].float()
            upd = (ref - snap_p[n].float()).norm()
            worst = max(worst, float((p.float() - ref).norm()
                                     / max(float(upd), 1e-30)))
        if not worst <= 1e-3:
            raise AssertionError("the resumed run's updates differ from "
                                 "the uninterrupted run's by a relative L2 "
                                 "of %.2e" % worst)
    n_steps = RESUME["before"] + 2 * RESUME["after"]
    check_only(kernels, {k: cfg.n_layers * n_steps for k in TRAIN_KERNELS},
               "train resume")
    log("train resume (%d layers, bf16, batch %d x %d): save call %.3f s on "
        "the host, the write behind it %.3f s more, %d bytes; "
        "resume_from_latest %.3f s; restored state bitwise the snapshot's; "
        "resumed run %s" % (cfg.n_layers, RESUME["batch"], cfg.max_len,
                            call_s, wait_s, nbytes, load_s,
                            "bitwise the uninterrupted run's" if bitwise
                            else "within %.2e relative L2 of the "
                            "uninterrupted run's updates" % worst))
    return {"launches": collections.Counter(kernels.launches),
            "save_s": call_s + wait_s, "load_s": load_s, "bytes": nbytes,
            "bitwise": bitwise}


def durable_phase(torch, tf, sv, kernels, params, cfg, device):
    """Durable serving and training checkpoints on the card (see DURABLE,
    OVERLOAD, ROLLOUT, RESUME): the journal A/B, kill -9 and recover
    (greedy with spec_k 2, and sampled), the OOM shrink, the router's
    replica death (paged and dense replicas), the checkpointed rolling
    rollout, and the training resume. Returns every kernel's launches
    over the phase."""
    import shutil
    from mxnet_tpu_torch.models import checkpoint as ck
    from mxnet_tpu_torch.models import router as rt
    t_phase = time.perf_counter()
    root = durable_root()
    launches = collections.Counter()
    try:
        dcfg = durable_cfg(torch, tf)
        dparams = tf.init_params(dcfg, seed=0, device=device)
        launches.update(journal_ab(torch, sv, kernels, dparams, dcfg, device,
                                   root)["launches"])
        for mode in ("greedy", "sampled"):
            launches.update(crash_recover(torch, tf, sv, kernels, dparams,
                                          dcfg, device, root, mode)
                            ["launches"])
        del dparams
        launches.update(oom_shrink(torch, tf, sv, kernels, params, cfg,
                                   device)["launches"])
        for paged in (True, False):
            launches.update(overload(torch, tf, rt, kernels, params, cfg,
                                     device, paged)["launches"])
        launches.update(rollout_phase(torch, tf, rt, ck, kernels, params, cfg,
                                      device, root)["launches"])
        torch.cuda.empty_cache()
        launches.update(train_resume(torch, tf, ck, kernels, device, root)
                        ["launches"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name in ("paged_decode", "flash_decode", "flash_fwd", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        if not launches[name]:
            raise AssertionError("durable phase: %s never launched" % name)
    log("durable phase: %.1f s; launches %s"
        % (time.perf_counter() - t_phase, dict(launches)))
    return launches


# ------------------------------------------------------------ training ---

def train_tokens(torch, cfg, device):
    """The fixed batch of train_lm_bench.py: seeded tokens in [1, vocab)."""
    rng = np.random.RandomState(0)
    return torch.from_numpy(rng.randint(1, cfg.vocab_size,
                                        (TRAIN["batch"], cfg.max_len))).to(
        device)


def loss_and_grads(torch, tf, params, tokens, cfg):
    ps = list(params.parameters())
    for p in ps:
        p.requires_grad_(True)
    try:
        loss = tf.loss_fn(params, tokens, cfg)
        grads = torch.autograd.grad(loss, ps)
    finally:
        for p in ps:
            p.requires_grad_(False)
    return float(loss.detach()), grads


def check_launches(kernels, before, n, what):
    for name in TRAIN_KERNELS:
        got = kernels.launches[name] - before.get(name, 0)
        if got != n:
            raise AssertionError("%s launched %s %d times, not %d"
                                 % (what, name, got, n))


def train_equivalence(torch, tf, kernels, device):
    """One fp32 step at full width, TF32 off: the loss and every
    parameter's gradient through the flash kernels against the dense
    attention route."""
    cfg = tf.TransformerConfig(dtype=torch.float32, **TRAIN_CFG)
    dense = dataclasses.replace(cfg, use_flash_kernel=False)
    params = tf.init_params(cfg, seed=0, device=device)
    tokens = train_tokens(torch, cfg, device)
    before = dict(kernels.launches)
    loss_k, grads_k = loss_and_grads(torch, tf, params, tokens, cfg)
    check_launches(kernels, before, cfg.n_layers, "the fp32 kernel step")
    loss_d, grads_d = loss_and_grads(torch, tf, params, tokens, dense)
    worst, worst_name = 0.0, None
    for (name, _), gk, gd in zip(params.named_parameters(), grads_k, grads_d):
        rel = float((gk - gd).norm() / gd.norm())
        if not rel <= worst:
            worst, worst_name = rel, name
    log("train fp32 step, kernels vs dense attention: loss %.6f vs %.6f "
        "(|diff| %.3g, tol 1e-4), worst gradient relative L2 %.3g at %s "
        "(tol 1e-3)" % (loss_k, loss_d, abs(loss_k - loss_d), worst,
                        worst_name))
    if not abs(loss_k - loss_d) <= 1e-4 or not worst <= 1e-3:
        raise AssertionError("the flash kernels' training step disagrees "
                             "with dense attention")


def train(torch, tf, kernels, device):
    """TRAIN["steps"] bf16 steps on one fixed batch through
    make_train_step; each step must launch each flash kernel once per
    layer, and the loss must stay finite and fall."""
    cfg = tf.TransformerConfig(dtype=torch.bfloat16, **TRAIN_CFG)
    params = tf.init_params(cfg, seed=0, device=device)
    n_params = sum(p.numel() for p in params.parameters())
    mom = tf.init_momentum(params)
    step = tf.make_train_step(cfg, lr=TRAIN["lr"])
    tokens = train_tokens(torch, cfg, device)
    losses, step_s = [], []
    kernels.launches.clear()
    for _ in range(TRAIN["steps"]):
        before = dict(kernels.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, mom, loss = step(params, mom, tokens)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
        check_launches(kernels, before, cfg.n_layers, "a bf16 train step")
    launches = {n: kernels.launches[n] for n in TRAIN_KERNELS}
    step_ms = 1e3 * float(np.mean(step_s[1:]))
    n_tok = tokens.numel()
    mfu = 6.0 * n_params * n_tok / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    log("train bf16: %d params, losses %s" % (
        n_params, " ".join("%.4f" % x for x in losses)))
    log("train bf16: step %.3f ms (mean of steps 2-%d; first %.3f ms), "
        "%.0f tokens/s, MFU %.4f (6 N FLOPs per token over 989 TFLOP/s), "
        "launches %s" % (step_ms, len(step_s), 1e3 * step_s[0],
                         n_tok / (step_ms / 1e3), mfu, launches))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("training loss is not finite and falling")
    return {"launches": launches, "step_ms": step_ms, "params": params,
            "mom": mom, "step": step, "tokens": tokens}


# ------------------------------------------------------ parallel slice ---

def mesh_tokens(torch, cfg, b, t, device):
    rng = np.random.RandomState(3)
    return torch.from_numpy(rng.randint(1, cfg.vocab_size, (b, t))).to(device)


def mesh_forward(torch, tf, parallel, kernels, device):
    """The parallel slice's main path: the training flagship (MESH_CFG)
    under parallel.make_mesh({"dp": 1, "sp": 1}) on a world of one, at
    MESH_RUNS. In fp32 the mesh loss (ring attention, one carry launch per
    layer) must be within 1e-4 of the no-mesh loss (the flash forward); in
    bf16 the forward must launch the carry kernel once per layer and
    nothing else, and the loss must be finite. Returns the bf16 model, the
    mesh and the first run's carry launches and forward ms."""
    mesh = parallel.make_mesh({"dp": 1, "sp": 1})
    out = {"mesh": mesh}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = tf.TransformerConfig(dtype=dtype, **MESH_CFG)
        params = tf.shard_params(tf.init_params(cfg, seed=0, device=device),
                                 cfg, mesh)
        for b, t in MESH_RUNS:
            tokens = mesh_tokens(torch, cfg, b, t, device)
            what = "mesh %s %d x %d" % (dtype_name(dtype), b, t)
            with torch.no_grad():
                kernels.launches.clear()
                loss = float(tf.loss_fn(params, tokens, cfg, mesh))
                check_only(kernels, {"flash_carry": cfg.n_layers},
                           what + " loss")
                if dtype == torch.float32:
                    plain = float(tf.loss_fn(params, tokens, cfg))
                    log("%s: loss %.6f, no-mesh loss (flash_fwd) %.6f, |diff| "
                        "%.3g (tol 1e-4)" % (what, loss, plain,
                                             abs(loss - plain)))
                    if not abs(loss - plain) <= 1e-4:
                        raise AssertionError("the mesh loss disagrees with "
                                             "the no-mesh loss")
                    continue
                if not np.isfinite(loss):
                    raise AssertionError(what + ": the loss is not finite")
                kernels.launches.clear()
                logits = tf.forward(params, tokens, cfg, mesh)
                torch.cuda.synchronize()
                launches = kernels.launches["flash_carry"]
                check_only(kernels, {"flash_carry": cfg.n_layers},
                           what + " forward")
                if logits.shape != (b, t, cfg.vocab_size) \
                        or not bool(torch.isfinite(logits).all()):
                    raise AssertionError(what + ": malformed logits")
                del logits
                times = []
                for _ in range(4):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    tf.forward(params, tokens, cfg, mesh)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                ms = 1e3 * float(np.mean(times[1:]))
                log("%s: loss %.4f, forward %.3f ms (mean of calls 2-4), "
                    "%.0f tokens/s, flash_carry launches %d per forward"
                    % (what, loss, ms, b * t / (ms / 1e3), launches))
                out.setdefault("launches", launches)
                out.setdefault("forward_ms", ms)
        if dtype == torch.bfloat16:
            out.update(params=params, cfg=cfg)
        else:
            del params
            torch.cuda.empty_cache()
    return out


def check_sp_decode(torch, ring, kernels, mesh, device):
    """sp_flash_decode at world one on the serving model's cache (8 lanes
    x 8 KV heads x 4096 x 64, bf16, lengths 0 to 4096): the default route
    launches the flash-decode kernel once and agrees with the dense route
    at TOL; both routes timed. Returns (launches, kernel ms, dense ms)."""
    q, k, v, lengths = flash_case(torch, device, torch.bfloat16, 1, seed=24)
    kernels.launches.clear()
    got = ring.sp_flash_decode(q, k, v, lengths, mesh)
    torch.cuda.synchronize()
    launches = kernels.launches["flash_decode"]
    check_only(kernels, {"flash_decode": 1}, "sp_flash_decode")
    want = ring.sp_flash_decode(q, k, v, lengths, mesh, use_pallas=False)
    compare(got, want, "bfloat16", "sp_flash_decode flash_decode route vs "
            "dense route")
    ms = time_ms(lambda: ring.sp_flash_decode(q, k, v, lengths, mesh), 20)
    dense = time_ms(lambda: ring.sp_flash_decode(q, k, v, lengths, mesh,
                                                 use_pallas=False), 20)
    log("sp_flash_decode sp=1, 8 x 4096: flash_decode route %.4f ms, dense "
        "route %.4f ms" % (ms, dense))
    return launches, ms, dense


# ------------------------------------------------------------ timings ---

def host_us(torch, fn, calls=100):
    """Host µs per call of ``fn``: time.perf_counter around ``calls``
    calls before the sync that waits for their kernels (a warm call
    first). What a host-bound decode step pays per wrapper call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    spent = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * spent / calls


def time_paged(torch, F, kernels, device):
    q, pool, tables, pos = full_pool_case(torch, device, torch.bfloat16,
                                          seed=11)
    lanes, _, h, d = q.shape
    bs, kvh = pool["k"].shape[1:3]
    splits, chunk = kernels.paged_decode_splits(lanes, kvh, tables.shape[1],
                                                bs)

    def run():
        return kernels.paged_attention(q, pool, tables, pos)
    ms, dev, host = time_ms(run, 20), device_ms(torch, run), host_us(torch,
                                                                     run)
    plain = time_ms(
        lambda: kernels.paged_attention_reference(q, pool, tables, pos), 5)
    # yardstick: SDPA on the gathered dense K/V (gather not timed)
    idx = tables.long()
    t = tables.shape[1] * bs
    kd, vd = (pool[n][idx].reshape(lanes, t, h, d).transpose(1, 2)
              for n in ("k", "v"))
    mask = (torch.arange(t, device=device)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    qd = q.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)
    lib, lib_dev = time_ms(sdpa, 20), device_ms(torch, sdpa)
    nbytes, flops = paged_work(q, pool, tables, pos)
    return {"ms": ms, "device_ms": dev, "plain_ms": plain, "library_ms": lib,
            "library_device_ms": lib_dev, "host_us": host,
            "splits": splits, "chunk": chunk,
            "bound": bound_ms(nbytes, flops, "bfloat16")}


def time_paged_int8(torch, F, kernels, device):
    """The int8 mode on the same full pool (seed 11 rows, quantised), q
    in bf16. No single PyTorch call computes int8 x int8 attention, so
    it has no library time."""
    q, pool, tables, pos = full_pool_case(torch, device, torch.bfloat16,
                                          seed=11, int8=True)
    lanes, bs, kvh = q.shape[0], pool["k"].shape[1], pool["k"].shape[2]
    splits, chunk = kernels.paged_decode_splits(lanes, kvh, tables.shape[1],
                                                bs)

    def run():
        return kernels.paged_attention(q, pool, tables, pos)
    ms, dev, host = time_ms(run, 20), device_ms(torch, run), host_us(torch,
                                                                     run)
    plain = time_ms(
        lambda: kernels.paged_attention_reference(q, pool, tables, pos), 5)
    nbytes, ops = paged_work(q, pool, tables, pos)
    return {"ms": ms, "device_ms": dev, "plain_ms": plain,
            "library_ms": None, "library_device_ms": None, "host_us": host,
            "splits": splits, "chunk": chunk,
            "bound": bound_ms(nbytes, ops, "int8")}


def time_flash(torch, F, kernels, device):
    q, k, v, lengths = flash_case(torch, device, torch.bfloat16, 1, seed=21)
    b, h, d = q.shape
    t, kvh = k.shape[1:3]
    splits, chunk = kernels.flash_decode_splits(b, kvh, t)

    def run():
        return kernels.flash_decode_with_lse(q, k, v, lengths)
    ms, dev, host = time_ms(run, 20), device_ms(torch, run), host_us(torch,
                                                                     run)
    plain = time_ms(
        lambda: kernels.dense_decode_with_lse(q, k, v, lengths), 5)
    kd, vd = k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(t, device=device)[None, :]
            < lengths.long()[:, None])[:, None, None, :]
    qd = q[:, :, None]

    def sdpa():
        return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)
    lib, lib_dev = time_ms(sdpa, 20), device_ms(torch, sdpa)
    nbytes, flops = flash_work(q, k, lengths)
    return {"ms": ms, "device_ms": dev, "plain_ms": plain, "library_ms": lib,
            "library_device_ms": lib_dev, "host_us": host,
            "splits": splits, "chunk": chunk,
            "bound": bound_ms(nbytes, flops, "bfloat16")}


def train_flash_work(bh, t, d, item, kernel):
    """(bytes, flops) one flash kernel's function needs at [bh, t, d],
    causal: each input read once and each output written once; the
    products the function needs, half of the full squares for the causal
    mask (forward: QK^T and PV; dQ: S, dP and dS K; dK/dV: S, dP, P^T dO
    and dS^T Q)."""
    mat = bh * t * d * item
    stat = 4 * bh * t
    nbytes, products = {
        "flash_fwd": (4 * mat + stat, 2),
        "flash_bwd_dq": (5 * mat + 2 * stat, 3),
        "flash_bwd_dkv": (6 * mat + 2 * stat, 4)}[kernel]
    return nbytes, 2 * products * bh * t * t * d / 2


def time_flash_attention(torch, F, kernels, device, b=8, h=8, t=1024,
                         d=128):
    """The three training kernels at the training shape, bf16, causal:
    {kernel: (ms, plain ms, library ms, (bound ms, bound by))}. The
    plain backward and the library backward compute dq, dk and dv
    together, so both backward rows carry the same plain and library
    times."""
    q, k, v, do = flash_inputs(torch, device, torch.bfloat16, b * h, t, t, d,
                               seed=41)
    o, lse = kernels.flash_attention_with_lse(q, k, v, True)
    delta = (do.float() * o.float()).sum(dim=-1)
    ms = {"flash_fwd": time_ms(
              lambda: kernels.flash_attention_with_lse(q, k, v, True), 10),
          "flash_bwd_dq": time_ms(
              lambda: kernels.flash_bwd_dq(q, k, v, do, lse, delta, True), 10),
          "flash_bwd_dkv": time_ms(
              lambda: kernels.flash_bwd_dkv(q, k, v, do, lse, delta, True),
              10)}
    plain_fwd = time_ms(
        lambda: kernels.dense_attention_with_lse(q, k, v, True), 5)
    plain_bwd = time_ms(
        lambda: kernels.dense_attention_bwd(q, k, v, o, lse, do, True), 5)
    q4, k4, v4 = (x.reshape(b, h, t, d) for x in (q, k, v))
    with torch.no_grad():
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), 10)
    lib_bwd, lib_bwd_dev = sdpa_bwd_ms(torch, F, q, k, v, do, b, h)
    log_bwd_pair(torch, kernels, "", ms["flash_bwd_dq"] + ms["flash_bwd_dkv"],
                 lib_bwd, lib_bwd_dev, (q, k, v, do, lse, delta))
    rows = {}
    for name in TRAIN_KERNELS:
        fwd = name == "flash_fwd"
        nbytes, flops = train_flash_work(b * h, t, d, 2, name)
        rows[name] = (ms[name], plain_fwd if fwd else plain_bwd,
                      lib_fwd if fwd else lib_bwd,
                      bound_ms(nbytes, flops, "bfloat16"))
    return rows


# ------------------------------------------------------------ profile ---

PROFILE_STEPS = 16
PROFILE_TOP = 6
SWEEP_LANES = (8, 32, 128)
SWEEP_LENGTHS = (256, 4096)


# kinds of kernel in a train step's profile, by a word of the kernel's name
TRAIN_KINDS = (("flash kernels", ("flash_",)),
               ("GEMM", ("nvjet", "gemm", "cutlass", "xmma")),
               ("index / embedding", ("index",)),
               ("reduction", ("reduce",)),
               ("elementwise and copies", ("elementwise", "copy")))


def profile_steps(torch, what, step, steps=PROFILE_STEPS, top=PROFILE_TOP,
                  kinds=(), expect=(), by_op=0):
    """Run ``step`` ``steps`` times untraced, then as many times under
    torch.profiler (CUDA activity only), and print the host ms per step of
    both runs, the device ms per step of the traced one (the sum of the
    kernels' own times), its idle share, its ``top`` costliest kernels
    and, with ``kinds``, the device ms per step of each kind of kernel
    (the first kind whose word a kernel's name holds; "other" else).
    Fails unless each word of ``expect`` is in some kernel's name, and
    logs the device ms per step of the kernels each word names. With
    ``by_op``, a third run of ``steps`` traces the host too and logs the
    ``by_op`` operators whose own kernels take the most device time (an
    operator's kernels are those it launches itself, so a backward
    kernel counts under the operator the backward formula calls)."""
    from torch.profiler import ProfilerActivity, profile

    def host_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / steps

    untraced = host_ms()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad_trace(torch)
        traced = host_ms()
        pad_trace(torch)
    # kernel rows only: an operator's row repeats its kernels' time
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and MARK_KERNEL not in e.key]
    if not rows:
        raise AssertionError("the profiler saw no kernel in " + what)
    for word in expect:
        if not any(word in e.key for e in rows):
            raise AssertionError("no %s kernel ran in %s" % (word, what))
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    log("%s: host %.3f ms per step (%.3f traced), device %.3f ms per step, "
        "idle share %.3f" % (what, untraced, traced, busy, 1 - busy / traced))
    if expect:
        log("  expected kernels, device ms per step: " + ", ".join(
            "%s %.4f" % (word, sum(e.self_device_time_total for e in rows
                                   if word in e.key) / 1e3 / steps)
            for word in expect))
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in rows[:top]:
        log("  %8.1f us/step %5d calls  %s"
            % (e.self_device_time_total / steps, e.count, e.key[:80]))
    if kinds:
        by_kind = collections.Counter()
        for e in rows:
            kind = next((k for k, words in kinds
                         if any(w in e.key for w in words)), "other")
            by_kind[kind] += e.self_device_time_total / 1e3 / steps
        log("  by kind, ms per step: " + ", ".join(
            "%s %.3f" % kv for kv in by_kind.most_common()))
    if by_op:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pad_trace(torch)
            host_ms()
            pad_trace(torch)
        ops = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.self_device_time_total > 0]
        ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
        log("  by operator (a host-traced run), ms per step and calls per "
            "step: " + ", ".join(
                "%s %.3f (%d)" % (e.key, e.self_device_time_total / 1e3
                                  / steps, e.count // steps)
                for e in ops[:by_op]))


def profile_serve(torch, sv, params, cfg, device, what, expect=()):
    """Where a serve step's time goes: the serve job mix on 16 lanes of
    32, warmed up by two steps; ``expect`` as ``profile_steps``."""
    srv = batcher(sv, params, cfg, device)
    for prompt, n_new in serve_jobs(cfg, 2 * PROFILE_STEPS + 4):
        srv.admit(prompt, n_new)
    for _ in range(2):
        srv.step()
    profile_steps(torch, what, srv.step, expect=expect)
    check_clean(srv, what)


def profile_decode(torch, tf, sv, params, cfg, device):
    """Where a decode step's time goes: the serve job mix on 16 lanes of
    32, then generate()'s decode step at batch 8 after a 256-token
    prefill, each warmed up by two steps."""
    profile_serve(torch, sv, params, cfg, device,
                  "serve step, 16 live lanes of 32", expect=PAGED_SPLIT)

    b, t_p = GENERATE["batch"], GENERATE["prompt"]
    prompt = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (b, t_p))).to(device)
    state = {"cache": tf.init_cache(cfg, b, device), "pos": t_p}
    with torch.no_grad():
        logits, state["cache"] = tf.prefill(params, state["cache"], prompt,
                                            cfg)
        state["tok"] = torch.argmax(logits, -1)

        def decode():
            out, state["cache"] = tf.decode_step(
                params, state["cache"], state["tok"], state["pos"], cfg)
            state["tok"] = torch.argmax(out, -1)
            state["pos"] += 1

        for _ in range(2):
            decode()
        profile_steps(torch, "generate decode step, batch 8", decode,
                      expect=FLASH_SPLIT)


# -------------------------------------------------------------- sweep ---

def sweep(torch, F, kernels, device, kvh=8, d=64, bs=16):
    """The decode kernels and the yardstick with every lane at one
    length, in bfloat16 (and the paged kernel on the same rows quantised
    to int8), over lane counts and lengths, by CUDA events and by device
    time, with each kernel's GB/s of live bytes (the K/V rows its lanes
    attend, over its device time). The time follows the total bytes
    where bandwidth limits a kernel, and the per-lane length at a fixed
    lane count where one CTA's walk along its lane does."""
    from mxnet_tpu_torch.kernels.common import kv_quant
    gen = torch.Generator(device=device).manual_seed(3)

    def rand(*shape):
        return randn(torch, shape, gen, device, torch.bfloat16)

    for lanes in SWEEP_LANES:
        for length in SWEEP_LENGTHS:
            q = rand(lanes, kvh, d)
            k, v = rand(lanes, length, kvh, d), rand(lanes, length, kvh, d)
            lens = torch.full((lanes,), length, dtype=torch.int32,
                              device=device)
            kd, vd = k.transpose(1, 2), v.transpose(1, 2)
            nbl = length // bs
            pool = {n: rand(lanes * nbl + 1, bs, kvh, d) for n in "kv"}
            tables = (1 + torch.randperm(lanes * nbl, generator=gen,
                                         device=device)).reshape(lanes, nbl)
            tables = tables.to(torch.int32)
            pos = torch.full((lanes,), length - 1, dtype=torch.int32,
                             device=device)
            qp = q[:, None]
            pool8 = {}
            for n in "kv":
                pool8[n], pool8[n + "s"] = kv_quant(pool[n])
            calls = {
                "flash_decode": lambda: kernels.flash_decode_with_lse(
                    q, k, v, lens),
                "sdpa": lambda: F.scaled_dot_product_attention(
                    q[:, :, None], kd, vd),
                "paged_decode": lambda: kernels.paged_attention(
                    qp, pool, tables, pos),
                "paged_decode_int8": lambda: kernels.paged_attention(
                    qp, pool8, tables, pos)}
            ms = {name: time_ms(fn, 20) for name, fn in calls.items()}
            dev = {name: sum(parts.values()) for name, parts in
                   device_ms_each(torch, calls).items()}
            del k, v, kd, vd, pool, pool8, calls
            cells = lanes * length * kvh
            live = {"flash_decode": 2 * cells * d * 2, "sdpa": 2 * cells * d
                    * 2, "paged_decode": 2 * cells * d * 2,
                    "paged_decode_int8": cells * (2 * d + 8)}
            bound, _ = bound_ms(live["paged_decode"], 4 * cells * d,
                                "bfloat16")
            bound8, _ = bound_ms(live["paged_decode_int8"], 4 * cells * d,
                                 "int8")
            log("sweep %3d lanes x %4d: flash_decode %.4f ms, paged_decode "
                "%.4f ms (bound %.4f), paged_decode_int8 %.4f ms (bound "
                "%.4f), sdpa %.4f ms"
                % (lanes, length, ms["flash_decode"], ms["paged_decode"],
                   bound, ms["paged_decode_int8"], bound8, ms["sdpa"]))
            log("sweep %3d lanes x %4d, device ms (GB/s of live bytes): %s"
                % (lanes, length, ", ".join(
                    "%s %.4f (%.0f)" % (name, dev[name],
                                        live[name] / dev[name] / 1e6)
                    for name in ("flash_decode", "paged_decode",
                                 "paged_decode_int8", "sdpa"))))


def train_sweep(torch, F, kernels, device, tokens=8192, h=8, d=128):
    """The flash forward, forward + backward (delta and both backward
    kernels) and the yardstick in bf16, causal, over TRAIN_SWEEP at
    ``tokens`` tokens (batch = tokens / T): whether the H100 needs a
    sequence-length crossover between the kernels and dense attention.
    The forward + backward bound counts the products a flash step needs:
    2 forward and 4 backward (dP, dS, dV, dK; recomputing S is not
    inherent)."""
    for t in TRAIN_SWEEP:
        b = tokens // t
        q, k, v, do = flash_inputs(torch, device, torch.bfloat16, b * h, t, t,
                                   d, seed=50)
        o, lse = kernels.flash_attention_with_lse(q, k, v, True)

        def both():
            o, lse = kernels.flash_attention_with_lse(q, k, v, True)
            kernels.flash_attention_bwd(q, k, v, o, lse, do, True)

        fwd = time_ms(lambda: kernels.flash_attention_with_lse(q, k, v, True),
                      5)
        fwd_bwd = time_ms(both, 3)
        q4, k4, v4 = (x.reshape(b, h, t, d).detach().requires_grad_(True)
                      for x in (q, k, v))
        do4 = do.reshape(b, h, t, d)
        with torch.no_grad():
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True), 5)
        lib_both = time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
            (q4, k4, v4), do4), 3)
        mat = b * h * t * d * 2
        sq = b * h * t * t * d            # one product, causal half x 2 flops
        bound_f, _ = bound_ms(4 * mat + 4 * b * h * t, 2 * sq, "bfloat16")
        bound_fb, _ = bound_ms(8 * mat + 8 * b * h * t, 6 * sq, "bfloat16")
        log("train sweep T=%4d x B=%d: flash_fwd %.3f ms (sdpa %.3f, bound "
            "%.3f), fwd+bwd %.3f ms (sdpa %.3f, bound %.3f)"
            % (t, b, fwd, lib, bound_f, fwd_bwd, lib_both, bound_fb))
        del q, k, v, do, o, lse, q4, k4, v4, do4


# ------------------------------------------------------ mesh training ---
# The LM stack under a mesh on a world of one (one card: NCCL takes no
# two ranks on one GPU) and weight-only int8 trees. MESH_TRAIN: the
# training flagship under make_mesh({"dp": 1, "tp": 1, "sp": 1, "ep": 1})
# with the sequence gathered (use_ring_attention=False), so attention
# runs B1, B2a and B2b, beside the no-mesh step; RING_CFG: the flagship
# cut to 2 layers, fp32, through the plain ring; MESH_SERVE_AXES:
# generate() and beam_search() at GENERATE's width on SERVE_CFG's model;
# the q8 tree: SERVE_CFG's bf16 weights quantised, served at SERVE's mix.
MESH_TRAIN_AXES = {"dp": 1, "tp": 1, "sp": 1, "ep": 1}
MESH_SERVE_AXES = {"dp": 1, "tp": 1}
RING_CFG = dict(TRAIN_CFG, n_layers=2)
MESH_BEAM = 4


def tree_bytes(tf, params):
    """Bytes of every array of a parameter tree (an int8 tree's codes,
    scales and dtype carriers as its checkpoint holds them)."""
    return sum(t.numel() * t.element_size()
               for t in tf.flat_tensors(params).values())


def mesh_train(torch, tf, parallel, kernels, device):
    """TRAIN["steps"] bf16 steps of the flagship through
    make_train_step(cfg, mesh) on a world of one, paired step by step
    (alternating which goes first) with make_train_step(cfg) from the
    same init and batch: every loss, parameter and momentum bitwise
    equal, each step launching B1, B2a and B2b n_layers times and nothing
    else. Prints each route's step ms, tokens/s, MFU and peak memory and
    the bucket plan that the mesh step's gradients take on a world above
    one (on this world of one every axis has size 1, and
    bucketed_all_reduce returns the gradients as they are)."""
    from mxnet_tpu_torch.parallel import fusion
    cfg = tf.TransformerConfig(dtype=torch.bfloat16, use_ring_attention=False,
                               **TRAIN_CFG)
    mesh = parallel.make_mesh(MESH_TRAIN_AXES)
    plain = tf.init_params(cfg, seed=0, device=device)
    meshed = tf.shard_params(copy.deepcopy(plain), cfg, mesh)
    n_params = sum(p.numel() for p in plain.parameters())
    tokens = train_tokens(torch, cfg, device)
    runs = {"no mesh": (tf.make_train_step(cfg, lr=TRAIN["lr"]), plain,
                        tf.init_momentum(plain)),
            "mesh": (tf.make_train_step(cfg, mesh, lr=TRAIN["lr"]), meshed,
                     tf.init_momentum(meshed))}
    stats = {name: {"losses": [], "s": [], "peak": 0, "own": 0}
             for name in runs}
    launches = collections.Counter()
    for i in range(TRAIN["steps"]):
        for name in (("no mesh", "mesh") if i % 2 == 0
                     else ("mesh", "no mesh")):
            step, params, mom = runs[name]
            kernels.launches.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            loss = step(params, mom, tokens)[2]
            torch.cuda.synchronize()
            st = stats[name]
            st["s"].append(time.perf_counter() - t0)
            st["losses"].append(loss)
            st["peak"] = max(st["peak"], torch.cuda.max_memory_allocated())
            st["own"] = max(st["own"], torch.cuda.max_memory_allocated()
                            - base)
            check_only(kernels, {k: cfg.n_layers for k in TRAIN_KERNELS},
                       "%s train step %d" % (name, i))
            if name == "mesh":
                launches.update(kernels.launches)
    a, b = stats["no mesh"], stats["mesh"]
    same = all(torch.equal(x, y) for x, y in zip(a["losses"], b["losses"]))
    for (n, p), q in zip(plain.named_parameters(), meshed.parameters()):
        same = same and torch.equal(p, q) and torch.equal(
            runs["no mesh"][2][n], runs["mesh"][2][n])
    losses = [float(x) for x in b["losses"]]
    n_tok = tokens.numel()
    for name, st in stats.items():
        ms = 1e3 * float(np.mean(st["s"][1:]))
        log("mesh train, %s: step %.3f ms (mean of steps 2-%d; first %.3f "
            "ms), %.0f tokens/s, MFU %.4f; peak memory %.3f GB (%.3f GB "
            "over the step's start)"
            % (name, ms, len(st["s"]), 1e3 * st["s"][0], n_tok / (ms / 1e3),
               6.0 * n_params * n_tok / (ms / 1e3) / PEAK_FLOPS["bfloat16"],
               st["peak"] / 1e9, st["own"] / 1e9))
        st["ms"] = ms
    entries = [(n, tuple(p.shape), p.dtype)
               for n, p in reversed(list(meshed.named_parameters()))]
    plan = fusion.plan_buckets(entries)
    log("mesh train: %d params, losses %s; bucket plan (a world above one "
        "reduces by it; a world of one skips the reduction) %d buckets, %d "
        "lanes, %d bytes (largest bucket %d bytes, %d above the 25 MB "
        "budget travel alone)"
        % (n_params, " ".join("%.4f" % x for x in losses), len(plan),
           sum(len(bk.lanes) for bk in plan), sum(bk.nbytes for bk in plan),
           max(bk.nbytes for bk in plan),
           sum(bk.nbytes > fusion.DEFAULT_BUCKET_BYTES for bk in plan)))
    log("mesh train: the mesh step bitwise the no-mesh step over %d steps "
        "(losses, parameters, momentum): %s" % (TRAIN["steps"], same))
    if not same:
        raise AssertionError("the world-of-one mesh step is not the no-mesh "
                             "step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("mesh training loss is not finite and falling")
    return {"launches": dict(launches), "ms": (a["ms"], b["ms"]),
            "peak": (a["peak"], b["peak"]), "buckets": len(plan)}


def ring_grads(torch, tf, parallel, kernels, device):
    """RING_CFG in fp32 (TF32 off): one make_train_step(cfg, mesh) step
    through the plain ring at sp = 1 (no kernel at all: B5 is forward
    only, so gradients go through the plain block) against loss_fn's
    gradients through the flash route with no mesh (B1, B2a and B2b
    once a layer): loss within 1e-4, worst gradient relative L2 1e-3
    (train_equivalence's limits). The first step's momentum is its
    gradient."""
    flash = tf.TransformerConfig(dtype=torch.float32, **RING_CFG)
    ring = dataclasses.replace(flash, use_flash_kernel=False,
                               use_ring_attention=True)
    mesh = parallel.make_mesh({"dp": 1, "sp": 1})
    params = tf.init_params(flash, seed=0, device=device)
    tokens = train_tokens(torch, flash, device)
    kernels.launches.clear()
    loss_k, grads_k = loss_and_grads(torch, tf, params, tokens, flash)
    check_only(kernels, {k: flash.n_layers for k in TRAIN_KERNELS},
               "the flash route's gradients")
    mom = tf.init_momentum(params)
    kernels.launches.clear()
    loss_r = float(tf.make_train_step(ring, mesh, lr=TRAIN["lr"])(
        params, mom, tokens)[2])
    torch.cuda.synchronize()
    check_only(kernels, {}, "the ring step (no B5, no kernel)")
    worst, worst_name = 0.0, None
    for (name, _), gk in zip(params.named_parameters(), grads_k):
        rel = float((mom[name] - gk).norm() / gk.norm())
        if not rel <= worst:
            worst, worst_name = rel, name
    log("ring step, fp32, %d layers, sp = 1: loss %.6f vs the flash route's "
        "%.6f (|diff| %.3g, tol 1e-4), worst gradient relative L2 %.3g at "
        "%s (tol 1e-3); no B5 launched"
        % (ring.n_layers, loss_r, loss_k, abs(loss_r - loss_k), worst,
           worst_name))
    if not abs(loss_r - loss_k) <= 1e-4 or not worst <= 1e-3:
        raise AssertionError("gradients through the plain ring disagree with "
                             "the flash route")


def mesh_serve(torch, tf, parallel, kernels, params, cfg, device):
    """generate() and beam_search() (beam MESH_BEAM) at GENERATE's width
    under a world-of-one {"dp": 1, "tp": 1} mesh against the same calls
    with no mesh: tokens (and beam scores) equal, and the B1 and B4
    launches equal the no-mesh calls' (flash_generate's counts)."""
    mesh = parallel.make_mesh(MESH_SERVE_AXES)
    sharded = tf.shard_params(params, cfg, mesh)
    rng = np.random.RandomState(2)
    b, t_p, n_new = GENERATE["batch"], GENERATE["prompt"], GENERATE["n_new"]
    prompt = rng.randint(0, cfg.vocab_size, (b, t_p)).astype(np.int32)
    calls = {
        "generate": lambda p, m: tf.generate(p, prompt, n_new, cfg, mesh=m,
                                             device=device),
        "beam_search": lambda p, m: tf.beam_search(p, prompt, n_new, cfg,
                                                   beam=MESH_BEAM, mesh=m,
                                                   device=device)}
    launches = collections.Counter()
    for label, call in calls.items():
        out = {}
        for route, p, m in (("no mesh", params, None),
                            ("mesh", sharded, mesh)):
            kernels.launches.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = call(p, m)
            torch.cuda.synchronize()
            out[route] = (res, dict(kernels.launches),
                          time.perf_counter() - t0)
        want = flash_generate(cfg.n_layers, n_new - 1)
        check_only(kernels, want, "%s under the mesh" % label)
        (ra, la, sa), (rb, lb, sb) = out["no mesh"], out["mesh"]
        launches.update(lb)
        pairs = zip(ra, rb) if isinstance(ra, tuple) else [(ra, rb)]
        same = all(torch.equal(x, y) for x, y in pairs)
        log("%s, batch %d, prompt %d, %d new%s: mesh tokens equal the no-mesh "
            "tokens: %s; launches %s (no mesh %s); %.3f s (no mesh %.3f s)"
            % (label, b, t_p, n_new,
               ", beam %d" % MESH_BEAM if label == "beam_search" else "",
               same, lb, la, sb, sa))
        if not same or la != lb:
            raise AssertionError("%s under a world-of-one mesh differs from "
                                 "the call with no mesh" % label)
    return dict(launches)


def serve_streams(torch, sv, kernels, params, cfg, device, kernel, label):
    """SERVE's job mix through the paged batcher: (results, order,
    tokens/s, launches); every dispatch launches ``kernel`` once a layer
    and nothing else, no dispatch is requeued."""
    jobs = serve_jobs(cfg, SERVE["n_new"], SERVE)
    srv = batcher(sv, params, cfg, device, SERVE)
    kernels.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, order = srv.run(jobs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_only(kernels, {kernel: cfg.n_layers * srv.dispatch_count}, label)
    check_clean(srv, label)
    srv.check_invariants(quiesce=True)
    return ([results[r] for r in order], sum(n for _, n in jobs) / dt,
            dict(kernels.launches))


def q8_serve(torch, tf, sv, ck, kernels, params, cfg, device):
    """SERVE_CFG's bf16 weights quantised (quantize_weights_int8): the
    tree's bytes against bf16's; SERVE's mix through the paged batcher
    (B3) on the q8 tree and on its dequantised twin materialised in bf16,
    in turns q8, twin, twin, q8 (tokens/s paired, streams equal token for
    token: the weights are bitwise the same); generate() (B1 + B4) and
    the int8 KV pool (B3 int8) each against the twin; a q8 checkpoint's
    save and load bitwise."""
    q8 = tf.quantize_weights_int8(params)
    twin = tf._dequantize_weights(q8)
    qb, fb = tree_bytes(tf, q8), tree_bytes(tf, params)
    log("q8 tree: %d bytes, bf16 tree %d bytes (%.4f of it)"
        % (qb, fb, qb / fb))
    launches = collections.Counter()
    streams, rates = {}, {"q8": [], "bf16": []}
    for name, p in (("q8", q8), ("bf16", twin), ("bf16", twin), ("q8", q8)):
        got, rate, used = serve_streams(torch, sv, kernels, p, cfg, device,
                                        "paged_decode", "serve " + name)
        streams.setdefault(name, got)
        if got != streams[name] or got != streams.get("q8", got):
            raise AssertionError("the q8 tree's streams differ from its "
                                 "dequantised twin's")
        rates[name].append(rate)
        if name == "q8":
            launches.update(used)
    log("serve q8 vs its bf16 twin (%d requests, %d lanes): streams equal; "
        "tokens/s q8 %s, bf16 %s (in turns q8, bf16, bf16, q8)"
        % (SERVE["requests"], SERVE["max_batch"],
           " ".join("%.1f" % r for r in rates["q8"]),
           " ".join("%.1f" % r for r in rates["bf16"])))
    rng = np.random.RandomState(2)
    b, t_p, n_new = GENERATE["batch"], GENERATE["prompt"], GENERATE["n_new"]
    prompt = rng.randint(0, cfg.vocab_size, (b, t_p)).astype(np.int32)
    out = {}
    for name, p in (("q8", q8), ("bf16", twin)):
        kernels.launches.clear()
        out[name] = (tf.generate(p, prompt, n_new, cfg, device=device),
                     dict(kernels.launches))
        check_only(kernels, flash_generate(cfg.n_layers, n_new - 1),
                   "generate " + name)
    launches.update(out["q8"][1])
    same = torch.equal(out["q8"][0], out["bf16"][0])
    log("generate q8 vs its twin: tokens equal %s, launches %s" % (
        same, out["q8"][1]))
    if not same:
        raise AssertionError("generate() on the q8 tree differs from its "
                             "twin")
    cfg8 = dataclasses.replace(cfg, kv_cache_int8=True)
    got = {}
    for name, p in (("q8", q8), ("bf16", twin)):
        got[name], rate, used = serve_streams(
            torch, sv, kernels, p, cfg8, device, "paged_decode_int8",
            "serve int8 KV " + name)
        if name == "q8":
            launches.update(used)
    log("serve int8 KV, q8 weights vs the twin: streams equal %s"
        % (got["q8"] == got["bf16"]))
    if got["q8"] != got["bf16"]:
        raise AssertionError("the int8 KV pool on the q8 tree differs from "
                             "its twin")
    root = tempfile.mkdtemp(prefix="q8-ckpt-")
    try:
        t0 = time.perf_counter()
        ck.save_checkpoint(root, cfg, q8, step=0)
        t1 = time.perf_counter()
        _, back, _, _, _ = ck.load_checkpoint(root, device=device)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want = tf.flat_tensors(q8)
    same = all(t.dtype == want[n].dtype and torch.equal(t, want[n])
               for n, t in tf.flat_tensors(back).items()) \
        and set(want) == set(tf.flat_tensors(back))
    log("q8 checkpoint: save %.3f s, load %.3f s, bitwise %s"
        % (t1 - t0, t2 - t1, same))
    if not same:
        raise AssertionError("the q8 checkpoint did not come back bitwise")
    return {"launches": dict(launches), "bytes": (qb, fb),
            "tokens_s": rates}


def mesh_train_phase(torch, tf, sv, ck, parallel, kernels, params, cfg,
                     device):
    """The LM stack under a mesh and int8 weight trees (see MESH_TRAIN_AXES
    and the functions it runs); every gate raises. Returns the phase's
    launches by kernel."""
    t0 = time.perf_counter()
    launches = collections.Counter()
    trained = mesh_train(torch, tf, parallel, kernels, device)
    launches.update(trained["launches"])
    torch.cuda.empty_cache()
    ring_grads(torch, tf, parallel, kernels, device)
    torch.cuda.empty_cache()
    launches.update(mesh_serve(torch, tf, parallel, kernels, params, cfg,
                               device))
    torch.cuda.empty_cache()
    launches.update(q8_serve(torch, tf, sv, ck, kernels, params, cfg,
                             device)["launches"])
    torch.cuda.empty_cache()
    log("mesh_train_phase: %.1f s; launches %s; %s"
        % (time.perf_counter() - t0, dict(launches), card_line()))
    return dict(launches)


# ------------------------------------------------------------- B6, rtc ---
# The user program of the rtc phase: the flagship's output head (8 x 1024
# tokens, d_model 1024, vocab 32000) through nd and autograd, its weight
# updated by user kernels written for rtc. CUDA C++ for CudaModule:
RTC_CUDA = r"""
template <typename T>
__global__ void sgd_mom_update(T *weight, T *mom, const T *grad, T lr,
                               T momentum, int n) {
  // mom = momentum * mom - lr * grad; weight += mom (sgd_mom_update, wd 0)
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    T m = momentum * mom[i] - lr * grad[i];
    mom[i] = m;
    weight[i] += m;
  }
}

template <typename T>
__global__ void axpy(const T *x, T *y, T alpha, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    y[i] += alpha * x[i];
}

extern "C" __global__ void row_sum(const float *x, float *out, int cols) {
  // one CTA per row; the partial sums meet in dynamic shared memory
  extern __shared__ float partial[];
  const float *row = x + (size_t)blockIdx.x * cols;
  float s = 0.f;
  for (int j = threadIdx.x; j < cols; j += blockDim.x) s += row[j];
  partial[threadIdx.x] = s;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) partial[threadIdx.x] += partial[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = partial[0];
}
"""
RTC_SIGNATURES = {
    "sgd_mom_update<float>": "float *weight, float *mom, const float *grad, "
                             "float lr, float momentum, int n",
    "axpy<float>": "const float *x, float *y, float alpha, int n",
    "row_sum": "const float *x, float *out, int cols",
}
RTC_HEAD = dict(tokens=8 * 1024, d_model=1024, vocab=32000)
RTC_UPDATE = dict(steps=5, lr=1.0, momentum=0.9)
RTC_SAXPY_N = 2 ** 28                  # 1 GiB per fp32 tensor
RTC_ROWSUM = dict(block=1024, shared_mem=64 * 1024)
RTC_THREADS, RTC_BLOCKS = 256, 132 * 32     # grid-stride launches
RTC_TRITON_BLOCK = 1024
# a user kernel against the same arithmetic in nd or torch ops, fp32,
# (atol, rtol): NVRTC (and Triton) contract momentum * mom - lr * grad
# and y + alpha * x into FMAs, which moves a result by about one ulp of
# its terms (6e-8 of them); an update is ~1e-4 here and a weight ~0.1
TOL_RTC = {"float32": (1e-6, 1e-6)}
# the row sums: 32000 fp32 logits summed in two orders; either order's
# rounding error stays under ~log2(32000) * 2^-24 = 1e-6 of sum |x| when
# summed by trees, so allow 1e-5 of a row's sum |x|
TOL_ROWSUM = 1e-5

# Triton bodies for PallasModule, written as a Pallas body is: the
# inputs, the scalars, then the fresh outputs. ``tl`` is bound to
# triton.language by triton_bodies(), which runs on the card only.
tl = None


def saxpy_body(x_ptr, y_ptr, n, BLOCK: "tl.constexpr", o_ptr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask)
    y = tl.load(y_ptr + offs, mask=mask)
    tl.store(o_ptr + offs, 2.0 * x + y, mask=mask)


def sgd_mom_body(w_ptr, m_ptr, g_ptr, lr, momentum, n, BLOCK: "tl.constexpr",
                 w_out, m_out):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    w = tl.load(w_ptr + offs, mask=mask)
    m = momentum * tl.load(m_ptr + offs, mask=mask) \
        - lr * tl.load(g_ptr + offs, mask=mask)
    tl.store(m_out + offs, m, mask=mask)
    tl.store(w_out + offs, w + m, mask=mask)


def triton_bodies():
    global tl
    import triton
    import triton.language as tl
    return triton, triton.jit(saxpy_body), triton.jit(sgd_mom_body)


def head_loss_nd(nd, h, w, labels):
    """The output head's mean cross-entropy, in nd ops only."""
    logits = nd.dot(h, w.astype("bfloat16")).astype("float32")
    top = nd.max(logits, axis=1, keepdims=True)
    lse = nd.log(nd.sum(nd.exp(logits - top), axis=1, keepdims=True)) + top
    return nd.mean(lse.reshape((-1,)) - nd.pick(logits, labels, axis=1))


def head_loss_torch(torch, h, w, labels):
    """The same expression written directly in torch ops."""
    logits = (h @ w.to(torch.bfloat16)).float()
    top = logits.amax(1, keepdim=True)
    lse = torch.log(torch.exp(logits - top).sum(1, keepdim=True)) + top
    return (lse[:, 0] - logits.gather(1, labels[:, None].long())[:, 0]).mean()


def host_ms(torch, fn, iters):
    """Mean host ms of ``fn`` over ``iters`` calls after one warm-up,
    ending in a device sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def rtc_head(torch, nd, autograd, ctx):
    """The head's forward and backward through nd/autograd, held against
    plain torch: loss within 1e-4 relative, W's gradient within 1e-3
    relative L2. Returns (h, W0, labels, head step ms)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    n, d, v = RTC_HEAD["tokens"], RTC_HEAD["d_model"], RTC_HEAD["vocab"]
    h_t = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    w_t = torch.randn(d, v, generator=gen, device="cuda") / d ** 0.5
    labels_t = torch.randint(0, v, (n,), generator=gen, device="cuda",
                             dtype=torch.int32)
    h = nd.array(h_t, ctx=ctx)
    labels = nd.array(labels_t, ctx=ctx)
    w = nd.array(w_t, ctx=ctx)
    w.attach_grad()

    def step():
        with autograd.record():
            loss = head_loss_nd(nd, h, w, labels)
        loss.backward()
        return loss

    loss = float(step().asscalar())
    wt = w_t.clone().requires_grad_(True)
    want = head_loss_torch(torch, h_t, wt, labels_t)
    want.backward()
    want = want.detach()
    rel_loss = abs(loss - float(want)) / abs(float(want))
    rel_grad = rel_l2(w.grad._data, wt.grad)
    def plain_step():
        wt.grad = None
        head_loss_torch(torch, h_t, wt, labels_t).backward()

    head_ms, plain_ms = (host_ms(torch, fn, 5) for fn in (step, plain_step))
    log("rtc head (8192 x 1024 bf16 @ 1024 x 32000, fp32 loss) through "
        "nd/autograd: loss %.6f vs torch %.6f (rel %.3g, tol 1e-4), W.grad "
        "rel L2 %.3g (tol 1e-3); forward + backward %.3f ms (plain torch "
        "%.3f ms)" % (loss, float(want), rel_loss, rel_grad, head_ms,
                      plain_ms))
    if not rel_loss <= 1e-4 or not rel_grad <= 1e-3:
        raise AssertionError("the head through nd/autograd disagrees with "
                             "plain torch")
    return h, w_t, labels, head_ms


def rtc_train(torch, nd, autograd, ctx, h, w0, labels, update, route,
              in_place):
    """RTC_UPDATE["steps"] steps of the head, each updated by a user
    kernel (``update(w, mom, lr, momentum)``; ``in_place``: it writes W
    where it lies, W's buffer being its own) and held against the same
    update in nd ops; returns the worst error."""
    lr, momentum = RTC_UPDATE["lr"], RTC_UPDATE["momentum"]
    w = nd.array(w0, ctx=ctx)
    w.attach_grad()
    mom = nd.zeros(w.shape, ctx=ctx)
    losses, errs = [], []
    for _ in range(RTC_UPDATE["steps"]):
        with autograd.record():
            loss = head_loss_nd(nd, h, w, labels)
        loss.backward()
        losses.append(float(loss.asscalar()))
        del loss                   # the graph holds W's tensor
        want_mom = momentum * mom - lr * w.grad
        want_w = w + want_mom
        ptr = w._data.data_ptr()
        update(w, mom, lr, momentum)
        if in_place and w._data.data_ptr() != ptr:
            raise AssertionError("the %s update copied W" % route)
        errs.append(max(
            compare(w._data.detach(), want_w._data, "float32",
                    "%s update, weight" % route, TOL_RTC),
            compare(mom._data, want_mom._data, "float32",
                    "%s update, momentum" % route, TOL_RTC)))
    log("rtc %s: head losses %s" % (route, " ".join("%.5f" % x
                                                    for x in losses)))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("the %s route's loss is not finite and falling"
                             % route)
    return max(errs)


def rtc_phase(torch, kernels, mt):
    """The rtc path on gpu(0): compile the user's CUDA source with NVRTC
    and the Triton bodies, drive the head and its five-step updates
    through both routes, the saxpy/axpy pair at 2^28 elements and the
    64 KB shared-memory row sum, each against its plain version, and the
    error paths. Returns the launch counts, errors and what the timing
    needs."""
    nd, autograd, rtc = mt.nd, mt.autograd, mt.rtc
    ctx = mt.gpu(0)
    t0 = time.perf_counter()
    mod = rtc.CudaModule(RTC_CUDA, exports=("sgd_mom_update<float>",
                                            "axpy<float>"))
    cuda = {name: mod.get_kernel(name, sig)
            for name, sig in RTC_SIGNATURES.items()}
    triton, saxpy_jit, sgd_jit = triton_bodies()
    pallas = rtc.PallasModule(
        saxpy=(saxpy_jit, lambda x, y, n, block:
               rtc.ShapeDtypeStruct(x.shape, x.dtype)),
        sgd_mom_update=(sgd_jit, lambda w, m, g, lr, mo, n, block: [
            rtc.ShapeDtypeStruct(w.shape, w.dtype),
            rtc.ShapeDtypeStruct(m.shape, m.dtype)]))
    log("rtc: NVRTC compiled the module in %.3f s (%s), set-up %.3f s"
        % (mod.compile_seconds, mod.arch, time.perf_counter() - t0))

    def grid1(n):
        return (min(triton.cdiv(n, RTC_THREADS), RTC_BLOCKS), 1, 1)

    def cuda_update(w, mom, lr, momentum):
        cuda["sgd_mom_update<float>"].launch(
            [w, mom, w.grad, lr, momentum, w.size], ctx, grid1(w.size),
            (RTC_THREADS, 1, 1))

    def triton_update(w, mom, lr, momentum):
        new_w, new_mom = pallas.get_kernel("sgd_mom_update").launch(
            [w, mom, w.grad, lr, momentum, w.size, RTC_TRITON_BLOCK],
            grid_dims=(triton.cdiv(w.size, RTC_TRITON_BLOCK),))
        nd.NDArray(new_w, ctx).copyto(w)
        nd.NDArray(new_mom, ctx).copyto(mom)

    kernels.launches.clear()
    t0 = time.perf_counter()
    h, w0, labels, head_ms = rtc_head(torch, nd, autograd, ctx)
    errs = {"rtc:sgd_mom_update<float>": rtc_train(
        torch, nd, autograd, ctx, h, w0, labels, cuda_update, "CudaModule",
        True),
        "rtc:sgd_mom_update": rtc_train(
        torch, nd, autograd, ctx, h, w0, labels, triton_update,
        "Triton PallasModule", False)}
    counts = dict(kernels.launches)
    steps = RTC_UPDATE["steps"]
    if counts != {"rtc:sgd_mom_update<float>": steps,
                  "rtc:sgd_mom_update": steps}:
        raise AssertionError("the rtc update launched %s, not one launch "
                             "per step per route" % counts)
    log("rtc head training, both routes: %s launches in %.1f s"
        % (counts, time.perf_counter() - t0))

    # saxpy at 2^28 fp32 elements: o = 2x + y (Triton), y += 2x (CUDA)
    n = RTC_SAXPY_N
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = nd.array(torch.randn(n, generator=gen, device="cuda"), ctx=ctx)
    y = nd.array(torch.randn(n, generator=gen, device="cuda"), ctx=ctx)
    saxpy = pallas.get_kernel("saxpy")
    t0 = time.perf_counter()
    out = saxpy.launch([x, y, n, RTC_TRITON_BLOCK],
                       grid_dims=(triton.cdiv(n, RTC_TRITON_BLOCK),))
    torch.cuda.synchronize()
    triton_first_s = time.perf_counter() - t0
    errs["rtc:saxpy"] = compare(out, 2.0 * x._data + y._data, "float32",
                                "Triton saxpy, 2^28", TOL_RTC)
    y_before = y._data.clone()
    cuda["axpy<float>"].launch([x, y, 2.0, n], ctx, grid1(n),
                               (RTC_THREADS, 1, 1))
    errs["rtc:axpy<float>"] = compare(y._data, y_before + 2.0 * x._data,
                                      "float32", "CUDA axpy, 2^28", TOL_RTC)
    del out, y_before

    # one CTA per row of the fp32 logits, 64 KB of dynamic shared memory
    logits = nd.dot(h, nd.array(w0, ctx=ctx).astype("bfloat16")).astype(
        "float32")
    sums = nd.zeros((logits.shape[0],), ctx=ctx)
    cuda["row_sum"].launch([logits, sums, logits.shape[1]], ctx,
                           (logits.shape[0], 1, 1),
                           (RTC_ROWSUM["block"], 1, 1),
                           RTC_ROWSUM["shared_mem"])
    want = logits._data.sum(1)
    scale = logits._data.abs().sum(1)
    share = float(((sums._data - want).abs() / (TOL_ROWSUM * scale)).max())
    errs["rtc:row_sum"] = max_err(sums._data, want)
    log("row_sum, 8192 x 32000 fp32, 1024 threads, 64 KB shared: max abs "
        "err %.3g, worst err / (%g sum |x|) = %.3f"
        % (errs["rtc:row_sum"], TOL_ROWSUM, share))
    if not share <= 1.0:
        raise AssertionError("row_sum disagrees with logits.sum(1)")
    launched = dict(kernels.launches)

    # the error paths, and a write through a view that must not show
    try:
        rtc.CudaModule("__global__ void broken(float *x) { x[0] = y; }")
        raise AssertionError("a source that does not compile was accepted")
    except mt.MXNetError as exc:
        if "identifier" not in str(exc):
            raise AssertionError("the NVRTC log is missing: %s" % exc)
        log("rtc: a broken source raises MXNetError with NVRTC's log (%s)"
            % str(exc).strip().splitlines()[-1][:100])
    small = nd.array(np.arange(8, dtype=np.float32), ctx=ctx)
    ints = nd.array(np.arange(8, dtype=np.int32), ctx=ctx)
    try:
        cuda["axpy<float>"].launch([ints, small, 2.0, 8], ctx, (1, 1, 1),
                                   (32, 1, 1))
        raise AssertionError("an int32 NDArray was passed as float *")
    except mt.MXNetError as exc:
        log("rtc: a dtype mismatch raises before launch (%s)" % exc)
    ref_body = rtc.PallasModule(saxpy=(
        lambda x_ref, y_ref, o_ref: o_ref.__setitem__(
            Ellipsis, 2.0 * x_ref[...] + y_ref[...]),
        lambda x, y: rtc.ShapeDtypeStruct(x.shape, x.dtype)))
    try:
        ref_body.get_kernel("saxpy").launch([small, small])
        raise AssertionError("a ref body ran on CUDA tensors, no kernel")
    except mt.MXNetError as exc:
        log("rtc: a ref body given CUDA tensors raises (%s)" % exc)
    view = small.reshape((2, 4))
    cuda["axpy<float>"].launch([nd.ones((8,), ctx=ctx), view, 1.0, 8], ctx,
                               (1, 1, 1), (32, 1, 1))
    if not (np.array_equal(small.asnumpy(), np.arange(8))
            and np.array_equal(view.asnumpy().reshape(-1),
                               np.arange(8) + 1)):
        raise AssertionError("a kernel's write through a view showed "
                             "through another NDArray")
    if dict(kernels.launches) != dict(launched, **{
            "rtc:axpy<float>": launched["rtc:axpy<float>"] + 1}):
        raise AssertionError("an error path launched a kernel")
    log("rtc: a kernel writing a reshaped NDArray left its source as it was")
    return {"launches": launched, "errs": errs, "head_ms": head_ms,
            "compile_s": mod.compile_seconds,
            "triton_first_s": triton_first_s,
            "timing": (mod, cuda, pallas, triton, grid1, x, y, logits, sums,
                       ctx)}


def time_rtc(torch, nd, run):
    """Each rtc kernel's ms beside its plain version, a one-call library
    yardstick where one exists, and its bound."""
    mod, cuda, pallas, triton, grid1, x, y, logits, sums, ctx = run["timing"]
    n = x.size
    lr, mo = RTC_UPDATE["lr"], RTC_UPDATE["momentum"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    shape = (RTC_HEAD["d_model"], RTC_HEAD["vocab"])
    w, mom, g = (nd.array(torch.randn(shape, generator=gen, device="cuda"),
                          ctx=ctx) for _ in range(3))
    m = w.size
    rows = {}
    bound_update = bound_ms(5 * 4 * m, 4 * m, "float32")
    bound_axpy = bound_ms(3 * 4 * n, 2 * n, "float32")

    def plain_update():
        new_mom = mo * mom._data - lr * g._data
        return w._data + new_mom, new_mom

    rows["rtc:sgd_mom_update<float>"] = (
        time_ms(lambda: cuda["sgd_mom_update<float>"].launch(
            [w, mom, g, lr, mo, m], ctx, grid1(m), (RTC_THREADS, 1, 1)), 20),
        time_ms(plain_update, 20), None, bound_update)
    rows["rtc:sgd_mom_update"] = (
        time_ms(lambda: pallas.get_kernel("sgd_mom_update").launch(
            [w, mom, g, lr, mo, m, RTC_TRITON_BLOCK],
            grid_dims=(triton.cdiv(m, RTC_TRITON_BLOCK),)), 20),
        rows["rtc:sgd_mom_update<float>"][1], None, bound_update)
    library = time_ms(lambda: torch.add(y._data, x._data, alpha=2.0), 10)
    rows["rtc:saxpy"] = (
        time_ms(lambda: pallas.get_kernel("saxpy").launch(
            [x, y, n, RTC_TRITON_BLOCK],
            grid_dims=(triton.cdiv(n, RTC_TRITON_BLOCK),)), 10),
        time_ms(lambda: 2.0 * x._data + y._data, 10), library, bound_axpy)
    rows["rtc:axpy<float>"] = (
        time_ms(lambda: cuda["axpy<float>"].launch(
            [x, y, 2.0, n], ctx, grid1(n), (RTC_THREADS, 1, 1)), 10),
        time_ms(lambda: y._data + 2.0 * x._data, 10), library, bound_axpy)
    r, c = logits.shape
    summed = time_ms(lambda: logits._data.sum(1), 20)
    rows["rtc:row_sum"] = (
        time_ms(lambda: cuda["row_sum"].launch(
            [logits, sums, c], ctx, (r, 1, 1), (RTC_ROWSUM["block"], 1, 1),
            RTC_ROWSUM["shared_mem"]), 20),
        summed, summed, bound_ms(4 * r * c + 4 * r, r * c, "float32"))
    return rows


# ------------------------------------------------------------- ResNet ---

# bench.py's headline step: ResNet-50 v1, batch 128, 224^2, 1000 classes,
# bf16 fold-cast, SGD lr 0.1 with momentum 0.9; one seeded batch
RESNET = dict(batch=128, image_size=224, classes=1000, lr=0.1, steps=10)
RESNET_CHECK = dict(batch=2, image_size=224)   # fp32 step, card vs CPU
RESNET_ENTRY = dict(batch=8, image_size=224)   # entry()'s own shape
RESNET_POOL = (2, 64, 112, 112)                # the stem pool's input
RESNET_ROUTE_ITERS = 5
RESNET_OPS = 16                                # operators in the profile
# card (fp32, TF32 off) against the CPU in float64: relative L2 of the
# logits, the loss, each parameter's gradient and each new running
# statistic, at most TOL_RESNET or TOL_FLOOR times the CPU fp32 step's
# own distance from float64 (resnet_card_vs_cpu)
TOL_RESNET = 1e-3
TOL_FLOOR = 4.0
RESNET_KINDS = (("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
                ("convolution", ("conv", "xmma", "implicit", "cudnn",
                                 "dgrad", "wgrad", "fprop")),
                ("GEMM", ("nvjet", "gemm", "cutlass")),
                ("pooling", ("pool",)),
                ("reduction", ("reduce",)),
                ("elementwise and copies", ("elementwise", "copy")))


def nll_loss(torch, logits, y):
    """Mean NLL of log_softmax over fp32 logits (bench.py's loss);
    float64 logits stay float64."""
    logp = torch.log_softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    return -logp.gather(-1, y.long()[:, None])[:, 0].mean()


def resnet_fp32_step(torch, graph_fn, data, args, aux, x, y):
    """One fp32 training step's numbers through a traced graph: (logits,
    loss, {name: gradient}, {name: new running statistic})."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in args.items()}
    inputs = dict(leaves)
    inputs[data] = x
    outs, new_aux = graph_fn(inputs, dict(aux))
    loss = nll_loss(torch, outs[0], y)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (outs[0].detach(), loss.detach(), dict(zip(leaves, grads)),
            new_aux)


def resnet_card_vs_cpu(torch, mt, device, spec=RESNET_CHECK):
    """ResNet-50 v1 traced by functionalize_block with one seeded
    initialisation; one fp32 training step on the card (TF32 off), the
    same step on the CPU in fp32 and in float64 (float64 throughout: the
    BatchNorm op computes in the wider of its input's type and fp32). Each
    of the logits, the loss, every parameter's gradient and every new
    running statistic must be within TOL_RESNET (relative L2) of the
    float64 step, or within TOL_FLOOR times the CPU fp32 step's own
    distance from it: at this initialisation the gradient grows backward
    through the 16 bottlenecks, and a BatchNorm beta's or gamma's gradient
    sums terms that nearly cancel (a training-mode BatchNorm's input
    gradient has its channel means taken out), so fp32 alone, summed in
    any order, is good to only a few percent there (CPU fp32 against
    float64: 0.034 on the worst beta)."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.utils import functionalize_block
    b, s = spec["batch"], spec["image_size"]
    gen = torch.Generator().manual_seed(1)
    x = torch.rand((b, 3, s, s), generator=gen)
    y = torch.randint(0, 1000, (b,), generator=gen)
    with mt.cpu():
        net = vision.resnet50_v1(classes=1000)
        net.initialize(mt.init.Xavier())
        graph_fn, names, args, aux = functionalize_block(
            net, mt.nd.NDArray(x, mt.cpu()), is_train=True)

    def step(to):
        moved = lambda d: {k: to(v) for k, v in d.items()}
        out = resnet_fp32_step(torch, graph_fn, names[0], moved(args),
                               moved(aux), to(x), y.to(to(x).device))
        logits, loss, grads, new_aux = out
        parts = {"logits": logits, "loss": loss}
        parts.update(("gradient " + k, v) for k, v in grads.items())
        parts.update(("running statistic " + k, v)
                     for k, v in new_aux.items())
        return {k: v.detach().cpu().double() for k, v in parts.items()}

    t0 = time.perf_counter()
    cpu32 = step(lambda t: t)
    cpu_s = time.perf_counter() - t0
    cpu64 = step(lambda t: t.double())
    card = step(lambda t: t.to(device))
    assert sorted(card) == sorted(cpu64)
    worst = {}
    for key in cpu64:
        part = next((p for p in ("gradient", "running statistic")
                     if key.startswith(p + " ")), key)
        err = rel_l2(card[key], cpu64[key])
        floor = rel_l2(cpu32[key], cpu64[key])
        bound = max(TOL_RESNET, TOL_FLOOR * floor)
        vs_cpu = rel_l2(card[key], cpu32[key])
        if part not in worst or err / bound > worst[part][0]:
            worst[part] = (err / bound, key, err, floor, vs_cpu)
    for part, (share, key, err, floor, vs_cpu) in worst.items():
        log("resnet50 fp32 step (batch %d, %d^2, TF32 off; %.1f s on the "
            "CPU), %s: worst %s: card vs float64 rel L2 %.3g, CPU fp32 vs "
            "float64 %.3g, card vs CPU fp32 %.3g; %.3f of its bound max(%g, "
            "%g x CPU fp32's)" % (b, s, cpu_s, part, key, err, floor, vs_cpu,
                                  share, TOL_RESNET, TOL_FLOOR))
        if not share <= 1.0:
            raise AssertionError("resnet50 fp32 step: %s differs between "
                                 "the card and the CPU" % key)
    log("resnet50 fp32 step, card vs CPU: %d tensors held (logits, loss, "
        "%d gradients, %d running statistics)"
        % (len(cpu64), len(args), len(aux)))
    return {part: w[2] for part, w in worst.items()}


def resnet_pool_ties(torch, mt, ctx, shape=RESNET_POOL):
    """The stem's MaxPool2D(3, 2, 1) on all-equal windows: each window's
    gradient lands on its first position (the first valid row and column
    of the padded window), bitwise as on the CPU."""
    pool = mt.gluon.nn.MaxPool2D(3, 2, 1)
    grads = []
    for c in (ctx, mt.cpu()):
        x = mt.nd.zeros(shape, ctx=c)
        x.attach_grad()
        with mt.autograd.record():
            y = pool(x)
        y.backward(mt.nd.ones(y.shape, ctx=c))
        grads.append(x.grad.asnumpy())
    want = np.zeros(shape, np.float32)
    oh, ow = y.shape[2:]
    for i in range(oh):
        for j in range(ow):
            want[:, :, max(2 * i - 1, 0), max(2 * j - 1, 0)] += 1.0
    for what, got in (("card", grads[0]), ("CPU", grads[1])):
        if not np.array_equal(got, want):
            raise AssertionError("max-pool ties on the %s: the gradient "
                                 "is not on each window's first position"
                                 % what)
    if not np.array_equal(grads[0], grads[1]):
        raise AssertionError("max-pool ties: card and CPU differ")
    log("resnet50 stem MaxPool2D(3, 2, 1) on all-equal windows %s: the "
        "gradient sits on each window's first position, card and CPU "
        "bitwise equal" % (shape,))


def resnet_train(torch, mt, device, spec=RESNET):
    """entry.build_train_step at bench.py's shape on one seeded batch:
    the loss of steps 1 and 10 (finite, falling), the step ms (host clock
    around a step that ends in a device sync, mean of steps 2-10), img/s
    and the peak device memory. Returns what the profile needs."""
    from mxnet_tpu_torch import entry
    b, s, classes = spec["batch"], spec["image_size"], spec["classes"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step, state, mom, aux = entry.build_train_step(
        b, image_size=s, classes=classes, lr=spec["lr"], ctx=mt.gpu(0))
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((b, 3, s, s), generator=gen, device=device)
    y = torch.randint(0, classes, (b,), generator=gen, device=device)
    run = {"state": state, "mom": mom, "aux": aux}

    def one():
        run["state"], run["mom"], run["aux"], loss = step(
            run["state"], run["mom"], run["aux"], x, y)
        return loss

    losses, times = [], []
    for _ in range(spec["steps"]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = one()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(loss))
    step_ms = 1e3 * sum(times[1:]) / len(times[1:])
    peak = torch.cuda.max_memory_allocated()
    log("resnet50 bf16 train step (%s; batch %d, %d^2, %d classes, "
        "fold-cast, lr %g, momentum 0.9): %.3f ms per step (mean of steps "
        "2-%d; step 1 %.1f ms, build %.1f s), %.1f img/s, loss %.4f at "
        "step 1 -> %.4f at step %d, peak device memory %.3f GB"
        % (card_line(), b, s, classes, spec["lr"], step_ms, spec["steps"],
           1e3 * times[0], build_s, b / step_ms * 1e3, losses[0],
           losses[-1], spec["steps"], peak / 1e9))
    if not all(np.isfinite(losses)):
        raise AssertionError("resnet50 train step: non-finite loss %s"
                             % losses)
    if not losses[-1] < losses[0]:
        raise AssertionError("resnet50 train step: the loss on a fixed "
                             "batch did not fall: %s" % losses)
    return {"step": one, "step_ms": step_ms, "img_s": b / step_ms * 1e3,
            "losses": losses, "peak_bytes": peak}


def resnet_entry(torch, mt, device, spec=RESNET_ENTRY):
    """entry() on the card: logits of (batch, 1000), finite, agreeing
    with the same call on the CPU to TOL_RESNET; the forward's ms."""
    from mxnet_tpu_torch import entry
    fn, (args, aux, x) = entry.entry(batch=spec["batch"],
                                     image_size=spec["image_size"],
                                     ctx=mt.gpu(0))
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}
    with torch.no_grad():
        logits = fn(args, aux, x)
        if tuple(logits.shape) != (spec["batch"], 1000) \
                or not bool(torch.isfinite(logits).all()):
            raise AssertionError("entry(): logits of shape %s, finite %s"
                                 % (tuple(logits.shape),
                                    bool(torch.isfinite(logits).all())))
        err = rel_l2(logits.cpu(), fn(cpu(args), cpu(aux), x.cpu()))
        ms = host_ms(torch, lambda: fn(args, aux, x), 10)
    log("entry() on the card (%s): logits %s, forward %.3f ms (host clock, "
        "mean of 10 after a sync), card vs CPU relative L2 %.3g (limit %g)"
        % (card_line(), tuple(logits.shape), ms, err, TOL_RESNET))
    if not err <= TOL_RESNET:
        raise AssertionError("entry(): the card's logits differ from the "
                             "CPU's")
    return {"forward_ms": ms, "err": err}


def resnet_routes(torch, mt, device, batch=RESNET["batch"],
                  image_size=RESNET["image_size"], iters=RESNET_ROUTE_ITERS):
    """ResNet-50 v1 cast to bf16, forward + backward under
    autograd.record, imperative (nd, op by op) and hybridized (CachedOp),
    in turns (imperative, hybridized, hybridized, imperative): the host ms
    of each, mean over ``iters`` calls ending in a device sync."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    ctx = mt.gpu(0)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mt.init.Xavier(), ctx=ctx)
    net.cast("bfloat16")
    gen = torch.Generator(device=device).manual_seed(2)
    x = mt.nd.NDArray(torch.rand((batch, 3, image_size, image_size),
                                 generator=gen, device=device)
                      .to(torch.bfloat16), ctx)

    def fwd_bwd():
        with mt.autograd.record():
            out = net(x)
        out.backward()

    times = {False: [], True: []}
    for hybrid in (False, True, True, False):
        net.hybridize(hybrid)
        times[hybrid].append(host_ms(torch, fwd_bwd, iters))
    ms = {route: sum(v) / len(v) for route, v in times.items()}
    log("resnet50 bf16 forward + backward under autograd.record (%s; batch "
        "%d, %d^2): imperative (nd) %.3f ms (%s), hybridized (CachedOp) "
        "%.3f ms (%s); imperative / hybridized %.3f"
        % (card_line(), batch, image_size, ms[False],
           ", ".join("%.3f" % t for t in times[False]), ms[True],
           ", ".join("%.3f" % t for t in times[True]),
           ms[False] / ms[True]))
    return ms


def resnet_phase(torch, mt, device):
    """The ResNet-50 path of entry (bench.py's and __graft_entry__'s
    counterparts) on the card; returns its numbers."""
    out = {"check": resnet_card_vs_cpu(torch, mt, device)}
    resnet_pool_ties(torch, mt, mt.gpu(0))
    run = resnet_train(torch, mt, device)
    profile_steps(torch, "resnet50 bf16 train step, batch %d x %d^2 (%s)"
                  % (RESNET["batch"], RESNET["image_size"], card_line()),
                  run["step"], steps=3, top=12, kinds=RESNET_KINDS,
                  by_op=RESNET_OPS)
    out["train"] = {k: v for k, v in run.items() if k != "step"}
    del run
    torch.cuda.empty_cache()
    out["entry"] = resnet_entry(torch, mt, device)
    out["routes"] = resnet_routes(torch, mt, device)
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------ Gluon training ---

# the Gluon loop at bench.py's shape: ResNet-50 v1 cast to bf16,
# hybridized, SoftmaxCrossEntropyLoss, Trainer("sgd") with bench.py's lr
# and momentum, the ImageNet recipe's wd and fp32 masters; one seeded batch
GLUON = dict(batch=128, image_size=224, classes=1000, steps=10,
             opt=dict(learning_rate=0.1, momentum=0.9, wd=1e-4,
                      multi_precision=True))
# card (fp32, TF32 off) against the CPU: the ResNet-18 thumbnail's loop
# and examples/dcgan.py's, held by resnet_card_vs_cpu's rule (TOL_RESNET
# relative L2 from a float64 run, or TOL_FLOOR x the CPU fp32 run's own
# distance from it) after each step
GLUON_CHECK = dict(batch=4, image_size=32, classes=10, steps=3,
                   opt=dict(learning_rate=0.1, momentum=0.9, wd=1e-4))
DCGAN = dict(size=16, latent=16, batch=32, iters=3,
             opt=dict(learning_rate=2e-3, beta1=0.5))
# the ops of ops/nn.py beyond the ResNet subset, card against the CPU in
# fp32: relative L2 of the output and of each input's gradient
TOL_OPS_E = 1e-4


def _set_float64(net):
    """Every parameter, its gradient buffer included, as float64 (the
    reference run of a card-vs-CPU check; the port's dtype requests
    narrow 64-bit types, so the tensors are set directly)."""
    for p in net.collect_params().values():
        p._data._set_data(p._data._data.detach().double())
        if p._grad is not None:
            p._grad._data = p._grad._data.double()


def _gluon_clone(mt, make, values, ctx, float64, shape):
    """A new net from ``make`` on ``ctx`` holding ``values`` (numpy, by
    structural name), float64 when asked."""
    import torch
    net = make()
    net.initialize(mt.init.Zero(), ctx=ctx)
    net(mt.nd.zeros(shape, ctx=ctx))
    for name, p in net._collect_params_with_prefix().items():
        t = torch.from_numpy(values[name]).to(ctx.torch_device)
        p.set_data(mt.nd.NDArray(t.double() if float64 else t, ctx))
    if float64:
        _set_float64(net)
    return net


def _params_of(net):
    return {"parameter " + k: p.data()._data.detach().cpu().double()
            for k, p in net._collect_params_with_prefix().items()}


def hold_card(torch, runs, what):
    """``runs`` = {"card", "cpu32", "cpu64"}: per step, {key: tensor}.
    Each key of each step within max(TOL_RESNET, TOL_FLOOR x the CPU fp32
    run's distance from float64) of the float64 run, relative L2; logs
    the worst of each kind and returns the largest card error."""
    worst = {}
    for step, (card, cpu32, cpu64) in enumerate(zip(
            runs["card"], runs["cpu32"], runs["cpu64"])):
        assert sorted(card) == sorted(cpu64)
        for key in cpu64:
            kind = key.split(" ")[0]
            err = rel_l2(card[key], cpu64[key])
            floor = rel_l2(cpu32[key], cpu64[key])
            share = err / max(TOL_RESNET, TOL_FLOOR * floor)
            if kind not in worst or share > worst[kind][0]:
                worst[kind] = (share, step + 1, key, err, floor)
    for kind, (share, step, key, err, floor) in sorted(worst.items()):
        log("%s (%s), worst %s: %s at step %d: card vs float64 rel L2 %.3g, "
            "CPU fp32 vs float64 %.3g; %.3f of its bound max(%g, %g x CPU "
            "fp32's)" % (what, card_line(), kind, key, step, err, floor,
                         share, TOL_RESNET, TOL_FLOOR))
        if not share <= 1.0:
            raise AssertionError("%s: %s differs between the card and the "
                                 "CPU at step %d" % (what, key, step))
    return max(w[3] for w in worst.values())


def gluon_resnet_card_vs_cpu(torch, mt, device, spec=GLUON_CHECK):
    """The ResNet-18 thumbnail, hybridized, ``spec["steps"]`` steps of
    Trainer("sgd") with SoftmaxCrossEntropyLoss on the card, on the CPU
    in fp32 and on the CPU in float64, from the same parameters (Xavier,
    each residual block's last BatchNorm gamma at 0.01: from gammas of 1
    the 3-step trajectory is chaotic, and fp32 rounding alone moves a
    BatchNorm beta by 5%); loss, logits and every parameter after each
    step held by ``hold_card``."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    b, s = spec["batch"], spec["image_size"]
    make = lambda: vision.resnet18_v1(thumbnail=True,
                                      classes=spec["classes"], prefix="r18_")
    shape = (1, 3, s, s)
    with mt.cpu():
        mt.random.seed(5)
        net = make()
        net.initialize(mt.init.Xavier())
        net(mt.nd.zeros(shape))
        for name, p in net._collect_params_with_prefix().items():
            if name.endswith("body.4.gamma"):
                p.set_data(mt.nd.ones(p.shape) * 0.01)
        values = {k: p.data().asnumpy()
                  for k, p in net._collect_params_with_prefix().items()}
    rs = np.random.RandomState(3)
    data = [(rs.uniform(-1, 1, (b, 3, s, s)).astype(np.float32),
             rs.randint(0, spec["classes"], b).astype(np.float32))
            for _ in range(spec["steps"])]

    def run(ctx, float64):
        net = _gluon_clone(mt, make, values, ctx, float64, shape)
        net.hybridize()
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(spec["opt"]))
        loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        out = []
        for x, y in data:
            xt = torch.from_numpy(x).to(ctx.torch_device)
            xn = mt.nd.NDArray(xt.double() if float64 else xt, ctx)
            with mt.autograd.record():
                logits = net(xn)
                loss = loss_fn(logits, mt.nd.array(y, ctx=ctx))
            loss.backward()
            trainer.step(b)
            parts = {"loss": loss._data.detach().cpu().double(),
                     "logits": logits._data.detach().cpu().double()}
            parts.update(_params_of(net))
            out.append(parts)
        return out

    t0 = time.perf_counter()
    runs = {"cpu32": run(mt.cpu(), False)}
    cpu_s = time.perf_counter() - t0
    runs["cpu64"] = run(mt.cpu(), True)
    runs["card"] = run(mt.gpu(0), False)
    err = hold_card(torch, runs, "gluon resnet18 thumbnail, %d Trainer "
                    "steps (sgd, momentum 0.9, wd 1e-4), batch %d x %d^2, "
                    "fp32, TF32 off; %.1f s a run on the CPU"
                    % (spec["steps"], b, s, cpu_s))
    log("gluon resnet18 thumbnail card vs CPU (%s): %d tensors a step "
        "held, largest card error %.3g" % (card_line(), len(runs["card"][0]),
                                           err))
    return err


def dcgan_nets(mt):
    """examples/dcgan.py's generator and discriminator."""
    nn = mt.gluon.nn
    net_g = nn.HybridSequential(prefix="gen_")
    with net_g.name_scope():
        net_g.add(nn.Conv2DTranspose(32, 4, strides=1, padding=0,
                                     use_bias=False), nn.BatchNorm(),
                  nn.Activation("relu"),
                  nn.Conv2DTranspose(16, 4, strides=2, padding=1,
                                     use_bias=False), nn.BatchNorm(),
                  nn.Activation("relu"),
                  nn.Conv2DTranspose(1, 4, strides=2, padding=1,
                                     use_bias=False), nn.Activation("tanh"))
    net_d = nn.HybridSequential(prefix="disc_")
    with net_d.name_scope():
        net_d.add(nn.Conv2D(16, 4, strides=2, padding=1), nn.LeakyReLU(0.2),
                  nn.Conv2D(32, 4, strides=2, padding=1), nn.LeakyReLU(0.2),
                  nn.Conv2D(1, 4, strides=1, padding=0), nn.Flatten())
    return net_g, net_d


def dcgan_real_batch(rs, n, size):
    """examples/dcgan.py's data: a bright gaussian blob near the centre
    on a dark background, in [-1, 1]."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    out = np.empty((n, 1, size, size), np.float32)
    for i in range(n):
        cx = size / 2 + rs.randn() * 1.5
        cy = size / 2 + rs.randn() * 1.5
        sig = 2.5 + rs.rand()
        img = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sig ** 2))
        out[i, 0] = img * 2 - 1
    return out


def dcgan_card_vs_cpu(torch, mt, device, spec=DCGAN):
    """examples/dcgan.py's loop at its own width (16^2 images, a 16-d
    latent, batch 32): ``spec["iters"]`` iterations of a discriminator
    step (real up, fake down) and a generator step through it, Adam with
    beta1 0.5, SigmoidBinaryCrossEntropyLoss; on the card, on the CPU in
    fp32 and in float64 from the same Normal(0.02) parameters; both
    losses and every parameter after each iteration held by
    ``hold_card``."""
    size, latent, b = spec["size"], spec["latent"], spec["batch"]
    shapes = ((1, latent, 1, 1), (1, 1, size, size))
    with mt.cpu():
        mt.random.seed(6)
        nets = dcgan_nets(mt)
        values = []
        for net, shape in zip(nets, shapes):
            net.initialize(mt.init.Normal(0.02))
            net(mt.nd.zeros(shape))
            values.append({k: p.data().asnumpy() for k, p in
                           net._collect_params_with_prefix().items()})
    rs = np.random.RandomState(0)
    data = [(dcgan_real_batch(rs, b, size),
             rs.randn(b, latent, 1, 1).astype(np.float32))
            for _ in range(spec["iters"])]

    def run(ctx, float64):
        cast = (lambda t: t.double()) if float64 else (lambda t: t)
        net_g, net_d = [
            _gluon_clone(mt, (lambda k=k: dcgan_nets(mt)[k]), values[k], ctx,
                         float64, shapes[k]) for k in (0, 1)]
        trainer_g = mt.gluon.Trainer(net_g.collect_params(), "adam",
                                     dict(spec["opt"]))
        trainer_d = mt.gluon.Trainer(net_d.collect_params(), "adam",
                                     dict(spec["opt"]))
        loss_fn = mt.gluon.loss.SigmoidBinaryCrossEntropyLoss()
        ones = mt.nd.ones((b,), ctx=ctx)
        zeros = mt.nd.zeros((b,), ctx=ctx)
        arr = lambda a: mt.nd.NDArray(
            cast(torch.from_numpy(a).to(ctx.torch_device)), ctx)
        out = []
        for real, z in data:
            real, z = arr(real), arr(z)
            with mt.autograd.record():
                out_real = net_d(real).reshape((-1,))
                fake = net_g(z)
                out_fake = net_d(fake.detach()).reshape((-1,))
                loss_d = loss_fn(out_real, ones) + loss_fn(out_fake, zeros)
            loss_d.backward()
            trainer_d.step(b)
            with mt.autograd.record():
                loss_g = loss_fn(net_d(net_g(z)).reshape((-1,)), ones)
            loss_g.backward()
            trainer_g.step(b)
            parts = {"loss D": loss_d._data.detach().cpu().double(),
                     "loss G": loss_g._data.detach().cpu().double()}
            parts.update(_params_of(net_g))
            parts.update(_params_of(net_d))
            out.append(parts)
        return out

    runs = {"cpu32": run(mt.cpu(), False), "cpu64": run(mt.cpu(), True),
            "card": run(mt.gpu(0), False)}
    return hold_card(torch, runs, "dcgan loop, %d iterations of D and G "
                     "(adam, beta1 0.5), batch %d x %d^2, fp32, TF32 off"
                     % (spec["iters"], b, size))


def _u(shape, seed, lo=-1.0, hi=1.0):
    rs = np.random.RandomState(seed)
    return np.asarray(lo + (hi - lo) * rs.rand(*shape), np.float32)


def ops_e_cases():
    """(label, op, [(input, numpy)], attrs, differentiated inputs): the
    ops of ops/nn.py beyond the ResNet subset at small widths."""
    from mxnet_tpu_torch.ops.nn import rnn_param_size
    x = _u((8, 16, 14, 14), 1)
    ctc = _u((40, 8, 21), 2, -2, 2)
    rs = np.random.RandomState(3)
    lab = rs.randint(0, 20, (8, 12)).astype(np.float32)
    lab[:, 9:] = -1
    rois = np.array([[i % 8, 0.4 + i, 1.2, 6.5 + i, 9.4] for i in range(8)],
                    np.float32)
    cases = [("LeakyReLU " + t, "LeakyReLU", [("data", x)] + (
        [("gamma", _u((16,), 4, 0, 0.5))] if t == "prelu" else []),
        dict(act_type=t, slope=0.2), ("data", "gamma"))
        for t in ("leaky", "prelu", "elu", "selu", "gelu", "rrelu")]
    cases += [
        ("LayerNorm", "LayerNorm", [("data", x), ("gamma", _u((14,), 5)),
                                    ("beta", _u((14,), 6))], {},
         ("data", "gamma", "beta")),
        ("GroupNorm", "GroupNorm", [("data", x), ("gamma", _u((16,), 5)),
                                    ("beta", _u((16,), 6))],
         dict(num_groups=4), ("data", "gamma", "beta")),
        ("InstanceNorm", "InstanceNorm", [("data", x),
                                          ("gamma", _u((16,), 5)),
                                          ("beta", _u((16,), 6))], {},
         ("data", "gamma", "beta")),
        ("LRN", "LRN", [("data", x)], dict(nsize=5), ("data",)),
        ("Deconvolution target_shape, 2 groups", "Deconvolution",
         [("data", x), ("weight", _u((16, 4, 4, 4), 7)),
          ("bias", _u((8,), 8))],
         dict(kernel=(4, 4), num_filter=8, num_group=2, stride=(2, 2),
              target_shape=(27, 28), no_bias=False),
         ("data", "weight", "bias")),
        ("LinearRegressionOutput", "LinearRegressionOutput",
         [("data", _u((32, 10), 9)), ("label", _u((32, 10), 10))], {},
         ("data",)),
        ("MAERegressionOutput", "MAERegressionOutput",
         [("data", _u((32, 10), 9)), ("label", _u((32, 10), 10))], {},
         ("data",)),
        ("LogisticRegressionOutput", "LogisticRegressionOutput",
         [("data", _u((32, 10), 9)), ("label", _u((32, 10), 10, 0, 1))], {},
         ("data",)),
        ("SVMOutput", "SVMOutput",
         [("data", _u((32, 10), 9)),
          ("label", (np.arange(32) % 10).astype(np.float32))], {},
         ("data",)),
        ("ROIPooling", "ROIPooling", [("data", x), ("rois", rois)],
         dict(pooled_size=(3, 3), spatial_scale=0.9), ("data",)),
        ("SpatialTransformer", "SpatialTransformer",
         [("data", x), ("loc", np.tile(np.array(
             [[0.93, 0.04, 0.03, -0.05, 1.07, 0.02]], np.float32), (8, 1)))],
         dict(target_shape=(12, 10)), ("data", "loc")),
        ("CTCLoss", "CTCLoss", [("data", ctc), ("label", lab)],
         dict(blank_label="last"), ("data",)),
    ]
    for mode, seed in (("lstm", 11), ("gru", 12)):
        n = rnn_param_size(mode, 2, 32, 64, True)
        cases.append(("RNN %s, 2 layers, bidirectional" % mode, "RNN",
                      [("data", _u((20, 8, 32), seed)),
                       ("parameters", _u((n,), seed + 1, -0.1, 0.1))],
                      dict(state_size=64, num_layers=2, mode=mode,
                           bidirectional=True), ("data", "parameters")))
    return cases


def ops_e_card_vs_cpu(torch, mt, device):
    """Each op of ``ops_e_cases`` forward and backward (a seeded head
    gradient on its first output) on the card and on the CPU in fp32
    (TF32 off; rrelu in inference): the output and the gradient of each
    differentiated input within TOL_OPS_E relative L2."""
    worst = (0.0, "")
    for label, op, inputs, attrs, diff in ops_e_cases():
        res = {}
        for where, ctx in (("cpu", mt.cpu()), ("card", mt.gpu(0))):
            arrs = {k: mt.nd.array(v, ctx=ctx) for k, v in inputs}
            for k in diff:
                if k in arrs:
                    arrs[k].attach_grad()
            with mt.autograd.record(train_mode=op != "LeakyReLU"):
                out = getattr(mt.nd, op)(**arrs, **attrs)
            first = out[0] if isinstance(out, (list, tuple)) else out
            first.backward(mt.nd.array(_u(first.shape, 99, 0.5, 1.5),
                                       ctx=ctx))
            got = {"output": first._data.detach().cpu()}
            got.update(("gradient of " + k, arrs[k].grad._data.cpu())
                       for k in diff if k in arrs)
            res[where] = got
        for key, want in res["cpu"].items():
            err = rel_l2(res["card"][key], want)
            if not bool(torch.isfinite(res["card"][key]).all()) \
                    or not err <= TOL_OPS_E:
                raise AssertionError("%s: %s differs between the card and "
                                     "the CPU (rel L2 %.3g)"
                                     % (label, key, err))
            worst = max(worst, (err, "%s %s" % (label, key)))
    log("ops/nn.py beyond the ResNet subset (%s): %d ops forward and "
        "backward, card vs CPU fp32 within %g relative L2; worst %.3g (%s)"
        % (card_line(), len(ops_e_cases()), TOL_OPS_E, worst[0], worst[1]))
    return worst[0]


def gluon_train(torch, mt, device, bench_step_ms, spec=GLUON):
    """The Gluon loop at bench.py's shape on one seeded batch: ResNet-50
    v1 (Xavier on gpu(0), cast to bf16, hybridized), each step
    ``autograd.record`` of SoftmaxCrossEntropyLoss, ``backward`` and
    ``Trainer.step`` (sgd, fp32 masters). ``spec["steps"]`` steps with a
    finite loss that must fall; logs the step ms (host clock around a
    step ending in a sync, mean of steps 2 on), img/s, peak device memory,
    the host ms of ``trainer.step`` alone and, from a torch.profiler trace
    of one ``trainer.step``, its kernel launches and device ms, beside
    ``entry.build_train_step``'s step ms of this call. Returns what the
    profile needs."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from torch.profiler import ProfilerActivity, profile
    b, s, classes = spec["batch"], spec["image_size"], spec["classes"]
    ctx = mt.gpu(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mt.random.seed(0)
    net = vision.resnet50_v1(classes=classes)
    net.initialize(mt.init.Xavier(), ctx=ctx)
    net.cast("bfloat16")
    net.hybridize()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               dict(spec["opt"]))
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(0)
    x = mt.nd.NDArray(torch.rand((b, 3, s, s), generator=gen, device=device)
                      .to(torch.bfloat16), ctx)
    y = mt.nd.NDArray(torch.randint(0, classes, (b,), generator=gen,
                                    device=device).float(), ctx)
    n_params = sum(1 for p in net.collect_params().values()
                   if p.grad_req != "null")
    step_host = []

    def forward_backward():
        with mt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        return loss

    def one():
        loss = forward_backward()
        t = time.perf_counter()
        trainer.step(b)
        step_host.append(time.perf_counter() - t)
        return loss

    losses, times = [], []
    for _ in range(spec["steps"]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = one()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(loss._data.detach().float().mean()))
    step_ms = 1e3 * sum(times[1:]) / len(times[1:])
    upd_ms = 1e3 * sum(step_host[1:]) / len(step_host[1:])
    peak = torch.cuda.max_memory_allocated()
    # one trainer.step alone under the profiler (CUDA activity)
    forward_backward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad_trace(torch)
        t = time.perf_counter()
        trainer.step(b)
        traced_ms = 1e3 * (time.perf_counter() - t)
        torch.cuda.synchronize()
        pad_trace(torch)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and MARK_KERNEL not in e.key]
    launches = sum(e.count for e in rows)
    upd_dev = sum(e.self_device_time_total for e in rows) / 1e3
    log("gluon resnet50 bf16 train step (%s; batch %d, %d^2, %d classes, "
        "hybridized, Trainer sgd lr %g momentum %g wd %g, fp32 masters): "
        "%.3f ms per step (mean of steps 2-%d; step 1 %.1f ms, build %.1f "
        "s), %.1f img/s, loss %.4f at step 1 -> %.4f at step %d, peak "
        "device memory %.3f GB" % (
            card_line(), b, s, classes, spec["opt"]["learning_rate"],
            spec["opt"]["momentum"], spec["opt"]["wd"], step_ms,
            spec["steps"], 1e3 * times[0], build_s, b / step_ms * 1e3,
            losses[0], losses[-1], spec["steps"], peak / 1e9))
    log("gluon resnet50 trainer.step (%s): host %.3f ms per call (mean of "
        "steps 2-%d; %.3f traced), %d kernel launches and %.3f device ms "
        "in one traced call over %d parameters (%.1f launches each); "
        "entry.build_train_step's step %.3f ms in this call, gluon step / "
        "build_train_step step %.3f" % (
            card_line(), upd_ms, spec["steps"], traced_ms, launches,
            upd_dev, n_params, launches / n_params, bench_step_ms,
            step_ms / bench_step_ms))
    if not all(np.isfinite(losses)):
        raise AssertionError("gluon resnet50 train step: non-finite loss %s"
                             % losses)
    if not losses[-1] < losses[0]:
        raise AssertionError("gluon resnet50 train step: the loss on a "
                             "fixed batch did not fall: %s" % losses)
    return {"step": one, "step_ms": step_ms, "img_s": b / step_ms * 1e3,
            "losses": losses, "peak_bytes": peak,
            "trainer_step_host_ms": upd_ms, "trainer_step_launches": launches,
            "trainer_step_device_ms": upd_dev}


def gluon_train_phase(torch, mt, device, bench_step_ms):
    """The Gluon training loop on the card (Trainer, optimizers, losses,
    the rest of ops/nn.py): the card against the CPU for the ResNet-18
    thumbnail's loop, dcgan's loop and each op beyond the ResNet subset,
    then the loop at bench.py's shape and its profile; returns its
    numbers."""
    out = {"resnet18": gluon_resnet_card_vs_cpu(torch, mt, device),
           "dcgan": dcgan_card_vs_cpu(torch, mt, device),
           "ops": ops_e_card_vs_cpu(torch, mt, device)}
    run = gluon_train(torch, mt, device, bench_step_ms)
    profile_steps(torch, "gluon resnet50 bf16 train step, batch %d x %d^2 "
                  "(%s)" % (GLUON["batch"], GLUON["image_size"], card_line()),
                  run["step"], steps=3, top=12, kinds=RESNET_KINDS,
                  by_op=RESNET_OPS)
    out["train"] = {k: v for k, v in run.items() if k != "step"}
    del run
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ data and IO ---

# bench.py --real-data's leg at its accelerator shape: the ResNet-50 step
# (batch 128, 224^2, 1000 classes, bf16 fold-cast, lr 0.1, momentum 0.9)
# fed by ImageRecordIter (shuffle, random crop, random mirror) from
# max(batch * 4, 64) .npy records of 256^2 x 3, 20 timed steps
IO = dict(batch=128, image_size=224, steps=20)
# the _image_* ops on the card against the same ops on the CPU: one
# seeded HWC float32 image (and an NHWC batch of 4) of IO_IMAGE's shape
IO_IMAGE = (224, 224, 3)
# |card - cpu| <= atol + rtol |cpu|: both compute in fp32 (TF32 off); the
# resize contracts up to a few hundred products in another order, which
# moves an output of ~255 by a few fp32 ulps (2^-24 * 255 * 100 = 1.5e-3
# at the worst); the others are elementwise or 3-term dots
TOL_IMAGE = (1e-4, 1e-5)
# the DataLoader leg: uint8 HWC images through ToTensor + Normalize
IO_LOADER = dict(n=64, hw=224, batch=16, workers=2,
                 mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))


def io_real_data(torch, mt, device, spec=IO):
    """entry.real_data on the card at ``spec``: the loss must be finite
    and the native RecordIO library must be the one that loaded the
    records; the first fed batch must equal, bitwise, the first batch of
    the same iterator built on the CPU from the same file and seed."""
    from mxnet_tpu_torch import entry
    torch.cuda.empty_cache()
    directory = tempfile.mkdtemp(prefix="io_phase_")
    try:
        run = entry.real_data(directory=directory, ctx=mt.gpu(0), **spec)
        if not run["native_read"]:
            raise AssertionError("io: the native RecordIO library did not "
                                 "read the records; they went the Python "
                                 "path")
        np.random.seed(entry.SEED)
        with mt.cpu():
            it = entry.record_iter(os.path.join(directory, "train.rec"),
                                   os.path.join(directory, "train.idx"),
                                   spec["batch"], spec["image_size"])
            cpu_batch = it.next()
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    first = (run.pop("first_data"), run.pop("first_label"))
    if first[0].context != mt.gpu(0):
        raise AssertionError("io: the fed batch is on %s, not the card"
                             % first[0].context)
    for what, card, cpu in zip(("data", "label"), first,
                               (cpu_batch.data[0], cpu_batch.label[0])):
        if not np.array_equal(card.asnumpy(), cpu.asnumpy()):
            raise AssertionError("io: the first fed batch's %s differs "
                                 "from the CPU iterator's" % what)
    if not run["loss_finite"]:
        raise AssertionError("io: real_data's loss is not finite: %s"
                             % run["loss"])
    b = spec["batch"]
    log("io real data (%s; ResNet-50 bf16 fold-cast step, batch %d x "
        "%d^2, ImageRecordIter with shuffle, rand_crop, rand_mirror over "
        "%d .npy records, native scan + read): fed %.1f img/s, synthetic "
        "%.1f img/s, feed-bound fraction %.3f; host ms per fed batch %.1f "
        "(decode/augment/stack/copy in next() %.1f, the step's call %.1f), "
        "synthetic step %.1f ms; records written in %.2f s, loaded in "
        "%.2f s; loss %.4f; first batch bitwise the CPU iterator's"
        % (card_line(), b, spec["image_size"], run["records"],
           run["fed_img_s"], run["syn_img_s"], run["feed_bound_fraction"],
           b / run["fed_img_s"] * 1e3, run["feed_ms"], run["step_ms"],
           run["syn_step_ms"], run["write_s"], run["load_s"], run["loss"]))
    return run


def io_image_ops(torch, mt, device, shape=IO_IMAGE, tol=TOL_IMAGE):
    """Each _image_* op on the card against the same op on the CPU, on
    the same seeded input: the deterministic ops through ``nd`` (resize
    shrinking, enlarging and 2x on uint8, which is exact, nearest), the
    random ops' bodies on one fixed draw, and each random op through
    ``nd`` on the card, whose draw must lie in its range. Returns the
    largest error."""
    from mxnet_tpu_torch.ops import image_ops as io_
    rng = np.random.RandomState(5)
    img = (rng.rand(*shape) * 255).astype(np.float32)
    batch = (rng.rand(4, 32, 48, 3) * 255).astype(np.float32)
    chw = rng.rand(3, 32, 48).astype(np.float32)
    u8 = rng.randint(0, 256, (32, 48, 3)).astype(np.uint8)
    nd = mt.nd
    cases = {
        "to_tensor": (nd.image.to_tensor, (img,), {}),
        "to_tensor NHWC": (nd.image.to_tensor, (batch,), {}),
        "normalize": (nd.image.normalize, (chw,),
                      dict(mean=(0.4, 0.5, 0.6), std=(0.2, 0.3, 0.25))),
        "flip_left_right": (nd.image.flip_left_right, (img,), {}),
        "flip_top_bottom": (nd.image.flip_top_bottom, (batch,), {}),
        "resize shrink": (nd.image.resize, (img,), dict(size=(100, 77))),
        "resize enlarge": (nd.image.resize, (batch,), dict(size=(61, 50))),
        "resize keep_ratio": (nd.image.resize, (img,),
                              dict(size=96, keep_ratio=True)),
        "resize nearest": (nd.image.resize, (img,),
                           dict(size=(50, 61), interp=0)),
        "resize uint8 2x": (nd.image.resize, (u8,), dict(size=(96, 64))),
        "crop": (nd.image.crop, (img,),
                 dict(x0=5, y0=7, width=100, height=80)),
        "adjust_lighting": (nd.image.adjust_lighting, (img,),
                            dict(alpha=(0.1, -0.2, 0.05)))}
    tols = {"float32": tol}
    errs = {}
    for name, (fn, args, kw) in cases.items():
        card = fn(*[nd.array(a, ctx=mt.gpu(0), dtype=a.dtype)
                    for a in args], **kw)._data.cpu()
        with mt.cpu():
            cpu = fn(*[nd.array(a, dtype=a.dtype) for a in args], **kw)._data
        if name == "resize uint8 2x":
            if not torch.equal(card, cpu):
                raise AssertionError("io: %s differs on the card" % name)
            errs[name] = 0.0
            continue
        errs[name] = compare(card, cpu, "float32", "io: _image_" + name,
                             tols)
    x = torch.from_numpy(img)
    bodies = {"brightness": lambda t: io_.brightness_body(t, 1.2),
              "contrast": lambda t: io_.contrast_body(t, 0.8),
              "saturation": lambda t: io_.saturation_body(t, 1.3),
              "hue": lambda t: io_.hue_body(t, 0.1),
              "color_jitter": lambda t: io_.color_jitter_body(
                  t, [1.1, 0.9, 1.2, -0.05], 0.2, 0.2, 0.2, 0.1),
              "flip": lambda t: io_.flip_body(
                  t, torch.tensor(True, device=t.device), -2)}
    for name, body in bodies.items():
        errs[name + " body"] = compare(body(x.to(device)).cpu(), body(x),
                                       "float32", "io: the %s body" % name,
                                       tols)
    xd = nd.array(img, ctx=mt.gpu(0))
    for name, kw, lo, hi in (
            ("random_brightness", dict(max_brightness=0.3), 0.7, 1.3),
            ("random_contrast", dict(max_contrast=0.3), None, None),
            ("random_saturation", dict(max_saturation=0.3), None, None),
            ("random_hue", dict(max_hue=0.1), None, None),
            ("random_color_jitter", dict(brightness=0.2, contrast=0.2,
                                         saturation=0.2, hue=0.1),
             None, None),
            ("random_lighting", dict(alpha_std=0.05), None, None),
            ("random_flip_left_right", {}, None, None),
            ("random_flip_top_bottom", {}, None, None)):
        out = getattr(nd.image, name)(xd, **kw)
        got = out.asnumpy()
        if got.shape != img.shape or not np.isfinite(got).all():
            raise AssertionError("io: _image_%s on the card gave %s"
                                 % (name, got.shape))
        if lo is not None:
            ratio = float(got.sum() / img.sum())
            if not lo - 1e-4 <= ratio <= hi + 1e-4:
                raise AssertionError("io: _image_%s drew %.4f outside "
                                     "[%g, %g]" % (name, ratio, lo, hi))
    log("io _image_* ops on the card against the CPU (%d deterministic "
        "cases, %d random bodies on a fixed draw; atol %g, rtol %g): max "
        "abs error %.3g (%s); the 8 random ops ran on the card's generator"
        % (len(cases), len(bodies), tol[0], tol[1], max(errs.values()),
           max(errs, key=errs.get)))
    return max(errs.values())


def io_loader(torch, mt, device, spec=IO_LOADER):
    """DataLoader over an ArrayDataset of seeded uint8 HWC images through
    Compose([ToTensor(), Normalize(...)]) onto the card: the process pool
    (``workers`` spawned workers, pinned memory) and the thread pool must
    give the serial loader's batches bitwise, on the card. Returns the
    seconds of each."""
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.gluon.data.vision import transforms
    rng = np.random.RandomState(9)
    n, hw = spec["n"], spec["hw"]
    imgs = rng.randint(0, 256, (n, hw, hw, 3)).astype(np.uint8)
    labels = rng.randint(0, 1000, n).astype(np.float32)
    aug = transforms.Compose([transforms.ToTensor(),
                              transforms.Normalize(spec["mean"],
                                                   spec["std"])])
    ds = ArrayDataset(imgs, labels).transform_first(aug)
    runs, secs = {}, {}
    for name, kw in (("serial", {}),
                     ("threads", dict(num_workers=spec["workers"],
                                      thread_pool=True)),
                     ("processes", dict(num_workers=spec["workers"],
                                        pin_memory=True))):
        loader = DataLoader(ds, batch_size=spec["batch"], **kw)
        t = time.perf_counter()
        runs[name] = list(loader)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        del loader
    for name in ("threads", "processes"):
        if len(runs[name]) != len(runs["serial"]):
            raise AssertionError("io: the %s loader gave %d batches, the "
                                 "serial one %d" % (name, len(runs[name]),
                                                    len(runs["serial"])))
        for got, want in zip(runs[name], runs["serial"]):
            for g, w in zip(got, want):
                if g.context != mt.gpu(0) or \
                        not np.array_equal(g.asnumpy(), w.asnumpy()):
                    raise AssertionError("io: the %s loader's batch differs "
                                         "from the serial one's" % name)
    log("io DataLoader (%s; %d uint8 %d^2 images, batch %d, ToTensor + "
        "Normalize): serial %.2f s, %d threads %.2f s, %d spawned "
        "processes with pinned memory %.2f s (their start included); "
        "every batch on the card, bitwise the serial loader's"
        % (card_line(), n, hw, spec["batch"], secs["serial"],
           spec["workers"], secs["threads"], spec["workers"],
           secs["processes"]))
    return secs


def io_phase(torch, mt, device):
    """Data and IO on the card (``io``, ``recordio`` with ``_native``,
    ``image``'s ops, ``gluon.data``, ``entry.real_data``): bench.py's
    --real-data leg, the _image_* ops against the CPU and the three
    DataLoader tiers; returns their numbers. ``image.ImageIter`` and
    ``ImageDetIter`` decode JPEG through cv2, which the card's machine
    lacks: they are held against the JAX package on the CPU only."""
    out = {"real_data": io_real_data(torch, mt, device),
           "image_ops_err": io_image_ops(torch, mt, device),
           "loader_s": io_loader(torch, mt, device)}
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------- kvstore and Module ---

# train_imagenet.py --benchmark 1 at its defaults (common.fit): ResNet-50
# v1 (the example's symbol), 1000 classes, 3 x 224^2, batch 128, float32,
# disp_batches 20, one epoch of disp_batches + 4 = 24 batches; img/s and
# host ms over batches 4-24 (the first three build and warm cuDNN)
MODULE_FIT = dict(batch=128, image_size=224, num_layers=50, classes=1000,
                  disp_batches=20, first=3)
MODULE_STORES = ("device", "dist_sync")
MODULE_GATE_UPDATES = 3
# the example's CIFAR branch (resnet.py:57): ResNet-18 at 3 x 32^2, two
# batches, fp32 on the card and on the CPU from the same arg_params: the
# recipe's Xavier draw with each unit's bn2 gamma at 0.01 (from Xavier's
# gammas of 1 two SGD steps at lr 0.1 are chaotic: a 1e-7 perturbation
# of the start moves the result by ~1e-3, 1.2e-5 with the damping; the
# gluon card-vs-CPU checks damp the same way). The parameters' change
# over the two updates is compared (the parameters themselves are
# dominated by their start): |card - cpu| / |cpu - start|, relative L2
# over all parameters, with the convolutions' and reductions' order the
# only difference (TF32 off)
MODULE_CHECK = dict(batch=16, image_size=32, num_layers=18, classes=10,
                    num_batches=2)
TOL_MODULE_FIT = 1e-3
# score/predict: an 8-batch iterator on the fitted ResNet-18 module
MODULE_SCORE_BATCHES = 8
# the metrics on card tensors against the same metrics on the CPU and
# against counts known from how the inputs were made: 128 rows of 1000
# class scores drawn on the host, the label's rank set per row (a quarter
# first, a quarter second to fifth, the rest beyond), every eighth row an
# exact tie at the label's score (at rank 0 or 4 in half of them, where
# the tie decides the hit); counts exact, cross-entropy (a sum of 128
# logs in fp32, every label's probability at least 2e-6, far above the
# metric's 1e-12 clip) within 1e-5 relative
METRIC_ROWS, METRIC_CLASSES = 128, 1000
TOL_METRIC = 1e-5
# 2-bit compression's threshold: the 90th percentile of the gradients'
# magnitudes, so that about a fifth of the codes are not 00
COMPRESS_QUANTILE = 0.9


class _HostTimes(object):
    """Host ms of Module's forward_backward, update and update_metric for
    each call, by patching the class for the length of a ``with``."""

    NAMES = ("forward_backward", "update", "update_metric")

    def __init__(self, cls):
        self.cls, self.ms = cls, {n: [] for n in self.NAMES}

    def __enter__(self):
        self.own = {n: n in vars(self.cls) for n in self.NAMES}
        self.saved = {n: getattr(self.cls, n) for n in self.NAMES}
        for name, fn in self.saved.items():
            def timed(mod, *a, _fn=fn, _name=name, **k):
                t = time.perf_counter()
                out = _fn(mod, *a, **k)
                self.ms[_name].append(1e3 * (time.perf_counter() - t))
                return out
            setattr(self.cls, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            if self.own[name]:
                setattr(self.cls, name, fn)
            else:
                delattr(self.cls, name)


def module_fit_run(torch, mt, ctx, train, kv_store, spec=MODULE_FIT):
    """``entry.module_fit`` once at ``spec``'s width through ``kv_store``
    (a name, as Module's ``_create_kvstore`` sees it): img/s over batches
    first+1..end on the host clock that Speedometer reads (time.time()
    at each batch's end, after update_metric's fetch has synced the
    host), the host ms of each batch's forward_backward, update() and
    update_metric, the store's dispatch_stats and the epoch's train
    accuracy."""
    from mxnet_tpu_torch import entry
    ends, acc = {}, []

    def clock(param):
        ends[param.nbatch] = time.time()
        acc[:] = param.eval_metric.get_global_name_value()

    np.random.seed(0)
    mt.random.seed(0)
    train.reset()
    t0 = time.perf_counter()
    with _HostTimes(mt.module.Module) as times:
        mod = entry.module_fit(
            batch=spec["batch"], image_size=spec["image_size"],
            num_layers=spec["num_layers"], classes=spec["classes"],
            kv_store=kv_store, disp_batches=spec["disp_batches"], ctx=ctx,
            train=train, batch_end_callback=[clock])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    first, last = spec["first"], max(ends)
    img_s = spec["batch"] * (last - first) / (ends[last] - ends[first])
    host = {n: float(np.mean(v[first + 1:])) for n, v in times.ms.items()}
    kv = mod._kvstore
    stats = dict(kv.dispatch_stats) if kv is not None else None
    log("module_fit resnet%d (%s): kv_store %r -> %s, update_on_kvstore %s; "
        "batch %d x %d^2, %d classes, fp32, %d batches in %.1f s: %.1f img/s "
        "over batches %d-%d (Speedometer's clock); host ms a batch: "
        "forward_backward %.3f, update() %.3f, update_metric %.3f; "
        "dispatch_stats %s; train %s" % (
            spec["num_layers"], card_line(), kv_store,
            type(kv).__name__ if kv is not None else "no store",
            mod._update_on_kvstore, spec["batch"], spec["image_size"],
            spec["classes"], last + 1, fit_s, img_s, first + 2, last + 1,
            host["forward_backward"], host["update"], host["update_metric"],
            stats, acc))
    if not acc or not np.isfinite(acc[0][1]):
        raise AssertionError("module_fit %s: no finite train accuracy %s"
                             % (kv_store, acc))
    if kv_store == "dist_sync":
        n = last + 1
        keys = len(mod._param_names)
        if kv is None or not mod._update_on_kvstore \
                or stats["keys"] != keys * n \
                or stats["buckets"] != stats["collectives"] \
                or stats["buckets"] % n or stats["shard_updates"]:
            raise AssertionError("module_fit dist_sync: the store's route "
                                 "was not the fused update on the store: "
                                 "%s" % stats)
    elif kv is not None or mod._update_on_kvstore:
        raise AssertionError("module_fit %s: one context should make no "
                             "store" % kv_store)
    return mod, {"img_s": img_s, "host_ms": host, "dispatch_stats": stats,
                 "train": acc, "fit_s": fit_s}


def _snapshot(torch, mod):
    """(weights, grads, aux) of a bound Module, as tensor clones."""
    ex = mod._exec
    return ({n: ex.arg_dict[n]._data.detach().clone()
             for n in mod._param_names},
            {n: ex.grad_dict[n]._data.detach().clone()
             for n in mod._param_names if n in ex.grad_dict},
            {n: v._data.detach().clone() for n, v in ex.aux_dict.items()})


def module_store_gate(torch, mt, mod, snap, opt_params,
                      updates=MODULE_GATE_UPDATES):
    """From one snapshot of weights and one set of gradients, Module's
    update() through the dist store (update_on_kvstore, pushpull_fused)
    and through the local updater: bitwise equal weights and momenta
    after ``updates`` updates."""
    weights, grads, aux = snap
    nd, ctx = mt.nd, mod._context[0]
    out = {}
    for route in ("local", "dist_sync"):
        mod.set_params({n: nd.NDArray(t.clone(), ctx)
                        for n, t in weights.items()},
                       {n: nd.NDArray(t.clone(), ctx)
                        for n, t in aux.items()})
        kv = None if route == "local" else mt.kvstore.create("dist_sync")
        mod.init_optimizer(kvstore=kv, optimizer="sgd",
                           optimizer_params=opt_params, force_init=True)
        for _ in range(updates):
            for n, g in grads.items():
                mod._exec.grad_dict[n]._set_data(g.clone())
            mod.update()
        updater = mod._updater if route == "local" \
            else mod._kvstore._updater
        assert mod._update_on_kvstore == (route != "local")
        out[route] = ({n: mod._exec.arg_dict[n]._data.clone()
                       for n in weights},
                      {i: s._data.clone()
                       for i, s in updater.states.items()})
    (w0, m0), (w1, m1) = out["local"], out["dist_sync"]
    same = all(torch.equal(w0[n], w1[n]) for n in w0) \
        and sorted(m0) == sorted(m1) \
        and all(torch.equal(m0[i], m1[i]) for i in m0)
    log("module store gate (%s): %d updates of %d parameters from one "
        "snapshot: the dist store's fused update on the store vs the local "
        "updater, weights and momenta bitwise equal: %s"
        % (card_line(), updates, len(w0), same))
    if not same:
        raise AssertionError("Module: the store's update differs from the "
                             "local updater's")
    return same


def trainer_store_gate(torch, mt, device, spec=GLUON,
                       updates=MODULE_GATE_UPDATES):
    """gluon_train's ResNet-50 step (bf16, hybridized, sgd with fp32
    masters): from one snapshot of parameters and one set of gradients,
    Trainer(kvstore="device"), whose step goes through the store's
    pushpull_fused, against Trainer(kvstore=None): bitwise equal
    parameters and optimizer states after ``updates`` steps."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    b, s, classes = spec["batch"], spec["image_size"], spec["classes"]
    ctx = mt.gpu(0)
    mt.random.seed(0)
    net = vision.resnet50_v1(classes=classes)
    net.initialize(mt.init.Xavier(), ctx=ctx)
    net.cast("bfloat16")
    net.hybridize()
    gen = torch.Generator(device=device).manual_seed(0)
    x = mt.nd.NDArray(torch.rand((b, 3, s, s), generator=gen, device=device)
                      .to(torch.bfloat16), ctx)
    y = mt.nd.NDArray(torch.randint(0, classes, (b,), generator=gen,
                                    device=device).float(), ctx)
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    with mt.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    params = net.collect_params()
    train = [p for p in params.values() if p.grad_req != "null"]
    w0 = {p.name: p.data()._data.detach().clone() for p in params.values()}
    g0 = {p.name: p.grad()._data.detach().clone() for p in train}
    out = {}
    for kv in (None, "device"):
        for p in params.values():
            p.set_data(mt.nd.NDArray(w0[p.name].clone(), ctx))
        trainer = mt.gluon.Trainer(params, "sgd", dict(spec["opt"]),
                                   kvstore=kv)
        for _ in range(updates):
            for p in train:
                p.grad()._set_data(g0[p.name].clone())
                p.data()._fresh_grad = True
            trainer.step(b)
        states = trainer._updaters[0].states

        def flat(state):
            if state is None:
                return []
            if isinstance(state, (list, tuple)):
                return [t for s_ in state for t in flat(s_)]
            return [state._data.clone()]
        out[kv] = ({p.name: p.data()._data.detach().clone()
                    for p in params.values()},
                   {i: flat(st) for i, st in states.items()},
                   trainer._kvstore)
    (wa, sa, _), (wb, sb, store) = out[None], out["device"]
    same = all(torch.equal(wa[n], wb[n]) for n in wa) \
        and sorted(sa) == sorted(sb) \
        and all(len(sa[i]) == len(sb[i])
                and all(torch.equal(u, v) for u, v in zip(sa[i], sb[i]))
                for i in sa)
    stats = dict(store.dispatch_stats)
    log("gluon trainer store gate (%s): resnet50 bf16, %d steps from one "
        "snapshot: Trainer(kvstore='device') through pushpull_fused "
        "(dispatch_stats %s) vs Trainer(kvstore=None), parameters and "
        "states bitwise equal: %s" % (card_line(), updates, stats, same))
    if not same or stats["keys"] != updates * len(train) \
            or not stats["buckets"]:
        raise AssertionError("Trainer: the store's step differs from the "
                             "local one (%s)" % stats)
    return same


def module_check_start(mt, spec, shape):
    """The ResNet-18 thumbnail's starting arg_params and aux_params, drawn
    once on the CPU by the recipe's Xavier, each unit's bn2 gamma then set
    to 0.01."""
    from mxnet_tpu_torch.symbols import resnet
    with mt.cpu():
        mt.random.seed(1)
        probe = mt.mod.Module(resnet.get_symbol(
            spec["classes"], spec["num_layers"], shape), context=mt.cpu())
        probe.bind([("data", (spec["batch"],) + shape)],
                   [("softmax_label", (spec["batch"],))])
        probe.init_params(mt.init.Xavier(rnd_type="gaussian",
                                         factor_type="in", magnitude=2))
        arg, aux = probe.get_params()
        start = {k: v.asnumpy() * (0.0 if k.endswith("_bn2_gamma") else 1.0)
                 + (0.01 if k.endswith("_bn2_gamma") else 0.0)
                 for k, v in arg.items()}
        start_aux = {k: v.asnumpy() for k, v in aux.items()}
    return start, start_aux


def module_card_vs_cpu(torch, mt, spec=MODULE_CHECK, tol=TOL_MODULE_FIT):
    """entry.module_fit on the example's ResNet-18 CIFAR branch, two
    batches, fp32, on the card and on the CPU from the same arg_params
    (drawn once on the CPU by the recipe's Xavier, each unit's bn2 gamma
    then set to 0.01) and the same data order: the parameters' change,
    the auxiliary states' change (each BatchNorm's moving mean and
    variance) and the fitted modules' eval-mode outputs on one batch each
    within ``tol`` relative L2 of the CPU's. Returns the fitted card
    module and the three errors."""
    from mxnet_tpu_torch import entry
    shape = (3, spec["image_size"], spec["image_size"])
    start, start_aux = module_check_start(mt, spec, shape)
    x = np.random.RandomState(5).uniform(
        -1, 1, (spec["batch"],) + shape).astype(np.float32)
    got = {}
    for key, ctx in (("cpu", mt.cpu()), ("card", mt.gpu(0))):
        with ctx:
            np.random.seed(0)
            train = entry.synthetic_iter(spec["classes"], shape,
                                         spec["batch"],
                                         num_batches=spec["num_batches"])
            mod = entry.module_fit(
                batch=spec["batch"], image_size=spec["image_size"],
                num_layers=spec["num_layers"], classes=spec["classes"],
                kv_store="device", ctx=ctx, train=train,
                arg_params={k: mt.nd.array(v) for k, v in start.items()},
                aux_params={k: mt.nd.array(v)
                            for k, v in start_aux.items()})
            mod.forward(mt.io.DataBatch([mt.nd.array(x, ctx=ctx)], None),
                        is_train=False)
            probs = mod.get_outputs()[0].asnumpy().astype(np.float64)
        arg_f, aux_f = ({k: v.asnumpy().astype(np.float64)
                         for k, v in p.items()} for p in mod.get_params())
        got[key] = (arg_f, aux_f, probs, mod)

    def change(a, b, start):
        diff = np.sqrt(sum(((a[k] - b[k]) ** 2).sum() for k in b))
        moved = np.sqrt(sum(((b[k] - start[k]) ** 2).sum() for k in b))
        return float(diff / moved), float(moved)
    card, cpu = got["card"], got["cpu"]
    err, moved = change(card[0], cpu[0], start)
    err_aux, moved_aux = change(card[1], cpu[1], start_aux)
    err_out = float(np.linalg.norm(card[2] - cpu[2])
                    / np.linalg.norm(cpu[2]))
    log("module_fit resnet%d card vs cpu (%s): %d x %d^2, %d batches, fp32 "
        "from the same arg_params: relative L2 of the parameters' change "
        "%.3g (the CPU fit moved them by %.4g), of the %d moving means' "
        "and variances' change %.3g (moved by %.4g), of the eval-mode "
        "outputs on one batch %.3g (largest probability %.4f); limit %g"
        % (spec["num_layers"], card_line(), spec["batch"],
           spec["image_size"], spec["num_batches"], err, moved,
           len(cpu[1]), err_aux, moved_aux, err_out, cpu[2].max(), tol))
    if not (err <= tol and err_aux <= tol and err_out <= tol) \
            or sorted(card[1]) != sorted(cpu[1]):
        raise AssertionError("module_fit: the card's fit differs from the "
                             "CPU's by %.3g, %.3g, %.3g"
                             % (err, err_aux, err_out))
    return card[3], {"params": err, "aux": err_aux, "outputs": err_out}


def module_score_predict(torch, mt, mod, spec=MODULE_CHECK,
                         batches=MODULE_SCORE_BATCHES):
    """score() and predict() of the fitted card module over an 8-batch
    iterator against its own forward() over the same batches: the same
    outputs bitwise and the same accuracy."""
    from mxnet_tpu_torch import entry
    shape = (3, spec["image_size"], spec["image_size"])
    ctx = mod._context[0]
    with ctx:
        it = entry.synthetic_iter(spec["classes"], shape, spec["batch"],
                                  num_batches=batches, seed=1)
        it.shuffle = False
        it.idx = np.arange(it.num_data)
        outs, labels = [], []
        for batch in it:
            mod.forward(batch, is_train=False)
            outs.append(mod.get_outputs()[0]._data.clone())
            labels.append(batch.label[0]._data.clone())
        fwd = torch.cat(outs)
        pred = mod.predict(it)._data
        acc = dict(mod.score(it, "acc"))["accuracy"]
    hits = int((fwd.argmax(1).to(torch.int32)
                == torch.cat(labels).to(torch.int32)).sum())
    want = hits / fwd.shape[0]
    same = torch.equal(pred, fwd)
    log("module score/predict (%s): %d batches of %d: predict() bitwise "
        "the module's forward(): %s; score() accuracy %.6f, forward's %.6f"
        % (card_line(), batches, spec["batch"], same, acc, want))
    if not same or acc != want:
        raise AssertionError("Module: score/predict differ from forward")
    return acc


def module_compression(torch, mt, grads):
    """The store's 2-bit compressed push on ResNet-50's gradients, twice
    (the second push carries the first's residuals), on the card and on
    the CPU: the packed words of the largest key, every residual and
    every stored aggregate bitwise the CPU's."""
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    t = float(torch.quantile(flat.abs()[::max(1, flat.numel() // 1000000)]
                             .float(), COMPRESS_QUANTILE))
    keys = list(range(len(grads)))
    largest = max(grads.values(), key=lambda g: g.numel())
    got = {}
    for key, ctx in (("card", mt.gpu(0)), ("cpu", mt.cpu())):
        dev = ctx.torch_device
        kv = mt.kvstore.create("device")
        kv.set_gradient_compression({"type": "2bit", "threshold": t})
        vals = [mt.nd.NDArray(g.to(dev), ctx) for g in grads.values()]
        for _ in range(2):
            kv.pushpull_fused(keys, vals)
        first = largest.to(dev).reshape(-1)
        words, _ = kv.gradient_compression.quantize(
            first, torch.zeros_like(first))
        got[key] = (words.cpu(),
                    {k: r.cpu() for k, r in kv._residuals.items()},
                    {k: v._data.cpu() for k, v in kv._store.items()})
    (wa, ra, sa), (wb, rb, sb) = got["card"], got["cpu"]
    same = torch.equal(wa, wb) and sorted(ra) == sorted(rb) \
        and all(torch.equal(ra[k], rb[k]) for k in ra) \
        and all(torch.equal(sa[k], sb[k]) for k in sa)
    codes = int(((wb.numpy().view(np.uint32)[:, None]
                  >> np.arange(30, -1, -2, dtype=np.uint32)) & 3)
                .astype(bool).sum())
    log("2-bit compression on the card (%s): %d keys, %d values, threshold "
        "%.4g; two pushes: words (of the largest key), residuals and "
        "aggregates bitwise the CPU's: %s (%d of that key's %d codes not "
        "00)" % (card_line(), len(keys), flat.numel(), t, same, codes,
                 largest.numel()))
    if not same:
        raise AssertionError("2-bit compression differs between the card "
                             "and the CPU")
    return same


def metric_inputs(n=METRIC_ROWS, classes=METRIC_CLASSES, seed=4):
    """Scores, labels and a binary head made on the host (numpy), with
    the counts that Accuracy, TopK (5) and F1 must find in them, worked
    out in numpy: the rank order is a stable sort of the negated scores,
    so a tie ranks the lower index first, as lax.top_k does."""
    rng = np.random.RandomState(seed)
    rows = np.arange(n)
    # distinct scores in each row: a permutation of 1..classes
    score = (np.argsort(rng.rand(n, classes), axis=1) + 1).astype(np.float64)
    labels = rng.randint(0, classes, n)
    rank = np.concatenate([np.zeros(n // 4, np.int64),
                           rng.randint(1, 5, n // 4),
                           rng.randint(5, classes - 1, n - n // 2)])
    rng.shuffle(rank)
    tie = rows % 8 == 0
    rank[rows % 16 == 0], rank[rows % 16 == 8] = 0, 4
    # swap the label's score with the one at its chosen rank
    at = np.argsort(-score, axis=1)[rows, rank]
    mine = score[rows, labels].copy()
    score[rows, labels] = score[rows, at]
    score[rows, at] = mine
    # a tie: the next rank's column takes the label's score
    nxt = np.argsort(-score, axis=1)[rows, rank + 1]
    score[tie, nxt[tie]] = score[tie, labels[tie]]
    probs = (score / score.sum(axis=1, keepdims=True)).astype(np.float32)
    order = np.argsort(-probs, axis=1, kind="stable")
    top1 = int((order[:, 0] == labels).sum())
    top5 = int((order[:, :5] == labels[:, None]).any(axis=1).sum())
    head = rng.randn(n, 2).astype(np.float32)
    bits = labels % 2
    hard = head.argmax(axis=1).astype(bool)
    truth = bits.astype(bool)
    counts = [int((hard & truth).sum()), int((hard & ~truth).sum()),
              int((~hard & truth).sum()), int((~hard & ~truth).sum())]
    ce = float(-np.log(probs[rows, labels].astype(np.float64)).sum())
    return (probs, labels.astype(np.float32), head, bits.astype(np.float32),
            {"acc": top1, "top_k": top5, "f1": counts, "ce": ce,
             "ties": int(tie.sum())})


def module_metrics(torch, mt, tol=TOL_METRIC):
    """Accuracy, TopK (5), F1 and CrossEntropy on card tensors against
    the CPU's and against the counts ``metric_inputs`` made its inputs
    with: counts exact, the cross-entropy within ``tol`` relative."""
    probs, labels, head, bits, want = metric_inputs()
    got = {}
    for key, ctx in (("card", mt.gpu(0)), ("cpu", mt.cpu())):
        def nd(a, ctx=ctx):
            return mt.nd.NDArray(torch.from_numpy(a).to(ctx.torch_device),
                                 ctx)
        row = {}
        for name, metric, lab, pred in (
                ("acc", mt.metric.Accuracy(), labels, probs),
                ("top_k", mt.metric.TopKAccuracy(top_k=5), labels, probs),
                ("f1", mt.metric.F1(average="micro"), bits, head),
                ("ce", mt.metric.CrossEntropy(), labels, probs)):
            metric.update([nd(lab)], [nd(pred)])
            counts = getattr(metric, "_counts", None)
            row[name] = (metric.sum_metric, metric.num_inst,
                         None if counts is None else
                         [int(c) for c in counts])
        got[key] = row
    card, cpu = got["card"], got["cpu"]
    n = labels.shape[0]
    exact = all(card[m] == cpu[m] for m in ("acc", "top_k", "f1")) \
        and card["acc"][:2] == (want["acc"], n) \
        and card["top_k"][:2] == (want["top_k"], n) \
        and card["f1"][2] == want["f1"]
    ce = abs(card["ce"][0] - cpu["ce"][0]) / abs(cpu["ce"][0])
    ce_want = abs(card["ce"][0] - want["ce"]) / want["ce"]
    log("metrics on the card (%s): %d rows of %d classes made on the host, "
        "%d exact ties; accuracy, top-5 and F1 counts equal to the CPU's "
        "and to the made ones: %s (card: acc %s, top-5 %s, F1 %s; CPU: %s, "
        "%s, %s; made: %d, %d, %s); cross-entropy %.9g vs the CPU's %.9g, "
        "relative %.3g, vs float64 %.9g, relative %.3g (limit %g)" % (
            card_line(), n, probs.shape[1], want["ties"], exact,
            card["acc"][:2], card["top_k"][:2], card["f1"][2],
            cpu["acc"][:2], cpu["top_k"][:2], cpu["f1"][2], want["acc"],
            want["top_k"], want["f1"], card["ce"][0], cpu["ce"][0], ce,
            want["ce"], ce_want, tol))
    if not exact or not ce <= tol or not ce_want <= tol \
            or card["ce"][1] != cpu["ce"][1]:
        raise AssertionError("metrics differ between the card, the CPU and "
                             "the made counts")
    return ce


def module_checkpoint(torch, mt, mod):
    """do_checkpoint at epoch 1, model.load_checkpoint and Module.load of
    the saved files: the same parameters and auxiliary states, bitwise."""
    import tempfile
    arg, aux = mod.get_params()
    with tempfile.TemporaryDirectory() as tmp, mod._context[0]:
        prefix = os.path.join(tmp, "resnet")
        mt.callback.do_checkpoint(prefix)(0, mod.symbol, arg, aux)
        sym, arg2, aux2 = mt.model.load_checkpoint(prefix, 1)
        back = mt.mod.Module.load(prefix, 1, context=mod._context[0])
        back.bind(mod.data_shapes, mod.label_shapes, for_training=False)
        arg3, aux3 = back.get_params()
        nbytes = os.path.getsize(prefix + "-0001.params")
    same = sym.tojson() == mod.symbol.tojson() and all(
        np.array_equal(a[k].asnumpy(), b[k].asnumpy())
        for a, b in ((arg, arg2), (arg, arg3), (aux, aux2), (aux, aux3))
        for k in a)
    log("module checkpoint (%s): do_checkpoint at epoch 1 (%d bytes), "
        "load_checkpoint and Module.load give the same symbol and "
        "parameters bitwise: %s" % (card_line(), nbytes, same))
    if not same:
        raise AssertionError("Module: the checkpoint round trip differs")
    return same


def module_phase(torch, mt, device, spec=MODULE_FIT):
    """The kvstore stack and the Module front end on the card
    (``kvstore``, ``gradient_compression``, fusion's store half, the
    Trainer's store path, ``module``, ``model``, ``metric``,
    ``callback``; no hand kernel): train_imagenet.py's Module.fit through
    no store and through the dist store, paired in this call; the store's
    update bitwise the local updater's for Module and for the Gluon
    Trainer; the ResNet-18 fit on the card against the CPU's; score and
    predict; the 2-bit compression and the metrics against the CPU's; a
    checkpoint round trip. Returns the numbers."""
    from mxnet_tpu_torch import entry
    ctx = mt.gpu(0)
    t0 = time.perf_counter()
    before = collections.Counter(mt.kernels.launches)
    shape = (3, spec["image_size"], spec["image_size"])
    with ctx:
        train = entry.synthetic_iter(spec["classes"], shape, spec["batch"],
                                     num_batches=spec["disp_batches"] + 4)
    log("module_fit data (train_imagenet.py --benchmark 1): %d x %s float32 "
        "made on the host in %.1f s" % (train.num_data, shape,
                                       time.perf_counter() - t0))
    out = {}
    for kv_store in MODULE_STORES:
        torch.cuda.empty_cache()
        mod, out[kv_store] = module_fit_run(torch, mt, ctx, train, kv_store,
                                            spec)
        if kv_store != MODULE_STORES[-1]:
            del mod
    del train
    # one resident batch: the fit's step without the iterator, traced
    batch = mt.io.DataBatch(
        [mt.nd.NDArray(torch.rand((spec["batch"],) + shape, device=device,
                                  generator=torch.Generator(device=device)
                                  .manual_seed(2)) * 2 - 1, ctx)],
        [mt.nd.NDArray(torch.arange(spec["batch"], device=device).float(),
                       ctx)])
    metric = mt.metric.create("acc")

    def fit_step():
        mod.forward_backward(batch)
        mod.update()
        mod.update_metric(metric, batch.label)

    profile_steps(torch, "module_fit resnet%d fp32 step through dist_sync, "
                  "batch %d x %d^2 resident (%s)" % (
                      spec["num_layers"], spec["batch"], spec["image_size"],
                      card_line()), fit_step, steps=3, top=8,
                  kinds=RESNET_KINDS)
    snap = _snapshot(torch, mod)
    out["checkpoint"] = module_checkpoint(torch, mt, mod)
    out["store_gate"] = module_store_gate(
        torch, mt, mod, snap, {"learning_rate": 0.1, "momentum": 0.9,
                               "wd": 1e-4})
    out["compression"] = module_compression(torch, mt, snap[1])
    del mod, snap
    torch.cuda.empty_cache()
    out["metric_ce_rel"] = module_metrics(torch, mt)
    out["trainer_gate"] = trainer_store_gate(torch, mt, device)
    torch.cuda.empty_cache()
    small, out["card_vs_cpu"] = module_card_vs_cpu(torch, mt)
    out["score_acc"] = module_score_predict(torch, mt, small)
    del small
    torch.cuda.empty_cache()
    launched = collections.Counter(mt.kernels.launches)
    launched.subtract(before)
    out["launches"] = {k: v for k, v in launched.items() if v}
    log("module phase (%s): %.1f s; img/s no store %.1f, dist_sync %.1f "
        "(dist_sync / no store %.3f); hand-kernel launches %s (the path "
        "runs none)" % (
            card_line(), time.perf_counter() - t0,
            out["device"]["img_s"], out["dist_sync"]["img_s"],
            out["dist_sync"]["img_s"] / out["device"]["img_s"],
            out["launches"]))
    if out["launches"]:
        raise AssertionError("module phase: a hand kernel ran on a path "
                             "that has none: %s" % out["launches"])
    return out


# ------------------------------------------------------- elastic worlds ---

# the training flagship under the port's elastic launcher: bf16, lr 1e-2,
# entry.elastic_tokens' 64 x 1024 rows from RandomState(7), 8 global rows a
# step; generation 0 is a world of 2 whose rank 1 never starts (the
# simulated peer), rank 0 the card process
ELASTIC = dict(steps=8, lr=1e-2, heartbeat_s=0.5, miss=3, world=2,
               timeout=240)
ELASTIC_ROWS_PER_STEP = 8
# the in-process capture under a wedged compute stream
ELASTIC_WEDGE_S = 20.0
ELASTIC_CAPTURE_LIMIT_S = 10.0
ELASTIC_WEDGE_STEPS = 3            # completed steps before the wedge
ELASTIC_SPIN_PROBE = 10 ** 8       # cycles of the spin kernel's calibration
ELASTIC_RESHARD_WORLD = 4
# examples/model_parallel/matrix_factorization.py's defaults
MF = dict(num_users=200, num_items=100, factor_size=8, batch_size=64,
          num_epochs=8, lr=0.1, ratings=4096)
# the placed fit against the all-card one, relative L2 of the parameters'
# change from their start (fp32; the user half's sums on the host)
TOL_MF = 1e-3


def elastic_root():
    """A fresh git-ignored directory of the checkout for sidebands and
    shard sets (removed when the phase ends)."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "elastic")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    return root


def _worker_cmd(ckdir, cfg_json, steps, solo):
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.entry", "--elastic-worker",
           "--ckpt-dir", ckdir, "--steps", str(steps), "--gen-steps", "0",
           "--config", cfg_json, "--dtype", "bfloat16",
           "--lr", str(ELASTIC["lr"]), "--keep-global-batch",
           "--heartbeat-s", str(ELASTIC["heartbeat_s"]),
           "--miss", str(ELASTIC["miss"]), "--keep-generations", "8"]
    return cmd + (["--solo"] if solo else [])


def _child_env(**kw):
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **kw)
    env["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    for name in ("MXNET_ELASTIC_RESUME_GEN", "MXNET_CHAOS"):
        if name not in kw:
            env.pop(name, None)
    return env


def _lines(pattern, out):
    import re
    return [m.groups() for m in re.finditer(pattern, out, re.M)]


def elastic_shrink(torch, root):
    """The flagship's shrink and exact resume through the port's launcher:
    generation 0 (world 2, rank 1 the simulated absent peer) is shrunk by
    rank 0's monitor thread while it trains, generation 1 resumes at
    world 1 with 2 micro-batches a step and finishes the 8 steps; a clean
    world-1 run from the same captured shard set, in another process,
    must give its LOSS lines and final parameters bitwise; the DATA lines
    must tile the 64 rows. Returns the numbers."""
    sb, ckdir = os.path.join(root, "sb"), os.path.join(root, "ck")
    cfg_json = json.dumps(TRAIN_CFG)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.elastic_launch",
         "-n", str(ELASTIC["world"]), "--max-restarts", "1",
         "--backoff-ms", "100", "--elastic-dir", sb, "--"]
        + _worker_cmd(ckdir, cfg_json, ELASTIC["steps"], solo=True),
        capture_output=True, text=True, timeout=ELASTIC["timeout"],
        cwd=here, env=_child_env())
    launch_s = time.perf_counter() - t0
    out = r.stdout
    with open(os.path.join(here, "build", "elastic_launch.log"), "w") as f:
        f.write(out + "\n--- stderr ---\n" + r.stderr)
    if r.returncode != 0:
        raise AssertionError("elastic launcher exited %d:\n%s\n%s"
                             % (r.returncode, out[-3000:], r.stderr[-3000:]))
    for want in ("simulated peer: rank 1 of generation 0 never starts",
                 "generation 0 exited [44, 31] -> shrink",
                 "generation 1: world 1 (shrunk from 2)",
                 "job complete after 2 generation(s), 1 counted restart(s)"):
        if want not in out:
            raise AssertionError("elastic launcher log lacks %r:\n%s"
                                 % (want, out[-3000:]))
    cap = _lines(r"^\[elastic\] rank 0 g0: shard of step (\d+) committed "
                 r"in (\S+) ms \(host copies (\S+) ms, write (\S+) ms, "
                 r"(\d+) bytes\)$", out)
    if len(cap) != 1:
        raise AssertionError("no single capture line in generation 0")
    step0, cap_ms, copy_ms, write_ms, nbytes = cap[0]
    step0 = int(step0)
    ranges = {}
    for _g, step, lo, hi in _lines(r"^DATA g(\d) r0 (\d+) (\d+) (\d+)$",
                                   out):
        if ranges.setdefault(int(step), (int(lo), int(hi))) != \
                (int(lo), int(hi)):
            raise AssertionError("step %s consumed two row ranges" % step)
    rows = ELASTIC_ROWS_PER_STEP
    if ranges != {s: ((s - 1) * rows, s * rows)
                  for s in range(1, ELASTIC["steps"] + 1)}:
        raise AssertionError("rows skipped or replayed: %s" % ranges)
    g1 = dict(_lines(r"^LOSS g1 r0 (\d+) (\S+)$", out))
    if sorted(int(s) for s in g1) != list(range(step0 + 1,
                                                ELASTIC["steps"] + 1)):
        raise AssertionError("generation 1 ran steps %s after a capture "
                             "of step %d" % (sorted(g1), step0))
    launches = _lines(r"^LAUNCHES g1 r0 (\d+) (\d+) (\d+) (\d+)$", out)
    per_step = 2 * TRAIN_CFG["n_layers"]
    if [tuple(int(x) for x in row[1:]) for row in launches] != \
            [(per_step,) * 3] * len(g1):
        raise AssertionError("generation 1's steps launched %s, not %d of "
                             "each flash kernel" % (launches, per_step))
    step_ms = {g: [float(ms) for _s, ms in _lines(
        r"^STEPMS g%d r0 (\d+) (\S+)$" % g, out)] for g in (0, 1)}
    ttr = _lines(r"^TTR (\S+)$", out)
    final = _lines(r"^final g1 r0 step (\d+) param_l1 (\S+) fingerprint "
                   r"(\S+)$", out)
    if len(ttr) != 1 or len(final) != 1:
        raise AssertionError("generation 1 printed no TTR or final line")

    # the clean world-1 run from the same shard set, in another process
    clean = os.path.join(root, "ck_clean")
    shutil.copytree(ckdir, clean, copy_function=os.link)
    t0 = time.perf_counter()
    rc = subprocess.run(
        _worker_cmd(clean, cfg_json, ELASTIC["steps"], solo=False),
        capture_output=True, text=True, timeout=ELASTIC["timeout"],
        cwd=here, env=_child_env(
            MXNET_ELASTIC_DIR=os.path.join(root, "sb_clean"),
            MXNET_ELASTIC_GENERATION="1", MXNET_ELASTIC_RESUME_GEN="1",
            MXNET_ELASTIC_BASE_WORLD=str(ELASTIC["world"]),
            MXNET_TPU_NUM_PROC="1", MXNET_TPU_PROC_ID="0"))
    clean_s = time.perf_counter() - t0
    if rc.returncode != 0:
        raise AssertionError("the clean run exited %d:\n%s"
                             % (rc.returncode, rc.stderr[-3000:]))
    g1_clean = dict(_lines(r"^LOSS g1 r0 (\d+) (\S+)$", rc.stdout))
    final_clean = _lines(r"^final g1 r0 step (\d+) param_l1 (\S+) "
                         r"fingerprint (\S+)$", rc.stdout)
    if g1_clean != g1 or final_clean != final:
        raise AssertionError("generation 1 is not the clean run:\n%s\n%s\n"
                             "%s\n%s" % (g1, g1_clean, final, final_clean))
    losses = [float.fromhex(g1[s]) for s in sorted(g1, key=int)]
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite loss after the shrink")
    res = {"captured_step": step0, "capture_ms": float(cap_ms),
           "copy_ms": float(copy_ms), "write_ms": float(write_ms),
           "bytes": int(nbytes), "ttr_ms": float(ttr[0][0]),
           "step_ms_accum2": float(np.median(step_ms[1][1:])),
           "first_step_ms_accum2": step_ms[1][0],
           "gen0_steps": len(step_ms[0]), "launch_s": launch_s,
           "clean_s": clean_s, "launches_per_step": per_step,
           "steps_g1": len(g1), "fingerprint": final[0][2]}
    log("elastic shrink (%s): the flagship (bf16, 8 x %d a step) under "
        "the launcher; generation 0 world 2 with rank 1 never started (the "
        "simulated peer), rank 0's monitor thread found the peer dead and "
        "captured step %d while the main thread went on (%d step(s) done "
        "in generation 0): %.1f ms (host "
        "copies %.1f ms, write %.1f ms, %d bytes, %.0f MB/s); generation 1 "
        "at world 1, accum 2, ran steps %d-%d, LOSS lines and final "
        "parameters (fingerprint %s) bitwise the clean run's, rows 0-%d "
        "each once; TTR %.1f ms (the shrink record to generation 1's first "
        "step); step %.1f ms at accum 2 (first %.1f ms); B1/B2a/B2b %d "
        "launches a step each; launcher %.1f s, clean run %.1f s"
        % (card_line(), TRAIN_CFG["max_len"], step0, res["gen0_steps"],
           res["capture_ms"],
           res["copy_ms"], res["write_ms"], res["bytes"],
           res["bytes"] / 1e6 / max(res["write_ms"] / 1e3, 1e-9),
           step0 + 1, ELASTIC["steps"], res["fingerprint"],
           ELASTIC["steps"] * rows, res["ttr_ms"], res["step_ms_accum2"],
           res["first_step_ms_accum2"], per_step, launch_s, clean_s))
    shutil.rmtree(clean, ignore_errors=True)
    return res


def _host_state(torch, params, mom):
    return ({n: t.detach().cpu() for n, t in params.named_parameters()},
            {n: t.detach().cpu() for n, t in mom.items()})


def _bitwise(want_p, want_m, params, mom, what):
    got_p = dict(params.named_parameters())
    for n, t in want_p.items():
        if got_p[n].dtype != t.dtype or not bool((got_p[n].cpu() == t)
                                                  .all()):
            raise AssertionError("%s: parameter %s differs" % (what, n))
        if want_m is not None and not bool((mom[n].cpu() == want_m[n])
                                           .all()):
            raise AssertionError("%s: momentum %s differs" % (what, n))


def _save_ranks(ck, path, cfg, params, mom, world, step, generation):
    """A shard set written as ``world`` survivors write it, each rank's
    save on a thread of its own (the crc32 and the writes release the
    GIL)."""
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(world) as pool:
        for done in [pool.submit(ck.save_shard_checkpoint, path, cfg, params,
                                 momentum=mom, step=step, rank=r,
                                 world=world, generation=generation,
                                 keep_generations=8)
                     for r in range(world)]:
            done.result()


def elastic_reshard(torch, tf, ck, params, want_p, want_m, captured, root):
    """From one process, the flagship state (its host copy) as a 4-rank
    shard set (each rank the full parameters and its slice of every lane,
    the four written at once); merged at world 1 bitwise; rank 2's arrays
    removed and merged with allow_partial, exactly rank 2's lane slices
    zero and every other byte bitwise; the world-1 set the capture wrote
    (``captured``) merged under a world-4 layout bitwise. Runs on the
    host only, so it overlaps the wedge."""
    world = ELASTIC_RESHARD_WORLD
    host = tf._rebuild(params, lambda name, leaf: want_p[name])
    d4 = os.path.join(root, "reshard4")
    t0 = time.perf_counter()
    _save_ranks(ck, d4, params.cfg, host, want_m, world, 7, 1)
    save_s = time.perf_counter() - t0
    save_bytes = sum(os.path.getsize(os.path.join(d4, f))
                     for f in os.listdir(d4))
    t0 = time.perf_counter()
    _, p1, m1, step, ex = ck.load_shard_checkpoint(d4, device="cpu")
    merge_s = time.perf_counter() - t0
    if step != 7 or ex["world"] != world:
        raise AssertionError("the 4-rank set merged as step %d world %d"
                             % (step, ex["world"]))
    _bitwise(want_p, want_m, p1, m1, "4 -> 1 merge")
    del p1, m1
    # rank 2 lost: exactly its lane slices resume as zeros
    layout = ck.shard_layout(want_m, world)
    lost = next(n for n in os.listdir(d4)
                if n.startswith("shard-arrays-g1-r2of4"))
    os.remove(os.path.join(d4, lost))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, pp, mp, _, _ = ck.load_shard_checkpoint(d4, allow_partial=True,
                                                   device="cpu")
    if not any("rank 2" in str(w.message) or "[2]" in str(w.message)
               for w in caught):
        raise AssertionError("the partial merge did not warn about rank 2")
    _bitwise(want_p, None, pp, None, "partial merge parameters")
    zeroed = 0
    for lane in layout["lanes"]:
        n_per = lane["l_pad"] // world
        lo, hi = 2 * n_per, 3 * n_per
        for key, _shape, size, offset in lane["segments"]:
            name = key[len("m."):]
            got = mp[name].reshape(-1)
            want = want_m[name].reshape(-1)
            mask = torch.zeros(size, dtype=torch.bool)
            a, b = max(lo, offset), min(hi, offset + size)
            if a < b:
                mask[a - offset:b - offset] = True
            if bool(got[mask].any()) or not bool(
                    (got[~mask] == want[~mask]).all()):
                raise AssertionError("partial merge: %s is not zero on rank "
                                     "2's slice and bitwise elsewhere"
                                     % name)
            zeroed += int(mask.sum())
    del pp, mp
    shutil.rmtree(d4, ignore_errors=True)
    # the world-1 set the capture wrote, merged, saved and merged under a
    # world-4 layout
    _, q, qm, _, _ = ck.load_shard_checkpoint(captured, device="cpu")
    d14 = os.path.join(root, "reshard14")
    t0 = time.perf_counter()
    _save_ranks(ck, d14, q.cfg, q, qm, world, 8, 2)
    host_save_s = time.perf_counter() - t0
    del q, qm
    _, q4, qm4, step, ex = ck.load_shard_checkpoint(d14, device="cpu")
    if step != 8 or ex["world"] != world:
        raise AssertionError("the 1 -> 4 reshard merged as step %d world %d"
                             % (step, ex["world"]))
    _bitwise(want_p, want_m, q4, qm4, "1 -> 4 reshard")
    del q4, qm4
    shutil.rmtree(d14, ignore_errors=True)
    return {"save_bytes": save_bytes, "save_s": save_s, "merge_s": merge_s,
            "save_mb_s": save_bytes / 1e6 / save_s,
            "merge_mb_s": save_bytes / 1e6 / merge_s,
            "host_save_s": host_save_s, "zeroed": zeroed}


def elastic_wedge(torch, mt, device, root):
    """The capture while the compute stream is wedged, in this process: a
    few flagship steps through make_accum_train_step (accum 1; timed, and
    each launching B1/B2a/B2b once a layer), then a ~20 s spin kernel on
    the compute stream (standing in for an all-reduce whose peer is dead)
    behind the next step's kernels, with the main thread blocked in a
    fetch of the loss queued after the spin, as a rank whose all-reduce
    hangs blocks in its loop's ``float(loss)``; the coordinator's shrink
    (an injected exit), on another thread as the monitor runs it, must
    commit the capture well within the wedge, and the captured state must
    be bitwise the completed step's, not the one in flight. The 4-rank
    reshard runs on that thread and the host while the wedge lasts. (The
    spin follows the next step's kernels, where a real step's all-reduce
    runs: queued before them, it would block the step's own call in its
    backward pass, which reads back from the device.)"""
    import threading
    from mxnet_tpu_torch import entry, kernels
    from mxnet_tpu_torch.models import checkpoint as ck
    from mxnet_tpu_torch.models import transformer as tf
    from mxnet_tpu_torch.parallel import elastic
    cfg = tf.TransformerConfig(dtype=torch.bfloat16, **TRAIN_CFG)
    params = tf.init_params(cfg, seed=0, device=device)
    mom = tf.init_momentum(params)
    step = elastic.make_accum_train_step(cfg, lr=ELASTIC["lr"], accum=1)
    data = torch.from_numpy(entry.elastic_tokens(cfg)).to(device)
    rows = ELASTIC_ROWS_PER_STEP
    kernels.launches.clear()
    step_s, ready = [], None
    for k in range(ELASTIC_WEDGE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, mom, loss = step(params, mom,
                                 data[k * rows:(k + 1) * rows][None])
        ready = torch.cuda.Event()
        ready.record()
        float(loss)
        step_s.append(time.perf_counter() - t0)
    want_p, want_m = _host_state(torch, params, mom)
    sb = os.path.join(root, "wedge-sb")
    elastic.write_generation(sb, 0, 2)
    live = {"params": params, "mom": mom, "ready": ready}
    coord = elastic.ElasticCoordinator(
        os.path.join(root, "wedge-ck"),
        lambda: {"cfg": cfg, "params": live["params"],
                 "momentum": live["mom"], "step": ELASTIC_WEDGE_STEPS,
                 "ready": live["ready"]},
        d=sb, rank=0, world=2, generation=0, monitor=False,
        exit=lambda code: live.setdefault("exit", code))
    # the training loop's step boundary: the first beat pins the host
    # buffers the capture will copy into
    t0 = time.perf_counter()
    coord.beat(ELASTIC_WEDGE_STEPS)
    reserve_s = time.perf_counter() - t0
    # the spin kernel counts SM clock cycles: time a short one to convert
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(ELASTIC_SPIN_PROBE)
    torch.cuda.synchronize()
    cycles_per_s = ELASTIC_SPIN_PROBE / (time.perf_counter() - t0)
    side = {}

    def monitor():
        # the monitor thread's part, as on a rank whose main thread is
        # blocked in a collective: the capture, then the reshard, both
        # on side streams and the host while the compute stream spins;
        # a failure is raised again by the joining thread
        try:
            t0 = time.perf_counter()
            coord.shrink({1})
            side["capture_s"] = time.perf_counter() - t0
            side["wedged_at_commit"] = not torch.cuda.current_stream(
                device).query()
            side["reshard"] = elastic_reshard(
                torch, tf, ck, params, want_p, want_m,
                os.path.join(root, "wedge-ck"), root)
            side["wedged_after_reshard"] = not torch.cuda.current_stream(
                device).query()
        except BaseException as exc:  # noqa: BLE001 — raised by the joiner
            side["error"] = exc
    # the next step, in flight: its kernels queued, then the spin kernel
    # where its all-reduce would hang, then the work after that collective
    # (the update) whose loss the main thread fetches, as the worker's
    # loop does with float(loss); the fetch blocks behind the spin
    k = ELASTIC_WEDGE_STEPS
    inflight = step(params, mom, data[k * rows:(k + 1) * rows][None])
    t_wedge = time.perf_counter()
    torch.cuda._sleep(int(ELASTIC_WEDGE_S * cycles_per_s))
    after = inflight[2] * 1.0
    runner = threading.Thread(target=monitor)
    runner.start()
    float(after)
    runner.join()
    torch.cuda.synchronize()
    wedge_s = time.perf_counter() - t_wedge
    if side.get("error") is not None:
        raise side["error"]
    capture_s, reshard = side["capture_s"], side["reshard"]
    wedged_at_commit = side["wedged_at_commit"]
    still_wedged = side["wedged_after_reshard"]
    if live.get("exit") != elastic.SHRINK_EXIT_CODE:
        raise AssertionError("the shrink did not exit 44")
    if not wedged_at_commit or not capture_s <= ELASTIC_CAPTURE_LIMIT_S:
        raise AssertionError("the capture took %.2f s (limit %.1f s; the "
                             "stream still wedged at the commit: %s)"
                             % (capture_s, ELASTIC_CAPTURE_LIMIT_S,
                                wedged_at_commit))
    _, cp, cm, cstep, ex = ck.load_shard_checkpoint(
        os.path.join(root, "wedge-ck"), device="cpu")
    if cstep != ELASTIC_WEDGE_STEPS or ex["world"] != 1:
        raise AssertionError("the capture holds step %d world %d"
                             % (cstep, ex["world"]))
    _bitwise(want_p, want_m, cp, cm, "the wedged capture")
    p_next = dict(inflight[0].named_parameters())
    if all(bool((p_next[n].cpu() == t).all()) for n, t in want_p.items()):
        raise AssertionError("the in-flight step changed nothing")
    n_steps = ELASTIC_WEDGE_STEPS + 1
    check_only(kernels, {k: cfg.n_layers * n_steps for k in TRAIN_KERNELS},
               "the elastic phase's in-process steps")
    launches = {k: kernels.launches[k] for k in TRAIN_KERNELS}
    res = {"capture_s": capture_s, "capture": coord.capture,
           "reserve_s": reserve_s,
           "wedge_s": wedge_s, "still_wedged_after_reshard": still_wedged,
           "step_ms_accum1": 1e3 * float(np.median(step_s[1:])),
           "first_step_ms_accum1": 1e3 * step_s[0], "launches": launches,
           "reshard": reshard}
    log("elastic capture under a wedged stream (%s): %d flagship steps at "
        "accum 1 (%.1f ms a step, first %.1f ms; %d launches of each flash "
        "kernel over them and the in-flight step, %d a step), then a %.0f s "
        "spin kernel on the "
        "compute stream with step %d queued behind it: the shrink committed "
        "step %d's shard in %.3f s (host copies %.1f ms on a side stream, "
        "write %.1f ms, %d bytes; limit %.1f s) while the stream was still "
        "wedged, bitwise step %d's state and not step %d's; the wedge "
        "lasted %.1f s; the first step boundary pinned the capture's host "
        "buffers in %.3f s"
        % (card_line(), ELASTIC_WEDGE_STEPS, res["step_ms_accum1"],
           res["first_step_ms_accum1"], launches["flash_fwd"],
           cfg.n_layers, ELASTIC_WEDGE_S, ELASTIC_WEDGE_STEPS + 1, ELASTIC_WEDGE_STEPS,
           capture_s, coord.capture["capture_ms"],
           coord.capture["write_ms"], coord.capture["bytes"],
           ELASTIC_CAPTURE_LIMIT_S, ELASTIC_WEDGE_STEPS,
           ELASTIC_WEDGE_STEPS + 1, wedge_s, reserve_s))
    log("elastic reshard (%s), during the wedge (still wedged after it: "
        "%s): the flagship state as a %d-rank set, %d bytes saved in %.2f s "
        "(%.0f MB/s, four ranks at once) and merged at world 1 in %.2f s "
        "(%.0f MB/s), bitwise; rank 2 lost: %d momentum elements zero, "
        "every other byte bitwise; the captured world-1 set resharded to "
        "world %d (saved in %.2f s) and merged, bitwise"
        % (card_line(), still_wedged, ELASTIC_RESHARD_WORLD,
           reshard["save_bytes"], reshard["save_s"], reshard["save_mb_s"],
           reshard["merge_s"], reshard["merge_mb_s"], reshard["zeroed"],
           ELASTIC_RESHARD_WORLD, reshard["host_save_s"]))
    shutil.rmtree(os.path.join(root, "wedge-ck"), ignore_errors=True)
    return res


def mf_symbol(mt, spec=MF):
    """matrix_factorization.py's net."""
    sym = mt.sym
    user, item = sym.Variable("user"), sym.Variable("item")
    score = sym.Variable("score_label")
    with mt.AttrScope(ctx_group="dev1"):
        user_vec = sym.Flatten(sym.Embedding(
            user, input_dim=spec["num_users"],
            output_dim=spec["factor_size"], name="user_emb"))
    with mt.AttrScope(ctx_group="dev2"):
        item_vec = sym.Flatten(sym.Embedding(
            item, input_dim=spec["num_items"],
            output_dim=spec["factor_size"], name="item_emb"))
        pred = sym.sum(user_vec * item_vec, axis=1)
    return sym.LinearRegressionOutput(pred, score, name="score")


def mf_data(spec=MF, seed=0):
    """The example's synthetic ratings and Normal(0.1) starting
    embeddings (drawn once on the host, so both fits start alike)."""
    rng = np.random.RandomState(seed)
    true_u = rng.randn(spec["num_users"], 4).astype(np.float32)
    true_i = rng.randn(spec["num_items"], 4).astype(np.float32)
    users = rng.randint(0, spec["num_users"], spec["ratings"])
    items = rng.randint(0, spec["num_items"], spec["ratings"])
    scores = (true_u[users] * true_i[items]).sum(1)
    init = np.random.RandomState(seed + 1)
    start = {"user_emb_weight": (init.randn(spec["num_users"],
                                            spec["factor_size"]) * 0.1)
             .astype(np.float32),
             "item_emb_weight": (init.randn(spec["num_items"],
                                            spec["factor_size"]) * 0.1)
             .astype(np.float32)}
    return users.astype(np.float32), items.astype(np.float32), scores, start


def elastic_group2ctx(torch, mt, spec=MF, tol=TOL_MF):
    """matrix_factorization.py through Module.fit at its defaults (Adam,
    lr 0.1, 8 epochs of 64-row batches, mse) with the user half placed on
    the host and the item half on the card (group2ctxs), against the same
    fit with every group on the card."""
    users, items, scores, start = mf_data(spec)
    fits = {}
    for key, g2c in (("placed", {"dev1": mt.cpu(0), "dev2": mt.gpu(0)}),
                     ("card", {"dev1": mt.gpu(0), "dev2": mt.gpu(0)})):
        with mt.gpu(0):
            np.random.seed(3)
            train = mt.io.NDArrayIter(
                {"user": users, "item": items}, {"score_label": scores},
                batch_size=spec["batch_size"], shuffle=True)
            mod = mt.mod.Module(mf_symbol(mt, spec),
                                data_names=("user", "item"),
                                label_names=("score_label",),
                                group2ctxs=g2c)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.fit(train, num_epoch=spec["num_epochs"], optimizer="adam",
                    optimizer_params={"learning_rate": spec["lr"]},
                    arg_params={k: mt.nd.array(v) for k, v in start.items()},
                    eval_metric="mse")
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            train.reset()
            mod.forward_backward(train.next())
            transfers = list(mod._exec.transfers)
            pred = mod.get_outputs()[0]
            ex = mod._exec
            placement = {n: str(ex.arg_dict[n]._data.device)
                         for n in ("user_emb_weight", "item_emb_weight")}
            placement["prediction"] = str(pred._data.device)
            mse = dict(mod.score(train, "mse"))["mse"]
        args, _ = mod.get_params()
        fits[key] = ({k: v.asnumpy() for k, v in args.items()}, fit_s,
                     transfers, placement, mse)
    got, want = fits["placed"][0], fits["card"][0]
    worst = max(float(np.linalg.norm(got[k] - want[k])
                      / np.linalg.norm(want[k] - start[k])) for k in want)
    placed = fits["placed"][3]
    if not (placed["item_emb_weight"].startswith("cuda")
            and placed["prediction"].startswith("cuda")
            and placed["user_emb_weight"] == "cpu"):
        raise AssertionError("group2ctx placement: %s" % placed)
    if not worst <= tol or not np.isfinite(fits["placed"][4]):
        raise AssertionError("the placed fit is %.3g from the card's" % worst)
    tr = fits["placed"][2]
    if not tr or fits["card"][2]:
        raise AssertionError("boundary transfers: placed %s, card %s"
                             % (tr, fits["card"][2]))
    desc = ", ".join("%s -> %s %d B" % (a, b, n) for a, b, n in tr)
    log("group2ctx (%s): matrix_factorization.py's defaults (%d x %d and "
        "%d x %d embeddings, %d ratings, batch %d, %d epochs of Adam lr "
        "%g) with dev1 on cpu(0) and dev2 on gpu(0): placement %s; the "
        "fit %.2f s (all on the card %.2f s), train mse %.5f (card %.5f); "
        "parameters within %.3g of the all-card fit's change (relative L2, "
        "limit %g); %d boundary transfers a batch (forward and backward): "
        "%s" % (card_line(), spec["num_users"], spec["factor_size"],
                spec["num_items"], spec["factor_size"], spec["ratings"],
                spec["batch_size"], spec["num_epochs"], spec["lr"], placed,
                fits["placed"][1], fits["card"][1], fits["placed"][4],
                fits["card"][4], worst, tol, len(tr), desc))
    return {"rel": worst, "transfers": len(tr),
            "transfer_bytes": sum(n for _a, _b, n in tr),
            "fit_s": fits["placed"][1], "card_fit_s": fits["card"][1]}


def elastic_two_contexts(torch, mt, spec=MODULE_CHECK):
    """Module(context=[gpu(0), cpu(0)], kvstore="device") binds on gpu(0)
    and makes a store (update_on_kvstore): two batches of the ResNet-18
    thumbnail give parameters and moving statistics bitwise those of the
    module bound on [gpu(0)] with a created device store, with the same
    dispatch_stats. cuDNN's convolution backward is not deterministic, so
    the leg sets torch.backends.cudnn.deterministic and restores it."""
    from mxnet_tpu_torch import entry
    from mxnet_tpu_torch.symbols import resnet
    shape = (3, spec["image_size"], spec["image_size"])
    start, start_aux = module_check_start(mt, spec, shape)
    got = {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for key, context, store in (
                ("two", [mt.gpu(0), mt.cpu(0)], "device"),
                ("one", [mt.gpu(0)], mt.kvstore.create("device"))):
            with mt.gpu(0):
                np.random.seed(0)
                train = entry.synthetic_iter(
                    spec["classes"], shape, spec["batch"],
                    num_batches=spec["num_batches"])
                mod = mt.mod.Module(resnet.get_symbol(
                    spec["classes"], spec["num_layers"], shape),
                    context=context)
                mod.fit(train, eval_metric="acc", kvstore=store,
                        optimizer="sgd", optimizer_params=entry.FIT_SGD,
                        arg_params={k: mt.nd.array(v)
                                    for k, v in start.items()},
                        aux_params={k: mt.nd.array(v)
                                    for k, v in start_aux.items()},
                        num_epoch=1)
            arg, aux = mod.get_params()
            got[key] = ({k: v.asnumpy() for k, v in arg.items()},
                        {k: v.asnumpy() for k, v in aux.items()},
                        mod._kvstore, mod._update_on_kvstore)
    finally:
        torch.backends.cudnn.deterministic = saved
    two, one = got["two"], got["one"]
    if two[2] is None or not two[3] or one[2] is None or not one[3]:
        raise AssertionError("the two-context module made no store")
    if two[2].dispatch_stats != one[2].dispatch_stats:
        raise AssertionError("dispatch_stats differ: %s vs %s"
                             % (two[2].dispatch_stats, one[2].dispatch_stats))
    for a, b in ((two[0], one[0]), (two[1], one[1])):
        for k in b:
            if not np.array_equal(a[k], b[k]):
                raise AssertionError("the two-context module's %s is not "
                                     "the created store's" % k)
    log("Module over [gpu(0), cpu(0)] with kvstore='device' (%s): bound on "
        "gpu(0), a store made (%s, update_on_kvstore), %d batches of the "
        "ResNet-%d thumbnail (%d x %d^2) bitwise the one-context module "
        "with a created device store, dispatch_stats %s (cudnn "
        "deterministic for the leg, restored to %s)"
        % (card_line(), two[2].type, spec["num_batches"],
           spec["num_layers"], spec["batch"], spec["image_size"],
           two[2].dispatch_stats, saved))
    return {"dispatch_stats": dict(two[2].dispatch_stats)}


def elastic_phase(torch, mt, device):
    """Elastic worlds and the shard checkpoints on the card:
    the flagship's shrink and exact resume under the port's launcher, the
    capture under a wedged compute stream with the 4-rank reshard beside
    it, group2ctx placement across the host and the card, and a Module
    over two contexts. Returns the numbers and the launches."""
    t0 = time.perf_counter()
    root = elastic_root()
    out = {}
    try:
        out["shrink"] = elastic_shrink(torch, root)
        torch.cuda.empty_cache()
        out["wedge"] = elastic_wedge(torch, mt, device, root)
        torch.cuda.empty_cache()
        out["group2ctx"] = elastic_group2ctx(torch, mt)
        out["two_contexts"] = elastic_two_contexts(torch, mt)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    per_step = out["shrink"]["launches_per_step"]
    workers = per_step * out["shrink"]["steps_g1"]
    out["launches"] = {k: out["wedge"]["launches"][k] + workers
                       for k in TRAIN_KERNELS}
    out["seconds"] = time.perf_counter() - t0
    log("elastic phase (%s): %.1f s; B1/B2a/B2b launches %s (in-process %s, "
        "generation 1's worker %d each: %d a step at accum 2)"
        % (card_line(), out["seconds"], out["launches"],
           out["wedge"]["launches"], workers, per_step))
    return out


# ---------------- random sampling, control flow and recurrent nets ---

# draws of each sampler on the card, in float32 and, where the sampler
# takes a float dtype, in float16 (which the port stores as bfloat16)
RNN_DRAWS = 2 ** 20
# a sample mean must lie within RNN_SE standard errors of its
# distribution's mean (sqrt(var / n)), a sample variance within RNN_SE of
# its variance (sqrt((mu4 - var^2) / n), mu4 the fourth central moment):
# a correct sampler fails one such check in ~5e8
RNN_SE = 6.0
# floor of each seeded draw's p-value: Kolmogorov-Smirnov for float32
# continuous draws, chi-square for discrete ones (singles, the tails
# pooled to an expectation of 5) and for bfloat16 ones (64 bins of equal
# probability whose edges are midpoints between bfloat16 neighbours, so
# that rounding to bfloat16 moves no draw across an edge)
RNN_P_MIN = 1e-4
# _sample_unique_zipfian at a sampled softmax's size: 128 rows of 8192
# candidates from 2^20 classes; every row must be duplicate-free
RNN_ZIPF = dict(range_max=2 ** 20, shape=(128, 8192))
# multinomial rows of ``sample_multinomial``'s case
RNN_MULTINOMIAL = ((0.1, 0.2, 0.3, 0.4), (0.5, 0.05, 0.2, 0.25))
# pdf ops and their gradients, card vs CPU (the port against itself). A
# density and its gradient in the sample, element by element, |card -
# cpu| <= atol + rtol |cpu|: both evaluate the same fp32 closed forms,
# whose log, exp and lgamma (digamma in the gradients) differ between the
# two devices' math libraries by a few fp32 ulps (2^-23 of a value each),
# which the few terms of a density keep within ~1e-5 of it. A parameter's
# gradient sums its row's RNN_PDF["n"] samples' terms, which cancel (the
# negative binomial's d/dp holds k/p - x/(1-p)), so it is held by its
# relative L2 error: on the CPU, fp32 against float64 reaches 1.6e-5
# (the generalized negative binomial's alpha), and each device sums in
# its own order
TOL_PDF = (1e-5, 1e-4)
TOL_PDF_PARAM_GRAD = 1e-4
RNN_PDF = dict(rows=8, n=4096)
# the Gluon word LM (entry.WORD_LM: upstream's train.py defaults with
# --tied): steps hybridized, the window timed, the profiled steps
WORD_LM_STEPS = 20
WORD_LM_TIMED_FROM = 4              # steps 5-20 timed
WORD_LM_PROFILE_STEPS = 4
# word LM card vs CPU in fp32 (TF32 off, dropout 0), from the same
# parameters: the first window's loss by its relative error and every
# gradient by its relative L2 error, as the flagship's train_equivalence
# holds them, then WORD_LM_EQUIV_STEPS whole steps (clip, trainer.step):
# each step's loss by its relative error and each parameter's change over
# the steps by its relative L2 error. The decoder's 650-long dots and the
# LSTM's 35 steps of recurrence sum fp32 products in another order on
# each device, and lr 20 amplifies that from step to step (the third
# step's loss is ~22). Read on an H100 (NVIDIA H100 80GB HBM3, 700.00 W),
# fp32 against the CPU: gradients 2.04e-6, the steps' losses 6.14e-5,
# the change 8.60e-5; the card with TF32 matmuls: 4.86e-4, 1.02e-4 and
# 7.41e-4. The gradient and change limits sit between the two readings,
# and the TF32 readings, taken in every run, must exceed them.
WORD_LM_EQUIV_STEPS = 3
TOL_WORD_LM = dict(loss=1e-4, grad=5e-5, steps=3e-4, change=2.5e-4)
# the word LM's loss falls: the median of the last five steps' losses at
# least this far below ln(vocab), which a net whose update did nothing
# (its loss stays at ln(vocab), dropout or not) cannot reach
WORD_LM_DROP = 0.5
# the bucketing LSTM at lstm_bucketing.py's defaults (entry.BUCKETING_LM)
BUCKETING_TIMED_FROM = 4            # batches 5-24 timed
# control flow at benchmark/python/control_flow/rnn.py's defaults: the
# three LSTM routes' outputs agree to TOL_CONTROL_FLOW (max abs): each
# output sums 512 fp32 products of size ~0.05 in another order (the
# fused layer projects every step's input in one matmul), at worst
# 512 x 2^-24 of a sum of magnitude ~1 a step, and the LSTM's gates
# contract what an earlier step carries
CONTROL_FLOW = dict(seq_len=64, batch=32, hidden=256)
TOL_CONTROL_FLOW = 1e-4
CONTROL_FLOW_ITERS = 5


def sampler_cases(mt):
    """[(label, draw(dtype) -> NDArray of rows x draws, [frozen scipy
    distribution of each row], discrete, takes a float dtype)] at
    RNN_DRAWS draws a case: the scalar samplers through ``nd.random``, the
    multisample ``sample_*`` ops on two parameter rows of RNN_DRAWS / 2."""
    from scipy import stats
    nd = mt.nd
    n, half = (RNN_DRAWS,), (RNN_DRAWS // 2,)

    def arr(*v):
        return nd.array(np.array(v, np.float32))

    def nbinom_gen(mu, alpha):
        # the generalized negative binomial's NB(1 / alpha, 1 / (1 + alpha mu))
        return stats.nbinom(1.0 / alpha, 1.0 / (1.0 + alpha * mu))

    rnd = nd.random
    return [
        ("uniform", lambda dt: rnd.uniform(-1, 2, shape=n, dtype=dt),
         [stats.uniform(-1, 3)], False, True),
        ("normal", lambda dt: rnd.normal(1, 2, shape=n, dtype=dt),
         [stats.norm(1, 2)], False, True),
        ("gamma", lambda dt: rnd.gamma(2.5, 0.5, shape=n, dtype=dt),
         [stats.gamma(2.5, scale=0.5)], False, True),
        ("exponential", lambda dt: rnd.exponential(2.0, shape=n, dtype=dt),
         [stats.expon(scale=0.5)], False, True),
        ("poisson", lambda dt: rnd.poisson(4.0, shape=n, dtype=dt),
         [stats.poisson(4.0)], True, True),
        ("negative_binomial",
         lambda dt: rnd.negative_binomial(3, 0.4, shape=n, dtype=dt),
         [stats.nbinom(3, 0.4)], True, True),
        ("generalized_negative_binomial",
         lambda dt: rnd.generalized_negative_binomial(2.0, 0.5, shape=n,
                                                      dtype=dt),
         [nbinom_gen(2.0, 0.5)], True, True),
        ("randint", lambda dt: rnd.randint(0, 10, shape=n),
         [stats.randint(0, 10)], True, False),
        ("sample_uniform",
         lambda dt: rnd.uniform(arr(0, -2), arr(1, 3), shape=half, dtype=dt),
         [stats.uniform(0, 1), stats.uniform(-2, 5)], False, True),
        ("sample_normal",
         lambda dt: rnd.normal(arr(0, 3), arr(1, 0.5), shape=half, dtype=dt),
         [stats.norm(0, 1), stats.norm(3, 0.5)], False, True),
        ("sample_gamma",
         lambda dt: rnd.gamma(arr(0.7, 3), arr(1, 2), shape=half, dtype=dt),
         [stats.gamma(0.7, scale=1), stats.gamma(3, scale=2)], False, True),
        ("sample_exponential",
         lambda dt: rnd.exponential(arr(1, 4), shape=half, dtype=dt),
         [stats.expon(scale=1), stats.expon(scale=0.25)], False, True),
        ("sample_poisson",
         lambda dt: rnd.poisson(arr(0.5, 12), shape=half, dtype=dt),
         [stats.poisson(0.5), stats.poisson(12)], True, True),
        ("sample_negative_binomial",
         lambda dt: nd.sample_negative_binomial(arr(2, 5), arr(0.3, 0.8),
                                                shape=half, dtype=dt),
         [stats.nbinom(2, 0.3), stats.nbinom(5, 0.8)], True, True),
        ("sample_generalized_negative_binomial",
         lambda dt: nd.sample_generalized_negative_binomial(
             arr(1, 6), arr(0.3, 1.5), shape=half, dtype=dt),
         [nbinom_gen(1, 0.3), nbinom_gen(6, 1.5)], True, True),
        ("sample_multinomial",
         lambda dt: rnd.multinomial(
             nd.array(np.array(RNN_MULTINOMIAL, np.float32)), shape=half),
         [stats.rv_discrete(values=(np.arange(4), p))
          for p in RNN_MULTINOMIAL], True, False),
    ]


def _bf16_midpoints(q):
    """Midpoints between each value's bfloat16 neighbours near ``q``
    (sorted, distinct): a draw rounded to bfloat16 lies on the same side
    of such an edge as the float32 value it was rounded from."""
    bits = (np.asarray(q, np.float32).view(np.uint32) >> 16).astype(
        np.uint32)
    lo = (bits << 16).view(np.float32).astype(np.float64)
    hi = ((bits + 1) << 16).view(np.float32).astype(np.float64)
    return np.unique((lo + hi) / 2)


def draw_pvalue(stats, row, dist, discrete, bf16):
    """The seeded draw's p-value under ``dist`` (RNN_P_MIN's tests)."""
    n = row.size
    if discrete:
        if not np.array_equal(row, np.round(row)):
            raise AssertionError("a discrete sampler drew a non-integer")
        lo, hi = int(dist.ppf(5.0 / n)), int(dist.ppf(1.0 - 5.0 / n))
        vals = np.clip(row, lo, hi).astype(np.int64) - lo
        counts = np.bincount(vals, minlength=hi - lo + 1)
        inner = np.arange(lo + 1, hi)
        expect = np.concatenate([[dist.cdf(lo)], dist.pmf(inner),
                                 [dist.sf(hi - 1)]])
        return stats.chisquare(counts, expect / expect.sum() * n).pvalue
    if not bf16:
        return stats.kstest(row, dist.cdf).pvalue
    edges = _bf16_midpoints(dist.ppf(np.arange(1, 64) / 64.0))
    counts = np.bincount(np.searchsorted(edges, row),
                         minlength=edges.size + 1)
    expect = np.diff(np.concatenate([[0.0], dist.cdf(edges), [1.0]]))
    return stats.chisquare(counts, expect / expect.sum() * n).pvalue


def draw_moments(row, dist):
    """(mean, variance) of ``row`` as multiples of their standard
    errors away from ``dist``'s."""
    m, v, _, k = (float(s) for s in dist.stats(moments="mvsk"))
    n = row.size
    mu4 = (k + 3.0) * v * v
    return ((row.mean() - m) / np.sqrt(v / n),
            (row.var() - v) / np.sqrt((mu4 - v * v) / n))


def rnn_samplers(torch, mt, card):
    """Every sampler at RNN_DRAWS draws on gpu(0): moments, a
    distribution test, bitwise reseeding, the ms per RNN_DRAWS draws;
    the unique zipfian's rows."""
    from scipy import stats
    out = {}
    cases = sampler_cases(mt)
    device = mt.gpu(0).torch_device
    for label, draw, dists, discrete, floats in cases:
        for dt in ("float32", "float16") if floats else ("int32",):
            x = draw(dt)
            want_dtype = {"float16": torch.bfloat16,
                          "float32": torch.float32}.get(dt, torch.int32)
            if x._data.dtype != want_dtype or x._data.device != device:
                raise AssertionError("%s (%s) drew %s on %s" % (
                    label, dt, x._data.dtype, x._data.device))
            rows = x._data.double().reshape(len(dists), -1).cpu().numpy()
            if not np.isfinite(rows).all():
                raise AssertionError("%s (%s): a draw is not finite"
                                     % (label, dt))
            worst = (0.0, 0.0, 1.0)
            for row, dist in zip(rows, dists):
                lo, hi = dist.support()
                if row.min() < lo or row.max() > hi:
                    raise AssertionError("%s (%s): draws in [%g, %g] leave "
                                         "the support [%g, %g]" % (
                                             label, dt, row.min(), row.max(),
                                             lo, hi))
                z_mean, z_var = draw_moments(row, dist)
                p = draw_pvalue(stats, row, dist, discrete,
                                dt == "float16")
                worst = (max(worst[0], abs(z_mean)),
                         max(worst[1], abs(z_var)), min(worst[2], p))
            if worst[0] > RNN_SE or worst[1] > RNN_SE or worst[2] < RNN_P_MIN:
                raise AssertionError(
                    "%s (%s): mean %.2f and variance %.2f standard errors "
                    "off (limit %g), p %.3g (floor %g)"
                    % (label, dt, worst[0], worst[1], RNN_SE, worst[2],
                       RNN_P_MIN))
            ms = time_ms(lambda: draw(dt), 5)
            out[label, dt] = dict(ms=ms, z_mean=worst[0], z_var=worst[1],
                                  p=worst[2])
            log("sampler %s %s: %.4f ms per %d draws; mean %.2f, variance "
                "%.2f standard errors off, p %.3g (%s)"
                % (label, dt, ms, RNN_DRAWS, worst[0], worst[1], worst[2],
                   card))
    # mx.random.seed(s) twice: every draw bitwise
    runs = []
    for _ in range(2):
        mt.random.seed(7)
        runs.append([draw("float32" if floats else "int32")._data
                     for _, draw, _, _, floats in cases])
    for (label, *_), a, b in zip(cases, *runs):
        if not torch.equal(a, b):
            raise AssertionError("%s: seed 7 twice drew different values"
                                 % label)
    del runs
    z = mt.nd._sample_unique_zipfian(**RNN_ZIPF)._data
    ordered = torch.sort(z, dim=-1).values
    dups = int((ordered[:, 1:] == ordered[:, :-1]).sum())
    if dups or int(z.min()) < 0 or int(z.max()) >= RNN_ZIPF["range_max"]:
        raise AssertionError("_sample_unique_zipfian: %d duplicates, values "
                             "in [%d, %d]" % (dups, int(z.min()),
                                              int(z.max())))
    ms = time_ms(lambda: mt.nd._sample_unique_zipfian(**RNN_ZIPF), 5)
    out["_sample_unique_zipfian", "int32"] = dict(ms=ms)
    log("sampler _sample_unique_zipfian %s: %.4f ms per %d draws, rows "
        "duplicate-free (%s)" % (RNN_ZIPF, ms, z.numel(), card))
    return out


def pdf_inputs(rows, n, seed=11):
    """{pdf op: numpy inputs} at ``rows`` parameter rows of ``n``
    samples each, inside each density's support."""
    rs = np.random.RandomState(seed)

    def u(shape, lo, hi):
        return rs.uniform(lo, hi, shape).astype(np.float32)

    def ints(shape, hi):
        return rs.randint(0, hi, shape).astype(np.float32)

    s, p = (rows, n), (rows,)
    simplex = u((rows, n // 8, 3), 0.1, 1.0)
    simplex /= simplex.sum(-1, keepdims=True)
    return {
        "_random_pdf_uniform": [u(s, 0.05, 0.95), u(p, -0.2, 0.0),
                                u(p, 1.0, 1.3)],
        "_random_pdf_normal": [u(s, -2, 2), u(p, -0.5, 0.5),
                               u(p, 0.5, 2.0)],
        "_random_pdf_gamma": [u(s, 0.2, 3.0), u(p, 1.0, 3.0),
                              u(p, 0.5, 2.0)],
        "_random_pdf_exponential": [u(s, 0.0, 3.0), u(p, 0.5, 2.0)],
        "_random_pdf_poisson": [ints(s, 7), u(p, 0.5, 4.0)],
        "_random_pdf_negative_binomial": [ints(s, 8), u(p, 3.0, 5.0),
                                          u(p, 0.2, 0.8)],
        "_random_pdf_generalized_negative_binomial": [
            ints(s, 8), u(p, 1.0, 4.0), u(p, 0.2, 1.0)],
        "_random_pdf_dirichlet": [simplex, u((rows, 3), 0.8, 3.0)],
    }


def rnn_pdf(torch, mt, spec=RNN_PDF):
    """Each pdf op, density and log-density, and the gradients of all its
    inputs under a seeded cotangent, on the card against the CPU
    (TOL_PDF, TOL_PDF_PARAM_GRAD)."""
    atol, rtol = TOL_PDF
    worst = worst_param = 0.0
    for name, inputs in pdf_inputs(spec["rows"], spec["n"]).items():
        for is_log in (False, True):
            got = []
            for ctx in (mt.gpu(0), mt.cpu()):
                arrs = [mt.nd.array(x, ctx=ctx) for x in inputs]
                for a in arrs:
                    a.attach_grad()
                with mt.autograd.record():
                    out = getattr(mt.nd, name)(*arrs, is_log=is_log)
                cot = np.random.RandomState(5).uniform(
                    0.5, 1.5, out.shape).astype(np.float32)
                out.backward(mt.nd.array(cot, ctx=ctx))
                got.append([out.asnumpy()] + [a.grad.asnumpy()
                                              for a in arrs])
            for i, (a, b) in enumerate(zip(*got)):
                what = ("value", "sample grad")[i] if i < 2 else \
                    "parameter %d grad" % (i - 1)
                if not np.isfinite(a).all():
                    raise AssertionError("%s (is_log %s) %s: not finite on "
                                         "the card" % (name, is_log, what))
                if i < 2:
                    excess = np.abs(a - b) - (atol + rtol * np.abs(b))
                    if excess.max() > 0:
                        raise AssertionError(
                            "%s (is_log %s) %s: card vs CPU off by %.3g "
                            "beyond TOL_PDF" % (name, is_log, what,
                                                excess.max()))
                    worst = max(worst, float(np.max(
                        np.abs(a - b) / (atol + rtol * np.abs(b)))))
                    continue
                rel = float(np.linalg.norm(a - b)
                            / max(np.linalg.norm(b), 1e-30))
                if rel > TOL_PDF_PARAM_GRAD:
                    raise AssertionError(
                        "%s (is_log %s) %s: card vs CPU relative L2 %.3g "
                        "(limit %g)" % (name, is_log, what, rel,
                                        TOL_PDF_PARAM_GRAD))
                worst_param = max(worst_param, rel)
    log("pdf ops: 8 densities x (pdf, log-pdf) at %d x %d samples, card vs "
        "CPU: values and sample gradients within TOL_PDF %s (worst %.3f of "
        "it), parameter gradients' relative L2 worst %.2e (limit %g)"
        % (spec["rows"], spec["n"], TOL_PDF, worst, worst_param,
           TOL_PDF_PARAM_GRAD))
    return dict(worst=worst, worst_param_grad=worst_param)


def word_lm_loss_grads(mt, run):
    """(mean token loss, {parameter: gradient on the host}) of one
    recorded forward and backward of ``run``'s first window, from zero
    hidden states."""
    data, target = run.batch(0)
    with mt.autograd.record():
        output, _ = run.model(data, run.hidden)
        loss = run.loss(output, target)
    loss.backward()
    grads = {name: p.grad(run.ctx)._data.detach().cpu()
             for name, p in run.model._collect_params_with_prefix().items()}
    return float(loss.mean().asscalar()), grads


def word_lm_card_vs_cpu(torch, mt):
    """The word LM at WORD_LM's widths, dropout 0, from the same
    parameters on the card and on the CPU: the first window's loss and
    gradients, then WORD_LM_EQUIV_STEPS whole steps' losses and the
    parameters' change, in fp32; and the card's readings with TF32
    matmuls on, which the limits must not admit."""
    from mxnet_tpu_torch import entry
    t0 = time.perf_counter()
    steps = WORD_LM_EQUIV_STEPS
    runs = {key: entry.word_lm_setup(ctx=ctx, seed=1, windows=steps,
                                     dropout=0.0)
            for key, ctx in (("card", mt.gpu(0)), ("tf32", mt.gpu(0)),
                             ("host", mt.cpu()))}
    start = {name: p.data()._data.detach().cpu().clone() for name, p in
             runs["card"].model._collect_params_with_prefix().items()}
    got = {}
    for key, run in runs.items():
        torch.backends.cuda.matmul.allow_tf32 = key == "tf32"
        try:
            params = run.model._collect_params_with_prefix()
            for name, value in start.items():
                params[name].set_data(mt.nd.array(value.numpy(), ctx=run.ctx))
            loss, grads = word_lm_loss_grads(mt, run)
            losses = [float(run.step(i).mean().asscalar())
                      for i in range(steps)]
            change = {name: p.data()._data.detach().cpu() - start[name]
                      for name, p in params.items()}
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        got[key] = dict(loss=loss, grads=grads, losses=losses, change=change)
    host = got["host"]

    def readings(dev):
        return dict(
            loss=abs(dev["loss"] - host["loss"]) / abs(host["loss"]),
            steps=max(abs(a - b) / abs(b)
                      for a, b in zip(dev["losses"], host["losses"])),
            grad=max((rel_l2(dev["grads"][k], host["grads"][k]), k)
                     for k in host["grads"]),
            change=max((rel_l2(dev["change"][k], host["change"][k]), k)
                       for k in host["change"]))
    fp32, tf32 = readings(got["card"]), readings(got["tf32"])
    log("word LM card vs CPU (dropout 0, %d x %d windows, limits %s): fp32 "
        "(TF32 off): first-window loss %.6f vs %.6f (rel %.2e), worst "
        "gradient relative L2 %.2e (%s); the %d steps' losses %s vs %s "
        "(worst rel %.2e), worst change relative L2 over them %.2e (%s); "
        "the card with TF32 on: loss %.2e, gradient %.2e (%s), steps' "
        "losses %.2e, change %.2e (%s); %.1f s" % (
            entry.WORD_LM["bptt"], entry.WORD_LM["batch_size"], TOL_WORD_LM,
            got["card"]["loss"], host["loss"], fp32["loss"],
            fp32["grad"][0], fp32["grad"][1], steps,
            ["%.6f" % x for x in got["card"]["losses"]],
            ["%.6f" % x for x in host["losses"]], fp32["steps"],
            fp32["change"][0], fp32["change"][1], tf32["loss"],
            tf32["grad"][0], tf32["grad"][1], tf32["steps"],
            tf32["change"][0], tf32["change"][1], time.perf_counter() - t0))
    worst = {k: v[0] if isinstance(v, tuple) else v for k, v in fp32.items()}
    if any(not worst[k] <= TOL_WORD_LM[k] for k in TOL_WORD_LM):
        raise AssertionError("word LM card vs CPU: %s (gradient %s, change "
                             "%s) past the limits %s" % (
                                 worst, fp32["grad"][1], fp32["change"][1],
                                 TOL_WORD_LM))
    if not tf32["grad"][0] > TOL_WORD_LM["grad"] \
            or not tf32["change"][0] > TOL_WORD_LM["change"]:
        raise AssertionError("word LM card vs CPU: TF32 matmuls read "
                             "gradient %.3g and change %.3g, within the "
                             "limits %s: the gate cannot tell them from fp32"
                             % (tf32["grad"][0], tf32["change"][0],
                                TOL_WORD_LM))
    return dict(fp32=worst, tf32_grad_rel_l2=tf32["grad"][0],
                tf32_change_rel_l2=tf32["change"][0])


def kernel_launches(torch, fn, steps=3):
    """CUDA kernels that ``fn()`` launches a call, by torch.profiler (the
    pad markers not counted)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()

    def run():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad_trace(torch)
            for _ in range(steps):
                fn()
            pad_trace(torch)
        return [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and MARK_KERNEL not in e.key]
    rows = traced(torch, run, "the RNN op")
    return sum(e.count for e in rows) / steps


def rnn_word_lm(torch, mt, card):
    """upstream's word_language_model at WORD_LM (train.py's defaults,
    --tied): WORD_LM_STEPS steps hybridized on seeded tokens, the loss
    near ln(vocab) at first, finite and falling (the last five's median
    WORD_LM_DROP below ln(vocab)), every parameter changed; tokens/s
    over steps 5-20 by CUDA events; a profile of WORD_LM_PROFILE_STEPS
    steps; the RNN op's kernel launches in one forward and backward at
    the step's shape."""
    from mxnet_tpu_torch import entry
    from mxnet_tpu_torch.ops import nn as ops_nn
    spec = entry.WORD_LM
    t0 = time.perf_counter()
    run = entry.word_lm_setup(ctx=mt.gpu(0), seed=0, windows=WORD_LM_STEPS)
    setup_s = time.perf_counter() - t0
    params = run.model._collect_params_with_prefix()
    before = {name: p.data()._data.detach().clone()
              for name, p in params.items()}
    losses = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i in range(WORD_LM_STEPS):
        if i == WORD_LM_TIMED_FROM:
            torch.cuda.synchronize()
            t_host = time.perf_counter()
            start.record()
        losses.append(run.step(i).mean())
    end.record()
    torch.cuda.synchronize()
    timed = WORD_LM_STEPS - WORD_LM_TIMED_FROM
    step_ms = start.elapsed_time(end) / timed
    host_ms = 1e3 * (time.perf_counter() - t_host) / timed
    losses = [float(x.asscalar()) for x in losses]
    tokens = spec["bptt"] * spec["batch_size"]
    tok_s = tokens / (step_ms / 1e3)
    ln_v = float(np.log(spec["vocab"]))
    still = sorted(name for name, p in params.items()
                   if torch.equal(p.data()._data, before[name]))
    del before
    log("word LM (%s; vocab %d, %d x %d LSTM, dropout %g, tied, bptt %d x "
        "batch %d, SGD lr %g, clip %g, hybridized): setup %.1f s, losses "
        "%s; %.1f tokens/s over steps %d-%d (%.3f ms a step by CUDA events, "
        "%.3f ms on the host clock); the last five's median %.4f (limit "
        "%.4f); parameters unchanged %s" % (
            card, spec["vocab"], spec["nlayers"], spec["nhid"],
            spec["dropout"], spec["bptt"], spec["batch_size"], spec["lr"],
            spec["clip"], setup_s, ["%.4f" % x for x in losses], tok_s,
            WORD_LM_TIMED_FROM + 1, WORD_LM_STEPS, step_ms, host_ms,
            np.median(losses[-5:]), ln_v - WORD_LM_DROP, still))
    if not np.isfinite(losses).all() or abs(losses[0] - ln_v) > 0.5 \
            or not np.mean(losses[-5:]) < np.mean(losses[:5]) \
            or not losses[-1] < losses[0] \
            or not np.median(losses[-5:]) < ln_v - WORD_LM_DROP or still:
        raise AssertionError("word LM: losses %s (ln vocab %.3f), "
                             "parameters unchanged %s: not finite, not near "
                             "ln vocab at first, not falling, or not updated"
                             % (losses, ln_v, still))
    steps = iter(range(WORD_LM_STEPS, 10 ** 6))
    profile_steps(torch, "word LM step (%s)" % card,
                  lambda: run.step(next(steps)),
                  steps=WORD_LM_PROFILE_STEPS, top=8, kinds=TRAIN_KINDS)
    # the RNN op alone, forward and backward at the step's shape
    layer = run.model.rnn
    n = spec["nlayers"]
    names = ["l%d_%s" % (i, w) for i in range(n)
             for w in ("i2h_weight", "h2h_weight")] + [
        "l%d_%s" % (i, w) for i in range(n) for w in ("i2h_bias", "h2h_bias")]
    params = torch.cat([getattr(layer, k).data()._data.reshape(-1)
                        for k in names]).detach().requires_grad_()
    x = torch.rand((spec["bptt"], spec["batch_size"], spec["emsize"]),
                   device=params.device, requires_grad=True)
    gen = mt.random.generator(params.device)

    def rnn_op():
        out = ops_nn.rnn(x, params, state_size=spec["nhid"],
                         num_layers=spec["nlayers"], mode="lstm",
                         p=spec["dropout"], state_outputs=True,
                         generator=gen, is_train=True)
        out[0].sum().backward()
    launches = kernel_launches(torch, rnn_op)
    log("word LM: the RNN op launches %.0f CUDA kernels a step (forward and "
        "backward, %d time steps x %d layers, dropout between them)"
        % (launches, spec["bptt"], spec["nlayers"]))
    return dict(losses=losses, tokens_s=tok_s, step_ms=step_ms,
                host_ms=host_ms, rnn_op_launches=launches)


def rnn_bucketing(torch, mt, card):
    """lstm_bucketing.py at BUCKETING_LM through BucketingModule.fit:
    each bucket bound once, the perplexity finite and falling (the fitted
    module scores the epoch's sentences below the epoch's training
    perplexity), samples/s over batches 5-24, and an rnn checkpoint round
    trip, bitwise."""
    from mxnet_tpu_torch import entry
    spec = entry.BUCKETING_LM
    binds = collections.Counter()
    bind = mt.module.Module.bind

    def counting_bind(self, data_shapes, *args, **kwargs):
        d = data_shapes[0]
        binds[tuple(getattr(d, "shape", None) or d[1])[1]] += 1
        return bind(self, data_shapes, *args, **kwargs)

    seen = []

    def on_batch(param):
        torch.cuda.synchronize()
        m = param.eval_metric
        seen.append((time.perf_counter(), m.sum_metric, m.num_inst))

    t0 = time.perf_counter()
    mt.module.Module.bind = counting_bind
    try:
        mod, stack, train = entry.bucketing_lm(
            ctx=mt.gpu(0), seed=0, batch_end_callback=[on_batch])
    finally:
        mt.module.Module.bind = bind
    fit_s = time.perf_counter() - t0
    if dict(binds) != {b: 1 for b in spec["buckets"]}:
        raise AssertionError("bucketing: binds per bucket %s" % dict(binds))
    if len(seen) != spec["batches"]:
        raise AssertionError("bucketing: %d batches, not %d"
                             % (len(seen), spec["batches"]))
    ppl = [float(np.exp((s1 - s0) / (n1 - n0))) for (_, s0, n0), (_, s1, n1)
           in zip([(0.0, 0.0, 0)] + seen[:-1], seen)]
    t_a, t_b = seen[BUCKETING_TIMED_FROM - 1][0], seen[-1][0]
    samples_s = (len(seen) - BUCKETING_TIMED_FROM) * spec["batch_size"] / (
        t_b - t_a)
    log("bucketing LSTM (%s; vocab %d, embed %d, %d x LSTMCell(%d), "
        "buckets %s, batch %d, %d batches, SGD lr %g wd %g): fit %.1f s; "
        "per-batch perplexity %s; %.1f samples/s over batches %d-%d"
        % (card, spec["vocab"], spec["num_embed"], spec["num_layers"],
           spec["num_hidden"], list(spec["buckets"]), spec["batch_size"],
           spec["batches"], spec["lr"], spec["wd"], fit_s,
           ["%.1f" % p for p in ppl], samples_s, BUCKETING_TIMED_FROM + 1,
           spec["batches"]))
    # the fitted module scored on the same sentences: below the epoch's
    # training perplexity, which its earlier weights gave
    train.reset()
    fitted = dict(mod.score(train, mt.metric.Perplexity(
        spec["invalid_label"])))["perplexity"]
    trained = float(np.exp(seen[-1][1] / seen[-1][2]))
    log("bucketing LSTM: the epoch's training perplexity %.2f, the fitted "
        "module's on the same sentences %.2f" % (trained, fitted))
    if not np.isfinite(ppl).all() or not fitted < trained:
        raise AssertionError("bucketing: perplexity %s not finite, or the "
                             "fitted module's %.3f not below the epoch's "
                             "%.3f" % (ppl, fitted, trained))
    arg, aux = mod.get_params()
    root = tempfile.mkdtemp(prefix="rnn_ckpt_")
    try:
        prefix = os.path.join(root, "lstm_bucketing")
        mt.rnn.save_rnn_checkpoint(stack, prefix, 1, mod.symbol, arg, aux)
        _, arg2, aux2 = mt.rnn.load_rnn_checkpoint(stack, prefix, 1)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if sorted(arg2) != sorted(arg) or sorted(aux2) != sorted(aux) or any(
            not np.array_equal(arg2[k].asnumpy(), arg[k].asnumpy())
            for k in arg):
        raise AssertionError("bucketing: the rnn checkpoint did not round "
                             "trip bitwise")
    log("bucketing LSTM: save_rnn_checkpoint / load_rnn_checkpoint round "
        "trip bitwise (%d arrays)" % len(arg))
    return dict(perplexity=ppl, samples_s=samples_s, fit_s=fit_s)


def rnn_control_flow(torch, mt, card, spec=CONTROL_FLOW):
    """benchmark/python/control_flow/rnn.py's LSTM three ways on gpu(0),
    from the same weights: ``sym.contrib.foreach`` over ``rnn.LSTMCell``,
    the hybridized fused ``gluon.rnn.LSTM``, and ``gluon.rnn.LSTMCell``
    stepped in a Python loop; their outputs agree to TOL_CONTROL_FLOW and
    each is timed."""
    T, N, H = spec["seq_len"], spec["batch"], spec["hidden"]
    ctx = mt.gpu(0)
    rs = np.random.RandomState(3)
    x_np = rs.rand(T, N, H).astype(np.float32)
    w = {k: rs.uniform(-0.1, 0.1, s).astype(np.float32) for k, s in (
        ("i2h_weight", (4 * H, H)), ("h2h_weight", (4 * H, H)),
        ("i2h_bias", (4 * H,)), ("h2h_bias", (4 * H,)))}
    nd = mt.nd
    with ctx:
        x = nd.array(x_np)
        fused = mt.gluon.rnn.LSTM(H, input_size=H, prefix="cf_fused_")
        fused.initialize(ctx=ctx)
        for k, v in w.items():
            getattr(fused, "l0_" + k).set_data(nd.array(v))
        fused.hybridize()
        cell = mt.gluon.rnn.LSTMCell(H, input_size=H, prefix="cf_cell_")
        cell.initialize(ctx=ctx)
        for k, v in w.items():
            getattr(cell, k).set_data(nd.array(v))

        def unrolled():
            states = cell.begin_state(batch_size=N)
            outs = []
            for t in range(T):
                out, states = cell(x[t], states)
                outs.append(out)
            return nd.stack(*outs)

        scell = mt.rnn.LSTMCell(num_hidden=H, prefix="cf_")
        outs, _ = mt.sym.contrib.foreach(
            lambda xt, states: scell(xt, states), mt.sym.Variable("data"),
            [mt.sym.Variable("h0"), mt.sym.Variable("c0")])
        args = {"data": x, "h0": nd.zeros((N, H)), "c0": nd.zeros((N, H))}
        args.update({"cf_" + k: nd.array(v) for k, v in w.items()})
        ex = outs.bind(ctx, args)
        routes = {"foreach": lambda: ex.forward()[0],
                  "fused (hybridized)": lambda: fused(x),
                  "unrolled cell": unrolled}
        got = {k: f().asnumpy() for k, f in routes.items()}
        ms = {k: time_ms(f, CONTROL_FLOW_ITERS) for k, f in routes.items()}
    ref = got["fused (hybridized)"]
    errs = {k: float(np.abs(v - ref).max()) for k, v in got.items()}
    log("control flow (%s; seq %d, batch %d, hidden %d): ms per sequence "
        "%s; max abs vs the fused layer %s (limit %g)" % (
            card, T, N, H, {k: round(v, 3) for k, v in ms.items()},
            {k: "%.2e" % v for k, v in errs.items()}, TOL_CONTROL_FLOW))
    if any(v.shape != (T, N, H) or not np.isfinite(v).all()
           for v in got.values()) or max(errs.values()) > TOL_CONTROL_FLOW:
        raise AssertionError("control flow: routes disagree: %s" % errs)
    return dict(ms=ms, errs=errs)


def rnn_phase(torch, mt):
    """Random sampling, control flow and the recurrent nets on the card
    (``random``, ``ops/random_ops``, ``control_flow``, ``rnn``,
    ``gluon.rnn``, ``gluon.contrib.rnn``, ``entry.word_lm`` and
    ``entry.bucketing_lm``; no hand kernel, and it fails if one is
    launched). Returns the numbers and the launches."""
    t0 = time.perf_counter()
    card = card_line()
    before = collections.Counter(mt.kernels.launches)
    out = {}
    # what makes arrays without a context makes them on the card
    with mt.gpu(0):
        out["samplers"] = rnn_samplers(torch, mt, card)
        out["pdf"] = rnn_pdf(torch, mt)
        torch.cuda.empty_cache()
        out["word_lm"] = rnn_word_lm(torch, mt, card)
        torch.cuda.empty_cache()
        out["word_lm_check"] = word_lm_card_vs_cpu(torch, mt)
        torch.cuda.empty_cache()
        out["bucketing"] = rnn_bucketing(torch, mt, card)
        torch.cuda.empty_cache()
        out["control_flow"] = rnn_control_flow(torch, mt, card)
    torch.cuda.empty_cache()
    launched = collections.Counter(mt.kernels.launches)
    launched.subtract(before)
    out["launches"] = {k: v for k, v in launched.items() if v}
    out["seconds"] = time.perf_counter() - t0
    log("rnn phase (%s): %.1f s; hand-kernel launches %s (the path runs "
        "none)" % (card, out["seconds"], out["launches"]))
    if out["launches"]:
        raise AssertionError("rnn phase: a hand kernel ran on a path that "
                             "has none: %s" % out["launches"])
    return out


def main():
    t_script = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    try:
        import mxnet_tpu_torch  # noqa: F401
    except ImportError as exc:
        raise SystemExit("chip_smoke: run from the root of a checkout of "
                         "the repository (%s)" % exc)
    import torch.nn.functional as F
    from mxnet_tpu_torch import kernels, parallel
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.models import checkpoint as ck
    from mxnet_tpu_torch.models import serving as sv
    from mxnet_tpu_torch.models import transformer as tf
    from mxnet_tpu_torch.parallel import ring

    # fp32 comparisons are made in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    log(card_line())
    log("torch %s, CUDA %s" % (torch.__version__, torch.version.cuda))

    t0 = time.perf_counter()
    _build.build_all()
    log("kernels built in %.1f s" % (time.perf_counter() - t0))
    for name, route in ROUTES.items():
        log("route %s: %s" % (name, route))

    paged_errs = check_paged(torch, kernels, device)
    check_paged_splits(torch, kernels, device)
    int8_errs = check_paged_int8(torch, kernels, device)
    torch.cuda.empty_cache()
    flash_errs = check_flash(torch, kernels, device)
    check_flash_splits(torch, kernels, device)
    train_errs = check_flash_attention(torch, kernels, device)
    check_flash_bwd_long(torch, kernels, device)
    carry_errs = check_flash_carry(torch, kernels, device)
    check_ring_schedule(torch, ring, kernels, device)
    torch.cuda.empty_cache()

    cfg = tf.TransformerConfig(dtype=torch.bfloat16, **SERVE_CFG)
    params = tf.init_params(cfg, seed=0, device=device)
    served = serve(torch, tf, sv, kernels, params, cfg, device,
                   "paged_decode")
    generated = run_generate(torch, tf, kernels, params, cfg, device,
                             flash_generate)
    served8, params8, cfg8 = serve_int8(torch, tf, sv, kernels, device)
    serve_rope(torch, tf, sv, kernels, device)
    torch.cuda.empty_cache()
    dispatched = serve_dispatch_phase(torch, tf, sv, kernels, params, cfg,
                                      device)
    torch.cuda.empty_cache()
    specd = spec_phase(torch, F, tf, sv, kernels, params, cfg, device)
    torch.cuda.empty_cache()
    durable = durable_phase(torch, tf, sv, kernels, params, cfg, device)
    torch.cuda.empty_cache()

    train_equivalence(torch, tf, kernels, device)
    torch.cuda.empty_cache()
    trained = train(torch, tf, kernels, device)
    meshed = mesh_forward(torch, tf, parallel, kernels, device)
    sp_decode = check_sp_decode(torch, ring, kernels, meshed["mesh"], device)
    mesh_trained = mesh_train_phase(torch, tf, sv, ck, parallel, kernels,
                                    params, cfg, device)
    rtc_run = rtc_phase(torch, kernels, mxnet_tpu_torch)

    rows = []
    for name, timing, run, err in (
            ("paged_decode", time_paged, served,
             paged_errs[("bfloat16", 1, 1)]),
            ("paged_decode_int8", time_paged_int8, served8,
             int8_errs[("bfloat16", 1, 1, 64)]),
            ("flash_decode", time_flash, generated,
             flash_errs[("bfloat16", 1)])):
        res = timing(torch, F, kernels, device)
        lib, lib_dev = res["library_ms"], res["library_device_ms"]
        bound, bound_by = res["bound"]
        log("%s: %.4f ms (device %.4f ms), plain %.4f ms, sdpa %s ms "
            "(device %s ms), bound %.4f ms, %.2f launches per decode step, "
            "host %.1f us per wrapper call"
            % (name, res["ms"], res["device_ms"], res["plain_ms"],
               "-" if lib is None else "%.4f" % lib,
               "-" if lib_dev is None else "%.4f" % lib_dev, bound,
               run["launches"] / run["steps"], res["host_us"]))
        log("%s: %d splits of %d positions; kernel / sdpa %s by events, %s "
            "by device time; device ms / bound %.2f"
            % (name, res["splits"], res["chunk"],
               "-" if lib is None else "%.3f" % (res["ms"] / lib),
               "-" if lib is None else "%.3f" % (res["device_ms"] / lib_dev),
               res["device_ms"] / bound))
        rows.append({"name": name, "route": "cuda", "source": SOURCE[name],
                     "replaces": REPLACES[name],
                     "launches": run["launches"], "max_abs_err": err,
                     "ms": res["ms"], "plain_ms": res["plain_ms"],
                     "bound_ms": bound, "bound_by": bound_by,
                     "library_ms": lib, "device_ms": res["device_ms"],
                     "library_device_ms": lib_dev})
        layout = {"paged_decode": "paged", "flash_decode": "dense"}.get(name)
        if layout:
            # the dispatch phase's greedy runs: n_layers x chunk a dispatch
            rows[-1]["dispatch_launches"] = {
                "%d,%d" % kd: r["launches"]
                for kd, r in dispatched[layout].items()}
        rows[-1]["spec_launches"] = spec_launches(specd, name)
        if name != "flash_decode":
            # B3 at the verify window, span spec_k + 1, max_len 4096
            rows[-1]["verify_ms"] = {
                "%d lanes" % n: specd["verify"][name, n]["ms"]
                for n in SPEC_VERIFY_LANES}
            rows[-1]["verify_device_ms"] = {
                "%d lanes" % n: specd["verify"][name, n]["device_ms"]
                for n in SPEC_VERIFY_LANES}
    outputs = {"flash_fwd": ("o",), "flash_bwd_dq": ("dq",),
               "flash_bwd_dkv": ("dk", "dv")}
    timed = time_flash_attention(torch, F, kernels, device)
    for name, (ms, plain, lib, (bound, bound_by)) in timed.items():
        err = max(train_errs[("train", True, "bfloat16", out)]
                  for out in outputs[name])
        log("%s: %.4f ms, plain %.4f ms, sdpa %.4f ms (%.2fx of it%s), "
            "bound %.4f ms (%s), %d launches in %d train steps"
            % (name, ms, plain, lib, ms / lib,
               "; target 2x" if name == "flash_fwd" else "", bound, bound_by,
               trained["launches"][name], TRAIN["steps"]))
        rows.append({"name": name, "route": "cuda", "source": SOURCE[name],
                     "replaces": REPLACES[name],
                     "launches": trained["launches"][name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": bound, "bound_by": bound_by,
                     "library_ms": lib})
    carry = time_flash_carry(torch, F, kernels, device)
    ms, plain, (bound, bound_by), sdpa = carry["B1 shape"]
    log("flash_carry: %.4f ms, plain %.4f ms, sdpa forward %.4f ms (%.2fx "
        "of it; target 2x), bound %.4f ms (%s), %d launches per mesh forward "
        "(bf16, 8 x 1024), sp_flash_decode %d flash_decode launch"
        % (ms, plain, sdpa, ms / sdpa, bound, bound_by, meshed["launches"],
           sp_decode[0]))
    time_flash_d64(torch, F, kernels, device)
    rows.append({"name": "flash_carry", "route": "cuda",
                 "source": SOURCE["flash_carry"],
                 "replaces": REPLACES["flash_carry"],
                 "launches": meshed["launches"],
                 "max_abs_err": carry_errs[("main 8x1024", "bfloat16", 128)],
                 "ms": ms, "plain_ms": plain, "bound_ms": bound,
                 "bound_by": bound_by, "library_ms": sdpa})
    for name, (ms, plain, lib, (bound, bound_by)) in time_rtc(
            torch, mxnet_tpu_torch.nd, rtc_run).items():
        route = "triton" if name in ("rtc:saxpy", "rtc:sgd_mom_update") \
            else "cuda"
        log("%s (%s): %.4f ms, plain %.4f ms, library %s ms, bound %.4f ms "
            "(%s), %d launches in the rtc phase"
            % (name, route, ms, plain, "-" if lib is None else "%.4f" % lib,
               bound, bound_by, rtc_run["launches"][name]))
        rows.append({"name": name, "route": route, "source": "chip_smoke.py",
                     "replaces": "mxnet_tpu/rtc.py:63",
                     "launches": rtc_run["launches"][name],
                     "max_abs_err": rtc_run["errs"][name], "ms": ms,
                     "plain_ms": plain, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": lib})
    log("rtc: head forward + backward %.3f ms, NVRTC compile %.3f s, first "
        "Triton launch (compile included) %.3f s"
        % (rtc_run["head_ms"], rtc_run["compile_s"],
           rtc_run["triton_first_s"]))
    del rtc_run
    torch.cuda.empty_cache()
    resnet = resnet_phase(torch, mxnet_tpu_torch, device)
    gluon_train_phase(torch, mxnet_tpu_torch, device,
                      resnet["train"]["step_ms"])
    io_phase(torch, mxnet_tpu_torch, device)
    moduled = module_phase(torch, mxnet_tpu_torch, device)
    elasticd = elastic_phase(torch, mxnet_tpu_torch, device)
    torch.cuda.empty_cache()
    rnnd = rnn_phase(torch, mxnet_tpu_torch)
    log("decode step: serve %.3f ms, generate %.3f ms; train step %.3f ms; "
        "mesh forward %.3f ms" % (served["step_ms"], generated["step_ms"],
                                  trained["step_ms"], meshed["forward_ms"]))
    profile_decode(torch, tf, sv, params, cfg, device)
    profile_serve(torch, sv, params8, cfg8, device,
                  "int8 serve step, 16 live lanes of 32", expect=INT8_SPLIT)
    del params8
    profile_steps(torch, "train step, bf16, batch 8 x 1024",
                  lambda: trained["step"](trained["params"], trained["mom"],
                                          trained["tokens"]),
                  steps=3, top=12, kinds=TRAIN_KINDS,
                  expect=(TEMPLATE,) + BWD_TEMPLATES)
    del trained
    tokens = mesh_tokens(torch, meshed["cfg"], *MESH_RUNS[0], device)
    with torch.no_grad():
        profile_steps(torch, "mesh forward, bf16, batch 8 x 1024",
                      lambda: tf.forward(meshed["params"], tokens,
                                         meshed["cfg"], meshed["mesh"]),
                      steps=3, top=12, kinds=TRAIN_KINDS,
                      expect=(TEMPLATE,))
    del meshed
    torch.cuda.empty_cache()
    sweep(torch, F, kernels, device)
    train_sweep(torch, F, kernels, device)
    for row in rows:
        # launches in the durable phase's runs (B1-B4 only) and in the
        # mesh-training phase's (B1-B4: the mesh step, sharded generate and
        # beam search, the q8 serving runs)
        row["durable_launches"] = durable.get(row["name"], 0)
        row["mesh_launches"] = mesh_trained.get(row["name"], 0)
        # the kvstore and Module phase's path launches no hand kernel
        row["module_launches"] = moduled["launches"].get(row["name"], 0)
        # the elastic phase's flagship steps (B1/B2a/B2b only), in this
        # process and in generation 1's worker
        row["elastic_launches"] = elasticd["launches"].get(row["name"], 0)
        # random sampling, control flow and the recurrent nets launch no
        # hand kernel
        row["rnn_launches"] = rnnd["launches"].get(row["name"], 0)
    log("chip_smoke: %.1f s in all (%s)" % (time.perf_counter() - t_script,
                                           card_line()))
    log(card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def import_package_as(path, name):
    """The package in directory ``path`` imported under the top-level
    ``name``: its relative imports resolve inside it, so it runs beside
    the package of the same name that this checkout holds."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def decode_path(torch, pkg, device, rounds):
    """{label: fn} of the decode path of the port package ``pkg``: its
    wrappers on the paged kernel's full served pool (bfloat16 and int8,
    seed 11) and on flash decode at ``time_flash``'s shape (seed 21), a
    serve step of its batcher (16 live lanes of 32, admitted and warmed
    up by two steps, with tokens enough for ``rounds`` timed rounds) and
    a generate() decode step at batch 8 after a 256-token prefill."""
    kernels, sv, tf = pkg.kernels, pkg.models.serving, pkg.models.transformer
    q, pool, tables, pos = full_pool_case(torch, device, torch.bfloat16,
                                          seed=11)
    q8, pool8, tables8, pos8 = full_pool_case(torch, device, torch.bfloat16,
                                              seed=11, int8=True)
    fq, fk, fv, flen = flash_case(torch, device, torch.bfloat16, 1, seed=21)
    cfg = tf.TransformerConfig(dtype=torch.bfloat16, **SERVE_CFG)
    params = tf.init_params(cfg, seed=0, device=device)
    srv = batcher(sv, params, cfg, device)
    for prompt, n_new in serve_jobs(cfg, (rounds + 1) * (PROFILE_STEPS + 1)):
        srv.admit(prompt, n_new)
    b, t_p = GENERATE["batch"], GENERATE["prompt"]
    prompt = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (b, t_p))).to(device)
    state = {"cache": tf.init_cache(cfg, b, device), "pos": t_p}
    with torch.no_grad():
        logits, state["cache"] = tf.prefill(params, state["cache"], prompt,
                                            cfg)
    state["tok"] = torch.argmax(logits, -1)

    def decode():
        with torch.no_grad():
            out, state["cache"] = tf.decode_step(
                params, state["cache"], state["tok"], state["pos"], cfg)
        state["tok"] = torch.argmax(out, -1)
        state["pos"] += 1

    for _ in range(2):
        srv.step()
        decode()
    return {
        "paged_decode": lambda: kernels.paged_attention(q, pool, tables, pos),
        "paged_decode_int8": lambda: kernels.paged_attention(
            q8, pool8, tables8, pos8),
        "flash_decode": lambda: kernels.flash_decode_with_lse(fq, fk, fv,
                                                              flen),
        "serve_step": srv.step, "generate_step": decode}


def int8_cases(torch, device, bs=16, nbl=256):
    """{label: (q, pool, tables, pos)} of the int8 wrapper's device-time
    pairs, q in bf16: the served pool full (seed 11, as
    ``time_paged_int8``), 16 query rows a KV head (span 4 x G 4 on the
    served tables, seed 64) and every lane at 4096 positions for 8 and
    128 lanes (the sweep's shapes, each lane on blocks of its own)."""
    cases = {"full pool": full_pool_case(torch, device, torch.bfloat16,
                                         seed=11, int8=True),
             "16 rows": paged_case(torch, device, torch.bfloat16, 4, 4,
                                   seed=64, int8=True)}
    for lanes in (8, 128):
        rng = np.random.RandomState(lanes)
        tables = 1 + rng.permutation(lanes * nbl).reshape(lanes, nbl)
        pos = np.full(lanes, nbl * bs - 1)
        cases["%d x %d" % (lanes, nbl * bs)] = paged_tensors(
            torch, device, torch.bfloat16, tables, pos, 1, 1, seed=lanes,
            nb=lanes * nbl + 1, int8=True)
    return cases


def decode_host(other, rounds=10):
    """The decode path's host cost, this checkout's port against the one
    in the checkout at ``other``, both in one process on one card:
    ``rounds`` rounds, each timing both packages (in turn first) on the
    same inputs: the host µs per wrapper call (``host_us``) of
    ``decode_path``'s three wrappers and the host ms per step
    (``host_ms`` over PROFILE_STEPS, no profiler) of its serve and
    generate() steps; and, in one torch.profiler session a round, the
    device ms per call of both packages' int8 wrappers on ``int8_cases``.
    Logs each metric's minimum and median over the rounds for both and
    the median of the per-round differences, and one JSON line with
    every value: ``python3 chip_smoke.py --decode-host OTHER``."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    import mxnet_tpu_torch
    pkgs = {"this": mxnet_tpu_torch, "other": import_package_as(
        os.path.join(os.path.abspath(other), "mxnet_tpu_torch"),
        "mxnet_tpu_torch_other")}
    device = torch.device("cuda", 0)
    log(card_line())
    paths = {}
    for who, pkg in pkgs.items():
        pkg.kernels._build.build_all()
        paths[who] = decode_path(torch, pkg, device, rounds)
    cases = int8_cases(torch, device)
    out = {who: collections.defaultdict(list) for who in pkgs}
    for r in range(rounds):
        order = ("this", "other") if r % 2 else ("other", "this")
        for who in order:
            for name, fn in paths[who].items():
                out[who][name].append(
                    host_ms(torch, fn, PROFILE_STEPS) if name.endswith(
                        "_step") else host_us(torch, fn))
        fns = {(who, label): functools.partial(
            pkgs[who].kernels.paged_attention, *case)
            for who in order for label, case in cases.items()}
        for (who, label), parts in device_ms_each(torch, fns).items():
            out[who]["int8 device ms, " + label].append(sum(parts.values()))
    for name in out["this"]:
        what = name if name.startswith("int8 device") else "host %s, %s" % (
            name, "ms per step" if name.endswith("_step") else "us per call")
        a, b = out["other"][name], out["this"][name]
        log("%s: other min %.4f median %.4f; this min %.4f median %.4f; "
            "this - other, median of %d rounds %.4f"
            % (what, min(a), float(np.median(a)), min(b),
               float(np.median(b)), rounds,
               float(np.median(np.subtract(b, a)))))
    log(json.dumps({"decode_host": out, "other": os.path.abspath(other)}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--decode-host"] and len(sys.argv) == 3:
        decode_host(sys.argv[2])
    elif sys.argv[1:2] == ["--durable-child"] and len(sys.argv) == 4 \
            and sys.argv[3] in CRASH_MODES:
        durable_child(sys.argv[2], sys.argv[3])
    elif len(sys.argv) > 1:
        raise SystemExit("usage: chip_smoke.py [--decode-host OTHER | "
                         "--durable-child DIR greedy|sampled]")
    else:
        main()
